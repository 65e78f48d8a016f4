"""Deterministic fault injection — twin of ``smk_tpu/testing/faults.py``
for the chunked executor, the distributed checkpoint, the serving engine
and the process group's bring-up.

Every injector is armed only inside its context manager and leaves
nothing behind when it exits; each fires at exactly the configured
chunk, job or write (no clock, no randomness), and travels the real
path: a NaN planted in the carried state travels the guard, quarantine
and drop; a failed writer job the degrade path; a flipped bit the
checksum and lenient resume.

- :func:`inject_subset_nan`: the chunk whose sweeps cover an iteration
  returns its state with a subset's latent u set to NaN (the twin's
  ``_poison``), a given number of times;
- :func:`stall_chunk`: the chunk covering an iteration blocks after its
  sweeps until the context exits (or a bounded fallback), a hung chunk
  for the watchdog to turn into ``ChunkTimeoutError``;
- :func:`dead_domain`: every subset of one failure domain non-finite at
  one boundary, persistently (a dead device's signature);
- :func:`fail_writer_job`: the Nth ``BackgroundWriter`` job of the scope
  raises :class:`ChaosError`;
- :func:`kill_at_manifest`: the Nth manifest write raises
  :class:`SimulatedKill`, after its segment landed;
- :func:`corrupt_segment`: truncate or bit-flip a draw segment on disk;
- :func:`kill_process_at_generation`: the publish of one generation of
  the distributed checkpoint raises :class:`SimulatedKill` after the
  shards landed (the torn generation the two-phase commit rolls back);
- :func:`torn_shard`: truncate one process's last draw segment or its
  committed state shard of a distributed checkpoint;
- :func:`resplit_shards`: rewrite a one-process distributed checkpoint
  as another topology's shards, for an elastic resume;
- :func:`stall_predict`: the serving engine's next predict dispatches
  block until the context exits (or a bounded fallback), a wedged
  program for the request deadline to turn into ``RequestTimeoutError``;
- :func:`inject_predict_nan`: the next predict dispatches come back with
  chosen query rows NaN, for the per-row guard to quarantine;
- :func:`flaky_coordinator`: the first calls of
  ``torch.distributed.init_process_group`` raise a transient
  coordinator error, for ``init_distributed``'s backoff ladder.

The chunk injectors wrap the executor's one-chunk seam
(``parallel/recovery._run_chunk``), the serving injectors the engine's
program seam (``serve/engine._invoke_program``, the per-request and the
coalesced row-seed predict calls, never the guard), while one is armed, and put it back when the last disarms.
For tests and probes only, as the twin's.
"""

from __future__ import annotations

import contextlib
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from smk_torch.parallel import recovery as _recovery
from smk_torch.utils import checkpoint as _checkpoint
from smk_torch.utils.checkpoint import segment_path


class ChaosError(RuntimeError):
    """The injected failure of :func:`fail_writer_job`."""


class SimulatedKill(RuntimeError):
    """The injected mid-boundary kill of :func:`kill_at_manifest` and
    :func:`kill_process_at_generation`."""


@dataclass
class SubsetNaNInjection:
    """Arming state of :func:`inject_subset_nan`, and the handle it
    yields (``fires`` counts the strikes). ``skip_fires`` window hits
    pass untouched before the first strike."""

    subset: int
    at_iteration: int
    max_fires: int = 1
    skip_fires: int = 0
    fires: int = 0
    skipped: int = 0
    fired_at: list = field(default_factory=list)


@dataclass
class ChunkStallInjection:
    """Arming state of :func:`stall_chunk`: the chunk covering
    ``at_iteration`` blocks on ``release`` (set when the context exits)
    or for ``max_stall_s``, ``max_fires`` times."""

    at_iteration: int
    max_fires: int = 1
    max_stall_s: float = 600.0
    fires: int = 0
    stalled_at: list = field(default_factory=list)
    release: threading.Event = field(default_factory=threading.Event)


_arm_lock = threading.Lock()
_active_nan: list = []
_active_stall: list = []
_real_run_chunk = None


def _poison(state, subset: int, n_chains: int):
    """NaN every chain of ``subset``'s latent u (a small leaf the
    boundary guard covers)."""
    u = state.u.clone()
    u[subset * n_chains:(subset + 1) * n_chains] = float("nan")
    return state._replace(u=u)


def _injecting_run_chunk(model, kind, pieces, state, start, n):
    state, draws = _real_run_chunk(model, kind, pieces, state, start, n)
    for st in list(_active_stall):
        if start <= st.at_iteration < start + n and st.fires < st.max_fires:
            st.fires += 1
            st.stalled_at.append(start)
            st.release.wait(timeout=st.max_stall_s)
    hits = []
    for inj in list(_active_nan):
        if not start <= inj.at_iteration < start + n or inj.fires >= inj.max_fires:
            continue
        if inj.skipped < inj.skip_fires:
            inj.skipped += 1
            continue
        inj.fires += 1
        inj.fired_at.append(start)
        hits.append(inj.subset)
    for j in hits:
        state = _poison(state, j, model.config.n_chains)
    return state, draws


@contextmanager
def _armed(registry: list, inj):
    """Put ``inj`` in ``registry`` for the context, with the chunk seam
    wrapped while any chunk injection is armed."""
    global _real_run_chunk
    with _arm_lock:
        if not (_active_nan or _active_stall):
            _real_run_chunk = _recovery._run_chunk
            _recovery._run_chunk = _injecting_run_chunk
        registry.append(inj)
    try:
        yield inj
    finally:
        with _arm_lock:
            registry.remove(inj)
            if not (_active_nan or _active_stall):
                _recovery._run_chunk = _real_run_chunk
                _real_run_chunk = None


@contextmanager
def inject_subset_nan(subset: int, at_iteration: int, max_fires: int = 1,
                      skip_fires: int = 0):
    """Arm a subset-NaN injection: the chunk whose sweeps cover
    ``at_iteration`` returns its state with subset ``subset`` (a row of
    the fit's partition, or of a ragged fit's bucket group) poisoned,
    ``max_fires`` times after letting ``skip_fires`` window hits
    through. A quarantine retry replays the window, so ``max_fires=1``
    lets the first retry succeed and a large value exhausts the ladder.
    Injections nest. Yields the injection record."""
    inj = SubsetNaNInjection(subset=int(subset), at_iteration=int(at_iteration),
                             max_fires=int(max_fires), skip_fires=int(skip_fires))
    with _armed(_active_nan, inj):
        yield inj


@contextmanager
def stall_chunk(at_iteration: int, max_fires: int = 1, max_stall_s: float = 600.0):
    """Arm a hung chunk: the chunk whose sweeps cover ``at_iteration``
    blocks after them until this context exits (its ``finally`` sets
    the release) or ``max_stall_s`` passes, ``max_fires`` times. Under
    ``SMKConfig.watchdog`` the deadline fires during the stall and
    raises :class:`~smk_torch.parallel.domains.ChunkTimeoutError`.
    Yields the injection record."""
    inj = ChunkStallInjection(at_iteration=int(at_iteration), max_fires=int(max_fires),
                              max_stall_s=float(max_stall_s))
    try:
        with _armed(_active_stall, inj):
            yield inj
    finally:
        inj.release.set()


@contextmanager
def dead_domain(subsets, at_iteration: int, max_fires: int = 99):
    """Arm a dead domain: every subset in ``subsets`` (one domain's
    roster, ``FailureDomainMap.subsets_of``) goes non-finite at the
    boundary covering ``at_iteration``, persistently (``max_fires``
    outlasts every replay), which the quarantine runs through the
    domain's retry ladder as one event. Yields the per-subset records."""
    with contextlib.ExitStack() as stack:
        yield [stack.enter_context(inject_subset_nan(int(j), int(at_iteration),
                                                     max_fires=max_fires))
               for j in subsets]


@contextmanager
def fail_writer_job(nth: int, exc: BaseException = None):
    """Arm a writer failure: the ``nth`` job (1-based, counted over every
    ``BackgroundWriter`` of the scope) raises ``exc`` (default
    :class:`ChaosError`) when the writer thread runs it. Yields a counter
    dict (``{"submitted": n}``)."""
    real = _checkpoint.BackgroundWriter.submit
    counter = {"submitted": 0}

    def patched(self, job):
        counter["submitted"] += 1
        if counter["submitted"] == nth:
            def boom():
                raise exc or ChaosError(f"chaos: injected failure of writer job {nth}")

            return real(self, boom)
        return real(self, job)

    _checkpoint.BackgroundWriter.submit = patched
    try:
        yield counter
    finally:
        _checkpoint.BackgroundWriter.submit = real


@contextmanager
def kill_at_manifest(nth: int):
    """Arm a kill: the ``nth`` manifest write of the scope (1-based, over
    every checkpoint) raises :class:`SimulatedKill` after that
    boundary's segment landed and before its manifest. Under "sync" the
    kill unwinds the executor as a process death would; under "overlap"
    it lands in the writer thread and the run degrades. Yields a counter
    dict (``{"writes": n}``)."""
    real = _recovery._SegmentedCheckpoint._write_manifest
    counter = {"writes": 0}

    def patched(self, state_np, noise_np, it, fault=None):
        counter["writes"] += 1
        if counter["writes"] == nth:
            raise SimulatedKill(f"chaos: simulated kill at manifest write {nth}")
        return real(self, state_np, noise_np, it, fault)

    _recovery._SegmentedCheckpoint._write_manifest = patched
    try:
        yield counter
    finally:
        _recovery._SegmentedCheckpoint._write_manifest = real


def corrupt_segment(path: str, index: int, mode: str = "bitflip") -> str:
    """Damage draw segment ``index`` of the checkpoint at ``path``:
    ``"truncate"`` keeps the first half of the file; ``"bitflip"`` flips
    one bit in the middle of the param payload and rewrites the file
    with the stale checksum, which only the checksum can catch. Returns
    the segment's path."""
    seg = segment_path(path, index)
    if mode == "truncate":
        with open(seg, "rb") as f:
            data = f.read()
        with open(seg, "wb") as f:
            f.write(data[: len(data) // 2])
    elif mode == "bitflip":
        with np.load(seg) as d:
            arrays = {k: d[k] for k in d.files}
        param = arrays["param"]
        raw = bytearray(param.tobytes())
        raw[len(raw) // 2] ^= 0x40
        arrays["param"] = np.frombuffer(bytes(raw), param.dtype).reshape(param.shape)
        with open(seg, "wb") as f:
            np.savez(f, **arrays)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return seg



# -- the distributed checkpoint (parallel/checkpoint.py) --------------------

@contextmanager
def kill_process_at_generation(generation: int):
    """Arm the crash-window kill of the distributed checkpoint: the
    manifest publish of generation ``generation`` raises
    :class:`SimulatedKill` instead of writing, on the one process that
    publishes (process 0), after its shards landed and the land barrier
    passed. Its peers then time out at the publish barrier with a typed
    CkptCommitError (bounded by ``ckpt_commit_timeout_s``). On disk the
    previous generation stays published and the killed generation's
    shard files are orphans that a resume finds and overwrites. Yields a
    counter dict (``{"publishes": n}``)."""
    from smk_torch.parallel import checkpoint as _dist

    real = _dist.DistributedCheckpoint._publish_manifest
    counter = {"publishes": 0}

    def patched(self, it, gen):
        counter["publishes"] += 1
        if int(gen) == int(generation):
            raise SimulatedKill(
                "chaos: simulated process death between shard-land and manifest-publish "
                f"of generation {gen}")
        return real(self, it, gen)

    _dist.DistributedCheckpoint._publish_manifest = patched
    try:
        yield counter
    finally:
        _dist.DistributedCheckpoint._publish_manifest = real


def torn_shard(path: str, process_id: int, kind: str = "segment") -> str:
    """Damage one process's shard of the newest committed generation of
    the distributed checkpoint at ``path``: ``kind="segment"`` truncates
    process ``process_id``'s last draw segment to half (a lenient resume
    re-samples its iteration range across all subsets);
    ``kind="state"`` truncates its committed state shard (not
    recoverable: the resume raises a typed error naming the shard's
    owner). Returns the damaged path."""
    from smk_torch.parallel import checkpoint as _dist
    from smk_torch.utils.checkpoint import load_pytree

    man = load_pytree(path, _dist._manifest_like())
    if kind == "segment":
        seg_base = int(np.asarray(man["seg_base"])[0])
        n_seg = int(np.asarray(man["n_segments"])[0])
        if n_seg < 1:
            raise ValueError(f"checkpoint {path} has no draw segments to tear")
        target = segment_path(_dist.shard_segment_prefix(path, int(process_id)),
                              seg_base + n_seg - 1)
    elif kind == "state":
        gen = int(np.asarray(man["generation"])[0])
        target = _dist.shard_state_path(path, int(process_id), gen)
    else:
        raise ValueError(f"unknown torn_shard kind {kind!r}")
    with open(target, "rb") as f:
        data = f.read()
    with open(target, "wb") as f:
        f.write(data[: len(data) // 2])
    return target


def resplit_shards(path: str, shard_rows, noise_like=None) -> None:
    """Rewrite a one-process distributed checkpoint on disk as if
    ``len(shard_rows)`` processes had written it: per-process state shards
    and segments cut on the subset axis at ``shard_rows`` ((start, stop)
    subset rows each), the manifest's ``shard_rows`` and ``n_processes``
    updated. A resume then takes the genuine elastic path. ``noise_like``:
    the structure of the noise snapshot (default: one array, as
    models/probit_gp.GeneratorNoise's)."""
    from smk_torch.models.probit_gp import SamplerState
    from smk_torch.parallel import checkpoint as _dist
    from smk_torch.parallel.recovery import _row_axis
    from smk_torch.utils.checkpoint import load_pytree, load_segment, save_pytree, save_segment

    man = load_pytree(path, _dist._manifest_like())
    if int(np.asarray(man["n_processes"])[0]) != 1:
        raise ValueError(f"checkpoint {path} was not written by one process")
    c = int(np.asarray(man["meta"])[5])
    gen = int(np.asarray(man["generation"])[0])
    seg_base = int(np.asarray(man["seg_base"])[0])
    n_seg = int(np.asarray(man["n_segments"])[0])
    placeholder = SamplerState(*([np.zeros(0)] * len(SamplerState._fields)))
    like = {"generation": np.zeros(1), "rows": np.zeros(2), "state": placeholder,
            "layout": placeholder, "noise": np.zeros(0) if noise_like is None else noise_like,
            "fault": dict.fromkeys(_dist._FAULT_FIELDS, np.zeros(0))}
    src = load_pytree(_dist.shard_state_path(path, 0, gen), like)
    rows = [(int(a), int(b)) for a, b in shard_rows]

    def cut(arr, ax, a, b):
        ix = [slice(None)] * arr.ndim
        ix[ax] = slice(a * c, b * c)
        return arr[tuple(ix)]

    for pid, (a, b) in enumerate(rows):
        state = SamplerState(*(cut(np.asarray(x), _row_axis(perm), a, b)
                               for x, perm in zip(src["state"], src["layout"])))
        noise = _dist._tree_map(lambda x: np.asarray(x)[a * c:b * c], src["noise"])
        fault = dict(src["fault"])
        for f in ("fault_attempts", "fault_dead", "fault_domain"):
            fault[f] = np.asarray(fault[f])[a:b]
        save_pytree(_dist.shard_state_path(path, pid, gen), {
            **src, "rows": np.asarray([a, b], np.int64), "state": state, "noise": noise,
            "fault": fault})
    prefix0 = _dist.shard_segment_prefix(path, 0)
    for i in range(seg_base, seg_base + n_seg):
        seg = load_segment(prefix0, i)
        for pid, (a, b) in enumerate(rows):
            save_segment(_dist.shard_segment_prefix(path, pid), i, seg["param"][a * c:b * c],
                         seg["w"][a * c:b * c], seg["start"], seg["stop"])
    man["shard_rows"] = np.asarray(rows, np.int64)
    man["n_processes"] = np.asarray([len(rows)], np.int64)
    save_pytree(path, man)


# -- the serving engine (serve/engine.py) ---------------------------------

_active_predict_stall: list = []
_active_predict_nan: list = []
_real_invoke = None


@dataclass
class PredictStallInjection:
    """Arming state of :func:`stall_predict`: the next ``max_fires``
    predict dispatches block on ``release`` (set when the context exits)
    or for ``max_stall_s``."""

    max_fires: int = 1
    max_stall_s: float = 600.0
    fires: int = 0
    release: threading.Event = field(default_factory=threading.Event)


@dataclass
class PredictNaNInjection:
    """Arming state of :func:`inject_predict_nan`: the next
    ``max_fires`` predict dispatches return with ``rows`` of their output
    set to NaN."""

    rows: tuple
    max_fires: int = 1
    fires: int = 0


def _poison_predict_rows(arr, rows):
    """``arr`` with the query rows ``rows`` (axis 1) NaN, as a new tensor."""
    out = arr.clone()
    out[:, list(rows)] = float("nan")
    return out


def _injecting_invoke(prog, prog_key, *args):
    if prog_key[0] not in ("serve_predict", "serve_predict_rs"):
        return _real_invoke(prog, prog_key, *args)
    # the fire counts move under the arm lock: concurrent dispatches
    # (max_in_flight > 1) never run past max_fires
    with _arm_lock:
        stalls = [st for st in _active_predict_stall if st.fires < st.max_fires]
        for st in stalls:
            st.fires += 1
    for st in stalls:
        st.release.wait(timeout=st.max_stall_s)
    out = _real_invoke(prog, prog_key, *args)
    hits: list = []
    with _arm_lock:
        for inj in list(_active_predict_nan):
            if inj.fires < inj.max_fires:
                inj.fires += 1
                hits.extend(inj.rows)
    if not hits:
        return out
    rows = sorted(set(hits))
    ps, pq = out
    return _poison_predict_rows(ps, rows), _poison_predict_rows(pq, rows)


@contextmanager
def _armed_serve(registry: list, inj):
    """Put ``inj`` in ``registry`` for the context, with the engine's
    program seam wrapped while any serving injection is armed."""
    global _real_invoke
    from smk_torch.serve import engine as _engine

    with _arm_lock:
        if not (_active_predict_stall or _active_predict_nan):
            _real_invoke = _engine._invoke_program
            _engine._invoke_program = _injecting_invoke
        registry.append(inj)
    try:
        yield inj
    finally:
        with _arm_lock:
            registry.remove(inj)
            if not (_active_predict_stall or _active_predict_nan):
                _engine._invoke_program = _real_invoke


@contextmanager
def stall_predict(max_fires: int = 1, max_stall_s: float = 600.0):
    """Arm a wedged predict: the engine's next ``max_fires`` predict
    dispatches block inside the dispatch until this context exits (its
    ``finally`` sets the release) or ``max_stall_s`` passes. The request
    deadline fires during the stall as a typed ``RequestTimeoutError``;
    the abandoned worker finishes at context exit and its result is
    dropped. Yields the injection record."""
    inj = PredictStallInjection(max_fires=int(max_fires), max_stall_s=float(max_stall_s))
    try:
        with _armed_serve(_active_predict_stall, inj):
            yield inj
    finally:
        inj.release.set()


@contextmanager
def inject_predict_nan(rows, max_fires: int = 1):
    """Arm sick rows: the engine's next ``max_fires`` predict dispatches
    come back with query ``rows`` (indices into the padded bucket, axis 1
    of the output) NaN — after query validation, so the damage travels
    the guard, the per-row quarantine, the partial response and the
    health state as a faulty device would feed it. Yields the injection
    record."""
    inj = PredictNaNInjection(rows=tuple(int(r) for r in rows), max_fires=int(max_fires))
    with _armed_serve(_active_predict_nan, inj):
        yield inj


@contextmanager
def flaky_coordinator(fail_first: int, passthrough: bool = False):
    """Arm the transient-coordinator injector: the first ``fail_first``
    calls of ``torch.distributed.init_process_group`` raise a transient
    (retryable) coordinator error; later calls go to the real function
    when ``passthrough`` (a real bring-up surviving a flaky start) or
    return as a no-op stub (unit tests of the backoff ladder, which must
    not start a process group). Yields a counter dict (``{"calls": n}``)."""
    import torch.distributed as dist

    real = dist.init_process_group
    counter = {"calls": 0}

    def patched(*args, **kwargs):
        counter["calls"] += 1
        if counter["calls"] <= fail_first:
            raise RuntimeError(
                "UNAVAILABLE: chaos: injected transient coordinator failure (attempt "
                f"{counter['calls']}; connection timed out)")
        if passthrough:
            return real(*args, **kwargs)
        return None

    dist.init_process_group = patched
    try:
        yield counter
    finally:
        dist.init_process_group = real
