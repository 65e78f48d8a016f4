"""The distributed checkpoint, format 8 — twin of
``smk_tpu/parallel/checkpoint.py``, in the port's own files.

The single-process checkpoint (format 7, parallel/recovery.py) writes the
whole carried state and every draw from one process. Over a
multi-process mesh each process holds only the subset rows it owns
(executor.process_row_range), so each process writes only those:

- **Per-process shard files.** Process ``p`` writes its rows of the
  carried state (each leaf in its memory order with its layout, as
  format 7 holds it), of the noise source's snapshot (a generator a
  row: the rows' own states) and of the fault ledger to
  ``<path>.pPPP.gGGGGG.state.npz``, one per committed generation, and
  appends its rows of each sampling chunk's draws as ordered segments
  ``<path>.pPPP.segNNNNN.npz`` (utils/checkpoint.save_segment, its
  checksum included).
- **A two-phase commit.** A chunk boundary is one GENERATION: every
  process lands its shard files; a barrier on the process group's store
  (parallel/distributed.barrier_sync, bounded by
  ``SMKConfig.ckpt_commit_timeout_s``) confirms them; process 0 alone
  publishes the one manifest at ``path`` (atomic rename); a second
  barrier releases the others. A kill in any window leaves the last
  published generation whole: the torn generation's files are orphans
  at deterministic names, found and overwritten on resume. A peer that
  is gone turns the barrier's timeout into a typed
  :class:`CkptCommitError`. At most two generations of state are on
  disk: generation g - 1's state shard goes once g is published.
- **Elastic resume.** On the same topology each process reads its own
  shard files. On another one (fewer processes, or the rows laid out
  anew) every process reads every shard from the shared directory,
  assembles the whole K rows, keeps its own, and publishes a fresh
  generation of them under the current layout (warned). Each row's
  generator state goes back to its row, so a resumed chain is the
  uninterrupted one bit for bit.
- **The run identity across processes.** Each process folds its own
  rows into exact plain and position-weighted mod-2^32 sums of the raw
  bit patterns (additive over rows, so the fold does not depend on the
  topology), the sums are all-gathered over the store, and every
  process folds them alike; the noise contributes one CRC a row. One
  process over all K rows, P processes over their own, and an elastic
  resume on one process compute the same vector.

All shard files and the manifest live under one ``checkpoint_path``
prefix that every process reads and writes: a shared filesystem on a
cluster, a local directory for processes of one machine.

A run without a multi-process mesh keeps writing format 7, byte for
byte; the executor takes this layer only under a multi-process mesh,
under :data:`FORCE_DISTRIBUTED_FOR_TESTING`, or when ``checkpoint_path``
already holds a format-8 manifest (the elastic resume onto one process).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
import zipfile
import zlib
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from smk_torch.analysis.sanitizers import explicit_d2h
from smk_torch.parallel.distributed import CollectiveTimeoutError, allgather_bytes, barrier_sync
from smk_torch.parallel.domains import FailureDomainMap
from smk_torch.utils.checkpoint import (
    BackgroundWriter,
    _flatten,
    _unflatten,
    load_pytree,
    save_pytree,
    save_segment,
    segment_path,
    to_numpy,
)
from smk_torch.utils.tracing import monotonic

# The distributed format; the single-process formats stay in
# parallel/recovery.py (CKPT_VERSION).
DIST_CKPT_VERSION = 8

# Testing hook: route a single-process run through this layer (the
# one-shard layout, barriers on whatever process group is up), so the
# generation, commit and rollback machinery runs in one process. Never
# set in library code.
FORCE_DISTRIBUTED_FOR_TESTING = False

_FAULT_FIELDS = ("fault_attempts", "fault_dead", "fault_domain", "fault_domain_attempts",
                 "fault_domain_dead")


class CkptCommitError(RuntimeError):
    """A generation's commit did not complete: a peer did not land its
    shards (or acknowledge the publish) within ``ckpt_commit_timeout_s``,
    or a multi-process job's writer failed. The last published
    generation is whole: resume from it."""


# ----------------------------------------------------------------------
# the shard layout
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Which contiguous subset rows each process writes: ``row_ranges[p]``
    is the ``(start, stop)`` of the process at position ``p`` (processes
    by ascending rank), ``process_id`` this process's position. Derived
    from the executor's layout oracle, so what a process writes is what
    it runs."""

    process_id: int
    row_ranges: tuple
    k: int

    @property
    def n_processes(self) -> int:
        return len(self.row_ranges)

    @property
    def rows(self) -> Tuple[int, int]:
        return self.row_ranges[self.process_id]

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    @classmethod
    def current(cls, k: int, mesh=None) -> "ShardLayout":
        """The layout of the current topology: one shard a process of a
        multi-process mesh (executor.all_process_row_ranges), else the
        one whole-K shard (one process, the forced layer, and the
        elastic resume onto one process)."""
        if mesh is not None and mesh.multi_process:
            from smk_torch.parallel.distributed import process_index
            from smk_torch.parallel.executor import all_process_row_ranges

            procs = list(mesh.process_indices)
            return cls(process_id=procs.index(process_index()),
                       row_ranges=tuple(tuple(r) for r in all_process_row_ranges(k, mesh)),
                       k=int(k))
        return cls(process_id=0, row_ranges=((0, int(k)),), k=int(k))


def shard_state_path(path: str, process_id: int, generation: int) -> str:
    """One process's state shard of one generation. Deterministic: a
    torn commit's orphan sits at the name the resumed run's commit of
    that generation overwrites."""
    return f"{path}.p{process_id:03d}.g{generation:05d}.state.npz"


def shard_segment_prefix(path: str, process_id: int) -> str:
    """The per-process root of the segment names:
    ``<path>.pPPP.segNNNNN.npz`` through utils/checkpoint.segment_path."""
    return f"{path}.p{process_id:03d}"


# ----------------------------------------------------------------------
# this process's rows on the host
# ----------------------------------------------------------------------
def _tree_map(fn, tree):
    leaves, _ = _flatten(tree)
    return _unflatten(tree, [fn(leaf) for leaf in leaves])


def local_tree_nbytes(tree) -> int:
    """Bytes of this process's rows over a tree of tensors or arrays (a
    process of the port holds only its own rows, so every leaf counts
    whole)."""
    total = 0
    for leaf in _flatten(tree)[0]:
        if torch.is_tensor(leaf):
            total += leaf.numel() * leaf.element_size()
        else:
            total += np.asarray(leaf).nbytes
    return total


def local_tree_np(tree):
    """This process's rows of every leaf as numpy (one synchronising copy
    a device leaf)."""
    return _tree_map(to_numpy, tree)


class LocalShardSnapshot:
    """A copy to the host of this process's rows of a tree, queued
    without blocking: each card tensor into pinned memory behind an event
    on its stream, a CPU tensor cloned. ``get()`` waits for the copies
    and returns the numpy tree. (The chunked executor stages its
    boundaries through its own pinned slots, recovery._HostStaging; this
    is the standalone form.)"""

    def __init__(self, tree):
        self._events = []

        def prep(leaf):
            if not torch.is_tensor(leaf):
                return np.array(leaf)
            if leaf.device.type != "cuda":
                return leaf.detach().clone()
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(leaf.device))
            self._events.append(ev)
            return host

        self._tree = _tree_map(prep, tree)
        self.nbytes = local_tree_nbytes(self._tree)

    def get(self):
        for ev in self._events:
            ev.synchronize()
        with explicit_d2h("host_snapshot", nbytes=self.nbytes):
            return local_tree_np(self._tree)


def fetch_global(local, layout: ShardLayout, *, timeout_s: float = 120.0,
                 tag: str = "chunk_stats") -> np.ndarray:
    """The whole-K array on every process, assembled from each process's
    rows (``local``: this process's rows, a whole number of rows a
    subset) through one bounded all-gather on the store; every process
    calls in the same order. The one-shard layout returns ``local`` as
    numpy. A dead peer is a typed CollectiveTimeoutError."""
    with explicit_d2h(tag, nbytes=local_tree_nbytes(local)):
        arr = to_numpy(local)
    if layout.n_processes == 1:
        return arr
    a, b = layout.rows
    per = arr.shape[0] // max(1, b - a)
    header = np.asarray([a * per, b * per], "<i8").tobytes()
    payload = header + np.ascontiguousarray(arr).tobytes()
    out = np.zeros((layout.k * per,) + arr.shape[1:], arr.dtype)
    for buf in allgather_bytes(tag, payload, timeout_s=timeout_s):
        lo, hi = (int(v) for v in np.frombuffer(buf[:16], "<i8"))
        out[lo:hi] = np.frombuffer(buf[16:], arr.dtype).reshape((hi - lo,) + arr.shape[1:])
    return out


# ----------------------------------------------------------------------
# the run identity across processes
# ----------------------------------------------------------------------
def identity_config_repr(cfg) -> bytes:
    """The run-identity view of a config: every chain-determining field,
    the pipeline, fault, store, observability, host-resilience, commit
    and partition-layout knobs set to fixed values (the twin's), so
    resuming across them stays legal."""
    cfg_ident = dataclasses.replace(
        cfg,
        chunk_pipeline="sync",
        fault_policy="abort",
        fault_max_retries=2,
        min_surviving_frac=0.5,
        compile_store_dir=None,
        xla_cache_dir=None,
        run_log_dir=None,
        profile_dir=None,
        profile_chunks=None,
        watchdog=False,
        watchdog_min_deadline_s=60.0,
        watchdog_margin=10.0,
        dist_init_timeout_s=120.0,
        dist_init_retries=3,
        live_diagnostics=(cfg.adaptive_schedule != "off"),
        ckpt_commit_timeout_s=120.0,
        partition_method="random",
        bucket_ladder=None,
        coalesce_window_ms=0.0,
    )
    return repr(cfg_ident).encode()


def _host_array(leaf) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor as its int16 bit patterns."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(leaf)


def _bits_u32(arr: np.ndarray) -> np.ndarray:
    """The flat uint32 bit patterns of an array, the twin's widening:
    4-byte elements as one word, 8-byte as two (low word first), 2-byte
    zero-extended, 1-byte (bool, int8, uint8) converted."""
    a = np.ascontiguousarray(arr).reshape(-1)
    size = a.dtype.itemsize
    if size == 4:
        return a.view(np.uint32)
    if size == 8:
        return a.view(np.uint32)
    if size == 2:
        return a.view(np.uint16).astype(np.uint32)
    return a.astype(np.uint32)


def leaf_identity_sums(leaf, flat_offset: int = 0) -> np.ndarray:
    """(2,) uint32: one array's (or one flat-contiguous piece of one,
    ``flat_offset`` elements into the whole) contribution to the leaf's
    plain and position-weighted (weight: global word index + 1) sums of
    its bit patterns, mod 2^32 — the twin's integers on the same array.
    Additive over disjoint pieces."""
    arr = _host_array(leaf)
    bits = _bits_u32(arr).astype(np.uint64)
    if bits.size == 0:
        return np.zeros(2, np.uint32)
    words = max(1, arr.dtype.itemsize // 4)
    mod = np.uint64(2 ** 32)
    off = np.uint64((int(flat_offset) * words) % (2 ** 32))
    w = (np.arange(bits.size, dtype=np.uint64) + off + np.uint64(1)) % mod
    plain = int(bits.sum() % mod)
    weighted = int(((bits * w) % mod).sum() % mod)
    return np.asarray([plain, weighted], np.uint32)


def _global_pair(gathered: List[bytes], i: int) -> np.ndarray:
    """Leaf ``i``'s (2,) sums over every process's contribution."""
    total = np.zeros(2, np.uint64)
    for buf in gathered:
        total += np.frombuffer(buf, "<u4")[2 * i:2 * i + 2].astype(np.uint64)
    return (total % np.uint64(2 ** 32)).astype("<u4")


def distributed_run_identity(cfg, noise, data, beta_init, layout: ShardLayout, *,
                             timeout_s: float = 120.0) -> np.ndarray:
    """The format-8 run identity: [config crc, noise crc, one crc per data
    leaf (coords, x, y, mask, coords_test, x_test), beta crc]. ``noise``
    and the first four data leaves hold this process's rows
    (``layout.rows``, C chain rows a subset); the test sites and the warm
    start are the same on every process and count once (process 0's).
    Each leaf's crc folds the global sums of its bit patterns (and the
    noise's the per-row CRCs of its rows' identities), agreed through one
    bounded all-gather, with its global shape and dtype."""
    c = cfg.n_chains
    a, b = layout.rows
    row_crcs = np.asarray([zlib.crc32(noise.rows([i]).identity()) for i in range((b - a) * c)],
                          np.uint32)
    leaves = [("noise", row_crcs, a * c, (layout.k * c,), True)]
    for name, leaf, sharded in zip(data._fields, data, (True,) * 4 + (False,) * 2):
        with explicit_d2h("run_identity"):
            arr = _host_array(leaf)
        shape = ((layout.k,) + arr.shape[1:]) if sharded else arr.shape
        row = int(np.prod(arr.shape[1:], dtype=np.int64)) if arr.ndim else 1
        leaves.append((name, arr, a * row, shape, sharded))
    if beta_init is not None:
        with explicit_d2h("run_identity"):
            arr = _host_array(beta_init)
        leaves.append(("beta", arr, 0, arr.shape, False))
    sums = []
    for _, arr, offset, _, sharded in leaves:
        mine = sharded or layout.is_leader
        sums.append(leaf_identity_sums(arr, offset) if mine else np.zeros(2, np.uint32))
    payload = np.concatenate(sums).astype("<u4").tobytes()
    gathered = allgather_bytes("run-identity", payload, timeout_s=timeout_s)
    crcs = [zlib.crc32(identity_config_repr(cfg))]
    for i, (name, arr, _, shape, _) in enumerate(leaves):
        h = zlib.crc32(repr((name, tuple(int(s) for s in shape), str(arr.dtype))).encode())
        crcs.append(zlib.crc32(_global_pair(gathered, i).tobytes(), h))
    return np.asarray(crcs, np.uint32)


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------
def _manifest_like():
    """The structure of a format-8 manifest (the leaves' shapes come from
    the file)."""
    return {
        "version": np.zeros(1, np.int64),
        "generation": np.zeros(1, np.int64),
        "it": np.zeros(1, np.int64),
        "meta": np.zeros(6, np.int64),
        "ident": np.zeros(1, np.uint32),
        "seg_base": np.zeros(1, np.int64),
        "n_segments": np.zeros(1, np.int64),
        "filled": np.zeros(1, np.int64),
        "n_processes": np.zeros(1, np.int64),
        "shard_rows": np.zeros((1, 2), np.int64),
    }


def is_distributed_manifest(path: str) -> bool:
    """Does ``path`` hold a format-8 manifest (not a format-7 one, whose
    structure differs)? The executor asks on resume, so the relaunch of a
    multi-process checkpoint on fewer processes takes this layer. Reads
    the file's structure string first, so a format-7 manifest (the whole
    carried state) is not loaded to answer."""
    try:
        with np.load(path) as data:
            if "__treedef__" not in data.files:
                return False
            saved = json.loads(bytes(data["__treedef__"]).decode())
        if saved != _flatten(_manifest_like())[1]:
            return False
        man = load_pytree(path, _manifest_like())
        return int(np.asarray(man["version"])[0]) == DIST_CKPT_VERSION
    except Exception:
        return False


def checkpoint_supported(mesh=None) -> dict:
    """Whether a checkpointed chunked fit runs on a topology, and in which
    format: always, format 8 over a multi-process mesh (whose
    ``checkpoint_path`` every process must share), format 7 otherwise."""
    multi = mesh is not None and mesh.multi_process
    return {"available": True, "format": DIST_CKPT_VERSION if multi else 7,
            "multi_process": bool(multi), "requires_shared_filesystem": bool(multi)}


# ----------------------------------------------------------------------
# the state machine
# ----------------------------------------------------------------------
class DistributedCheckpoint:
    """The format-8 state machine, one per process: the executor-facing
    surface of recovery._SegmentedCheckpoint (``save`` /
    ``ensure_synced`` / the full rewrites / ``load``), writing this
    process's shard of every array and committing each boundary as a
    generation (module docstring). Writes run inline (``"sync"``) or as
    jobs of this process's BackgroundWriter (``"overlap"``), where the
    barriers overlap the next chunk.

    ``state_np`` arguments are recovery._HostState copies of this
    process's rows; ``noise_np`` the noise source's snapshot of its rows;
    ``local_draws(filled)`` returns its rows' draws [0, filled) as numpy;
    ``fault_src()`` its rows' fault ledger (attempts, dead, domain of
    each subset, the domains' attempts and deaths)."""

    def __init__(self, path: str, meta: np.ndarray, ident: np.ndarray, layout: ShardLayout, *,
                 writer: Optional[BackgroundWriter] = None, pstats=None,
                 local_draws: Optional[Callable] = None, fault_src: Optional[Callable] = None,
                 commit_timeout_s: float = 120.0, run_log=None, barrier=barrier_sync):
        self.path = path
        self.meta = np.asarray(meta, np.int64)
        self.ident = ident
        self.layout = layout
        self.writer = writer
        self.pstats = pstats
        self._local_draws = local_draws
        self.commit_timeout_s = float(commit_timeout_s)
        self.run_log = run_log
        self._barrier = barrier
        kl = layout.rows[1] - layout.rows[0]
        self._fault_src = fault_src or (lambda: (
            np.zeros(kl, np.int64), np.zeros(kl, np.int64), np.zeros(kl, np.int64),
            np.zeros(1, np.int64), np.zeros(1, np.int64)))
        self.generation = 0
        self.seg_base = 0
        self.n_segments = 0
        self.filled = 0
        self.degraded = False
        self._need_full = False
        # an elastic resume with holes: the old topology's chain stays
        # the resumable truth until the refill's publication re-bases it
        # under the current layout (see load)
        self._suspend_appends = False
        self._warned_suspended = False

    @property
    def pid(self) -> int:
        return self.layout.process_id

    @property
    def n_chains(self) -> int:
        return int(self.meta[5])

    @property
    def _seg_prefix(self) -> str:
        return shard_segment_prefix(self.path, self.pid)

    # -- the snapshot of a boundary ------------------------------------
    def snapshot(self, tree):
        """(source, bytes) of a boundary's tree: a LocalShardSnapshot under
        the overlap pipeline (its ``get()`` the host copy), the live tree
        under sync (``local_tree_np`` of it when saved)."""
        if self.writer is not None:
            snap = LocalShardSnapshot(tree)
            return snap, snap.nbytes
        return tree, local_tree_nbytes(tree)

    # -- the writes (on the writing thread) ----------------------------
    def _shard(self, state_np, noise_np, fault, gen: int) -> dict:
        attempts, dead, dom, dom_att, dom_dead = fault
        return {
            "generation": np.asarray([gen], np.int64),
            "rows": np.asarray(self.layout.rows, np.int64),
            "state": state_np.arrays,
            "layout": state_np.layout,
            "noise": noise_np,
            "fault": {"fault_attempts": np.asarray(attempts, np.int64),
                      "fault_dead": np.asarray(dead, np.int64),
                      "fault_domain": np.asarray(dom, np.int64),
                      "fault_domain_attempts": np.asarray(dom_att, np.int64),
                      "fault_domain_dead": np.asarray(dom_dead, np.int64)},
        }

    def _publish_manifest(self, it: int, generation: int) -> int:
        """Process 0 only: publish the generation's manifest, the one file
        whose content says what exists. testing/faults
        .kill_process_at_generation patches this: the window after the
        shards landed and before it returns is the torn generation the
        commit protects against."""
        return save_pytree(self.path, {
            "version": np.asarray([DIST_CKPT_VERSION], np.int64),
            "generation": np.asarray([generation], np.int64),
            "it": np.asarray([it], np.int64),
            "meta": self.meta,
            "ident": self.ident,
            "seg_base": np.asarray([self.seg_base], np.int64),
            "n_segments": np.asarray([self.n_segments], np.int64),
            "filled": np.asarray([self.filled], np.int64),
            "n_processes": np.asarray([self.layout.n_processes], np.int64),
            "shard_rows": np.asarray(self.layout.row_ranges, np.int64).reshape(-1, 2),
        })

    def _agree(self, gen: int, it: int, nbytes: int, what: str) -> int:
        """Phase 2 of a commit: the land barrier, process 0's publish, the
        publish barrier; a barrier's timeout is a CkptCommitError (the
        previous generation stays published). Returns the bytes
        written."""
        try:
            self._barrier(f"smk-ckpt-land-g{gen}", timeout_s=self.commit_timeout_s)
            if self.layout.is_leader:
                nbytes += self._publish_manifest(it, gen)
            self._barrier(f"smk-ckpt-pub-g{gen}", timeout_s=self.commit_timeout_s)
        except CollectiveTimeoutError as e:
            raise CkptCommitError(f"generation {gen} {what} failed: {e}") from e
        self.generation = gen
        try:
            os.remove(shard_state_path(self.path, self.pid, gen - 1))
        except OSError:
            pass
        return nbytes

    def _record(self, gen: int, it: int, t0: float, t_land: float, nbytes: int):
        t1 = monotonic()
        if self.pstats is not None:
            self.pstats.add_ckpt_write(t_land - t0, nbytes)
            self.pstats.add_ckpt_commit(t1 - t_land, generation=gen, it=int(it),
                                        filled=int(self.filled),
                                        n_processes=self.layout.n_processes)
        return {"ckpt_write_s": t_land - t0, "ckpt_bytes": nbytes,
                "ckpt_commit_s": t1 - t_land}

    def _commit(self, state_np, noise_np, seg, it: int, fault) -> dict:
        """One boundary's two-phase commit. Phase 1: land this process's
        state shard and its segment (``seg`` = (param, w, start, stop), or
        None at a burn-in boundary). Phase 2: :meth:`_agree`."""
        gen = self.generation + 1
        t0 = monotonic()
        nbytes = save_pytree(shard_state_path(self.path, self.pid, gen),
                             self._shard(state_np, noise_np, fault, gen))
        if seg is not None:
            param, w, start, stop = seg
            if stop > start:
                nbytes += save_segment(self._seg_prefix, self.seg_base + self.n_segments,
                                       param, w, start, stop)
                self.n_segments += 1
                self.filled = stop
        t_land = monotonic()
        nbytes = self._agree(gen, it, nbytes, "commit")
        return self._record(gen, it, t0, t_land, nbytes)

    def _commit_full(self, state_np, noise_np, param_local, w_local, it: int, filled: int,
                     fault=None) -> dict:
        """A full per-process rewrite: one merged segment at a fresh index
        and a fresh generation (the elastic re-base, the degraded writer's
        recovery, the lenient refill's publication). Every process runs it
        in step (the plan is the same everywhere), so process 0's counters
        describe every process's chain."""
        gen = self.generation + 1
        t0 = monotonic()
        old = range(self.seg_base, self.seg_base + self.n_segments)
        self.seg_base += self.n_segments
        self.n_segments = self.filled = 0
        nbytes = save_pytree(shard_state_path(self.path, self.pid, gen),
                             self._shard(state_np, noise_np, fault or self._fault_src(), gen))
        if filled > 0:
            nbytes += save_segment(self._seg_prefix, self.seg_base, param_local, w_local,
                                   0, filled)
            self.n_segments, self.filled = 1, filled
        t_land = monotonic()
        nbytes = self._agree(gen, it, nbytes, "full-rewrite commit")
        for i in old:
            try:
                os.remove(segment_path(self._seg_prefix, i))
            except OSError:  # pragma: no cover - cleanup only
                pass
        return self._record(gen, it, t0, t_land, nbytes)

    # -- the boundary (caller's thread) ---------------------------------
    def _check_degrade(self) -> None:
        if self.writer is not None and not self.degraded and self.writer.error is not None:
            err = self.writer.acknowledge_error()
            if self.layout.n_processes > 1:
                # one process cannot re-base its own chain while process
                # 0's manifest counters describe everyone's, and its
                # missing lands stalled the others' barriers anyway
                raise CkptCommitError(
                    f"background distributed-checkpoint writer failed on process {self.pid} "
                    f"({err!r}); a multi-process job cannot degrade one process's chain "
                    "unilaterally — aborting; resume from the last committed generation")
            warnings.warn(
                f"background distributed-checkpoint writer failed ({err!r}); degrading to "
                "synchronous commits — the next boundary rewrites this process's full shard "
                "and publishes a fresh generation",
                RuntimeWarning, stacklevel=3,
            )
            self.writer.flush()
            self.degraded = True
            self._need_full = True

    def save(self, state_np, noise_np, seg, it: int, filled: int) -> dict:
        """Commit one boundary as one generation (the executor's call of
        recovery._SegmentedCheckpoint.save, same arguments). Returns the
        chunk record's entries: ``ckpt_job`` when the commit went to the
        writer, else its write and commit seconds and bytes."""
        if self._suspend_appends:
            if not self._warned_suspended:
                self._warned_suspended = True
                warnings.warn(
                    "distributed checkpoint: per-boundary commits are suspended during this "
                    "elastic lenient (hole) resume — the previous topology's committed "
                    "generations remain the resumable truth until the post-refill "
                    "publication re-bases the chain (a crash before then repeats this resume)",
                    RuntimeWarning, stacklevel=3,
                )
            return {}
        self._check_degrade()
        fault = self._fault_src()
        if self.writer is not None and not self.degraded:
            return {"ckpt_job": self.writer.submit(
                lambda: self._commit(state_np, noise_np, seg, it, fault))}
        if self._need_full:
            param, w = self._local_draws(filled)
            self._need_full = False
            return self._commit_full(state_np, noise_np, param, w, it, filled)
        if self.run_log is not None:
            # inline, the span nests on the caller's stack (the writer
            # thread emits the per-generation event alone)
            with self.run_log.span("ckpt_commit", generation=self.generation + 1):
                return self._commit(state_np, noise_np, seg, it, fault)
        return self._commit(state_np, noise_np, seg, it, fault)

    def ensure_synced(self, state_fn, noise_np, it: int, filled: int) -> None:
        """Drain the writer; publish a full generation inline from the
        live state (``state_fn()``, its host copy) if a background commit
        was lost."""
        if self._suspend_appends or self.writer is None:
            return
        self.writer.flush()
        if self.writer.error is not None and not self.degraded:
            self._check_degrade()
        if self._need_full:
            param, w = self._local_draws(filled)
            self._commit_full(state_fn(), noise_np, param, w, it, filled)
            self._need_full = False

    def rewrite_full_from_device(self, state_live, noise_np, param_local, w_local, it: int,
                                 filled: int) -> None:
        """The lenient refill's publication: this process's live state
        (on its device), its noise snapshot and its rows' whole kept
        region as one merged segment in a fresh generation. Ends an
        elastic resume's suspension: from here the chain is the current
        layout's."""
        from smk_torch.parallel.recovery import _host_state

        if self.writer is not None and not self._suspend_appends:
            self.writer.flush()
            if self.writer.error is not None:
                self._check_degrade()
        self._suspend_appends = False
        self._commit_full(_host_state(state_live), noise_np, param_local, w_local, it, filled)
        self._need_full = False

    # -- resume -----------------------------------------------------------
    def _warn_orphans(self, generation: int, prev_rows) -> None:
        """Warn of the shard files of a torn generation (landed after the
        last published manifest: a kill between land and publish). The
        resumed run overwrites them as it reaches that boundary."""
        nxt = self.seg_base + self.n_segments
        torn = [p for p in range(len(prev_rows))
                if os.path.exists(shard_state_path(self.path, p, generation + 1))
                or os.path.exists(segment_path(shard_segment_prefix(self.path, p), nxt))]
        if torn:
            dmap = FailureDomainMap.from_shard_rows(prev_rows)
            warnings.warn(
                f"checkpoint {self.path}: orphan shard files of torn generation "
                f"{generation + 1} found for {[dmap.labels[p] for p in torn]} — a previous run "
                "crashed between shard-land and manifest-publish; resuming from the last "
                f"COMMITTED generation {generation} (the orphans are overwritten as the "
                "resumed run reaches that boundary again)",
                RuntimeWarning, stacklevel=3,
            )

    def _read_shard(self, p: int, rows, gen: int, prev_rows, state_like, noise_like) -> dict:
        a, b = rows
        sp = shard_state_path(self.path, p, gen)
        like = {"generation": np.zeros(1, np.int64), "rows": np.zeros(2, np.int64),
                "state": state_like, "layout": state_like, "noise": noise_like,
                "fault": dict.fromkeys(_FAULT_FIELDS, np.zeros(0, np.int64))}
        try:
            shard = load_pytree(sp, like)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            dmap = FailureDomainMap.from_shard_rows(prev_rows)
            raise ValueError(
                f"checkpoint {self.path}: carried-state shard {sp} (owner {dmap.labels[p]}, "
                f"subset rows [{a}, {b})) of committed generation {gen} is missing or "
                "unreadable — a committed generation's shards all existed at publish time "
                "(two-phase commit), so the file was damaged after the fact; restore it or "
                "delete the checkpoint and re-run"
            ) from e
        if (int(np.asarray(shard["generation"])[0]) != gen
                or not np.array_equal(np.asarray(shard["rows"]), np.asarray((a, b)))):
            raise ValueError(
                f"checkpoint {self.path}: state shard {sp} records a different "
                "generation/row range than the manifest — the file set is inconsistent")
        return shard

    def load(self, *, state_like, noise_like, dtype, d_par: int, d_w: int,
             lenient: bool) -> dict:
        """Load the last committed generation: this process's rows of the
        carried state (a recovery._HostState), of the noise snapshot, of
        the draws [0, filled) (numpy, or None) and of the fault ledger
        (format 7's key names), with ``it``, ``generation``, ``holes``
        (iteration ranges of torn segments, agreed over the processes),
        ``same_topology`` and ``prev_shard_rows``. On another topology
        every shard is read, the whole K assembled and this process's
        rows kept; without holes a fresh generation of them is published
        at once under the current layout."""
        from smk_torch.parallel.recovery import _HostState, _row_axis

        try:
            man = load_pytree(self.path, _manifest_like())
        except ValueError as e:
            raise ValueError(
                f"checkpoint {self.path} does not match the distributed checkpoint format "
                f"v{DIST_CKPT_VERSION} of smk_torch (per-process shard files + one generation "
                "manifest; format-7 files load through the single-process path) — delete the "
                "file or pass a fresh checkpoint_path"
            ) from e
        version = int(np.asarray(man["version"])[0])
        if version != DIST_CKPT_VERSION:
            raise ValueError(
                f"checkpoint {self.path} has distributed format version {version}, expected "
                f"{DIST_CKPT_VERSION} — delete the file or re-run")
        if not np.array_equal(np.asarray(man["meta"]), self.meta):
            raise ValueError(
                f"checkpoint {self.path} was written for a different run: meta "
                f"{np.asarray(man['meta'])} vs expected {self.meta}")
        if not np.array_equal(np.asarray(man["ident"]), self.ident):
            raise ValueError(
                f"checkpoint {self.path} was written for a different run: cross-process "
                "config/noise/data fingerprint mismatch — same shapes, different chain; "
                "delete the file or pass a different checkpoint_path")
        gen = int(np.asarray(man["generation"])[0])
        it = int(np.asarray(man["it"])[0])
        self.seg_base = int(np.asarray(man["seg_base"])[0])
        self.n_segments = int(np.asarray(man["n_segments"])[0])
        self.filled = int(np.asarray(man["filled"])[0])
        self.generation = gen
        prev_rows = [(int(a), int(b)) for a, b in np.asarray(man["shard_rows"])]
        self._warn_orphans(gen, prev_rows)
        same = tuple(prev_rows) == tuple(self.layout.row_ranges)
        if not same:
            dmap = FailureDomainMap.from_shard_rows(prev_rows)
            warnings.warn(
                f"elastic resume: the checkpoint was written by {len(prev_rows)} process(es) "
                f"(shard owners {list(dmap.labels)}) but the current topology has "
                f"{self.layout.n_processes} — all shards are re-gathered and re-laid under "
                "the current layout (each subset's chain is untouched: its draws depend "
                "only on its data and its rows' noise); the per-domain retry ladders reset",
                RuntimeWarning, stacklevel=3,
            )
        pids = [self.pid] if same else list(range(len(prev_rows)))
        rows = [self.layout.rows] if same else prev_rows
        c = self.n_chains
        shards = [self._read_shard(p, r, gen, prev_rows, state_like, noise_like)
                  for p, r in zip(pids, rows)]
        layout = shards[0]["layout"]
        if any(not all(np.array_equal(x, y) for x, y in zip(s["layout"], layout))
               for s in shards):
            raise ValueError(f"checkpoint {self.path}: the state shards' layouts disagree")
        axes = [_row_axis(p) for p in layout]
        arrays = type(layout)(*(np.concatenate([np.asarray(s["state"][i]) for s in shards],
                                               axis=ax) for i, ax in enumerate(axes)))
        noise = _unflatten(noise_like, [np.concatenate(parts) for parts in zip(
            *(_flatten(s["noise"])[0] for s in shards))])
        fault = {f: np.concatenate([np.asarray(s["fault"][f], np.int64) for s in shards])
                 for f in ("fault_attempts", "fault_dead", "fault_domain_attempts",
                           "fault_domain_dead")}
        # the writers' domain ids, made global over the shards
        offs = np.cumsum([0] + [len(s["fault"]["fault_domain_attempts"]) for s in shards])
        fault["fault_domain"] = np.concatenate(
            [np.asarray(s["fault"]["fault_domain"], np.int64) + o for s, o in zip(shards, offs)])
        # -- the draw segments
        holes: List[Tuple[int, int]] = []
        param = w = None
        if self.filled > 0:
            parts = [self._read_own_segments(p, r, dtype, d_par, d_w, lenient)
                     for p, r in zip(pids, rows)]
            param = np.concatenate([x[0] for x in parts])
            w = np.concatenate([x[1] for x in parts])
            holes = _union_ranges([h for x in parts for h in x[2]])
            if same:
                holes = self._agree_holes(holes)
        # -- this process's rows of the whole K
        if not same:
            a, b = self.layout.rows
            rsl = slice(a * c, b * c)

            def take(arr, ax):
                ix = [slice(None)] * arr.ndim
                ix[ax] = rsl
                return np.ascontiguousarray(arr[tuple(ix)])

            arrays = type(layout)(*(take(x, ax) for x, ax in zip(arrays, axes)))
            noise = _tree_map(lambda x: np.ascontiguousarray(x[rsl]), noise)
            for f in ("fault_attempts", "fault_dead", "fault_domain"):
                fault[f] = fault[f][a:b]
            if param is not None:
                param, w = param[rsl], w[rsl]
        state = _HostState(arrays, layout)
        if not same:
            # re-base: the loaded counters describe the writers' chains;
            # appending the current layout's boundaries to them would
            # publish a manifest that mixes the two. Without holes each
            # process publishes a fresh full generation of its rows now;
            # with holes appends wait for the refill's publication.
            if holes:
                self._suspend_appends = True
            else:
                self._commit_full(state, noise, param, w, it,
                                  self.filled if param is not None else 0,
                                  fault=tuple(fault[f] for f in _FAULT_FIELDS))
        return {"it": it, "generation": gen, "holes": holes, "same_topology": same,
                "state": state, "noise": noise, "param": param, "w": w,
                "prev_shard_rows": prev_rows, **fault}

    def _read_own_segments(self, pid: int, rows, dtype, d_par: int, d_w: int, lenient: bool):
        """One process's segment chain, assembled to its rows by format 7's
        readers at the process's prefix: lenient, an unreadable, corrupt or
        inconsistent segment is a hole (an iteration range every process
        re-samples across all its rows); strict, it raises. Returns
        (param, w, holes)."""
        from smk_torch.parallel.recovery import _read_segments, _read_segments_lenient

        a, b = rows
        prefix = shard_segment_prefix(self.path, pid)
        if lenient:
            return _read_segments_lenient(prefix, self.seg_base, self.n_segments, self.filled,
                                          dtype, ((b - a) * self.n_chains,), d_par, d_w)
        param, w = _read_segments(prefix, self.seg_base, self.n_segments, self.filled, dtype)
        return param, w, []

    def _agree_holes(self, local_holes):
        """One hole set on every process: a torn shard on one process must
        become the same fill plan everywhere (the fill chunks run in step).
        Bounded by the commit deadline."""
        payload = np.asarray(local_holes, np.int64).reshape(-1).astype("<i8").tobytes()
        merged = list(local_holes)
        for buf in allgather_bytes("ckpt-holes", payload, timeout_s=self.commit_timeout_s):
            merged.extend((int(x), int(y)) for x, y in np.frombuffer(buf, "<i8").reshape(-1, 2))
        return _union_ranges(merged)


def _union_ranges(ranges) -> List[Tuple[int, int]]:
    """Sorted union of half-open ranges."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(set((int(a), int(b)) for a, b in ranges)):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
