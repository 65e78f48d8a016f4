"""Program acquisition: the three-level lookup behind every hot program
of the chunked executor and the serving engine (twin of
``smk_tpu/compile/programs.py``).

:func:`get_program` resolves a shape-bucket key through:

- **L1**: the owner's (a sampler's, an engine's) FIFO table of
  programs, ``L1_CACHE_MAX`` entries. On the card a program is a
  :class:`GraphProgram`: a ``torch.cuda.CUDAGraph`` captured once per
  bucket with its static input and output buffers, then replayed. On the
  CPU it is the same static-buffer program run directly, with no
  capture. A graph cannot be serialized, so each process captures its
  own;
- **L2**: the :class:`~smk_torch.compile.store.ProgramStore`
  (``SMKConfig.compile_store_dir``) of the kernel libraries the program
  launches, which outlive the process;
- **L3**: the build directory those libraries are compiled into
  (compile/xla_cache.py, ``SMKConfig.xla_cache_dir``).

The bucket key is the twin's ``(kind, chunk_len, K, chunk_size, m, q, p,
t, d, n_chains, J, cov_model, link, fused_build, subset_engine,
n_neighbors, build_dtype, config-digest)``, and a chunk key has one more
trailing field, the chunk's first sweep modulo ``phi_update_every``:
the captured sweeps bake in which of them update phi. Kind and length
lead, as the fault injectors' contract has them.

Telemetry: each acquisition records ``(key, program_source,
compile_s)`` into the caller's ``ChunkPipelineStats``.
``program_source`` is ``"l1"`` (the program was in memory), ``"l2"``
(captured now, its libraries from the store), ``"l3"`` (captured now,
its libraries from the build directory) or ``"fresh"`` (nvcc ran in this
process). A program that launches no kernel library (the serving
programs, the plain versions on the CPU) is ``"l3"`` when L3 is armed,
else ``"fresh"``, as the twin's lazily compiled programs are.
``compile_s`` is the library acquisition plus the warm-up and capture
seconds: the warm-up run is the program's first call, whose outputs are
returned, so a captured program costs one capture and no extra run.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import hashlib
import threading
from typing import Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from smk_torch.analysis.sanitizers import note_compile
from smk_torch.compile.store import ProgramStore
from smk_torch.compile.xla_cache import persistent_cache_enabled
from smk_torch.utils.tracing import monotonic

# one capture at a time in the process: a capture's entry synchronises
# the device and empties the allocator's cache, which must not fall
# inside another thread's capture
_CAPTURE_LOCK = threading.Lock()

# FIFO bound of an owner's L1 table (the twin's): a normal run touches a
# handful of buckets, so evictions happen only under sweeps of shapes
L1_CACHE_MAX = 32

# Config fields that change no computation (scheduling, fault handling,
# checkpointing, observability, caches), normalized out of the digest:
# the twin's set.
_DIGEST_NEUTRAL = dict(
    chunk_pipeline="sync",
    fault_policy="abort",
    fault_max_retries=2,
    min_surviving_frac=0.5,
    compile_store_dir=None,
    xla_cache_dir=None,
    run_log_dir=None,
    live_diagnostics=False,
    profile_dir=None,
    profile_chunks=None,
    watchdog=False,
    watchdog_min_deadline_s=60.0,
    watchdog_margin=10.0,
    dist_init_timeout_s=120.0,
    dist_init_retries=3,
    ckpt_commit_timeout_s=120.0,
    partition_method="random",
    bucket_ladder=None,
    coalesce_window_ms=0.0,
    adaptive_schedule="off",
    target_rhat=1.05,
    target_ess=100.0,
    adapt_patience=2,
    min_samples_before_stop=0,
    adapt_max_extra_frac=0.5,
)


@functools.lru_cache(maxsize=256)
def config_digest(cfg) -> str:
    """12 hex digits of the sha256 of the config's ``repr`` with the
    neutral fields at their defaults: two configs with the same digest
    compute the same thing at equal shapes. Memoized (the config is a
    frozen dataclass). It names a port fit (a serving artifact's
    provenance) and every bucket key; it equals the twin's digest only
    while the two configs' reprs agree, and nothing relies on that."""
    neutral = dataclasses.replace(cfg, **_DIGEST_NEUTRAL)
    return hashlib.sha256(repr(neutral).encode()).hexdigest()[:12]


def topology_fingerprint(mesh=None) -> Optional[tuple]:
    """The topology field of a bucket key: None for the unmeshed path (its
    keys stay as they were), else the twin's tuple ``("mesh", shape,
    axis_names, kinds, n_procs, devices_per_proc)`` of a
    parallel/executor.Mesh: a program of another mesh shape, axis name,
    card or process layout keys another bucket."""
    if mesh is None:
        return None
    n_procs = max(1, len(mesh.process_indices))
    return ("mesh", tuple(int(s) for s in mesh.devices.shape),
            tuple(str(a) for a in mesh.axis_names), mesh.device_kind, n_procs,
            mesh.size // n_procs)


def _with_topology(key: tuple, mesh) -> tuple:
    topo = topology_fingerprint(mesh)
    return key if topo is None else key + (topo,)


def chunk_bucket_key(model, kind: str, length: int, k: int, chunk_size: Optional[int],
                     m: int, q: int, p: int, t: int, d: int, mesh=None,
                     phase: int = 0) -> tuple:
    """Shape-bucket key of one chunk program: ``kind`` "burn" or "samp",
    ``length`` its sweeps, every data dimension explicit (the digest
    cannot see them), then ``phase``, the chunk's first sweep modulo
    ``phi_update_every``, and last, under a mesh, its topology
    fingerprint."""
    (cov_model, link, fused, n_chains, j, engine, n_nbr, build_dt) = \
        model.program_bucket_fields()
    return _with_topology(
        (kind, length, k, chunk_size, m, q, p, t, d, n_chains, j, cov_model, link,
         fused, engine, n_nbr, build_dt, config_digest(model.config), int(phase)), mesh)


def aux_bucket_key(model, kind: str, *shape_fields, mesh=None) -> tuple:
    """Bucket key of a non-chunk program (stats guard, finalize, refork,
    the streaming monitor's): ``kind`` never collides with the chunk
    kinds; a mesh appends its fingerprint."""
    (cov_model, link, fused, n_chains, j, engine, n_nbr, build_dt) = \
        model.program_bucket_fields()
    return _with_topology(
        (kind,) + tuple(shape_fields)
        + (n_chains, j, cov_model, link, fused, engine, n_nbr, build_dt,
           config_digest(model.config)), mesh)


def store_from_config(cfg, mesh=None) -> Optional[ProgramStore]:
    """The L2 store a run consults: ``cfg.compile_store_dir``, or None.
    One store serves every topology: the libraries it holds are the same
    on every mesh, and the programs' keys carry the fingerprint."""
    del mesh
    d = getattr(cfg, "compile_store_dir", None)
    return ProgramStore(d) if d else None


def _record(stats, key, source, compile_s, aot):
    if stats is None:
        return
    rec = getattr(stats, "record_program", None)
    if rec is not None:
        rec(key=key, source=source, compile_s=compile_s, aot=aot)


def _library_source(origins: dict) -> str:
    """The program_source of a program whose kernel libraries came from
    ``origins`` (library -> cuda_build.ORIGIN)."""
    vals = set(origins.values())
    if not vals:
        return "l3" if persistent_cache_enabled() else "fresh"
    for src in ("fresh", "l2"):
        if src in vals:
            return src
    return "l3"


def get_program(owner, key: tuple, build, *, store: Optional[ProgramStore] = None,
                stats=None, libraries: Sequence[str] = (), device=None):
    """Resolve ``key`` to a program via L1, else acquire its kernel
    ``libraries`` (L2, L3 or nvcc: ops/cuda_build.ensure) and ``build``
    it. ``build`` returns a :class:`GraphProgram` (captured at its first
    call, or by :meth:`GraphProgram.capture`) or any callable (kept as
    it is: the eager programs). ``device`` keys the table beside
    ``key``, so one owner driven on two devices keeps two programs.

    An L1 hit with a ``store`` that has not been filled from this owner
    yet fills it (the L2 backfill): the keys are the same with and
    without a store, as the digest normalizes the knob out.

    Instance storage on the owner (not a module-level map): the programs
    die with the owner, and everything a program closes over is fixed at
    the owner's construction."""
    from smk_torch.ops import cuda_build

    table = owner.__dict__.setdefault("_program_l1", {})
    persisted = owner.__dict__.setdefault("_programs_persisted", set())
    slot = (None if device is None else str(device), key)
    if slot in table:
        if store is not None and (store.root, slot) not in persisted:
            if libraries:
                cuda_build.ensure(libraries, store)
            persisted.add((store.root, slot))
        _record(stats, key, "l1", 0.0, False)
        return table[slot]
    t0 = monotonic()
    origins = cuda_build.ensure(libraries, store) if libraries else {}
    source = _library_source(origins)
    prog = build()
    if not (isinstance(prog, GraphProgram) and prog.captures):
        # the compile event of the sanitizers (analysis/sanitizers.py):
        # this build, or on the card the program's capture
        note_compile()
    if store is not None:
        persisted.add((store.root, slot))
    while len(table) >= L1_CACHE_MAX:
        table.pop(next(iter(table)))
    table[slot] = prog
    if isinstance(prog, GraphProgram):
        prog.acquired(stats, source, monotonic() - t0)
    else:
        _record(stats, key, source, monotonic() - t0, False)
    return prog


def programs_of(owner) -> list:
    """The owner's graph programs, oldest first (for reports)."""
    return [p for p in owner.__dict__.get("_program_l1", {}).values()
            if isinstance(p, GraphProgram)]


class _Shared:
    """What one owner's graph programs share, per device: a lock (their
    calls on a device run one at a time), the last call's completion
    event, one graph memory pool and capture stream, and their static
    input and output buffers, by role, shape, layout, dtype and device.
    Sharing is sound because the calls on a device are serialised and
    every output is copied out before the next call binds its inputs: so
    a model's many buckets (kinds, lengths, phases) hold one copy of the
    state a device, not one each, and programs on two mesh entries'
    devices never wait for each other."""

    def __init__(self):
        self._locks_lock = threading.Lock()
        self.locks: dict = {}
        self.pools: dict = {}
        self.buffers: dict = {}
        self.done: dict = {}

    def lock(self, device) -> threading.RLock:
        key = str(device)
        with self._locks_lock:
            if key not in self.locks:
                self.locks[key] = threading.RLock()
            return self.locks[key]

    def pool(self, device):
        """The graph memory pool on ``device`` and the one side stream
        every warm-up and capture runs on: the caching allocator hands a
        freed block only to allocations on the stream it was freed on, so
        one stream lets each capture reuse the memory the earlier ones
        freed."""
        key = str(device)
        if key not in self.pools:
            self.pools[key] = (torch.cuda.graph_pool_handle(), torch.cuda.Stream(device))
        return self.pools[key]

    def buffers_like(self, role: str, flat: list) -> list:
        """A shared buffer for each tensor of ``flat`` (the n-th tensor of
        a shape, layout and dtype gets that signature's n-th buffer), other
        leaves as they are."""
        seen: dict = {}
        out = []
        for a in flat:
            if not isinstance(a, torch.Tensor):
                out.append(a)
                continue
            # the input's layout too: a product's kernel, and so its bits,
            # can depend on its operands' strides
            sig = (role, tuple(a.shape), a.stride(), a.dtype, str(a.device))
            n = seen[sig] = seen.get(sig, -1) + 1
            buf = self.buffers.get(sig + (n,))
            if buf is None:
                buf = self.buffers[sig + (n,)] = torch.empty_like(a)
            out.append(buf)
        return out


_SHARED_LOCK = threading.Lock()


def _shared(owner) -> _Shared:
    with _SHARED_LOCK:
        st = owner.__dict__.get("_graph_shared")
        if st is None:
            st = owner.__dict__["_graph_shared"] = _Shared()
        return st


class GraphProgram:
    """One bucket's program: ``fn`` over static input buffers.

    A call copies each tensor of its arguments into the static buffers
    (the owner's, shared by its programs: :class:`_Shared`), then:

    - on the CPU, runs ``fn`` on the static buffers;
    - on the card, at the first call, runs ``fn`` once on a side stream
      (the warm-up: its outputs are the call's result, and the launches
      it makes count as the main path's) and captures it into a
      ``torch.cuda.CUDAGraph`` on that stream, in the owner's memory
      pool, with ``capture_error_mode="thread_local"``, the outputs
      copied into static output buffers inside the graph (so what the
      body allocates returns to the pool for the owner's next capture);
      every later call replays the graph and returns copies of its
      outputs, tensors the caller owns. ``fn`` must be capturable: no
      host synchronisation and no randomness of its own (callers draw
      their noise outside and pass it in). A capture that fails raises,
      naming the key: nothing falls back to running eagerly.

    The fused-build launch counts (ops/fused_build.py) count each
    captured launch once per replay, and the capture itself counts
    nothing. An owner's calls are serialised by its lock, and a call on
    another stream than the last waits for it."""

    def __init__(self, fn, key: tuple, device, *, owner=None):
        self.fn = fn
        self.key = key
        self.device = torch.device(device)
        self.captures = self.device.type == "cuda"
        self._shared = _shared(owner) if owner is not None else _Shared()
        self._static = None
        self._spec = None
        self._graph = None
        self._out = None
        self._launches = None
        self._pending = None
        self.source = None
        self.compile_s = 0.0
        self.capture_s = None
        self.pool_bytes = None
        self.replays = 0

    def acquired(self, stats, source: str, seconds: float) -> None:
        """Record the acquisition: now on the CPU, at the capture on the
        card (compile_s then includes the warm-up and capture)."""
        self.source = source
        self.compile_s = seconds
        if self.captures and self._graph is None:
            self._pending = stats
        else:
            _record(stats, self.key, source, seconds, True)

    # -- binding ----------------------------------------------------------

    def _bind(self, args) -> None:
        flat, spec = tree_flatten(args)
        if self._static is None:
            self._spec = spec
            self._static = self._shared.buffers_like("in", flat)
        elif spec != self._spec:
            raise ValueError(f"program {self.key!r}: called with another input structure")
        for i, (buf, a) in enumerate(zip(self._static, flat)):
            if isinstance(buf, torch.Tensor):
                buf.copy_(a)
            elif a != buf:
                raise ValueError(
                    f"program {self.key!r}: constant input {i} changed ({buf!r} -> {a!r})")

    def _args(self):
        return tree_unflatten(self._static, self._spec)

    def _owned(self, out):
        """``out`` with every tensor that shares storage with a static
        input copied (a later call overwrites the static buffers)."""
        ptrs = {b.untyped_storage().data_ptr() for b in self._static
                if isinstance(b, torch.Tensor)}
        flat, spec = tree_flatten(out)
        flat = [o.clone() if isinstance(o, torch.Tensor)
                and o.untyped_storage().data_ptr() in ptrs else o for o in flat]
        return tree_unflatten(flat, spec)

    # -- running ----------------------------------------------------------

    def __call__(self, *args):
        sh = self._shared
        dkey = str(self.device)
        with sh.lock(self.device):
            if not self.captures:
                self._bind(args)
                return self._owned(self.fn(*self._args()))
            cur = torch.cuda.current_stream(self.device)
            if sh.done.get(dkey) is not None:
                cur.wait_event(sh.done[dkey])
            self._bind(args)
            if self._graph is None:
                out = self._capture(count=True)
            else:
                self._graph.replay()
                from smk_torch.ops import fused_build

                fused_build.add_counts(self._launches)
                self.replays += 1
                flat, spec = self._out
                out = tree_unflatten(
                    [o.clone() if isinstance(o, torch.Tensor) else o for o in flat], spec)
            sh.done[dkey] = torch.cuda.Event()
            sh.done[dkey].record(cur)
            return out

    def capture(self, *args) -> None:
        """Warm up and capture on ``args`` now (precompile), counting no
        launch; a no-op on the CPU and for a captured program."""
        sh = self._shared
        dkey = str(self.device)
        with sh.lock(self.device):
            if not self.captures or self._graph is not None:
                return
            cur = torch.cuda.current_stream(self.device)
            if sh.done.get(dkey) is not None:
                cur.wait_event(sh.done[dkey])
            self._bind(args)
            self._capture(count=False)
            sh.done[dkey] = torch.cuda.Event()
            sh.done[dkey].record(cur)

    def _capture(self, count: bool):
        with _CAPTURE_LOCK:
            return self._warm_and_capture(count)

    def _warm_and_capture(self, count: bool):
        from smk_torch.ops import fused_build

        t0 = monotonic()
        dev = self.device
        # unreachable owners (a finished fit's model sits in reference
        # cycles until the collector runs) still hold their graphs' memory
        # pools: release them before this warm-up and capture allocate
        gc.collect()
        torch.cuda.empty_cache()
        cur = torch.cuda.current_stream(dev)
        pool, side = self._shared.pool(dev)
        before = fused_build.count_snapshot()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self.fn(*self._args())
        cur.wait_stream(side)
        warm = self._owned(warm)
        warm_flat, out_spec = tree_flatten(warm)
        for o in warm_flat:
            if isinstance(o, torch.Tensor) and o.device.type == "cuda":
                o.record_stream(cur)
        if not count:
            fused_build.restore_counts(before)
        out_bufs = self._shared.buffers_like("out", warm_flat)
        before = fused_build.count_snapshot()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: collecting an
        # unreachable graph destroys it, a CUDA call the capturing thread
        # may not make (it invalidates the capture)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                r0 = torch.cuda.memory_reserved(dev)
                body = tree_flatten(self.fn(*self._args()))[0]
                for i, buf in enumerate(out_bufs):
                    if isinstance(buf, torch.Tensor):
                        buf.copy_(body[i])
                del body  # the body's memory goes back to the pool
            r1 = torch.cuda.memory_reserved(dev)
        except Exception as e:
            fused_build.restore_counts(before)
            raise RuntimeError(
                f"CUDA graph capture failed for program {self.key!r}: {e}") from e
        finally:
            if gc_was_on:
                gc.enable()
            cur.wait_stream(side)
        self._launches = fused_build.count_delta(before)
        fused_build.restore_counts(before)
        self._out = (out_bufs, out_spec)
        self._graph = graph
        note_compile()
        self.pool_bytes = int(r1 - r0)
        self.capture_s = monotonic() - t0
        self.compile_s += self.capture_s
        _record(self._pending, self.key, self.source or "fresh", self.compile_s, True)
        self._pending = None
        return warm

    def info(self) -> dict:
        """Key, source and capture figures, for reports."""
        return {"key": [str(f) for f in self.key], "source": self.source,
                "compile_s": self.compile_s, "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes, "replays": self.replays,
                "captured": self._graph is not None}
