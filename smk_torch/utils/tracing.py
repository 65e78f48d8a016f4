"""Phase timing and the chunked executor's per-chunk ledger — twin of
``PhaseTimes``, ``phase_timer`` and ``ChunkPipelineStats`` in
``smk_tpu/utils/tracing.py``. A phase ends with a sync of the device's
stream (as the twin's ``device_sync``), so its wall time covers the
work and not only its enqueueing.

``ChunkPipelineStats`` carries the members the chunked executor's host
loop (both pipelines), the checkpoint, its background writer,
quarantine, the streaming monitor and the adaptive schedule record into
(parallel/recovery.py); with a ``run_log`` each record is also an event
of the fit's run log (obs/events.py). Every program acquisition of the
chunked executor and the serving engine (compile/programs.get_program)
is recorded by ``record_program``, and ``aggregate`` reports their
sources and seconds as the twin's does.

The span recorder (:func:`record_spans`, :class:`SpanRecorder`; the
port's own, no twin) holds the program's spans inside a fit in memory:
the sites :func:`span`, :func:`stage` and :func:`count` in the sampler,
the factor and build entry points and the API phases cost one read of a
module-level variable while nothing is armed. Stamps are
:func:`monotonic_ns`; :func:`to_unix_ns` lays them on a torch.profiler
trace's clock.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from smk_torch.analysis.sanitizers import explicit_wait
from smk_torch.device import sync


def monotonic() -> float:
    """The telemetry clock: monotonic seconds, as the twin's."""
    return time.perf_counter()


def monotonic_ns() -> int:
    """The same clock in integer nanoseconds: the stamps of the span
    recorder (:class:`SpanRecorder`)."""
    return time.perf_counter_ns()


def clock_anchor() -> Tuple[int, int]:
    """One (monotonic ns, Unix ns) pair: the Unix clock read between two
    reads of the monotonic one, paired with their midpoint."""
    a = time.perf_counter_ns()
    unix = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, unix


def to_unix_ns(t_ns: int, anchor: Tuple[int, int]) -> int:
    """Monotonic stamp ``t_ns`` on the Unix clock, in nanoseconds, by
    the recorder's ``anchor`` (:func:`clock_anchor`). A torch.profiler
    Chrome trace is on that clock: an event starts at
    ``baseTimeNanoseconds + 1000 * ts``."""
    return t_ns - anchor[0] + anchor[1]


# ---------------------------------------------------------------------------
# Spans inside the fit: the in-memory recorder
# ---------------------------------------------------------------------------
# The recorder armed in the process (record_spans), or None. Every span
# site reads it first: with it None a site does nothing else.
_RECORDER: Optional["SpanRecorder"] = None


def capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph (a
    span or count then records nothing: the graph's replays run no
    Python)."""
    rec = _RECORDER
    return rec is not None and rec.cuda and torch.cuda.is_current_stream_capturing()


# what a span site gets while nothing records: one shared, reusable
# context that does nothing
_NULL = contextlib.nullcontext()


class _Open:
    """A span open on a thread's stack (a ``with`` span, or a stage
    opened by :func:`stage`)."""

    __slots__ = ("rec", "sid", "name", "parent", "t0", "attrs", "is_stage")

    def __init__(self, rec, name, attrs, is_stage):
        self.rec, self.name, self.attrs, self.is_stage = rec, name, attrs, is_stage
        self.sid = self.parent = self.t0 = None

    def __enter__(self):
        self.rec._push(self, monotonic_ns())
        return self.sid

    def __exit__(self, *exc):
        self.rec._pop(self, monotonic_ns())
        return False


class SpanRecorder:
    """The program's spans and counters, held in memory while armed
    (:func:`record_spans`) and written nowhere: a caller reads
    :attr:`spans`, :meth:`export` or :meth:`totals` when the work ends.

    A span record is the run log's span (obs/events.RunLog): ``name``,
    ``span_id``, ``parent``, ``t0``/``t1`` (monotonic ns,
    :func:`monotonic_ns`) and ``attrs``. Each thread keeps its own stack
    of open spans; a thread started through :func:`under_current_span`
    opens its first span under the span its starter had open.
    ``counters``: named totals (``factor_mm``, the m x m factorizations
    of the subset samplers, summed over batch rows; ``noise_rows_batched``
    and ``noise_rows_rowwise``, the rows each sweep's noise source drew
    in one launch or row by row)."""

    def __init__(self):
        self.anchor = clock_anchor()
        self.cuda = torch.cuda.is_available()
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, sp: _Open, t: int) -> None:
        st = self._stack()
        sp.sid = next(self._ids)
        sp.parent = st[-1].sid if st else getattr(self._local, "base", None)
        sp.t0 = t
        st.append(sp)

    def _close(self, sp: _Open, t: int) -> None:
        self.spans.append({"name": sp.name, "span_id": sp.sid, "parent": sp.parent,
                           "t0": sp.t0, "t1": t, "attrs": sp.attrs})

    def _pop(self, sp: _Open, t: int) -> None:
        """Close ``sp`` and every span still open above it (its stages,
        or spans an exception unwound past), all at ``t``."""
        st = self._stack()
        if sp not in st:
            return
        while st:
            top = st.pop()
            self._close(top, t)
            if top is sp:
                return

    def stage(self, name: str) -> None:
        """Close the stage open at the top of this thread's stack, if
        any, and open stage ``name`` in its place (a child of the span
        below it), at one instant."""
        t = monotonic_ns()
        st = self._stack()
        if st and st[-1].is_stage:
            self._close(st.pop(), t)
        self._push(_Open(self, name, {}, True), t)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def current(self) -> Optional[int]:
        """The id of this thread's innermost open span, or None."""
        st = self._stack()
        return st[-1].sid if st else getattr(self._local, "base", None)

    def mark(self) -> Tuple[int, Dict[str, int]]:
        """A point to total from (:meth:`totals`)."""
        with self._lock:
            return len(self.spans), dict(self.counters)

    def export(self) -> List[Dict[str, Any]]:
        """Every closed span with ``t0``/``t1`` on the Unix clock in ns
        (:func:`to_unix_ns`), the conversion made once, here."""
        return [dict(s, t0=to_unix_ns(s["t0"], self.anchor), t1=to_unix_ns(s["t1"], self.anchor))
                for s in list(self.spans)]

    def totals(self, since: Optional[Tuple[int, Dict[str, int]]] = None) -> Dict[str, Any]:
        """Per span name ``count``, ``total_s`` and ``self_s`` (a span's
        wall less the union of its children's), and the counters, over
        the spans closed since ``since`` (:meth:`mark`; default: all)."""
        first, base = since if since is not None else (0, {})
        spans = list(self.spans)[first:]
        kids: Dict[int, list] = {}
        for s in spans:
            if s["parent"] is not None:
                kids.setdefault(s["parent"], []).append((s["t0"], s["t1"]))
        out: Dict[str, Dict[str, Any]] = {}
        for s in spans:
            wall = s["t1"] - s["t0"]
            covered, end = 0, s["t0"]
            for a, b in sorted(kids.get(s["span_id"], ())):
                a, b = max(a, end), min(b, s["t1"])
                if b > a:
                    covered += b - a
                    end = b
            e = out.setdefault(s["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
            e["count"] += 1
            e["total_s"] += wall * 1e-9
            e["self_s"] += (wall - covered) * 1e-9
        with self._lock:
            counters = {k: v - base.get(k, 0) for k, v in self.counters.items()
                        if v != base.get(k, 0)}
        return {"spans": out, "counters": counters}


def span(name: str, **attrs: Any):
    """A span of the armed recorder around a ``with`` block: ``with
    span("smk.noise", rows=k):``. ``attrs`` are plain Python values
    (never a tensor read: no span waits for the device). With nothing
    armed, or while a CUDA graph is being captured, the block runs under
    a shared object that records nothing."""
    rec = _RECORDER
    if rec is None or capturing():
        return _NULL
    return _Open(rec, name, attrs, False)


def stage(name: str) -> None:
    """Open stage ``name`` of the enclosing span (closing the previous
    stage): consecutive stages of one body, such as a sweep's, without
    re-nesting it; the enclosing ``with`` span closes the last."""
    rec = _RECORDER
    if rec is None or capturing():
        return
    rec.stage(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the armed recorder."""
    rec = _RECORDER
    if rec is None or capturing():
        return
    rec.add(name, n)


def under_current_span(fn):
    """``fn`` wrapped to run on another thread with the caller's
    innermost open span as the parent of its first span (the one host
    thread a card of parallel/executor.run_per_device)."""
    rec = _RECORDER
    if rec is None:
        return fn
    parent = rec.current()

    def run():
        rec._local.base = parent
        try:
            return fn()
        finally:
            rec._local.base = None
    return run


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecorder]:
    """Arm span recording in this process for the block and yield the
    :class:`SpanRecorder`; an inner arming shares the outer recorder.
    Recording reads no tensor and syncs nothing: the draws are bitwise
    those of an unarmed run."""
    global _RECORDER
    if _RECORDER is not None:
        yield _RECORDER
        return
    rec = SpanRecorder()
    _RECORDER = rec
    try:
        yield rec
    finally:
        _RECORDER = None


def device_sync(tree: Any) -> None:
    """Wait for the queued work of every CUDA device a tensor of ``tree``
    lives on (twin of ``device_sync``, whose ``block_until_ready`` this
    stream sync replaces); a no-op for host tensors. Inside
    analysis.sanitizers.transfer_guard_strict it is a sanctioned wait,
    ledgered apart from the transfers (tag "device_sync", direction
    "wait")."""
    devices = {leaf.device for leaf in tree_flatten(tree)[0]
               if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
    if not devices:
        return
    with explicit_wait("device_sync"):
        for dev in sorted(devices, key=str):
            sync(dev)


@dataclass
class PhaseTimes:
    seconds: Dict[str, float] = field(default_factory=dict)

    def record(self, name: str, secs: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)


@contextlib.contextmanager
def phase_timer(
    times: PhaseTimes, name: str, device: Optional[torch.device] = None, log: Any = None
) -> Iterator[None]:
    """Time a phase; on a CUDA ``device`` the phase ends with a stream
    sync. With ``log`` (an obs/events.RunLog) the phase is also a span of
    the run log; with a recorder armed (:func:`record_spans`), a span of
    the recorder."""
    start = monotonic()
    log_span = log.span(name) if log is not None else None
    if log_span is not None:
        log_span.__enter__()
    rec_span = span(name)
    rec_span.__enter__()
    try:
        yield
    finally:
        if device is not None:
            with explicit_wait("device_sync"):
                sync(device)
        rec_span.__exit__(None, None, None)
        if log_span is not None:
            log_span.__exit__(None, None, None)
        times.record(name, monotonic() - start)


@dataclass
class ChunkPipelineStats:
    """Per-chunk observability of the chunked executor's host loop, both
    ``chunk_pipeline`` modes (see the twin's docstring for each field).
    One ``record_chunk`` entry per chunk: ``dispatch_s`` (the host's
    seconds queuing the chunk's sweeps and its boundary's copies),
    ``host_work_s`` (the boundary's fetch, guard, report and checkpoint
    submit or write), ``host_stall_s`` (host seconds with no next chunk
    queued: the whole boundary under "sync" and at the overlap's last
    boundary, plus the wait for a free staging buffer), ``d2h_bytes``
    (the boundary's device-to-host bytes) and, where they apply,
    ``device_wait_s`` (the wait for the chunk's own stats: the sweeps'
    device time the dispatch did not cover), ``state_fetch_s`` (the
    state's copy into the staging buffer, after that), ``ckpt_write_s``
    and ``ckpt_bytes`` (an inline write's files) and ``staging_wait_s``
    (overlap: the wait for the writer job that held the buffer). Under
    "overlap" a last ``phase="drain"`` entry holds the terminal drain
    of the writer. One ``add_ckpt_write`` per boundary write (seconds
    and bytes, from the writer thread under "overlap"), one
    ``record_fault`` per quarantine event. ``host_staging_bytes`` is the
    host memory the staging buffers held (pinned on the card)."""

    mode: str = "sync"
    fault_policy: str = "abort"
    domain_of_subset: Any = None
    chunks: List[Dict[str, Any]] = field(default_factory=list)
    fault_events: List[Dict[str, Any]] = field(default_factory=list)
    ckpt_write_s: float = 0.0
    ckpt_bytes: int = 0
    ckpt_boundary_bytes: List[int] = field(default_factory=list)
    # generations of the distributed checkpoint (format 8,
    # parallel/checkpoint.py) and their commits' seconds: 0 under format 7
    ckpt_generations: int = 0
    ckpt_commit_s: float = 0.0
    total_wall_s: float = 0.0
    # one entry per bucket group of a ragged fit, None on equal-m runs
    ragged_groups: Any = None
    # the RaggedMeshPlan summary of a ragged fit on a mesh
    ragged_mesh_plan: Any = None
    host_staging_bytes: int = 0
    run_log: Any = None
    adaptive: Any = None
    # the live-fit ledger (serve/ingest.LiveFit): ingested batches and
    # rows, refits, the published generation, the append log's watermark
    ingest: Any = None
    # one entry per program acquisition (record_program, through
    # compile/programs.get_program)
    programs: List[Dict[str, Any]] = field(default_factory=list)
    # one entry per CUDA-graph capture (record_capture): on a mesh every
    # entry's device captures its own programs under the same keys
    captures: List[Dict[str, Any]] = field(default_factory=list)
    _program_keys: set = field(default_factory=set, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def _emit(self, name: str, attrs: Dict[str, Any]) -> None:
        """One record to the run log (the caller holds the lock); a log
        that fails is dropped, never the fit."""
        if self.run_log is None:
            return
        try:
            self.run_log.event(name, **attrs)
        except Exception:
            self.run_log = None

    def record_chunk(self, **entry: Any) -> None:
        with self._lock:
            self.chunks.append(entry)
            self._emit("chunk", entry)

    def record_fault(
        self,
        *,
        chunk: int,
        iteration: int,
        phase: str,
        retried: List[int],
        dropped: List[int],
        attempts: Dict[int, int],
        deferred: List[int] = (),
        domains_retried: List[int] = (),
        domains_dropped: List[int] = (),
        domains_deferred: List[int] = (),
    ) -> None:
        """One quarantine event (the twin's ``record_fault``)."""
        ev = {
            "chunk": int(chunk),
            "iteration": int(iteration),
            "phase": phase,
            "retried": [int(j) for j in retried],
            "dropped": [int(j) for j in dropped],
            "deferred": [int(j) for j in deferred],
            "attempts": {int(j): int(n) for j, n in attempts.items()},
        }
        if domains_retried or domains_dropped or domains_deferred:
            ev["domains_retried"] = [int(d) for d in domains_retried]
            ev["domains_dropped"] = [int(d) for d in domains_dropped]
            ev["domains_deferred"] = [int(d) for d in domains_deferred]
        with self._lock:
            self.fault_events.append(ev)
            self._emit("fault", ev)

    def record_capture(self, *, key, device: str, capture_s: float, wait_s: float) -> None:
        """One CUDA-graph capture (compile/programs.GraphProgram): its
        bucket ``key``, the ``device`` it was captured on, the warm-up
        and capture seconds and ``wait_s``, the seconds it waited for
        the process's one capture at a time."""
        with self._lock:
            self.captures.append({"key": [str(f) for f in key], "device": str(device),
                                  "capture_s": round(float(capture_s), 4),
                                  "wait_s": round(float(wait_s), 4)})

    def record_program(self, *, key, source: str, compile_s: float = 0.0,
                       aot: bool = False) -> None:
        """One program acquisition (the twin's ``record_program``,
        compile/programs.get_program): the bucket ``key``, where the
        program came from (``source``: "l1" already in memory, "l2"
        captured with its kernel libraries from the store, "l3" captured
        with them from the build directory, "fresh" nvcc ran in this
        process) and ``compile_s``, the library acquisition plus the
        warm-up and capture seconds. The first record of a key wins."""
        key_t = tuple(str(f) for f in key)
        entry = {
            "key": list(key_t),
            "source": source,
            "compile_s": round(float(compile_s), 4),
            "aot": bool(aot),
        }
        with self._lock:
            if key_t in self._program_keys:
                return
            self._program_keys.add(key_t)
            self.programs.append(entry)

    def program_summary(self) -> Dict[str, Any]:
        """Total acquisition seconds and a histogram of sources."""
        sources: Dict[str, int] = {}
        for p in self.programs:
            sources[p["source"]] = sources.get(p["source"], 0) + 1
        return {
            "compile_s": round(sum(p["compile_s"] for p in self.programs), 4),
            "program_sources": sources,
        }

    def add_ckpt_commit(
        self, seconds: float, *, generation: int, it: int = -1,
        filled: int = -1, n_processes: int = 1,
    ) -> None:
        """One committed generation of the distributed checkpoint
        (parallel/checkpoint.py; the twin's): ``seconds`` is the commit's
        coordination, the land and publish barriers and process 0's
        manifest write, measured on the writing thread (the shard files'
        writes go to :meth:`add_ckpt_write`). Emits one ``ckpt_commit``
        event to the run log."""
        with self._lock:
            self.ckpt_generations += 1
            self.ckpt_commit_s += float(seconds)
            self._emit("ckpt_commit", {"generation": int(generation),
                                       "seconds": round(float(seconds), 6), "it": int(it),
                                       "filled": int(filled),
                                       "n_processes": int(n_processes)})

    def add_ckpt_write(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.ckpt_write_s += float(seconds)
            self.ckpt_bytes += int(nbytes)
            self.ckpt_boundary_bytes.append(int(nbytes))
            self._emit("ckpt_write", {"seconds": round(float(seconds), 6),
                                      "nbytes": int(nbytes)})

    def aggregate(self) -> Dict[str, Any]:
        """The twin's summary, key for key: the loop's, the checkpoint's,
        the fault ledger's, the device memory's, the live diagnostics'
        and the adaptive schedule's keys measured (None where nothing
        recorded them), the ingest ledger (None without a live fit), the
        program records' seconds and sources; the mesh's None, as the
        twin reports it when it is off."""
        stall = sum(c.get("host_stall_s", 0.0) for c in self.chunks)
        work = sum(c.get("host_work_s", 0.0) for c in self.chunks)
        disp = sum(c.get("dispatch_s", 0.0) for c in self.chunks)
        d2h = sum(int(c.get("d2h_bytes", 0)) for c in self.chunks)
        wall = self.total_wall_s
        ess_final = self._ess_sum_final()
        return {
            "mode": self.mode,
            "n_chunks": len(self.chunks),
            "total_wall_s": round(wall, 4),
            "dispatch_s": round(disp, 4),
            "host_work_s": round(work, 4),
            "host_stall_s": round(stall, 4),
            "host_stall_frac": round(stall / wall, 4) if wall > 0 else 0.0,
            "d2h_bytes": d2h,
            "ckpt_write_s": round(self.ckpt_write_s, 4),
            "ckpt_bytes": self.ckpt_bytes,
            "ckpt_boundary_bytes": list(self.ckpt_boundary_bytes),
            "ckpt_generations": self.ckpt_generations,
            "ckpt_commit_s": round(self.ckpt_commit_s, 4),
            "overlap_efficiency": round(1.0 - stall / wall, 4) if wall > 0 else 1.0,
            "hbm_peak_bytes": self._last_chunk_field("hbm_peak_bytes", reduce=max),
            "live_rhat_final": self._last_chunk_field("live_rhat_max"),
            "live_ess_min_final": self._last_chunk_field("live_ess_min"),
            "live_ess_sum_final": ess_final,
            "ess_per_second": (round(ess_final / wall, 4)
                               if wall > 0 and ess_final is not None else None),
            "ragged_groups": self.ragged_groups,
            "ragged_mesh_plan": self.ragged_mesh_plan,
            "adaptive": self.adaptive,
            "chunks_saved_frac": (self.adaptive.get("chunks_saved_frac")
                                  if self.adaptive else None),
            "frozen_at": self.adaptive.get("frozen_at") if self.adaptive else None,
            "ess_per_second_adaptive": (
                round(ess_final / wall, 4)
                if self.adaptive and wall > 0 and ess_final is not None else None),
            "ingest": self.ingest,
            "fault": self.fault_summary(),
            **self.program_summary(),
        }

    def _ess_sum_final(self):
        """The last boundary's total streaming ESS; on a ragged fit the
        sum of every bucket group's last value (the groups run one after
        another)."""
        if self.ragged_groups:
            vals = [g.get("live_ess_sum_final") for g in self.ragged_groups]
            vals = [v for v in vals if v is not None]
            return sum(vals) if vals else None
        return self._last_chunk_field("live_ess_sum")

    def _last_chunk_field(self, name: str, reduce=None):
        """The last (or ``reduce``-d) non-None value of a chunk field;
        None when no chunk carried it."""
        vals = [c[name] for c in self.chunks if c.get(name) is not None]
        if not vals:
            return None
        return reduce(vals) if reduce is not None else vals[-1]

    def fault_summary(self) -> Dict[str, Any]:
        """The retry-ladder history compressed for a record (the twin's
        ``fault_summary``, domain keys included when domains are in
        play)."""
        attempts: Dict[int, int] = {}
        dropped: List[int] = []
        retries = 0
        dom_dropped: List[int] = []
        any_domain_events = False
        for ev in self.fault_events:
            retries += len(ev["retried"])
            dropped.extend(ev["dropped"])
            for j, n in ev["attempts"].items():
                attempts[j] = max(attempts.get(j, 0), n)
            if any(key in ev for key in
                   ("domains_retried", "domains_dropped", "domains_deferred")):
                any_domain_events = True
                dom_dropped.extend(ev.get("domains_dropped", []))
        out = {
            "policy": self.fault_policy,
            "n_events": len(self.fault_events),
            "retries_total": retries,
            "subsets_dropped": sorted(set(dropped)),
            "retry_attempts": {str(j): attempts[j] for j in sorted(attempts)},
        }
        if any_domain_events or self.domain_of_subset is not None:
            out["domains_dropped"] = sorted(set(dom_dropped))
            if self.domain_of_subset is not None:
                doms = [int(d) for d in self.domain_of_subset]
                per: Dict[str, Dict[str, Any]] = {}
                for ev in self.fault_events:
                    involved = {str(doms[int(j)]) for j in
                                set(ev["retried"] + ev["dropped"] + ev["deferred"])}
                    for d in involved:
                        entry = per.setdefault(d, {"events": 0, "subsets_dropped": []})
                        entry["events"] += 1
                    for j in ev["dropped"]:
                        per[str(doms[int(j)])]["subsets_dropped"].append(int(j))
                for entry in per.values():
                    entry["subsets_dropped"] = sorted(set(entry["subsets_dropped"]))
                out["per_domain"] = per
        return out
