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
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.utils._pytree import tree_flatten

from smk_torch.analysis.sanitizers import explicit_wait
from smk_torch.device import sync


def monotonic() -> float:
    """The telemetry clock: monotonic seconds, as the twin's."""
    return time.perf_counter()


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
    the run log."""
    start = monotonic()
    span = log.span(name) if log is not None else None
    if span is not None:
        span.__enter__()
    try:
        yield
    finally:
        if device is not None:
            with explicit_wait("device_sync"):
                sync(device)
        if span is not None:
            span.__exit__(None, None, None)
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
    state's copy into the staging buffer, after that), ``mirror_merge_s``
    (adaptive schedule: the staged group rows merged into the host
    mirror the manifest holds), ``ckpt_write_s``
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
            self._emit("program", entry)

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
