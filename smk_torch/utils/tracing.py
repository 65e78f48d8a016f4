"""Phase timing and the chunked executor's per-chunk ledger — twin of
``PhaseTimes``, ``phase_timer`` and ``ChunkPipelineStats`` in
``smk_tpu/utils/tracing.py``. A phase ends with a sync of the device's
stream (as the twin's ``device_sync``), so its wall time covers the
work and not only its enqueueing.

``ChunkPipelineStats`` carries the members the chunked executor's host
loop (both pipelines), the checkpoint, its background writer and
quarantine record into (parallel/recovery.py). The streaming monitor
and the run log are not ported (ROADMAP A8c), nor the program store
(A10): ``aggregate`` reports their keys as the twin does when they are
off.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

from smk_torch.device import sync


def monotonic() -> float:
    """The telemetry clock: monotonic seconds, as the twin's."""
    return time.perf_counter()


@dataclass
class PhaseTimes:
    seconds: Dict[str, float] = field(default_factory=dict)

    def record(self, name: str, secs: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)


@contextlib.contextmanager
def phase_timer(
    times: PhaseTimes, name: str, device: Optional[torch.device] = None
) -> Iterator[None]:
    """Time a phase; on a CUDA ``device`` the phase ends with a stream
    sync."""
    start = monotonic()
    try:
        yield
    finally:
        if device is not None:
            sync(device)
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
    # generations of the distributed checkpoint (ROADMAP A9): 0 on one
    # host, as in the twin
    ckpt_generations: int = 0
    ckpt_commit_s: float = 0.0
    total_wall_s: float = 0.0
    # one entry per bucket group of a ragged fit, None on equal-m runs
    ragged_groups: Any = None
    host_staging_bytes: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def record_chunk(self, **entry: Any) -> None:
        with self._lock:
            self.chunks.append(entry)

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

    def add_ckpt_commit(
        self, seconds: float, *, generation: int, it: int = -1,
        filled: int = -1, n_processes: int = 1,
    ) -> None:
        """One committed checkpoint generation (the distributed layout's
        accounting; nothing on one host calls it)."""
        del generation, it, filled, n_processes
        with self._lock:
            self.ckpt_generations += 1
            self.ckpt_commit_s += float(seconds)

    def add_ckpt_write(self, seconds: float, nbytes: int) -> None:
        with self._lock:
            self.ckpt_write_s += float(seconds)
            self.ckpt_bytes += int(nbytes)
            self.ckpt_boundary_bytes.append(int(nbytes))

    def aggregate(self) -> Dict[str, Any]:
        """The twin's summary, key for key: the sync loop's, the
        checkpoint's and the fault ledger's keys measured; the live
        diagnostics', the adaptive schedule's, the ingest's and the
        device-memory keys None and the program store's empty, as the
        twin reports them when those are off."""
        stall = sum(c.get("host_stall_s", 0.0) for c in self.chunks)
        work = sum(c.get("host_work_s", 0.0) for c in self.chunks)
        disp = sum(c.get("dispatch_s", 0.0) for c in self.chunks)
        d2h = sum(int(c.get("d2h_bytes", 0)) for c in self.chunks)
        wall = self.total_wall_s
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
            "hbm_peak_bytes": None,
            "live_rhat_final": None,
            "live_ess_min_final": None,
            "live_ess_sum_final": None,
            "ess_per_second": None,
            "ragged_groups": self.ragged_groups,
            "ragged_mesh_plan": None,
            "adaptive": None,
            "chunks_saved_frac": None,
            "frozen_at": None,
            "ess_per_second_adaptive": None,
            "ingest": None,
            "fault": self.fault_summary(),
            "compile_s": 0.0,
            "program_sources": {},
        }

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
