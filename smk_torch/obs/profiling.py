"""Profiler capture over a chunk window — twin of
``smk_tpu/obs/profiling.py``, through ``torch.profiler``.

- :class:`ProfilerCapture` — the chunk-windowed capture the chunked
  executor (parallel/recovery.py) drives: armed by config
  (``SMKConfig.profile_dir`` / ``profile_chunks``) or environment
  (``SMK_PROFILE_DIR`` / ``SMK_PROFILE_CHUNKS``, which win), it opens
  one ``torch.profiler.profile`` window (CPU activity, and CUDA activity
  where a card is visible) at chunk ``start``'s dispatch and closes it
  after the boundary wait of chunk ``stop - 1``, then writes a Chrome
  trace into the directory. While it is open, each chunk runs under a
  ``torch.profiler.record_function`` scope named
  ``smk_chunk[<index>]`` (:func:`chunk_scope`).
- trace summaries — the newest trace of a directory, its device
  events' totals per op and per named scope. A device event is a
  complete event whose ``cat`` is ``kernel``, ``gpu_memcpy`` or
  ``gpu_memset`` (torch's Chrome-trace categories); a scope's device
  time is that of the device events launched inside it (matched through
  the launch's ``correlation`` id), not a name rule on process names.

Profiling is observational but not free: a capture never arms itself
(the directory must be asked for) and its window is bounded.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

PROFILE_DIR_ENV = "SMK_PROFILE_DIR"
PROFILE_CHUNKS_ENV = "SMK_PROFILE_CHUNKS"
CHUNK_SCOPE = "smk_chunk"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_TRACE_GLOBS = ("*.trace.json.gz", "*.trace.json")


def parse_chunk_range(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"a:b"`` -> (a, b), a half-open chunk-index window; ``"a"`` ->
    (a, a + 1); None or empty -> None. A malformed or empty window
    raises ValueError."""
    if spec is None or not str(spec).strip():
        return None
    s = str(spec).strip()
    m = re.fullmatch(r"(\d+)(?::(\d+))?", s)
    if m is None:
        raise ValueError(
            f"profile chunk range {spec!r} is not 'start' or "
            "'start:stop' (half-open chunk indices)"
        )
    a = int(m.group(1))
    b = int(m.group(2)) if m.group(2) is not None else a + 1
    if b <= a:
        raise ValueError(f"profile chunk range {spec!r} is empty (stop <= start)")
    return a, b


def chunk_scope(index: int) -> str:
    """The record_function name of chunk ``index``."""
    return f"{CHUNK_SCOPE}[{int(index)}]"


class ProfilerCapture:
    """One bounded ``torch.profiler`` window over chunks [start, stop).

    The executor calls ``maybe_start(i)`` at chunk ``i``'s dispatch and
    ``maybe_stop(i)`` after its boundary wait; ``active`` says whether
    the window is open (the executor then names the chunk's scope).
    ``close`` stops a window the run abandoned (a kill, an error), so
    its trace is still written. ``trace_path`` names the file written."""

    def __init__(self, out_dir: str, chunk_range: Tuple[int, int]):
        self.out_dir = out_dir
        self.start, self.stop = int(chunk_range[0]), int(chunk_range[1])
        self.active = False
        self.captured = False
        self.trace_path: Optional[str] = None
        self._prof = None

    @classmethod
    def from_config(cls, cfg) -> Optional["ProfilerCapture"]:
        """The capture a run carries, or None. The environment overrides
        the config."""
        out_dir = os.environ.get(PROFILE_DIR_ENV) or getattr(cfg, "profile_dir", None)
        spec = os.environ.get(PROFILE_CHUNKS_ENV) or getattr(cfg, "profile_chunks", None)
        if not out_dir:
            return None
        return cls(out_dir, parse_chunk_range(spec) or (0, 1))

    def maybe_start(self, chunk_idx: int) -> bool:
        if self.captured or self.active or not self.start <= chunk_idx < self.stop:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.out_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=acts)
            prof.start()
        except Exception as e:
            warnings.warn(
                f"profiler capture failed to start ({e!r}); the run continues unprofiled",
                RuntimeWarning, stacklevel=2,
            )
            self.captured = True  # no retry every chunk
            return False
        self._prof = prof
        self.active = True
        return True

    def maybe_stop(self, chunk_idx: int) -> bool:
        """Close the window once its last chunk's boundary has waited
        for the chunk (the caller's boundary wait comes first, so the
        window's device work is complete), and write the trace."""
        if not self.active or chunk_idx < self.stop - 1:
            return False
        prof, self._prof = self._prof, None
        self.active = False
        self.captured = True
        try:
            prof.stop()
            path = os.path.join(
                self.out_dir,
                f"smk_chunks_{self.start}_{self.stop}_{os.getpid()}_"
                f"{time.strftime('%Y%m%dT%H%M%S', time.gmtime())}.pt.trace.json.gz")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception as e:
            warnings.warn(f"profiler capture failed to stop cleanly ({e!r})",
                          RuntimeWarning, stacklevel=2)
        return True

    def close(self) -> None:
        if self.active:
            self.maybe_stop(self.stop)


# ---------------------------------------------------------------------------
# Chrome-trace summaries
# ---------------------------------------------------------------------------


def latest_chrome_trace(trace_dir: str) -> Optional[str]:
    """The newest Chrome trace under ``trace_dir`` (by modification
    time), or None."""
    paths = []
    for pat in _TRACE_GLOBS:
        paths += glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def load_trace_events(trace_path: str) -> List[dict]:
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as f:
        return json.load(f)["traceEvents"]


def _is_device(e: dict) -> bool:
    return (e.get("ph") == "X" and str(e.get("cat", "")).lower() in DEVICE_CATS
            and float(e.get("dur", 0.0)) > 0)


def device_op_totals(events: Iterable[dict]) -> Dict[str, float]:
    """Total device duration (µs) per op name."""
    by_name: Dict[str, float] = {}
    for e in events:
        if _is_device(e):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    return by_name


def _scope_instances(events: List[dict], scopes: Optional[Iterable[str]]):
    """The host-side record_function intervals (name, t0, t1) whose name
    is in ``scopes`` (default: every name starting with ``smk_``)."""
    out = []
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")) != "user_annotation":
            continue
        name = e.get("name", "")
        if (name in scopes) if scopes is not None else name.startswith("smk_"):
            t0 = float(e.get("ts", 0.0))
            out.append((name, t0, t0 + float(e.get("dur", 0.0))))
    return out


def _launches(events: List[dict]) -> Dict[object, float]:
    """correlation id -> host timestamp of the runtime call that
    launched it."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and not _is_device(e):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None and str(e.get("cat", "")).startswith("cuda"):
                out[corr] = float(e.get("ts", 0.0))
    return out


def scope_device_spans(events: Iterable[dict],
                       scopes: Optional[Iterable[str]] = None) -> List[dict]:
    """Per scope instance: its host interval, the device events it
    launched (``busy_us``, the sum of their durations) and their device
    span (``span_us``, first start to last end; 0 without any)."""
    events = list(events)
    inst = _scope_instances(events, None if scopes is None else set(scopes))
    launch = _launches(events)
    dev = [(launch.get((e.get("args") or {}).get("correlation")), e)
           for e in events if _is_device(e)]
    out = []
    for name, t0, t1 in inst:
        mine = [e for ts, e in dev if ts is not None and t0 <= ts <= t1]
        starts = [float(e["ts"]) for e in mine]
        ends = [float(e["ts"]) + float(e["dur"]) for e in mine]
        out.append({"scope": name, "host_us": t1 - t0, "n_device_events": len(mine),
                    "busy_us": sum(float(e["dur"]) for e in mine),
                    "span_us": (max(ends) - min(starts)) if mine else 0.0})
    return out


def scope_totals(events: Iterable[dict],
                 scopes: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Device µs launched inside each named scope, summed over its
    instances (default: every ``smk_`` scope in the trace)."""
    out: Dict[str, float] = {}
    for s in scope_device_spans(events, scopes):
        out[s["scope"]] = out.get(s["scope"], 0.0) + s["busy_us"]
    return out


def summarize_trace(trace_dir: str, top: int = 20) -> Optional[dict]:
    """The newest trace of ``trace_dir``: device time, the ``top`` device
    ops by total time, and each named scope's device time (busy and
    span). None when no trace exists."""
    path = latest_chrome_trace(trace_dir)
    if path is None:
        return None
    events = load_trace_events(path)
    totals = device_op_totals(events)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    spans = scope_device_spans(events)
    return {
        "trace_path": path,
        "n_events": len(events),
        "device_us_total": round(sum(totals.values()), 1),
        "n_device_ops": len(totals),
        "top_ops_us": [{"op": n[:120], "us": round(us, 1)} for n, us in ranked],
        "scope_us": {k: round(v, 1) for k, v in scope_totals(events).items()},
        "scopes": spans,
    }
