"""Structured span/event run log — twin of ``smk_tpu/obs/events.py``.

One :class:`RunLog` per fit, an append-only JSONL timeline written
through obs/reporter.py (each record flushed as it is written, so a kill
tears at most one line). Three record kinds:

- ``span``: a nested wall-clock interval with its id, its parent's id
  and monotonic ``t0``/``t1`` bounds relative to the log's opening.
  Spans are written when they close, so a crashed run's open spans are
  absent and the summarizer reports the truncation;
- ``event``: a point-in-time fact attached to the innermost open span
  (chunk boundaries, faults, checkpoint writes, live diagnostics, the
  watchdog, the adaptive schedule's compactions, profiler windows);
- ``counter``: a named running total, written when bumped.

The first record is ``run_start`` (trace id, wall-clock anchor, pid,
meta), the last ``run_end``. Every other time is monotonic seconds since
the log opened. Stdlib only: arming a run log cannot change a draw.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

from smk_torch.obs.reporter import JsonlWriter

SCHEMA_VERSION = 1


def _clean(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """JSON-safe attribute values: numpy scalars/arrays and other
    non-JSON leaves are coerced via item()/tolist()/str so an emitting
    site can pass telemetry as it holds it."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[k] = v
        elif hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            out[k] = v.item()
        elif hasattr(v, "tolist"):
            out[k] = v.tolist()
        elif isinstance(v, (list, tuple)):
            out[k] = [
                x if isinstance(x, (str, int, float, bool)) or x is None
                else (x.item() if hasattr(x, "item") else str(x))
                for x in v
            ]
        elif isinstance(v, dict):
            out[k] = _clean(v)
        else:
            out[k] = str(v)
    return out


class RunLog:
    """Append-only structured timeline of one fit.

    Thread-safe: spans form a stack per the OPENING order on the
    caller side, but events may arrive from any thread (the overlap
    pipeline's background checkpoint writer reports its writes from
    the writer thread) — they attach to the innermost span open at
    emission time. Close is idempotent.
    """

    def __init__(
        self,
        path: str,
        *,
        name: str = "run",
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.path = path
        self.trace_id = uuid.uuid4().hex[:16]
        self._writer = JsonlWriter(path)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self._next_span = 0
        self._stack: List[int] = []
        self._counters: Dict[str, float] = {}
        self._closed = False
        self._writer.write({
            "kind": "run_start",
            "schema": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "name": name,
            # the one wall-clock anchor; everything else is monotonic
            # seconds since this record
            "wall_anchor_unix_s": time.time(),
            "pid": os.getpid(),
            "meta": _clean(meta or {}),
        })

    # -- clock -----------------------------------------------------

    def now(self) -> float:
        """Monotonic seconds since the log opened."""
        return time.perf_counter() - self._t0

    # -- spans -----------------------------------------------------

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[int]:
        """Open a nested span; emitted as one record at close with its
        monotonic [t0, t1) bounds. Yields the span id (events inside
        reference it implicitly via the stack)."""
        with self._lock:
            sid = self._next_span
            self._next_span += 1
            parent = self._stack[-1] if self._stack else None
            self._stack.append(sid)
        t0 = self.now()
        try:
            yield sid
        finally:
            t1 = self.now()
            with self._lock:
                # tolerate exception-unwound out-of-order exits: drop
                # everything above (their records are simply absent,
                # which the summarizer reports as truncation)
                if sid in self._stack:
                    del self._stack[self._stack.index(sid):]
                if not self._closed:
                    self._writer.write({
                        "kind": "span",
                        "name": name,
                        "span_id": sid,
                        "parent": parent,
                        "t0": round(t0, 6),
                        "t1": round(t1, 6),
                        "attrs": _clean(attrs),
                    })

    # -- events / counters -----------------------------------------

    def event(self, name: str, **attrs: Any) -> None:
        with self._lock:
            if self._closed:
                return
            span = self._stack[-1] if self._stack else None
            self._writer.write({
                "kind": "event",
                "name": name,
                "t": round(self.now(), 6),
                "span": span,
                "attrs": _clean(attrs),
            })

    def counter(self, name: str, value: float) -> None:
        """Bump a typed running total and emit its new value."""
        with self._lock:
            if self._closed:
                return
            total = self._counters.get(name, 0) + value
            self._counters[name] = total
            self._writer.write({
                "kind": "counter",
                "name": name,
                "t": round(self.now(), 6),
                "value": total,
                "delta": value,
            })

    # -- lifecycle -------------------------------------------------

    def close(self, **attrs: Any) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._writer.write({
                "kind": "run_end",
                "t": round(self.now(), 6),
                "open_spans": len(self._stack),
                "counters": dict(self._counters),
                "attrs": _clean(attrs),
            })
            self._writer.close()

    def __enter__(self) -> "RunLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_run_log(
    run_log_dir: str,
    *,
    name: str = "fit",
    meta: Optional[Dict[str, Any]] = None,
) -> RunLog:
    """One fresh run log file under ``run_log_dir``
    (``SMKConfig.run_log_dir``): ``<name>_<utc>_<pid>_<nonce>.jsonl``
    — collision-proof across concurrent fits without coordination."""
    os.makedirs(run_log_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
    fname = (
        f"{name}_{stamp}_{os.getpid()}_{uuid.uuid4().hex[:6]}.jsonl"
    )
    return RunLog(
        os.path.join(run_log_dir, fname), name=name, meta=meta
    )
