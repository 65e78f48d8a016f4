"""Cross-request coalescing — twin of ``smk_tpu/serve/coalesce.py``: the
admission stage that packs concurrent requests' query rows into one
padded bucket dispatch, in front of one engine's dispatch path.

**Protocol** (leader and followers, no scheduler thread): the first
request to reach an empty coalescer leads the batch. It waits on a
condition variable for at most the window, shrunk to the tightest
member's deadline headroom (remaining budget less ``HOLD_SAFETY`` times
the recent dispatch wall), so no request is held past the point where
the window and the dispatch would overrun its budget. It then takes every
pending request, concatenates their rows, takes the engine's in-flight
gate for the batch, dispatches the packed rows through the bucket ladder
(compile/buckets.slice_plan over the total) and scatters the rows back,
each request with its own slice of the quarantine mask, so one request's
non-finite rows never degrade its batch-mates. Followers wait on an event
bounded by their own budget. A deadline-critical arrival, one whose
headroom is gone, flushes the batch at once (it wakes the leader; a
critical leader skips the window, so its ``held_s`` is ~0).

Every wait is bounded by the window or a request's budget. Dispatches run
in the engine's ``_dispatch_slice_rows`` under the deadline discipline of
serve/deadline.py.

**Bitwise**: a row's composition draw depends on its request's (seed,
row index) alone (``PredictionEngine._build_predict_rows``), so a
coalesced response is bitwise the same request served alone by a
window-armed engine; only the packing differs.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Optional

import numpy as np

from smk_torch.compile.buckets import slice_plan
from smk_torch.serve.deadline import DeadlineBudget, RequestTimeoutError
from smk_torch.utils.tracing import monotonic

# headroom multiplier on the observed dispatch wall when deciding how long
# a request may be held: it is flushed once remaining < SAFETY x estimate
HOLD_SAFETY = 2.0

# observed batch-dispatch walls kept for the hold estimate (the recent
# maximum, so one slow warm-up batch ages out)
_WALL_WINDOW = 8


class _Pending:
    """One admitted request parked in the coalescing window."""

    __slots__ = ("cq", "xq", "rid", "seed", "budget", "event", "box", "held_s")

    def __init__(self, cq, xq, rid, seed, budget):
        self.cq = cq
        self.xq = xq
        self.rid = rid
        self.seed = int(seed)
        self.budget = budget
        self.event = threading.Event()
        self.box: dict = {}
        self.held_s = 0.0

    @property
    def n(self) -> int:
        return self.cq.shape[0]


class RequestCoalescer:
    """The leader/follower batching stage of one
    :class:`~smk_torch.serve.engine.PredictionEngine`, created by it when
    ``coalesce_window_ms > 0``."""

    def __init__(self, engine, *, window_s: float):
        if not window_s > 0:
            raise ValueError("coalescing window must be > 0 seconds")
        self.engine = engine
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list = []
        self._flush_asap = False
        # the monotonic instant the current leader flushes at (None with
        # no window open): arrivals compare their headroom against it
        self._flush_at: Optional[float] = None
        self._walls: deque = deque(maxlen=_WALL_WINDOW)
        self._ids = 0
        self._stats = {
            "batches": 0,
            "requests": 0,
            "rows": 0,
            "max_batch_requests": 0,
            "critical_flushes": 0,
            "held_s_max": 0.0,
        }

    # -- deadline headroom ---------------------------------------------

    def dispatch_estimate_s(self) -> float:
        """The recent maximum batch-dispatch wall (0 before the first
        batch: the window alone bounds the hold)."""
        return max(self._walls, default=0.0)

    def _headroom_s(self, budget: DeadlineBudget) -> float:
        """Seconds this request may still be held; <= 0 marks it
        deadline-critical."""
        raw = budget.total_s - budget.elapsed()
        return raw - HOLD_SAFETY * self.dispatch_estimate_s()

    # -- submission ----------------------------------------------------

    def submit(self, cq, xq, rid, seed, budget):
        """Park one admitted request and return its response; the calling
        thread leads the batch or waits, bounded by its own budget (the
        engine's ``predict`` owns admission and the error counters)."""
        entry = _Pending(cq, xq, rid, seed, budget)
        with self._cv:
            self._pending.append(entry)
            leader = len(self._pending) == 1
            critical = self._headroom_s(budget) <= 0.0
            if critical:
                self._stats["critical_flushes"] += 1
            if not leader and not critical and self._flush_at is not None:
                # a window that outlives this arrival's headroom flushes
                # early too
                critical = monotonic() + self._headroom_s(budget) < self._flush_at
            if critical and not leader:
                self._flush_asap = True
                self._cv.notify()
        if leader:
            self._lead(entry, critical)
        elif not entry.event.wait(timeout=budget.remaining()):
            # the batch outlived this request's budget: it is shed typed
            # while the batch completes for the others
            raise RequestTimeoutError(rid, "held", budget.total_s)
        return self._finish(entry)

    # -- the leader ----------------------------------------------------

    def _lead(self, entry: _Pending, critical: bool) -> None:
        if not critical:
            with self._cv:
                hold = min([self.window_s] + [self._headroom_s(e.budget) for e in self._pending])
                if hold > 0 and not self._flush_asap:
                    self._flush_at = monotonic() + hold
                    self._cv.wait(timeout=hold)
        with self._cv:
            batch = list(self._pending)
            self._pending.clear()
            self._flush_asap = False
            self._flush_at = None
        self._flush(batch)

    def _flush(self, batch) -> None:
        """Dispatch one packed batch and deliver each member's rows (or
        its typed failure) through its box and event."""
        eng = self.engine
        with self._lock:
            self._ids += 1
            bid = self._ids
        # bounded by the longest member budget: shorter members shed on
        # their own event wait while the batch completes for the rest
        dbudget = DeadlineBudget(max(
            DeadlineBudget.MIN_WAIT_S,
            *(e.budget.total_s - e.budget.elapsed() for e in batch)))
        if not eng._inflight.acquire(timeout=dbudget.remaining()):
            for e in batch:
                e.box["timeout_phase"] = "queued"
                e.event.set()
            return
        try:
            for e in batch:
                e.held_s = e.budget.elapsed()
            t0 = monotonic()
            all_c = np.concatenate([e.cq for e in batch])
            all_x = np.concatenate([e.xq for e in batch])
            # each row carries its request's seed and its index within
            # that request: the noise's packing-invariant identity
            all_rs = np.concatenate([np.full(e.n, e.seed & 0xFFFFFFFF, np.int64)
                                     for e in batch])
            all_ri = np.concatenate([np.arange(e.n, dtype=np.int64) for e in batch])
            total = int(all_c.shape[0])
            log = eng.run_log
            span = (log.span("coalesce", batch=bid, n_requests=len(batch), rows=total,
                             request_ids=[e.rid for e in batch],
                             held_s=[round(e.held_s, 6) for e in batch])
                    if log is not None else contextlib.nullcontext())
            pq_parts, ps_parts, mask_parts, used = [], [], [], []
            # one generation for the whole batch: a swap landing mid-flush
            # cannot tear a batch across artifacts
            gen = eng._gen
            with span:
                for lo, hi, u in slice_plan(total, eng.buckets):
                    if dbudget.expired():
                        raise RequestTimeoutError(f"coalesce{bid}", "dispatch", dbudget.total_s)
                    used.append(u)
                    pqp, psp, maskp = eng._dispatch_slice_rows(
                        all_c[lo:hi], all_x[lo:hi], all_rs[lo:hi], all_ri[lo:hi],
                        u, f"coalesce{bid}/bucket{u}", dbudget, gen)
                    pq_parts.append(pqp)
                    mask_parts.append(maskp)
                    if psp is not None:
                        ps_parts.append(psp)
            self._walls.append(monotonic() - t0)
            pq_all = np.concatenate(pq_parts, axis=1)
            mask_all = np.concatenate(mask_parts)
            ps_all = np.concatenate(ps_parts, axis=1) if ps_parts else None
            buckets = tuple(used)
            # each request gets its own rows and its own slice of the mask
            off = 0
            for e in batch:
                sl = slice(off, off + e.n)
                e.box["result"] = (pq_all[:, sl], mask_all[sl],
                                   ps_all[:, sl] if ps_all is not None else None, buckets)
                off += e.n
            with self._lock:
                st = self._stats
                st["batches"] += 1
                st["requests"] += len(batch)
                st["rows"] += total
                st["max_batch_requests"] = max(st["max_batch_requests"], len(batch))
                st["held_s_max"] = max([st["held_s_max"]] + [e.held_s for e in batch])
            if log is not None:
                log.counter("coalesce_batches", 1)
                log.counter("coalesced_requests", len(batch))
                log.counter("coalesced_rows", total)
        except RequestTimeoutError as exc:
            for e in batch:
                e.box["timeout_phase"] = exc.phase
        except BaseException as exc:
            # delivered to every member's caller, which re-raises it
            for e in batch:
                e.box["exc"] = exc
        finally:
            eng._inflight.release()
            for e in batch:
                e.event.set()

    # -- completion ----------------------------------------------------

    def _finish(self, entry: _Pending):
        from smk_torch.serve.engine import PredictResponse

        box = entry.box
        if "timeout_phase" in box and "result" not in box:
            raise RequestTimeoutError(entry.rid, box["timeout_phase"], entry.budget.total_s)
        if "exc" in box:
            raise box["exc"]
        pq, mask, ps, buckets = box["result"]
        rows_degraded = ~mask
        eng = self.engine
        eng._note_guard(int(rows_degraded.sum()))
        eng._count("requests_served")
        return PredictResponse(
            p_quant=pq,
            rows_degraded=rows_degraded,
            p_samples=ps,
            buckets=buckets,
            request_id=entry.rid,
            latency_s=entry.budget.elapsed(),
            held_s=entry.held_s,
        )

    def stats_snapshot(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        out["window_ms"] = self.window_s * 1000.0
        out["dispatch_estimate_s"] = self.dispatch_estimate_s()
        return out
