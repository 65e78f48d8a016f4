"""Request deadlines for the serving engine — twin of
``smk_tpu/serve/deadline.py``.

A request arrives with a total deadline budget, every wait in its path
spends from it, and each device step runs on a pooled watchdog worker
thread, so a wedged dispatch becomes a typed
:class:`RequestTimeoutError` naming the in-flight batch within the
deadline instead of a hung caller. The abandoned worker holds no locks;
its late result is discarded.

A worker is another thread, and torch keeps the current CUDA device, the
current stream and the grad mode per thread: :func:`run_under_deadline`
runs each job under the caller's (device.in_callers_context), so the job
queues on the caller's stream.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from smk_torch.device import in_callers_context
from smk_torch.utils.tracing import monotonic


class RequestTimeoutError(RuntimeError):
    """A serving request overran its deadline budget.

    ``label`` names the in-flight batch (request id, bucket), ``phase``
    where the budget ran out (``"queued"``: it never reached the device;
    ``"dispatch"``: the predict overran; ``"guard"``: the finiteness
    guard or the response's copy overran), ``deadline_s`` the total
    budget. A timeout sheds this request only."""

    def __init__(self, label: str, phase: str, deadline_s: float):
        self.label = str(label)
        self.phase = str(phase)
        self.deadline_s = float(deadline_s)
        super().__init__(
            f"request {label!r} overran its {deadline_s:.3f}s "
            f"deadline in phase {phase!r} — the request is shed; "
            "the engine keeps serving"
        )


class DeadlineBudget:
    """One request's monotonic deadline budget: :meth:`remaining` is
    never below a small floor (a bounded wait is still attempted at
    exhaustion, so the timeout stays typed), :meth:`expired` gates early
    sheds."""

    # the least wait ever handed to a lock or thread wait
    MIN_WAIT_S = 0.001

    def __init__(self, total_s: float):
        if not (total_s > 0):
            raise ValueError("deadline budget must be > 0 seconds")
        self.total_s = float(total_s)
        self._t0 = monotonic()

    def elapsed(self) -> float:
        return monotonic() - self._t0

    def remaining(self) -> float:
        return max(self.MIN_WAIT_S, self.total_s - self.elapsed())

    def expired(self) -> bool:
        return self.elapsed() >= self.total_s


# Idle workers are pooled: a thread start per call would put two thread
# spawns (dispatch and guard) on every request slice. A worker is handed
# out only from the pool and re-enters it only after its job finishes,
# so a wedged worker is simply not in the pool. Idle workers leave after
# _IDLE_REAP_S; at most _MAX_IDLE wait.
_IDLE_REAP_S = 60.0
_MAX_IDLE = 32

_pool_lock = threading.Lock()
_idle_pool: list = []


class _WatchdogWorker:
    """One persistent daemon worker, one outstanding job at a time."""

    def __init__(self):
        self._ready = threading.Event()
        self._job = None
        self._thread = threading.Thread(
            target=self._loop, name="smk-serve-deadline", daemon=True
        )
        self._thread.start()

    def submit(self, fn, box: dict, done: threading.Event) -> None:
        self._job = (fn, box, done)
        self._ready.set()

    def _loop(self):
        while True:
            # a bounded idle wait; leave the pool (under its lock, so a
            # concurrent pop either finds us gone or already claimed us)
            if not self._ready.wait(timeout=_IDLE_REAP_S):
                with _pool_lock:
                    if self in _idle_pool:
                        _idle_pool.remove(self)
                        return
                continue
            self._ready.clear()
            fn, box, done = self._job
            self._job = None
            try:
                box["result"] = fn()
            except BaseException as e:  # re-raised on the caller's thread
                box["exc"] = e
            finally:
                done.set()
                with _pool_lock:
                    if len(_idle_pool) < _MAX_IDLE:
                        _idle_pool.append(self)
                    else:
                        return


def _acquire_worker() -> _WatchdogWorker:
    with _pool_lock:
        if _idle_pool:
            return _idle_pool.pop()
    return _WatchdogWorker()


def run_under_deadline(
    fn,
    budget: DeadlineBudget,
    *,
    label: str,
    phase: str = "dispatch",
    run_log=None,
    device: Optional[torch.device] = None,
):
    """Run ``fn()`` on a pooled watchdog worker under the caller's grad
    mode (and, for a CUDA ``device``, its current device and stream),
    waiting at most ``budget.remaining()``.

    Returns ``fn``'s result, re-raises its exception, or raises
    :class:`RequestTimeoutError` on overrun (after a ``deadline`` event in
    the run log, when one is armed). A wedged job is abandoned, never
    joined."""
    job = in_callers_context(fn, torch.device("cpu") if device is None else device)
    deadline = budget.remaining()
    box: dict = {}
    done = threading.Event()
    _acquire_worker().submit(job, box, done)
    if not done.wait(timeout=deadline):
        if run_log is not None:
            try:
                run_log.event(
                    "deadline", action="fired", label=str(label),
                    phase=str(phase), deadline_s=round(budget.total_s, 4),
                )
            except Exception:  # a failing log never hides the timeout
                pass
        raise RequestTimeoutError(label, phase, budget.total_s)
    if "exc" in box:
        raise box["exc"]
    return box["result"]
