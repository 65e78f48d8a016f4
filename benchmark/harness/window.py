"""The measured window: a closed loop of one client, whole fits back to
back until ``seconds`` have passed; the fit under way then is finished
and counted, so the window holds whole fits only."""

from __future__ import annotations

import time
from typing import Callable, Optional


class Window:
    """What the window ran: each fit's index, wall seconds, sweeps and
    whether it raised; the window's wall from its start to the end of
    its last fit."""

    def __init__(self):
        self.fits = []
        self.wall_s = 0.0

    @property
    def attempted(self) -> int:
        return len(self.fits)

    @property
    def failed(self) -> int:
        return sum(1 for f in self.fits if f["error"] is not None)

    @property
    def sweeps(self) -> int:
        return sum(f["sweeps"] for f in self.fits if f["error"] is None)

    def ms_per_sweep(self) -> Optional[float]:
        """All the window's wall over all the sweeps of its whole fits."""
        return 1e3 * self.wall_s / self.sweeps if self.sweeps else None


def run_window(fit: Callable[[int], object], seconds: float, sweeps_per_fit: int, *,
               clock: Callable[[], float] = time.perf_counter,
               sync: Callable[[], None] = lambda: None,
               on_fit: Optional[Callable[[int, object], None]] = None) -> Window:
    """Call ``fit(i)`` for i = 0, 1, ... until ``seconds`` have passed at
    the end of a fit (one fit at least). ``sync`` waits for the device at each fit's end
    (inside the fit's time); ``on_fit(i, result)`` keeps what the check
    needs, outside the clock's reading of that fit. A fit that raises is
    counted as failed and the loop goes on."""
    w = Window()
    start = clock()
    i = 0
    while True:
        t0 = clock()
        err, res = None, None
        try:
            res = fit(i)
            sync()
        except Exception as e:  # a failed fit is counted, the window goes on
            err = f"{type(e).__name__}: {e}"
        t1 = clock()
        w.fits.append({"index": i, "wall_s": t1 - t0, "sweeps": sweeps_per_fit, "error": err})
        if on_fit is not None and err is None:
            on_fit(i, res)
        del res
        i += 1
        if t1 - start >= seconds:
            w.wall_s = t1 - start
            return w
