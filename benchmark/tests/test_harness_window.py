"""The window's accounting: whole fits only, the fit under way at the
limit finished and counted, failures counted, ms per sweep over the
window's whole wall."""

# smklint: test-budget=pure Python with a fake clock, milliseconds

import pytest

from harness.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_whole_fits_and_the_fit_under_way_counted():
    clock = Clock()

    def fit(i):
        clock.t += 3.0  # every fit takes 3 s
        return i

    w = run_window(fit, 10.0, 256, clock=clock)
    # the fit ending at 9 s is under the limit, the one ending at 12 s is counted
    assert w.attempted == 4 and w.failed == 0
    assert w.wall_s == pytest.approx(12.0)
    assert w.sweeps == 4 * 256
    assert w.ms_per_sweep() == pytest.approx(12.0e3 / 1024)


def test_one_fit_longer_than_the_window():
    clock = Clock()

    def fit(i):
        clock.t += 25.0
        return i

    w = run_window(fit, 10.0, 16, clock=clock)
    assert w.attempted == 1 and w.wall_s == pytest.approx(25.0)
    assert w.ms_per_sweep() == pytest.approx(25.0e3 / 16)


def test_failed_fits_counted_and_left_out_of_the_sweeps():
    clock = Clock()
    kept = []

    def fit(i):
        clock.t += 2.0
        if i == 1:
            raise RuntimeError("boom")
        return i

    w = run_window(fit, 5.0, 10, clock=clock, on_fit=lambda i, r: kept.append(r))
    assert w.attempted == 3 and w.failed == 1
    assert w.fits[1]["error"].startswith("RuntimeError")
    assert kept == [0, 2]
    assert w.sweeps == 20


def test_sync_inside_each_fit_time():
    clock = Clock()

    def fit(i):
        clock.t += 1.0

    def sync():
        clock.t += 0.5  # the device finishing after the host returns

    w = run_window(fit, 2.0, 8, clock=clock, sync=sync)
    assert [f["wall_s"] for f in w.fits] == [1.5, 1.5]


def test_a_window_shorter_than_a_fit_holds_that_whole_fit():
    clock = Clock()

    def fit(i):
        clock.t += 30.0

    w = run_window(fit, 10.0, 8, clock=clock)
    assert w.attempted == 1 and w.wall_s == pytest.approx(30.0)
