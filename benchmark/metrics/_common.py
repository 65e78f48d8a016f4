"""Shared arithmetic of the per-layer metric readers (not a metric)."""

from __future__ import annotations

from harness import spec, trace


def mean_wall(ctx):
    """The mean wall of the window's whole fits (all run untraced)."""
    fits = ctx["fits"]
    return sum(f["wall_s"] for f in fits) / len(fits) if fits else None


def kernel_seconds(ctx, metric: str):
    """Device seconds of the traced fit in the kernels of ``metric``'s
    name list, or None where the trace has none of them."""
    if "trace" not in ctx:
        return None
    secs = trace.seconds_matching(ctx["trace"], trace.patterns(spec.kernel_list(metric)))
    return secs if secs > 0 else None


def idle_percent(ctx):
    """100 (1 - busy / window) per card used, averaged over the cards."""
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    busy = t["busy_by_card"]
    if not busy:
        return None
    n = ctx["chips"]
    return 100.0 * sum(1.0 - busy.get(str(i), 0.0) / t["window_s"] for i in range(n)) / n


def mfu_percent(ctx, cards: int):
    """The least time of a fit's counted work at ``cards`` cards' peaks
    over a fit's wall, in %."""
    wall = mean_wall(ctx)
    if not wall:
        return None
    return 100.0 * ctx["work"].fit_least_seconds(ctx["config"], ctx["peaks"]) / cards / wall
