"""idle_frac: the share of the traced fit in which no kernel, copy or set
ran on the card (torch.profiler's device events), in %."""

from _common import idle_percent


def read(ctx):
    return idle_percent(ctx)
