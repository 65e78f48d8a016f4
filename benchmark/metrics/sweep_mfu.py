"""sweep_mfu: the least time the published peaks of one card allow for a
fit's counted work (factorizations and triangular work at the float32
peak, the CG operator's bf16 products at the bf16 peak, each bounded by
its bytes over the memory peak, and the builds' bytes; harness/work.py)
over a fit's wall, in %."""

from _common import mfu_percent


def read(ctx):
    return mfu_percent(ctx, 1)
