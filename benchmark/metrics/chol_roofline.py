"""chol_roofline: the traced fit's m x m factorizations (m^3 / 3 FLOPs
each, counted by harness/work.py) at the float32 peak, over the device
time in the kernels of chol_roofline.txt, in %."""

from _common import kernel_seconds


def read(ctx):
    secs = kernel_seconds(ctx, "chol_roofline")
    if secs is None:
        return None
    flops = ctx["work"].ops(ctx["config"])["chol"]["flops"]
    return 100.0 * flops / ctx["peaks"]["fp32_flops"] / secs
