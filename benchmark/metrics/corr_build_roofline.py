"""corr_build_roofline: the traced fit's correlation builds at their
least bytes (inputs read once, output written once; harness/work.py)
over the memory peak, over the device time in the kernels of
corr_build_roofline.txt, in %."""

from _common import kernel_seconds


def read(ctx):
    secs = kernel_seconds(ctx, "corr_build_roofline")
    if secs is None:
        return None
    nbytes = ctx["work"].ops(ctx["config"])["build"]["bytes"]
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / secs
