"""factor_roofline: the m x m factorizations (m^3 / 3 FLOPs each,
harness/work.py) of the span fits' profiled fit (harness/span_fits.py,
at its sweeps) at the float32 peak, over the device time launched inside
the program's ``smk.factor`` spans whose matrices are m x m, m the
subset size (the factorizations, their copies and fills; the smaller
factors of the beta and A draws, the kriging and the Nystrom
preconditioner left out), in % (the spans laid on the trace by
harness/spans.py; the kernels of factor_roofline.txt)."""

from harness import span_fits


def read(ctx):
    got = span_fits.measure(ctx)
    if got is None or got.get("factor_s") is None:
        return None
    flops = ctx["work"].ops(dict(ctx["config"], n_samples=got["sweeps"]))["chol"]["flops"]
    return 100.0 * flops / ctx["peaks"]["fp32_flops"] / got["factor_s"]
