"""noise_ms: the host's milliseconds a sweep in the program's
``smk.noise`` spans (models/probit_gp.GeneratorNoise: every batch row's
draws of one sweep and their stacking), in the span fits' host fit (the
spans armed, no profiler, a fresh process; harness/span_fits.py), over
its sweeps."""

from harness import span_fits


def read(ctx):
    got = span_fits.measure(ctx)
    return None if got is None else got.get("noise_ms")
