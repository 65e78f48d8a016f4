"""noise_idle_pct: the share of a traced fit's window in which card 0
is idle while the host is inside an ``smk.noise`` span (the program's
noise draws, or a span inside them), in % (harness/span_fits.py's
profiled fit, the spans laid on the trace by harness/spans.py)."""

from harness import span_fits


def read(ctx):
    got = span_fits.measure(ctx)
    return None if got is None else got.get("noise_idle_pct")
