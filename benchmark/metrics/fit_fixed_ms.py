"""fit_fixed_ms: a fit's wall outside its subset fits (partition, warm
start, combine, resample and predict), from the program's
``phase_seconds`` spans (host clock, the device synced at each phase
end), averaged over the window's fits, in ms."""


def read(ctx):
    fits = ctx["fits"]
    vals = [sum(v for k, v in f["phase_seconds"].items() if k != "subset_fits") for f in fits]
    return 1e3 * sum(vals) / len(vals) if vals else None
