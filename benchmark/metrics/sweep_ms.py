"""sweep_ms: the untraced window's wall over all the sweeps of its whole
fits (host clock, the device synced at each fit's end), in ms."""


def read(ctx):
    return ctx["window"].ms_per_sweep()
