"""noise_idle_pct.config4: noise_idle_pct (see noise_idle_pct.py) of the config4 cells,
under a name of its own: a per-layer metric names one end-to-end
metric that it moves, and config4.fit reports sweep_ms.config4."""

from harness import spec

read = spec.metric_reader("noise_idle_pct")
