"""noise_ms.config4: noise_ms (see noise_ms.py) of the config4 cells,
under a name of its own: a per-layer metric names one end-to-end
metric that it moves, and config4.fit reports sweep_ms.config4."""

from harness import spec

read = spec.metric_reader("noise_ms")
