"""corr_build_roofline.config4: corr_build_roofline (see corr_build_roofline.py) of the config4 cells,
under a name of its own: a per-layer metric names one end-to-end
metric that it moves, and config4.fit reports sweep_ms.config4."""

from harness import spec

read = spec.metric_reader("corr_build_roofline")
