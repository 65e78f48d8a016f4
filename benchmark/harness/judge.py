"""The comparison that decides ``correct``: the numbers compared between
a fit the window ran and the plain reference, each against its limit
from the cell's own file (workloads/<cell>.json).

- ``p_gap``: the mean, over the fit's p(y = 1) summary at the test sites
  (median, 2.5 % and 97.5 % rows), of the gap between the port's value
  and the reference's, both from the same inputs and random numbers.
  It covers every layer: the partition, the warm start, each sweep (the
  correlation builds, the factor and solves, the CG u-draw, the latent
  draw, the phi move, the kriging draw), the combine, the resample and
  the prediction.
- ``combine_gap``: the largest gap between the port's combined
  posterior (its p(y = 1) draws and parameter summary) and what the
  reference's combine, resample and prediction make of the port's own
  subset grids: that stage alone, followed from the port's state, to
  round-off. Gaps of parameters are taken relative to max(1, |value|).

A NaN or an infinite value reads as an infinite gap."""

from __future__ import annotations

import numpy as np


def _gap(a, b, *, how: str, rel: bool = False) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    d = np.abs(a - b)
    if rel:
        d = d / np.maximum(1.0, np.abs(b))
    if not np.all(np.isfinite(d)):
        return float("inf")
    return float(d.mean() if how == "mean" else d.max())


def numbers(port: dict, ref: dict, ref_of_port: dict) -> dict:
    """``port``: the fit's outputs (numpy: p_quant, p_samples,
    param_quant); ``ref``: the reference fit; ``ref_of_port``: the
    reference's combine and prediction of the port's subset grids."""
    return {
        "p_gap": _gap(port["p_quant"], ref["p_quant"], how="mean"),
        "combine_gap": max(
            _gap(port["p_samples"], ref_of_port["p_samples"], how="max"),
            _gap(port["param_quant"], ref_of_port["param_quant"], how="max", rel=True),
        ),
    }


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, checks): every number at or under its limit; ``checks``
    maps each name to {"value", "limit"}."""
    checks = {k: {"value": values[k], "limit": float(limits[k])} for k in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
