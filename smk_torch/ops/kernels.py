"""Spatial correlation kernels — twin of ``smk_tpu/ops/kernels.py``.
Each maps a distance and a decay phi to a correlation with unit
diagonal; elementwise, broadcasting over any leading axes."""

from __future__ import annotations

import torch

_SQRT3 = 1.7320508075688772
_SQRT5 = 2.23606797749979


def exponential(dist: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """rho(h) = exp(-phi * h) — the reference's model (R:84)."""
    return torch.exp(-phi * dist)


def matern32(dist: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Matérn nu=3/2: (1 + sqrt(3) phi h) exp(-sqrt(3) phi h)."""
    t = _SQRT3 * phi * dist
    return (1.0 + t) * torch.exp(-t)


def matern52(dist: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Matérn nu=5/2: (1 + t + t^2/3) exp(-t), t = sqrt(5) phi h."""
    t = _SQRT5 * phi * dist
    return (1.0 + t + t * t / 3.0) * torch.exp(-t)


CORRELATION_FNS = {
    "exponential": exponential,
    "matern32": matern32,
    "matern52": matern52,
}


def correlation(dist: torch.Tensor, phi: torch.Tensor, model: str) -> torch.Tensor:
    """Correlation for a model name."""
    try:
        fn = CORRELATION_FNS[model]
    except KeyError:
        raise ValueError(
            f"unknown cov model {model!r}; expected one of "
            f"{sorted(CORRELATION_FNS)}"
        ) from None
    return fn(dist, phi)


def correlation_stack(
    dist: torch.Tensor, phis: torch.Tensor, model: str
) -> torch.Tensor:
    """(..., s, m, m) correlations for an (..., s) phi vector from one
    (..., m, m) distance matrix."""
    return correlation(dist[..., None, :, :], phis[..., None, None], model)
