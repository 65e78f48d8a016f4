"""Pólya-Gamma sampling for the logit link — twin of
``smk_tpu/ops/polya_gamma.py``.

omega ~ PG(b, c) from its series
    omega = (1 / (2 pi^2)) * sum_k g_k / ((k - 1/2)^2 + a^2),
    g_k ~ Gamma(b, 1),  a = c / (2 pi),
truncated at ``n_terms`` with the dropped tail replaced by its mean.
The Gamma draws come in as an argument (the sampler's per-sweep noise,
models/probit_gp.SweepNoise.kz under logit), as the Albert–Chib draw
takes its uniforms: the same draws give the same omega as the twin.
"""

from __future__ import annotations

import math

import torch

_TWO_PI_SQ = 2.0 * math.pi * math.pi


def sample_pg(g: torch.Tensor, b: int, c: torch.Tensor, n_terms: int = 64) -> torch.Tensor:
    """omega ~ PG(b, c) elementwise over c's shape, from ``g``: the
    (n_terms,) + c.shape Gamma(b, 1) draws of the series."""
    dtype = c.dtype
    c = torch.abs(c)  # PG(b, c) depends on c only through c^2
    a = c / (2.0 * math.pi)
    k = torch.arange(1, n_terms + 1, dtype=dtype, device=c.device)
    k_half = (k - 0.5).reshape((n_terms,) + (1,) * c.dim())
    denom = k_half * k_half + a[None] * a[None]
    series = torch.sum(g / denom, dim=0)
    # mean of the dropped tail, (b / 2pi^2) (1/a) arctan(a / n_terms)
    a_safe = torch.clamp(a, min=1e-12)
    tail = float(b) * torch.arctan(a_safe / n_terms) / a_safe
    return (series + tail) / _TWO_PI_SQ


def gamma_draws(generator: torch.Generator, b: int, shape, *, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Gamma(b, 1) draws of ``shape`` for an integer b: the sum of b
    Exponential(1) draws, from one ``exponential_`` call (Gamma(1, 1)
    is Exponential(1), as the twin's b == 1 branch draws it)."""
    e = torch.empty((b,) + tuple(shape), dtype=dtype, device=device)
    e.exponential_(generator=generator)
    return e[0] if b == 1 else torch.sum(e, dim=0)


def pg_mean(b: float, c: torch.Tensor) -> torch.Tensor:
    """E[PG(b, c)] = (b / 2c) tanh(c / 2), with the c -> 0 limit b/4."""
    c = torch.abs(c)
    small = c < 1e-4
    c_safe = torch.where(small, 1.0, c)
    return torch.where(small, b / 4.0, b * torch.tanh(c_safe / 2.0) / (2.0 * c_safe))
