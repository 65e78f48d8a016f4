"""Truncated-normal sampling for the Albert–Chib latent update — twin of
``smk_tpu/ops/truncnorm.py``.

Inverse-CDF draws in the log domain, so the deep tail keeps the right
conditional law in fp32. The draws take their uniforms as an argument
(the sampler's per-sweep noise, models/probit_gp.SweepNoise): the same
uniforms give the same latents as the JAX twin, whatever generator
made them.
"""

from __future__ import annotations

import torch
from torch.special import log_ndtr, ndtri

_TINY = 1e-7
_LOG_2PI = 1.8378770664093453


def ndtri_from_log(log_p: torch.Tensor) -> torch.Tensor:
    """x = Phi^{-1}(p) from log_p = log(p), accurate for tiny p: plain
    ndtri for moderate p; below that the tail asymptotic polished by
    three Newton steps on log_ndtr(x) - log_p."""
    p = torch.exp(log_p)
    moderate = p > 1e-4
    x_mod = ndtri(torch.clamp(p, 1e-30, 1.0 - _TINY))
    r = -log_p
    two_r = torch.clamp(2.0 * r, min=1e-10)
    asym = -torch.sqrt(torch.clamp(two_r - torch.log(two_r) - _LOG_2PI, min=1e-10))
    x = torch.where(moderate, x_mod, asym)
    for _ in range(3):
        log_cdf = log_ndtr(x)
        log_pdf = -0.5 * x * x - 0.5 * _LOG_2PI
        step = (log_cdf - log_p) * torch.exp(log_cdf - log_pdf)
        x = torch.where(moderate, x, x - torch.clamp(step, -2.0, 2.0))
    return x


def truncated_normal(
    uniforms: torch.Tensor, mu: torch.Tensor, positive: torch.Tensor
) -> torch.Tensor:
    """One-sided truncated N(mu, 1) draws from ``uniforms`` on
    [_TINY, 1): (0, inf) where ``positive``, (-inf, 0] elsewhere."""
    sign = torch.where(positive, 1.0, -1.0).to(mu.dtype)
    log_v = torch.log(uniforms) + log_ndtr(sign * mu)
    z = mu - sign * ndtri_from_log(log_v)
    return torch.where(
        positive, torch.clamp(z, min=_TINY), torch.clamp(z, max=-_TINY)
    )


def sample_albert_chib_latent(
    uniforms: torch.Tensor,
    mu: torch.Tensor,
    y: torch.Tensor,
    weight: int = 1,
) -> torch.Tensor:
    """Mean of ``weight`` Albert–Chib latents per observation. uniforms
    has mu's shape for weight 1, else a leading (weight,) trial axis."""
    if weight == 1:
        return truncated_normal(uniforms, mu, y > 0)
    trial = torch.arange(weight, device=mu.device).reshape((weight,) + (1,) * mu.dim())
    positive = trial < y[None]
    mu_rep = mu[None].expand((weight,) + tuple(mu.shape))
    return torch.mean(truncated_normal(uniforms, mu_rep, positive), dim=0)
