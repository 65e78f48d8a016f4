"""MCMC diagnostics on the device — twin of
``smk_tpu/utils/diagnostics.py`` (Geyer ESS over an FFT
autocovariance, split-R-hat). Every function works along the draw axis
``dim`` with any leading batch axes."""

from __future__ import annotations

import torch


def _autocovariance(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Biased autocovariance along ``dim`` via FFT, lags 0..n-1."""
    n = x.shape[dim]
    xc = x - torch.mean(x, dim=dim, keepdim=True)
    f = torch.fft.rfft(xc, n=2 * n, dim=dim)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=dim)
    return torch.narrow(acov, dim, 0, n) / n


def effective_sample_size(chain: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Geyer initial-positive-sequence ESS per column of draws along
    ``dim``: autocorrelation pair sums (rho_2t + rho_2t+1) are summed
    while they stay positive."""
    chain = torch.movedim(chain, dim, -1)
    n = chain.shape[-1]
    acov = _autocovariance(chain, -1)
    var0 = torch.clamp(acov[..., :1], min=1e-30)
    rho = acov / var0
    n_pairs = n // 2
    pair = rho[..., 0 : 2 * n_pairs : 2] + rho[..., 1 : 2 * n_pairs : 2]
    keep = torch.cumprod((pair > 0.0).to(chain.dtype), dim=-1)
    tau = -1.0 + 2.0 * torch.sum(pair * keep, dim=-1)
    tau = torch.clamp(tau, min=1.0 / n)
    return torch.clamp(n / tau, max=float(n))


def _var1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unbiased variance along ``dim`` (NaN below 2 entries, quietly)."""
    dev = x - torch.mean(x, dim=dim, keepdim=True)
    return torch.sum(dev * dev, dim=dim) / (x.shape[dim] - 1)


def rhat(chains: torch.Tensor) -> torch.Tensor:
    """Split-R-hat over C chains: (..., C, n, d) -> (..., d). Each chain
    is split in half; NaN below 4 draws per chain."""
    n = chains.shape[-2] // 2
    halves = torch.cat([chains[..., :n, :], chains[..., n : 2 * n, :]], dim=-3)
    within = torch.mean(_var1(halves, -2), dim=-2)
    means = torch.mean(halves, dim=-2)
    between = n * _var1(means, -2)
    var_est = (n - 1) / n * within + between / n
    return torch.sqrt(var_est / torch.clamp(within, min=1e-30))


def split_rhat(chain: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per column of one chain, (..., n, d) -> (..., d) (a 1-D
    chain is one column): :func:`rhat` of a single chain."""
    if chain.dim() == 1:
        chain = chain[:, None]
    return rhat(chain.unsqueeze(-3))
