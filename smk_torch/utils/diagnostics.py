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


def masked_effective_sample_size(chain: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Geyer ESS over the valid rows of capacity-padded chains (the
    adaptive schedule's buffers): ``chain`` (..., n, d), ``mask`` (n,)
    or broadcastable to (..., n), true where a row was drawn. Invalid
    rows contribute nothing to any moment; with a contiguous all-valid
    mask this is :func:`effective_sample_size` on the valid prefix.
    Lag products across a reopen gap are zeroed, not bridged."""
    x = torch.movedim(chain, -2, -1)  # (..., d, n)
    n = x.shape[-1]
    mk = mask.to(chain.dtype)[..., None, :]  # (..., 1, n)
    cnt = torch.clamp(torch.sum(mk, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(x * mk, dim=-1, keepdim=True) / cnt
    xc = (x - mean) * mk
    f = torch.fft.rfft(xc, n=2 * n, dim=-1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=-1)[..., :n] / cnt
    var0 = torch.clamp(acov[..., :1], min=1e-30)
    rho = acov / var0
    n_pairs = n // 2
    pair = rho[..., 0 : 2 * n_pairs : 2] + rho[..., 1 : 2 * n_pairs : 2]
    keep = torch.cumprod((pair > 0.0).to(chain.dtype), dim=-1)
    tau = -1.0 + 2.0 * torch.sum(pair * keep, dim=-1, keepdim=True)
    tau = torch.maximum(tau, 1.0 / cnt)
    return torch.minimum(cnt / tau, cnt)[..., 0]


def masked_rhat(chains: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Split-R-hat over the valid rows of capacity-padded chains:
    (..., C, n, d) and a (..., n) mask -> (..., d). The valid draws, in
    buffer order, split into two halves of floor(count / 2) rows by
    valid rank (with an all-valid buffer, :func:`rhat`'s fixed split);
    NaN below 4 valid draws."""
    dt = chains.dtype
    c_ch = chains.shape[-3]
    mk = mask.to(dt)
    cnt = torch.sum(mk, dim=-1)
    h = torch.floor(cnt / 2.0)
    hf = torch.clamp(h, min=1.0)
    rank = torch.cumsum(mk, dim=-1) - mk  # valid rank of each row
    m1 = mk * (rank < h[..., None]).to(dt)
    m2 = mk * ((rank >= h[..., None]) & (rank < 2.0 * h[..., None])).to(dt)

    def half_stats(mh):
        w = mh[..., None, :, None]  # (..., 1, n, 1)
        mean = torch.sum(w * chains, dim=-2) / hf[..., None, None]
        dev = (chains - mean[..., None, :]) * w
        var = torch.sum(dev * dev, dim=-2) / torch.clamp(h - 1.0, min=1.0)[..., None, None]
        return mean, var

    mean1, var1 = half_stats(m1)
    mean2, var2 = half_stats(m2)
    means = torch.cat([mean1, mean2], dim=-2)  # (..., 2C, d)
    within = torch.mean(torch.cat([var1, var2], dim=-2), dim=-2)
    mu = torch.mean(means, dim=-2, keepdim=True)
    between = h[..., None] * torch.sum((means - mu) ** 2, dim=-2) / float(2 * c_ch - 1)
    var_est = ((h - 1.0) / hf)[..., None] * within + between / hf[..., None]
    r = torch.sqrt(var_est / torch.clamp(within, min=1e-30))
    return torch.where((h >= 2.0)[..., None], r, torch.full_like(r, float("nan")))
