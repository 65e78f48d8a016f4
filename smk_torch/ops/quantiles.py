"""Posterior compression, interpolation, resampling and summaries —
twin of ``smk_tpu/ops/quantiles.py``.

``torch.quantile`` refuses large inputs, so the type-7 (linear)
quantile here is a sort and a gather, written as the JAX package's
``jnp.quantile`` computes it; ``jnp.interp`` has no torch counterpart
and is rebuilt on ``searchsorted``.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _linspace(start: float, stop: float, num: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace`` in ``dtype``: start * (1 - step) + stop * step
    with step = iota / (num - 1), the stop appended exactly."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    div = num - 1
    # the scalars are filled on the device (no host upload to wait on)
    step = torch.arange(div, dtype=dtype, device=device) / torch.full(
        (), div, dtype=dtype, device=device
    )
    lo = torch.full((), start, dtype=dtype, device=device)
    hi = torch.full((), stop, dtype=dtype, device=device)
    out = lo * (1 - step) + hi * step
    return torch.cat([out, hi[None]])


def quantile_probs(n_quantiles: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """seq(step, 1, step) with step = 1/n_quantiles (R:88)."""
    return _linspace(1.0 / n_quantiles, 1.0, n_quantiles, dtype, device)


def _type7(samples: torch.Tensor, probs: torch.Tensor, dim: int) -> torch.Tensor:
    """Linear-interpolation quantiles of ``samples`` along ``dim`` at
    ``probs``; the quantile axis replaces ``dim``. A column holding a
    NaN is NaN throughout, as ``jnp.quantile`` returns it (a subset
    that quarantine dropped keeps NaN grids, not partly finite ones)."""
    n = samples.shape[dim]
    s = torch.sort(samples, dim=dim).values
    q = probs * (n - 1)
    low = torch.floor(q)
    high = torch.ceil(q)
    high_w = q - low
    low_w = 1 - high_w
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    shape = [1] * samples.dim()
    shape[dim] = -1
    low_v = torch.index_select(s, dim, low)
    high_v = torch.index_select(s, dim, high)
    out = low_v * low_w.reshape(shape) + high_v * high_w.reshape(shape)
    has_nan = torch.isnan(samples).any(dim=dim, keepdim=True)
    return torch.where(has_nan, torch.full_like(out, float("nan")), out)


def quantile_grid(
    samples: torch.Tensor, n_quantiles: int = 200, *, dim: int = 0
) -> torch.Tensor:
    """Compress (..., n_samples, d) draws along ``dim`` to an
    n_quantiles grid at the reference's probabilities."""
    probs = quantile_probs(n_quantiles, samples.dtype, samples.device)
    return _type7(samples, probs, dim)


def interp_quantile_grid(grid: torch.Tensor, out_step: float = 0.001) -> torch.Tensor:
    """Densify a (..., n_q, d) quantile grid onto probs
    seq(1/n_q, 1, out_step) by linear interpolation (R:140,142) —
    ``jnp.interp``'s arithmetic on ``searchsorted``."""
    n_q = grid.shape[-2]
    dt, dev = grid.dtype, grid.device
    src = quantile_probs(n_q, dt, dev)
    lo = float(1.0 / n_q)
    n_out = int(round((1.0 - lo) / out_step)) + 1
    x = _linspace(lo, 1.0, n_out, dt, dev)
    i = torch.clamp(torch.searchsorted(src, x, right=True), 1, n_q - 1)
    fp_hi = torch.index_select(grid, -2, i)
    fp_lo = torch.index_select(grid, -2, i - 1)
    dx = (src[i] - src[i - 1])[:, None]
    delta = (x - src[i - 1])[:, None]
    # jnp.interp's guard: |dx| <= spacing(eps), which is eps^2 (eps is
    # a power of two)
    dx0 = torch.abs(dx) <= torch.finfo(dt).eps ** 2
    safe_dx = torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, fp_lo, fp_lo + (delta / safe_dx) * (fp_hi - fp_lo))
    f = torch.where((x < src[0])[:, None], grid[..., :1, :], f)
    return torch.where((x > src[-1])[:, None], grid[..., -1:, :], f)


def resample_index(
    generator: torch.Generator, n_draws: int, n_grid: int, device
) -> torch.Tensor:
    """Uniform row indices in [0, n_grid) for :func:`inverse_cdf_resample`."""
    return torch.randint(
        0, n_grid, (n_draws,), generator=generator, device=device
    )


def inverse_cdf_resample(
    index: torch.Tensor, dense_grids: Sequence[torch.Tensor]
) -> list:
    """Rows ``index`` of every densified grid: ONE index vector shared
    by all grids keeps the cross-quantity coupling (R:141,145-146)."""
    return [g[index, :] for g in dense_grids]


def credible_probs(dtype=torch.float32, device=None) -> torch.Tensor:
    """The probabilities of :func:`credible_summary`'s rows, as a tensor
    (a host-to-device copy on the card: a caller on a hot path builds it
    once and passes it)."""
    return torch.tensor([0.5, 0.025, 0.975], dtype=dtype, device=device)


def credible_summary(samples: torch.Tensor, probs=None) -> torch.Tensor:
    """(3, d) rows = [median, 2.5%, 97.5%] per column (R:163-165);
    ``probs``: :func:`credible_probs` in ``samples``' dtype and device,
    built here when not given."""
    if probs is None:
        probs = credible_probs(samples.dtype, samples.device)
    return _type7(samples, probs, 0)


def masked_quantile_grid(samples: torch.Tensor, mask: torch.Tensor,
                         n_quantiles: int = 200) -> torch.Tensor:
    """:func:`quantile_grid` over the valid rows of a capacity buffer
    (the adaptive schedule's partly filled draws): ``samples`` (..., n,
    d), ``mask`` (..., n) true where a row holds a draw. Invalid rows
    sort to +inf, and the type-7 index h = p (count - 1) is gathered
    from the valid prefix; with an all-valid mask this is the linear
    quantile exactly (the twin's ``masked_quantile_grid``)."""
    dt = samples.dtype
    mk = mask.to(torch.bool)
    cnt_i = torch.clamp(torch.sum(mk.to(torch.int64), dim=-1), min=1)  # (...,)
    cnt = cnt_i.to(dt)
    x = torch.where(mk[..., None], samples, torch.full_like(samples, float("inf")))
    s = torch.sort(x, dim=-2).values
    probs = quantile_probs(n_quantiles, dt, samples.device)
    h = probs * (cnt[..., None] - 1.0)  # (..., n_q)
    lo = torch.floor(h).to(torch.int64)
    hi = torch.minimum(lo + 1, cnt_i[..., None] - 1)  # never read the +inf tail
    frac = (h - lo.to(dt))[..., None]
    d = samples.shape[-1]
    lo_v = torch.gather(s, -2, lo[..., None].expand(*lo.shape, d))
    hi_v = torch.gather(s, -2, hi[..., None].expand(*hi.shape, d))
    return lo_v + frac * (hi_v - lo_v)
