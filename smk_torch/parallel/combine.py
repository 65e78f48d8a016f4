"""Quantile-grid combiners — twin of ``wasserstein_barycenter``,
``weiszfeld_median`` and ``combine_quantile_grids`` in
``smk_tpu/parallel/combine.py`` (no mesh, no survival mask: those come
with the chunked and multi-GPU executors, ROADMAP A8/A9)."""

from __future__ import annotations

import torch


def wasserstein_barycenter(grids: torch.Tensor) -> torch.Tensor:
    """Mean of (K, n_q, d) quantile grids over K (R:123-133)."""
    return torch.mean(grids, dim=0)


def weiszfeld_median(
    grids: torch.Tensor, n_iter: int = 50, eps: float = 1e-8
) -> torch.Tensor:
    """W2 geometric median of (K, n_q, d) quantile grids, per column d,
    by Weiszfeld iterations from the barycenter with the Vardi–Zhang
    guard for an iterate that lands on one of the curves (see the
    twin's docstring). All d columns iterate together."""
    curves = torch.movedim(grids, -1, 0)  # (d, K, n_q)
    scale = torch.clamp(torch.amax(torch.abs(curves), dim=(1, 2)), min=1.0)
    tol = (eps ** 0.5 * scale)[:, None]  # (d, 1)
    tiny = (eps * scale)[:, None]
    y = torch.mean(curves, dim=1)  # (d, n_q)
    for _ in range(n_iter):
        diff = curves - y[:, None]
        dist = torch.sqrt(torch.sum(diff ** 2, dim=2))  # (d, K)
        near = dist < tol
        w = torch.where(near, 0.0, 1.0 / torch.maximum(dist, tol))
        wsum = torch.sum(w, dim=1, keepdim=True)
        t_y = torch.sum(w[..., None] * curves, dim=1) / torch.maximum(wsum, tiny)
        r = torch.sum(w[..., None] * diff, dim=1)
        rnorm = torch.sqrt(torch.sum(r ** 2, dim=1, keepdim=True))
        eta = torch.sum(near.to(curves.dtype), dim=1, keepdim=True)
        gamma = torch.clamp(eta / torch.maximum(rnorm, tiny), max=1.0)
        y_next = (1.0 - gamma) * t_y + gamma * y
        y = torch.where(wsum > 0, y_next, y)
    return torch.movedim(y, 0, -1)


def combine_quantile_grids(
    grids: torch.Tensor,
    method: str = "wasserstein_mean",
    *,
    n_iter: int = 50,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Dispatch on the configured combiner."""
    if method == "wasserstein_mean":
        return wasserstein_barycenter(grids)
    if method == "weiszfeld_median":
        return weiszfeld_median(grids, n_iter=n_iter, eps=eps)
    raise ValueError(f"unknown combiner {method!r}")
