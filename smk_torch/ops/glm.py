"""Non-spatial binomial GLM by IRLS — the warm start, twin of
``smk_tpu/ops/glm.py`` (probit and logit links). A fixed number of
Newton/IRLS steps, as the twin's fori_loop."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.special import ndtr

from smk_torch.ops.chol import chol_solve, jittered_cholesky


class GLMFit(NamedTuple):
    coef: torch.Tensor  # (p,)
    vcov: torch.Tensor  # (p, p) inverse Fisher information at the MLE
    converged_delta: torch.Tensor  # last Newton step's max |delta|


def _link_quantities(eta: torch.Tensor, link: str):
    """(p, dp/deta) for the link, clipped for stability."""
    if link == "logit":
        p = 1.0 / (1.0 + torch.exp(-eta))
        dmu = p * (1.0 - p)
    elif link == "probit":
        p = ndtr(eta)
        dmu = torch.exp(-0.5 * eta * eta) / math.sqrt(2.0 * math.pi)
    else:
        raise ValueError(f"unknown link {link!r}")
    return torch.clamp(p, 1e-6, 1.0 - 1e-6), torch.clamp(dmu, min=1e-8)


def irls_glm(
    y: torch.Tensor,
    x: torch.Tensor,
    *,
    weight: float = 1.0,
    link: str = "probit",
    n_iter: int = 25,
    obs_mask: Optional[torch.Tensor] = None,
    ridge: float = 1e-6,
) -> GLMFit:
    """Binomial GLM MLE of y/weight on x (no intercept column added).
    y: (n,) success counts; x: (n, p); obs_mask: optional (n,) {0, 1}."""
    n, p_dim = x.shape
    ybar = (y / weight).to(x.dtype)
    mask = (
        torch.ones((n,), dtype=x.dtype, device=x.device)
        if obs_mask is None
        else obs_mask.to(x.dtype)
    )

    def weights(eta):
        mu, dmu = _link_quantities(eta, link)
        var = mu * (1.0 - mu)
        return mu, dmu, mask * weight * dmu * dmu / var

    def step(beta):
        eta = x @ beta
        mu, dmu, w_work = weights(eta)
        z_work = eta + (ybar - mu) / dmu
        xtw = x.T * w_work[None, :]
        chol_h = jittered_cholesky(xtw @ x, ridge)
        return chol_solve(chol_h, xtw @ z_work)

    beta = torch.zeros((p_dim,), dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        beta = step(beta)
    beta_next = step(beta)
    _, _, w_work = weights(x @ beta_next)
    chol_h = jittered_cholesky((x.T * w_work[None, :]) @ x, ridge)
    vcov = chol_solve(chol_h, torch.eye(p_dim, dtype=x.dtype, device=x.device))
    delta = torch.max(torch.abs(beta_next - beta))
    return GLMFit(coef=beta_next, vcov=vcov, converged_delta=delta)


def glm_warm_start(
    y_stacked: torch.Tensor,
    x_stacked: torch.Tensor,
    *,
    weight: float = 1.0,
    link: str = "probit",
    obs_mask: Optional[torch.Tensor] = None,
) -> GLMFit:
    """Warm start on the stacked multivariate design (the reference's
    one long GLM, R:53): (n_total,) response, block-diagonal
    (n_total, p_total) design."""
    return irls_glm(
        y_stacked, x_stacked, weight=weight, link=link, obs_mask=obs_mask
    )
