"""The plain reference of a fit: the meta-kriging algorithm of the
configuration, written out in PyTorch tensor operations, independent of
the port (it imports nothing of ``smk_torch`` and takes nothing the
port made).

What it computes, for the configurations of this benchmark (dense
subsets, exponential correlation, collapsed phi moves every E sweeps,
Nystrom-preconditioned CG u-draw on a bf16-rounded operator, the
inverse-Wishart A prior, probit or logit link, C chains):

1. the random partition along the fit's permutation;
2. the non-spatial GLM warm start by IRLS on the stacked design;
3. per batch row (subset, chain) the Gibbs sweeps: the Albert-Chib or
   Polya-Gamma latent, beta, per component the collapsed phi move
   (Metropolis on the marginal of the latent with u_j integrated out)
   and the Matheron u_j draw, A by rows with its independence test,
   and on kept sweeps the kriging draw at the test sites;
4. 200-quantile grids of each subset's kept draws, their mean over the
   subsets, the resample of the combined grids and p(y = 1) at the test
   sites with its median and 95 % bounds.

``knobs`` refuses, with a ValueError naming the key, a configuration
outside this path (``PATH``): such a configuration names a reference
of its own (harness/spec.py).

The random numbers are the port's default ones, drawn again by
``noise.py``'s frozen copy of their layout from the same seed.
Distances are summed coordinate by coordinate; every matrix
product is a plain ``torch`` product in the precision the caller sets
(float32 with TF32 off as the configuration states; the control turns
TF32 on). The latent's inverse CDF is taken in float64.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
from torch.special import log_ndtr, ndtr, ndtri

NYSTROM_JITTER = 1e-4  # K_rr's jitter in the Nystrom factor
CG_EPS = 1e-20  # the CG step's guard
# The path this reference computes: for each sampler setting its value,
# and the port's default (smk_torch/config.SMKConfig), which is what a
# configuration that leaves the key out runs; the priors' likewise.
PATH = {
    "cov_model": ("exponential", "exponential"),
    "subset_engine": ("dense", "dense"),
    "phi_sampler": ("collapsed", "conditional"),
    "phi_proposals": (1, 1),
    "phi_proposal_family": ("gaussian", "gaussian"),
    "u_solver": ("cg", "chol"),
    "cg_precond": ("nystrom", "jacobi"),
    "dtype": ("float32", "float32"),
    "partition_method": ("random", "random"),
    "build_dtype": ("float32", "float32"),
    "combiner": ("wasserstein_mean", "wasserstein_mean"),
    "adaptive_schedule": ("off", "off"),
}
PRIOR_PATH = {"a_prior": ("invwishart", "invwishart"), "temper": ("none", "none")}


def check_path(s: dict) -> None:
    """A ValueError naming the first setting of sampler fields ``s``
    outside ``PATH``."""
    for fields, path, where in ((s, PATH, ""), (s.get("priors", {}), PRIOR_PATH, "priors.")):
        for key, (want, default) in path.items():
            got = fields.get(key, default)
            if got != want:
                raise ValueError(f"{where}{key}: harness/reference.py computes {want!r} only, "
                                 f"not {got!r}; name the configuration's own reference")


def knobs(cfg: dict) -> dict:
    """The sampler's settings from a configuration file: its ``sampler``
    fields over this module's needs, and the subset size. A ValueError
    for a configuration outside ``PATH``."""
    s = dict(cfg["sampler"])
    check_path(s)
    s.update(n=cfg["n"], q=cfg["q"], p=cfg["p"], t=cfg["t"], n_subsets=cfg["n_subsets"],
             n_samples=cfg["n_samples"])
    s["m"] = -(-cfg["n"] // s["n_subsets"])
    s["n_burn"] = int(s["burn_in_frac"] * s["n_samples"])
    return s


def effective_jitter(s: dict, m: int) -> float:
    return max(s["jitter"], s["jitter_per_m"] * m)


# ----------------------------------------------------------------------
# small pieces
# ----------------------------------------------------------------------
def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances between (..., ma, d) and (..., mb, d), the
    squared differences summed coordinate by coordinate."""
    sq = torch.zeros(a.shape[:-1] + (b.shape[-2],), dtype=a.dtype, device=a.device)
    for c in range(a.shape[-1]):
        diff = a[..., :, None, c] - b[..., None, :, c]
        sq += diff * diff
    return torch.sqrt(sq)


def corr(dist: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Exponential correlation exp(-phi h); ``phi`` broadcasts (B, 1, 1)."""
    return torch.exp(-phi * dist)


def chol_or_nan(mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where ``mat`` is not positive definite."""
    l, info = torch.linalg.cholesky_ex(mat)
    return torch.where((info != 0)[..., None, None], torch.full_like(l, float("nan")), l)


def add_diag(mat: torch.Tensor, diag) -> torch.Tensor:
    out = mat.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(diag)
    return out


def lsolve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L x = b for a vector (..., m) or a matrix (..., m, n) b."""
    if b.dim() == l.dim() - 1:
        return torch.linalg.solve_triangular(l, b[..., None], upper=False)[..., 0]
    return torch.linalg.solve_triangular(l, b, upper=False)


def ltsolve(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^T x = b."""
    if b.dim() == l.dim() - 1:
        return torch.linalg.solve_triangular(l.mT, b[..., None], upper=True)[..., 0]
    return torch.linalg.solve_triangular(l.mT, b, upper=True)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def truncated_normal(u: torch.Tensor, mu: torch.Tensor, positive: torch.Tensor) -> torch.Tensor:
    """N(mu, 1) truncated to (0, inf) where ``positive``, else to
    (-inf, 0], by the inverse CDF of ``u``, taken in float64:
    z = mu - s Phi^{-1}(u Phi(s mu)), s = +-1."""
    mu64 = mu.double()
    s = torch.where(positive, 1.0, -1.0).double()
    x = ndtri(torch.exp(torch.log(u.double()) + log_ndtr(s * mu64)))
    z = (mu64 - s * x).to(mu.dtype)
    return torch.where(positive, torch.clamp(z, min=1e-7), torch.clamp(z, max=-1e-7))


def polya_gamma(g: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """PG(1, c) from its series with the Gamma(1, 1) terms ``g``
    (n_terms leading), the dropped tail replaced by its mean."""
    n_terms = g.shape[0]
    a = torch.abs(c) / (2.0 * math.pi)
    k = torch.arange(1, n_terms + 1, dtype=c.dtype, device=c.device) - 0.5
    denom = k.reshape((n_terms,) + (1,) * c.dim()) ** 2 + a[None] ** 2
    a_safe = torch.clamp(a, min=1e-12)
    tail = torch.arctan(a_safe / n_terms) / a_safe
    return (torch.sum(g / denom, dim=0) + tail) / (2.0 * math.pi * math.pi)


def quantiles_np(draws: np.ndarray, probs: np.ndarray, axis: int) -> np.ndarray:
    """Type-7 (linear) quantiles along ``axis``."""
    return np.quantile(draws, probs, axis=axis, method="linear")


def grid_probs(n_q: int) -> np.ndarray:
    return np.linspace(1.0 / n_q, 1.0, n_q)


# ----------------------------------------------------------------------
# warm start
# ----------------------------------------------------------------------
def glm_warm_start(y: torch.Tensor, x: torch.Tensor, link: str, n_iter: int = 26,
                   ridge: float = 1e-6) -> torch.Tensor:
    """(q, p) MLE of the stacked binary GLM (responses stacked
    response-major, the design block-diagonal) by ``n_iter`` IRLS steps
    from 0, each with a ``ridge`` on the information."""
    n, q, p = x.shape
    yl = y.T.reshape(-1)
    xl = torch.zeros((q * n, q * p), dtype=x.dtype, device=x.device)
    for j in range(q):
        xl[j * n:(j + 1) * n, j * p:(j + 1) * p] = x[:, j, :]
    beta = torch.zeros(q * p, dtype=x.dtype, device=x.device)
    eye = torch.eye(q * p, dtype=x.dtype, device=x.device)
    for _ in range(n_iter):
        eta = xl @ beta
        if link == "logit":
            mu = torch.sigmoid(eta)
            dmu = mu * (1.0 - mu)
        else:
            mu = ndtr(eta)
            dmu = torch.exp(-0.5 * eta * eta) / math.sqrt(2.0 * math.pi)
        mu = torch.clamp(mu, 1e-6, 1.0 - 1e-6)
        dmu = torch.clamp(dmu, min=1e-8)
        w = dmu * dmu / (mu * (1.0 - mu))
        z = eta + (yl - mu) / dmu
        info = (xl.T * w) @ xl + ridge * eye
        beta = torch.linalg.solve(info, (xl.T * w) @ z)
    return beta.reshape(q, p)


# ----------------------------------------------------------------------
# the sampler over a block of batch rows
# ----------------------------------------------------------------------
class _PhiOps:
    """What the chain keeps for the current phi of each component: the
    factor of R(phi) + jit I, R(phi) rounded to bf16 (the CG operator),
    and the Nystrom factor of R(phi)'s first r columns."""

    def __init__(self, dist: torch.Tensor, phi: torch.Tensor, jit: float, rank: int,
                 bf16: bool):
        r = corr(dist, phi[:, None, None])
        self.rb = bf16_round(r) if bf16 else r
        k_rr = add_diag(r[:, :rank, :rank], NYSTROM_JITTER)
        l_rr = chol_or_nan(k_rr)
        self.z = lsolve(l_rr, r[:, :, :rank].mT).mT  # K_mr L_rr^-T
        self.l = chol_or_nan(add_diag(r, jit))

    def select(self, other: "_PhiOps", acc: torch.Tensor) -> None:
        a = acc[:, None, None]
        self.rb = torch.where(a, other.rb, self.rb)
        self.z = torch.where(a, other.z, self.z)
        self.l = torch.where(a, other.l, self.l)


def _pcg(rb: torch.Tensor, z: torch.Tensor, shift: torch.Tensor, b: torch.Tensor,
         n_iter: int, bf16: bool):
    """``n_iter`` steps of CG from 0 on (R + diag(shift)) x = b, with R
    and the vector it multiplies rounded to bf16 when ``bf16`` (the
    products and sums stay float32), preconditioned by the Woodbury
    inverse of Z Z^T + diag(shift). Returns (x, the product by R)."""
    def apply_r(v):
        return (rb @ (bf16_round(v) if bf16 else v)[..., None])[..., 0]

    s = 1.0 / shift
    w = z * s[..., None]
    eye_r = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    c = chol_or_nan(eye_r + z.mT @ w)

    def precond(v):
        inner = ltsolve(c, lsolve(c, (w.mT @ v[..., None])[..., 0]))
        return s * v - (w @ inner[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b
    zr = precond(r)
    p = zr
    rz = torch.sum(r * zr, dim=-1, keepdim=True)
    for _ in range(n_iter):
        ap = apply_r(p) + shift * p
        alpha = rz / (torch.sum(p * ap, dim=-1, keepdim=True) + CG_EPS)
        x = x + alpha * p
        r = r - alpha * ap
        zr = precond(r)
        rz_new = torch.sum(r * zr, dim=-1, keepdim=True)
        p = zr + (rz_new / (rz + CG_EPS)) * p
        rz = rz_new
    return x, apply_r


def run_rows(s: dict, coords, x, y, coords_test, beta0, noise: Callable):
    """The Gibbs sweeps of the batch rows (subset-major, C chains a
    subset) on the device of the inputs: coords (B, m, 2), x (B, m, q, p),
    y (B, m, q) are those rows' data. ``noise(collect)`` draws the next
    sweep's noise of every row (noise.SweepStreams). Returns (param
    draws (B, n_kept, n_par), w draws (B, n_kept, t q), phi accept
    counts (B, q))."""
    dt, dev = x.dtype, x.device
    b_rows, m, q, p = x.shape
    t = coords_test.shape[0]
    jit = effective_jitter(s, m)
    pri = s["priors"]
    lo_phi, hi_phi = pri["phi_min"], pri["phi_max"]
    big = s["mask_noise_var"]
    rank = min(s["cg_precond_rank"], m)
    every = s["phi_update_every"]
    bf16 = s["cg_matvec_dtype"] == "bfloat16"
    f32 = np.float32

    dist = sq_dist(coords, coords)
    dist.diagonal(dim1=-2, dim2=-1).zero_()
    dist_c = sq_dist(coords, coords_test[None])
    dist_t = sq_dist(coords_test, coords_test)

    beta = beta0.to(dt).expand(b_rows, q, p).clone()
    u = torch.zeros((b_rows, m, q), dtype=dt, device=dev)
    a = torch.eye(q, dtype=dt, device=dev).expand(b_rows, q, q).clone()
    phi0 = min(max(3.0 / 0.5, lo_phi + 1e-3 * (hi_phi - lo_phi)), hi_phi - 1e-3 * (hi_phi - lo_phi))
    phi = torch.full((b_rows, q), phi0, dtype=dt, device=dev)
    ops = [_PhiOps(dist, phi[:, j], jit, rank, bf16) for j in range(q)]
    log_step = torch.full((b_rows, q), float(np.log(f32(s["phi_step"]))), dtype=dt, device=dev)
    n_acc = torch.zeros((b_rows, q), dtype=dt, device=dev)
    nu = pri["iw_df"] if pri["iw_df"] > 0 else q
    prior_prec = 1.0 / float(f32(pri["a_scale"])) ** 2
    tril_r, tril_c = torch.tril_indices(q, q, device=dev)
    eye_q = torch.eye(q, dtype=dt, device=dev)
    jac_w = (q - torch.arange(q, device=dev)).to(dt)
    n_samples, n_burn = s["n_samples"], s["n_burn"]
    par_draws, w_draws = [], []

    def log_prior_ratio(a_mat):
        diag = torch.abs(torch.diagonal(a_mat, dim1=-2, dim2=-1)) + 1e-30
        a_inv = lsolve(a_mat, eye_q.expand_as(a_mat))
        lp_iw = (-0.5 * (nu + q + 1) * 2.0 * torch.sum(torch.log(diag), -1)
                 - 0.5 * pri["iw_scale"] * torch.sum(a_inv * a_inv, dim=(-2, -1)))
        lp_n = -0.5 * prior_prec * torch.sum(a_mat[:, tril_r, tril_c] ** 2, dim=-1)
        return lp_iw + torch.sum(jac_w * torch.log(diag), -1) - lp_n

    for it in range(n_samples):
        collect = it >= n_burn
        if it == n_burn:
            n_acc = torch.zeros_like(n_acc)
        nz = noise(collect)
        # 1. the latent
        w_cur = torch.einsum("bmj,blj->bml", u, a)
        mu = torch.einsum("bmqp,bqp->bmq", x, beta) + w_cur
        if s["link"] == "probit":
            zbar = truncated_normal(nz["kz"], mu, y > 0)
            wom = torch.ones_like(mu)
        else:
            om = polya_gamma(nz["kz"].movedim(1, 0), mu)
            zbar = (y - 0.5) / om
            wom = om
        # 2. beta
        prec_b = torch.einsum("bmqp,bmq,bmqr->bqpr", x, wom, x)
        l_b = chol_or_nan(add_diag(prec_b, 1.0 / pri["beta_scale"] ** 2))
        rhs = torch.einsum("bmqp,bmq->bqp", x, wom * (zbar - w_cur))
        beta = ltsolve(l_b, lsolve(l_b, rhs)) + ltsolve(l_b, nz["kb"])
        e0 = zbar - torch.einsum("bmqp,bqp->bmq", x, beta)
        # 3-4. per component: the collapsed phi move, then u_j
        update = it % every == 0
        accepted = torch.zeros((b_rows, q), dtype=dt, device=dev)
        u = u.clone()
        for j in range(q):
            a_j = a[:, :, j]
            part = e0 - torch.einsum("bmi,bli->bml", u, a) + u[:, :, j, None] * a_j[:, None, :]
            c = torch.einsum("bml,bl->bm", wom, a_j * a_j)
            bv = torch.einsum("bml,bl->bm", wom * part, a_j)
            c = torch.clamp(c, min=float(f32(1.0) / f32(big)))
            ytil = bv / c
            d = torch.clamp(1.0 / c, max=big)
            shift = jit + d
            if update:
                t_cur = torch.log((phi[:, j] - lo_phi) / (hi_phi - phi[:, j]))
                t_prop = t_cur + torch.exp(log_step[:, j]) * nz["kprop"][:, j]
                phi_prop = lo_phi + (hi_phi - lo_phi) * torch.sigmoid(t_prop)

                def marginal(ph):
                    l_s = chol_or_nan(add_diag(corr(dist, ph[:, None, None]), shift))
                    al = lsolve(l_s, ytil)
                    diag = torch.diagonal(l_s, dim1=-2, dim2=-1)
                    return -0.5 * torch.sum(al * al, -1) - torch.sum(torch.log(diag), -1)

                def log_jac(tt):
                    sg = torch.sigmoid(tt)
                    return torch.log(sg * (1.0 - sg))

                log_ratio = (marginal(phi_prop) + log_jac(t_prop)
                             - marginal(phi[:, j]) - log_jac(t_cur))
                prop = _PhiOps(dist, phi_prop, jit, rank, bf16)
                ok = torch.all(torch.isfinite(torch.diagonal(prop.l, dim1=-2, dim2=-1)), -1)
                acc = (torch.log(nz["kphi"][:, j]) < log_ratio) & ok
                ops[j].select(prop, acc)
                del prop
                phi = phi.clone()
                phi[:, j] = torch.where(acc, phi_prop, phi[:, j])
                accepted[:, j] = acc.to(dt)
            oj = ops[j]
            u_star = (oj.l @ nz["ku_prior"][:, j, :, None])[..., 0]
            rhs_u = ytil - u_star - torch.sqrt(d) * nz["ku_noise"][:, j]
            sol, apply_r = _pcg(oj.rb, oj.z, shift, rhs_u, s["cg_iters"], bf16)
            u[:, :, j] = u_star + apply_r(sol) + jit * sol
        n_acc = n_acc + accepted
        if s["phi_adapt"] and not collect:
            gain = f32(s["phi_adapt_rate"]) * (f32(1.0) + f32(it) / f32(every)) ** f32(-0.6)
            gain = float(gain * f32(1.0 if update else 0.0))
            log_step = torch.clamp(log_step + gain * (accepted - s["phi_target_accept"]),
                                   float(np.log(f32(1e-3))), float(np.log(f32(50.0))))
        # 5. A by rows, then its independence test under the IW prior
        a_new = torch.zeros_like(a)
        for l in range(q):
            u_sub = u[:, :, :l + 1]
            prec = u_sub.mT @ (wom[:, :, l, None] * u_sub)
            l_p = chol_or_nan(add_diag(prec, prior_prec + s["jitter"]))
            mean = ltsolve(l_p, lsolve(l_p, torch.einsum("bmi,bm->bi", u_sub, wom[:, :, l] * e0[:, :, l])))
            a_new[:, l, :l + 1] = mean + ltsolve(l_p, nz["ka"][:, l, :l + 1])
        acc_a = torch.log(nz["ka_u"]) < log_prior_ratio(a_new) - log_prior_ratio(a)
        a = torch.where(acc_a[:, None, None], a_new, a)
        if not collect:
            continue
        # 6. the kriging draw at the test sites
        ust = torch.empty((b_rows, q, t), dtype=dt, device=dev)
        for j in range(q):
            rc = corr(dist_c, phi[:, j, None, None])
            rt = corr(dist_t[None], phi[:, j, None, None])
            wk = ltsolve(ops[j].l, lsolve(ops[j].l, rc))
            l_c = chol_or_nan(add_diag(rt - rc.mT @ wk, jit))
            ust[:, j] = torch.einsum("bmt,bm->bt", wk, u[:, :, j]) + (l_c @ nz["kpred"][:, j, :, None])[..., 0]
        w_star = torch.einsum("bqt,blq->btl", ust, a).reshape(b_rows, -1)
        k_mat = a @ a.mT
        par_draws.append(torch.cat([beta.reshape(b_rows, -1), k_mat[:, tril_r, tril_c], phi], -1))
        w_draws.append(w_star)
    return torch.stack(par_draws, 1), torch.stack(w_draws, 1), n_acc


# ----------------------------------------------------------------------
# the whole fit
# ----------------------------------------------------------------------
def partition(perm: torch.Tensor, k: int, arrays):
    """Each array's rows along ``perm``, reshaped to (K, m, ...)."""
    n = perm.shape[0]
    if n % k:
        raise ValueError(f"the reference partitions n = {n} into K = {k} equal subsets only")
    idx = perm.reshape(k, n // k)
    return [a[idx] for a in arrays]


def fit(cfg: dict, inputs, perm: torch.Tensor, resample_idx: torch.Tensor,
        noise: Optional[Callable], device, subset_grids: Optional[tuple] = None) -> dict:
    """The reference fit of configuration ``cfg`` on ``inputs`` (numpy
    y, x, coords, coords_test, x_test) on ``device``. ``noise(collect)``:
    the next sweep's noise of every batch row (noise.SweepStreams).
    ``subset_grids``: (param, w) subset grids to combine in place of the
    reference's own (the check of the combine stage alone).

    Returns numpy arrays: ``subset_param_grid`` (K, n_q, n_par),
    ``subset_w_grid`` (K, n_q, t q), ``param_grid`` and ``w_grid``
    (n_q, .) combined, ``p_samples`` (S, t q), ``p_quant`` (3, t q),
    ``param_quant`` (3, n_par), ``phi_accept_rate`` (K, q)."""
    s = knobs(cfg)
    k, c, q = s["n_subsets"], s["n_chains"], s["q"]
    out = {}
    if subset_grids is None:
        dev = torch.device(device)
        y, x, coords, coords_test, x_test = (torch.as_tensor(a, device=dev) for a in inputs)
        beta0 = glm_warm_start(y, x, s["link"])
        yk, xk, ck = partition(perm.to(dev), k, (y, x, coords))
        if c > 1:
            yk, xk, ck = (torch.repeat_interleave(a_, c, dim=0) for a_ in (yk, xk, ck))
        pd, wd, acc = (a_.cpu().double().numpy()
                       for a_ in run_rows(s, ck, xk, yk, coords_test, beta0, noise))
        n_kept = pd.shape[1]
        n_upd = max(sum(1 for i in range(s["n_burn"], s["n_samples"]) if i % s["phi_update_every"] == 0), 1)
        pooled_p = pd.reshape(k, c * n_kept, -1)
        pooled_w = wd.reshape(k, c * n_kept, -1)
        probs = grid_probs(s["n_quantiles"])
        sp = np.moveaxis(quantiles_np(pooled_p, probs, 1), 0, 1)
        sw = np.moveaxis(quantiles_np(pooled_w, probs, 1), 0, 1)
        out["phi_accept_rate"] = (acc / n_upd).reshape(k, c, q).mean(1)
        x_test_np = inputs[4].astype(np.float64)
    else:
        sp, sw = (np.asarray(g, np.float64) for g in subset_grids)
        x_test_np = np.asarray(inputs[4], np.float64)
    out["subset_param_grid"], out["subset_w_grid"] = sp, sw
    out.update(combine_predict(s, sp, sw, x_test_np, resample_idx.cpu().numpy()))
    return out


def combine_predict(s: dict, sp: np.ndarray, sw: np.ndarray, x_test: np.ndarray,
                    index: np.ndarray) -> dict:
    """Mean of the subsets' quantile grids, densified to the grid step,
    the rows ``index`` of both, p(y = 1) at the test sites and the
    credible summaries (median, 2.5 %, 97.5 %)."""
    n_q = s["n_quantiles"]
    pg, wg = sp.mean(0), sw.mean(0)
    src = grid_probs(n_q)
    n_out = int(round((1.0 - 1.0 / n_q) / s["interp_grid_step"])) + 1
    dense_x = np.linspace(1.0 / n_q, 1.0, n_out)

    def dense(g):
        return np.stack([np.interp(dense_x, src, g[:, i]) for i in range(g.shape[1])], 1)

    sample_par, sample_w = dense(pg)[index], dense(wg)[index]
    t, q, p = x_test.shape
    betas = sample_par[:, :q * p].reshape(-1, q, p)
    eta = np.einsum("tqp,sqp->stq", x_test, betas).reshape(len(index), -1) + sample_w
    if s["link"] == "probit":
        p_s = ndtr(torch.from_numpy(eta)).numpy()
    else:
        p_s = 1.0 / (1.0 + np.exp(-eta))
    cp = np.array([0.5, 0.025, 0.975])
    return {
        "param_grid": pg, "w_grid": wg, "p_samples": p_s,
        "p_quant": quantiles_np(p_s, cp, 0), "param_quant": quantiles_np(sample_par, cp, 0),
    }
