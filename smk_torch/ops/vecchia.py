"""Vecchia / NNGP sparse-precision subset engine — twin of
``smk_tpu/ops/vecchia.py``, K-batched: every tensor carries the leading
axes of its batch (the K subsets, and the q components where a
function takes them) before the site axis.

Each site conditions on at most ``nn`` predecessors in the subset's
row order, which factors the subset precision as Q = F^T F with
F = D^{-1}(I - B): B holds per-site neighbor coefficients (m, nn) and D
the conditional standard deviations (m,). Everything is O(m nn^3)
flops and O(m nn) memory per subset: one batched (nn, nn) Cholesky per
site instead of one (m, m) factor.

Masking law (the twin's, which every function here keeps): invalid
neighbor slots (past a site's predecessor count, pointing at a pad row,
or any slot of a pad site) carry coefficient b = 0 and identity rows
and columns in the (nn, nn) conditioning block, so a pad site gets
d = sqrt(1 + jitter), phi-free, and cancels in MH ratios. Distances of
invalid candidates are the finite ``LARGE`` (never inf: inf * 0 = nan
under the masking arithmetic) and validity is recovered as
dist < LARGE / 2.

The neighbor indices are int64 (the twin's are int32): torch gathers
take int64 indices. The adjoint F^T and the diagonal of Q add each
site's slot values into the sites they point at, which the twin does
with a scatter-add (``.at[].add``). On the card a scatter-add sums with
float atomics in no fixed order, so two runs of one seeded chain would
differ in their last bits. Here the sum is a gather instead: the
reverse neighbor lists (:func:`reverse_neighbors`, built once per
geometry) name, for each site, the slots that point at it, and each
site sums its slots in one fixed order, so a chain repeats bit for bit.
An invalid slot points at its own site (any in-range index will do,
since its coefficient is 0), which bounds what it adds to a site's list
by nn.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from smk_torch.ops.cg import cg_solve
from smk_torch.ops.chol import cholesky, tri_solve
from smk_torch.ops.distance import cross_distance, pairwise_distance
from smk_torch.ops.kernels import correlation

# Finite sentinel for masked-out candidate distances: exp(-phi * 1e10)
# underflows to exactly 0 in float32 for every admissible phi.
LARGE = 1e10

# Conditional-variance floor: (1 + jit) - alpha'alpha can round below
# zero for near-duplicate sites; the floor keeps d finite.
_DVAR_FLOOR = 1e-10


def _gather_sites(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v at the neighbor indices: v (K, *mid, m), idx (K, r, nn) ->
    (K, *mid, r, nn), the same indices for every middle row."""
    k, r, nn = idx.shape
    mid = v.shape[1:-1]
    flat = idx.reshape((k,) + (1,) * len(mid) + (r * nn,)).expand(v.shape[:-1] + (r * nn,))
    return torch.gather(v, -1, flat).reshape(v.shape[:-1] + (r, nn))


def reverse_neighbors(nbr_idx: torch.Tensor) -> torch.Tensor:
    """(K, m, D) reverse neighbor lists of nbr_idx (K, m, nn): row j holds
    the flat slot positions i * nn + s with nbr_idx[i, s] = j, ascending,
    padded with m * nn (a slot that holds 0); D is the largest number of
    slots pointing at one site. Integer bookkeeping only, so it is the
    same on every device; one host read (D)."""
    k, m, nn = nbr_idx.shape
    flat = nbr_idx.reshape(k, m * nn)
    deg = torch.zeros((k, m), dtype=torch.long, device=flat.device)
    deg.scatter_add_(-1, flat, torch.ones_like(flat))
    d_max = int(deg.max())
    order = torch.argsort(flat, dim=-1, stable=True)  # slots grouped by target
    target = torch.gather(flat, -1, order)
    rank = torch.arange(m * nn, device=flat.device) - torch.gather(
        torch.cumsum(deg, -1) - deg, -1, target)
    rev = torch.full((k, m * d_max), m * nn, dtype=torch.long, device=flat.device)
    rev.scatter_(-1, target * d_max + rank, order)
    return rev.reshape(k, m, d_max)


def _sum_into_sites(src: torch.Tensor, rev: torch.Tensor) -> torch.Tensor:
    """For each site, the sum of the slot values ``src`` (K, *mid, m, nn)
    of the slots pointing at it (``rev`` from :func:`reverse_neighbors`),
    in the lists' order: (K, *mid, m)."""
    k, m, d = rev.shape
    mid = src.shape[1:-2]
    flat = src.reshape(src.shape[:-2] + (-1,))
    flat = torch.cat([flat, flat.new_zeros(flat.shape[:-1] + (1,))], dim=-1)
    idx = rev.reshape((k,) + (1,) * len(mid) + (m * d,)).expand(flat.shape[:-1] + (m * d,))
    return torch.gather(flat, -1, idx).reshape(src.shape[:-2] + (m, d)).sum(dim=-1)


# candidates sorted in one call at most: bounds the sort's values and
# int64 indices to ~0.75 GB whatever K and m are
_SORT_ELEMENTS = 1 << 26


def _nearest(cand: torch.Tensor, nn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist, idx) of the nn smallest candidates of each row, ascending,
    equal values in index order: the twin's ``lax.top_k(-cand, nn)``.
    ``torch.topk`` leaves the order of equal values unspecified, and the
    norm-trick distances are quantized finely enough in fp32 that equal
    candidates do occur among a site's nearest (chip_smoke.py counts
    them at config5), so the rows are sorted stably and sliced instead,
    a few subsets at a time (at most _SORT_ELEMENTS candidates a call)."""
    step = max(1, _SORT_ELEMENTS // max(1, cand[0].numel()))
    vals, idx = [], []
    for chunk in cand.split(step):
        srt = torch.sort(chunk, dim=-1, stable=True)
        vals.append(srt.values[..., :nn].clone())
        idx.append(srt.indices[..., :nn].clone())
        del srt
    return torch.cat(vals), torch.cat(idx)


def _block_distances(coords: torch.Tensor, idx: torch.Tensor, sites: torch.Tensor):
    """(K, r, nn+1, nn+1) pairwise distances of each block [neighbors...,
    site]: coords (K, m, d), idx (K, r, nn), sites (K, r, d)."""
    k = coords.shape[0]
    nbrs = coords[torch.arange(k, device=coords.device)[:, None, None], idx]
    return pairwise_distance(torch.cat([nbrs, sites[:, :, None, :]], dim=2))


def build_neighbor_consts(
    coords: torch.Tensor, mask: torch.Tensor, nn: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-site predecessor neighbor sets over K padded subsets.

    coords: (K, m, d) in each subset's row order; mask: (K, m) 1.0 real
    / 0.0 pad. Returns (nbr_idx (K, m, nn) int64, nbr_dist
    (K, m, nn+1, nn+1), nbr_valid (K, m, nn)) as the twin: the nn
    nearest valid predecessors of each site, the pairwise distances of
    the block [neighbors..., site] (garbage at invalid slots, which the
    identity masking of vecchia_coeffs discards), and 1.0 where a slot
    holds a real neighbor. An invalid slot points at its own site. The
    (K, m, m) candidate distance matrix is a transient, overwritten in
    place by its masking."""
    m = coords.shape[-2]
    cand = pairwise_distance(coords)
    valid = mask > 0
    idx = torch.arange(m, device=coords.device)
    predecessor = idx[None, :] < idx[:, None]
    cand.masked_fill_(~(predecessor[None] & valid[:, None, :]), LARGE)
    nbr_d, nbr_idx = _nearest(cand, nn)
    del cand
    ok = (nbr_d < LARGE / 2) & valid[..., None]
    nbr_idx = torch.where(ok, nbr_idx, idx[None, :, None])  # invalid: the site itself
    nbr_dist = _block_distances(coords, nbr_idx, coords)
    return nbr_idx, nbr_dist, ok.to(coords.dtype)


def build_test_neighbor_consts(
    coords: torch.Tensor, mask: torch.Tensor, coords_test: torch.Tensor, nn: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest observed neighbor sets of the t test sites (shared by the
    K subsets): every real row is admissible (no predecessor rule).
    coords: (K, m, d); mask: (K, m); coords_test: (t, d). Returns
    (tnbr_idx (K, t, nn) int64, tnbr_dist (K, t, nn+1, nn+1),
    tnbr_valid (K, t, nn)) under the same masking law."""
    k = coords.shape[0]
    cand = cross_distance(coords_test[None], coords)  # (K, t, m)
    cand.masked_fill_(~(mask[:, None, :] > 0), LARGE)
    tnbr_d, tnbr_idx = _nearest(cand, nn)
    tnbr_valid = (tnbr_d < LARGE / 2).to(coords.dtype)
    sites = coords_test[None].expand(k, -1, -1)
    return tnbr_idx, _block_distances(coords, tnbr_idx, sites), tnbr_valid


def vecchia_coeffs(
    nbr_dist: torch.Tensor,
    nbr_valid: torch.Tensor,
    phi: torch.Tensor,
    jitter: float,
    model: str,
    build_dtype: str = "float32",
) -> torch.Tensor:
    """Packed Vecchia coefficients (..., m, nn+1): columns [0:nn] the
    conditional-mean coefficients b (zero at invalid slots), column nn
    the conditional standard deviation d.

    nbr_dist: (..., m, nn+1, nn+1) block distances [neighbors..., site];
    nbr_valid: (..., m, nn); phi: one decay per leading index, its shape
    broadcasting against the leading axes (``...``) of both. Per site:
    C = corr(N, N) + jit I (invalid rows/cols -> identity),
    c = corr(N, site) (invalid -> 0), alpha = L^{-1} c, b = L^{-T} alpha,
    d = sqrt((1 + jit) - alpha'alpha). A block that is not positive
    definite gives NaN coefficients, as the twin's factor does.

    build_dtype "bfloat16" evaluates the correlation in bf16 and
    upcasts before the factor (build in bf16, factor and accumulate in
    fp32), as the twin."""
    nn = nbr_valid.shape[-1]
    phi = phi[..., None, None, None]
    if build_dtype == "bfloat16":
        corr = correlation(
            nbr_dist.to(torch.bfloat16), phi.to(torch.bfloat16), model
        ).to(nbr_dist.dtype)
    else:
        corr = correlation(nbr_dist, phi, model)
    c_site = corr[..., :nn, nn] * nbr_valid
    vv = nbr_valid[..., :, None] * nbr_valid[..., None, :]
    eye = torch.eye(nn, dtype=corr.dtype, device=corr.device)
    c_nn = vv * corr[..., :nn, :nn] + (1.0 - vv) * eye + jitter * eye
    chol = cholesky(c_nn)
    alpha = tri_solve(chol, c_site)
    b = tri_solve(chol, alpha, trans=True) * nbr_valid
    dvar = (1.0 + jitter) - torch.sum(alpha * alpha, dim=-1)
    d = torch.sqrt(torch.clamp(dvar, min=_DVAR_FLOOR))
    return torch.cat([b, d[..., None]], dim=-1)


def unpack_coeffs(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split packed (..., m, nn+1) coefficients into (b (..., m, nn),
    d (..., m))."""
    return packed[..., :-1], packed[..., -1]


def vecchia_f_matvec(packed: torch.Tensor, nbr_idx: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """F v with F = D^{-1}(I - B): (v_i - b_i . v_{N(i)}) / d_i.
    packed: (K, *mid, m, nn+1); nbr_idx: (K, m, nn); v: (K, *mid, m)."""
    b, d = unpack_coeffs(packed)
    return (v - torch.sum(b * _gather_sites(v, nbr_idx), dim=-1)) / d


def vecchia_ft_matvec(packed: torch.Tensor, nbr_idx: torch.Tensor, w: torch.Tensor,
                      rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F^T w, the adjoint of :func:`vecchia_f_matvec` (the twin's
    scatter-add, summed through the reverse lists ``rev``, built here
    when not given)."""
    if rev is None:
        rev = reverse_neighbors(nbr_idx)
    b, d = unpack_coeffs(packed)
    wd = w / d
    return wd + _sum_into_sites(-(b * wd[..., None]), rev)


def vecchia_q_matvec(packed: torch.Tensor, nbr_idx: torch.Tensor, v: torch.Tensor,
                     rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Q v = F^T (F v), the sparse precision applied in O(m nn)."""
    return vecchia_ft_matvec(packed, nbr_idx, vecchia_f_matvec(packed, nbr_idx, v), rev)


def vecchia_loglik(packed: torch.Tensor, nbr_idx: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """log N(u | 0, Q^{-1}) up to the phi-free constant, over the site
    axis: -0.5 |F u|^2 - sum log d. Pad sites add a phi-free term
    (b = 0, d = sqrt(1 + jit)) that cancels in MH ratios. Returns the
    leading shape of ``u`` without its site axis."""
    resid = vecchia_f_matvec(packed, nbr_idx, u)
    return -0.5 * torch.sum(resid * resid, dim=-1) - torch.sum(torch.log(packed[..., -1]), dim=-1)


def vecchia_q_diag(packed: torch.Tensor, nbr_idx: torch.Tensor,
                   rev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """diag(Q) = 1/d_i^2 + the sum over sites i with j in N(i) of
    (b_is / d_i)^2: the Jacobi preconditioner of the posterior CG."""
    if rev is None:
        rev = reverse_neighbors(nbr_idx)
    b, d = unpack_coeffs(packed)
    return 1.0 / (d * d) + _sum_into_sites((b / d[..., None]) ** 2, rev)


def vecchia_posterior_draw(
    packed: torch.Tensor,
    nbr_idx: torch.Tensor,
    b_vec: torch.Tensor,
    c_safe: torch.Tensor,
    eps_prior: torch.Tensor,
    eps_noise: torch.Tensor,
    cg_iters: int,
    rev: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One draw from N(P^{-1} b_vec, P^{-1}), P = Q + diag(c_safe), by
    perturbation: rhs = b_vec + F^T eps_prior + sqrt(c_safe) eps_noise
    has covariance P, so u = P^{-1} rhs, solved by ``cg_iters`` steps of
    Jacobi-preconditioned CG with the O(m nn) Q matvec. packed:
    (K, m, nn+1); nbr_idx: (K, m, nn); the vectors (K, m); ``rev``: the
    reverse lists of nbr_idx, built here when not given."""
    if rev is None:
        rev = reverse_neighbors(nbr_idx)
    rhs = b_vec + vecchia_ft_matvec(packed, nbr_idx, eps_prior, rev) + torch.sqrt(c_safe) * eps_noise

    def matvec(v):
        return vecchia_q_matvec(packed, nbr_idx, v, rev) + c_safe * v

    diag = vecchia_q_diag(packed, nbr_idx, rev) + c_safe
    return cg_solve(matvec, rhs, cg_iters, diag=diag)


def vecchia_krige_draw(
    tpacked: torch.Tensor, tnbr_idx: torch.Tensor, u: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """Nearest-neighbor kriging draw at the test sites: per test site
    b . u_{N(site)} + d z, each conditional on its own neighbor set
    (independent across test sites given u, the twin's contract).
    tpacked: (K, *mid, t, nn+1); tnbr_idx: (K, t, nn); u: (K, *mid, m);
    z: (K, *mid, t)."""
    b, d = unpack_coeffs(tpacked)
    return torch.sum(b * _gather_sites(u, tnbr_idx), dim=-1) + d * z
