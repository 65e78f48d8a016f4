"""Factor-reuse cache — twin of ``smk_tpu/ops/factor_cache.py``.

The phi-dependent solve operators carried beside the sampler state
across Gibbs sweeps, refreshed only where a phi proposal is accepted.
In the port every field carries a leading K (subset) axis before the
component axis; the counters are plain Python ints (they never feed the
chain, and keeping them on the host avoids a device sync).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FactorCache(NamedTuple):
    """r_mv: (K, q, m, m) masked correlation in the CG matvec dtype
    (u_solver="cg" only); nys_z: (K, q, m, rank) Nystrom factor
    (cg_precond="nystrom" only); chol_inv: (K, q, nb, p, p) diagonal-
    panel inverses of the carried factor (when the blocked triangular
    solve engages, m > trisolve_block_size). krige_w: (K, q, m, t)
    W = R~^{-1} R_cross; krige_chol: (K, q, t, t) Cholesky of the
    conditional covariance — both built for collecting sweeps only.
    Unused fields are None. n_chol / n_chol_calls: m x m factorizations
    (per subset) and batched Cholesky calls since the cache was built.
    The port counts what it runs: where the twin's accept branch is a
    select over K (the collapsed accept side), every update counts it."""

    r_mv: Optional[torch.Tensor]
    nys_z: Optional[torch.Tensor]
    chol_inv: Optional[torch.Tensor]
    krige_w: Optional[torch.Tensor] = None
    krige_chol: Optional[torch.Tensor] = None
    n_chol: int = 0
    n_chol_calls: int = 0


def empty_counter() -> int:
    """Fresh factorization counter."""
    return 0


def tick(cache: FactorCache, n: int, n_calls: Optional[int] = None) -> FactorCache:
    """Record ``n`` logical m x m factorizations issued as ``n_calls``
    batched calls (default ``n``)."""
    if n_calls is None:
        n_calls = n
    return cache._replace(
        n_chol=cache.n_chol + n, n_chol_calls=cache.n_chol_calls + n_calls
    )


def select_accept(
    prop: FactorCache, cur: FactorCache, accept: torch.Tensor
) -> FactorCache:
    """Per-(subset, component) select between a proposal-side cache and
    the current one. ``accept``: (K, q) bool aligned with the leading
    axes of every populated field; the counters come from ``prop``."""

    def sel(p, c, extra_dims):
        if c is None:
            return None
        acc = accept.reshape(accept.shape + (1,) * extra_dims)
        return torch.where(acc, p, c)

    return FactorCache(
        r_mv=sel(prop.r_mv, cur.r_mv, 2),
        nys_z=sel(prop.nys_z, cur.nys_z, 2),
        chol_inv=sel(prop.chol_inv, cur.chol_inv, 3),
        krige_w=sel(prop.krige_w, cur.krige_w, 2),
        krige_chol=sel(prop.krige_chol, cur.krige_chol, 2),
        n_chol=prop.n_chol,
        n_chol_calls=prop.n_chol_calls,
    )


def set_component(x: torch.Tensor, j: int, val: torch.Tensor) -> torch.Tensor:
    """``x`` (K, q, ...) with component ``j`` replaced by ``val`` (K, ...),
    as a new tensor: ``x`` itself is left as it was (a caller may still
    hold the state it belongs to)."""
    if x.shape[1] == 1:
        return val[:, None]
    out = x.clone()
    out[:, j] = val
    return out


def scatter_component(
    prop: FactorCache, cur: FactorCache, j: int, accept: torch.Tensor
) -> FactorCache:
    """Write component ``j`` of a one-component proposal cache (axis 1 of
    length 1) into the full cache for the subsets where ``accept`` (K,)
    holds — the collapsed sampler's per-component refresh. The counters
    come from ``prop``."""

    def sel_j(p, c):
        if c is None:
            return None
        acc = accept.reshape(accept.shape + (1,) * (c.dim() - 2))
        return set_component(c, j, torch.where(acc, p[:, 0], c[:, j]))

    return FactorCache(
        r_mv=sel_j(prop.r_mv, cur.r_mv),
        nys_z=sel_j(prop.nys_z, cur.nys_z),
        chol_inv=sel_j(prop.chol_inv, cur.chol_inv),
        krige_w=sel_j(prop.krige_w, cur.krige_w),
        krige_chol=sel_j(prop.krige_chol, cur.krige_chol),
        n_chol=prop.n_chol,
        n_chol_calls=prop.n_chol_calls,
    )
