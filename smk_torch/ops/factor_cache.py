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
    """r_mv / nys_z / chol_inv: the CG and blocked-trisolve operators of
    the twin (None in this slice: u_solver="chol", no blocked solves).
    krige_w: (K, q, m, t) W = R~^{-1} R_cross; krige_chol: (K, q, t, t)
    Cholesky of the conditional covariance — both built for collecting
    sweeps only. n_chol / n_chol_calls: logical m x m factorizations
    and batched Cholesky calls since the cache was built."""

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
