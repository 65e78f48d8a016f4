"""Cholesky factorization and solves with jitter — twin of
``smk_tpu/ops/chol.py`` (the XLA-native factorizations, here through
``torch.linalg``: cuSOLVER/cuBLAS on the card).

The one behaviour the port must add: ``lax.linalg.cholesky`` returns an
all-NaN factor for a matrix that is not positive definite, and the
sampler's accept logic relies on that (a NaN log-ratio rejects;
:func:`finite_factor` guards). ``torch.linalg.cholesky`` raises
instead, and ``cholesky_ex`` returns a finite partial factor with
``info > 0``, so every factor here is NaN-filled where ``info != 0`` —
with no host sync.

Each factorization entry point is one ``smk.factor`` span
(utils/tracing.span; ``m`` the matrix size, ``batch`` the matrices
factored), its copies and fills included.
"""

from __future__ import annotations

from typing import Optional

import torch

from smk_torch.utils.tracing import span


def _factor_span(mat: torch.Tensor):
    return span("smk.factor", m=mat.shape[-1], batch=mat.shape[:-2].numel())


def cholesky(mat: torch.Tensor) -> torch.Tensor:
    """Lower factor of ``mat`` (batched); where ``mat`` is not PD, its
    lower triangle is all NaN and its upper triangle zero — what the
    twin's ``jnp.tril(lax.linalg.cholesky(mat))`` gives. The fill is
    one in-place select over the factor, with no host sync."""
    with _factor_span(mat):
        return _cholesky(mat)


def _cholesky(mat: torch.Tensor) -> torch.Tensor:
    chol, info = torch.linalg.cholesky_ex(mat)
    m = mat.shape[-1]
    nan_lower = torch.full((m, m), float("nan"), dtype=chol.dtype,
                           device=chol.device).tril_()
    return torch.where((info != 0)[..., None, None], nan_lower, chol, out=chol)


def _add_diag(mat: torch.Tensor, diag) -> torch.Tensor:
    """``mat + diag(diag)`` as a new tensor (diag: scalar or (..., m))."""
    out = mat.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(diag)
    return out


def jittered_cholesky(mat: torch.Tensor, jitter: float = 1e-5) -> torch.Tensor:
    """Lower Cholesky factor of ``mat + jitter * I`` over (..., m, m)."""
    with _factor_span(mat):
        return _cholesky(_add_diag(mat, jitter))


def blocked_cholesky(
    mat: torch.Tensor, jitter: float = 0.0, block_size: int = 512
) -> torch.Tensor:
    """Lower factor of ``mat + jitter * I`` by the twin's left-looking
    blocked algorithm (``chol.blocked_cholesky``): per block column of
    width b, the Schur-complement update and the panel scaling (by the
    explicit inverse of the b x b diagonal factor) are two GEMMs, and
    only the b x b diagonal blocks go through :func:`cholesky`. The
    same factorization as :func:`cholesky`, up to the GEMMs' summation
    order.

    mat: (..., m, m). At m <= block_size it is :func:`jittered_cholesky`.
    Otherwise m is padded to a multiple of b with an identity tail, as
    in the twin, and the factor is built in place in that padded copy
    (left-looking: block column k reads only the columns already
    factored and its own, untouched, input; ``mat`` itself is not
    written). A diagonal block that is not positive definite factors
    to NaN (:func:`cholesky`), and the GEMMs carry the NaN into every
    later block column, where the twin's XLA GEMMs carry it."""
    with _factor_span(mat):
        return _blocked_cholesky(mat, jitter, block_size)


def _blocked_cholesky(mat: torch.Tensor, jitter: float, block_size: int) -> torch.Tensor:
    m = mat.shape[-1]
    if m <= block_size:
        return _cholesky(_add_diag(mat, jitter))
    b = block_size
    nb = -(-m // b)
    mp = nb * b
    buf = torch.zeros(mat.shape[:-2] + (mp, mp), dtype=mat.dtype, device=mat.device)
    buf[..., :m, :m] = mat
    diag = buf.diagonal(dim1=-2, dim2=-1)
    if jitter:
        diag[..., :m].add_(jitter)
    diag[..., m:].fill_(1.0)
    eye_b = torch.eye(b, dtype=mat.dtype, device=mat.device)
    for k in range(nb):
        lo, hi = k * b, (k + 1) * b
        s = buf[..., lo:, lo:hi]
        if k > 0:
            s = s - buf[..., lo:, :lo] @ buf[..., lo:hi, :lo].mT
        l_kk = _cholesky(s[..., :b, :])
        buf[..., lo:hi, lo:hi] = l_kk
        if hi < mp:
            inv_kk = torch.linalg.solve_triangular(l_kk, eye_b.expand(l_kk.shape), upper=False)
            buf[..., hi:, lo:hi] = s[..., b:, :] @ inv_kk.mT
        del s
    return torch.tril(buf[..., :m, :m]) if mp != m else buf.tril_()


def shifted_cholesky(r: torch.Tensor, shift) -> torch.Tensor:
    """Lower Cholesky factor of ``r + diag(shift)``; shift is a scalar or
    a (..., m) diagonal."""
    with _factor_span(r):
        return _shifted_cholesky(r, shift)


def _shifted_cholesky(r: torch.Tensor, shift) -> torch.Tensor:
    shift = torch.zeros(r.shape[:-1], dtype=r.dtype, device=r.device) + shift
    return _cholesky(_add_diag(r, shift))


def batched_shifted_cholesky(r_stack: torch.Tensor, shift) -> torch.Tensor:
    """Factor a (..., s, m, m) stack sharing one diagonal shift (scalar
    or (..., m), broadcast across the stack axis)."""
    if torch.is_tensor(shift) and shift.dim() >= 1:
        shift = shift[..., None, :]
    with _factor_span(r_stack):
        return _shifted_cholesky(r_stack, shift)


def finite_factor(chol_l: torch.Tensor) -> torch.Tensor:
    """Per batch element: every diagonal entry of the factor finite."""
    diag = torch.diagonal(chol_l, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(diag), dim=-1)


def tri_solve(chol_l: torch.Tensor, b: torch.Tensor, *, trans: bool = False) -> torch.Tensor:
    """Solve L x = b (or L^T x = b when ``trans``) for lower-triangular
    L (..., m, m); b is (..., m) or (..., m, n)."""
    vec = b.dim() == chol_l.dim() - 1
    if vec:
        b = b[..., None]
    if trans:
        x = torch.linalg.solve_triangular(chol_l.mT, b, upper=True)
    else:
        x = torch.linalg.solve_triangular(chol_l, b, upper=False)
    return x[..., 0] if vec else x


def blocked_tri_solve(
    l: torch.Tensor,
    b: torch.Tensor,
    block_size: int = 512,
    inv_diag: Optional[torch.Tensor] = None,
    *,
    trans: bool = False,
) -> torch.Tensor:
    """Solve L X = B (or L^T X = B when ``trans``) by substitution over
    (p, p) diagonal panels with their explicit inverses, so the work is
    GEMMs — the twin's form (its docstring gives the TPU reason; on the
    card it is timed against the native solve in chip_smoke.py).

    l: (..., m, m); b: (..., m) or (..., m, t) with l's batch shape.
    ``inv_diag``: optionally :func:`panel_inverses` of ``l``. At
    m <= block_size this is the native solve. The twin pads L to a
    block multiple with an identity tail; here the ragged last panel
    takes the real corner of its identity-padded inverse instead, which
    is the same arithmetic without a padded copy of L (the padded
    inverse is block-diagonal, so the dropped terms are exact zeros)."""
    m = l.shape[-1]
    vec = b.dim() == l.dim() - 1
    if vec:
        b = b[..., None]
    if m <= block_size:
        x = tri_solve(l, b, trans=trans)
        return x[..., 0] if vec else x
    p = block_size
    nb = -(-m // p)
    if inv_diag is None:
        inv_diag = panel_inverses(l, block_size)
    x = torch.empty_like(b)
    order = range(nb - 1, -1, -1) if trans else range(nb)
    for i in order:
        lo, hi = i * p, min((i + 1) * p, m)
        inv = inv_diag[..., i, : hi - lo, : hi - lo]
        rhs = b[..., lo:hi, :]
        if trans:
            # x_i = inv_ii^T (b_i - sum_{j>i} L[j, i]^T x_j)
            if hi < m:
                rhs = rhs - l[..., hi:, lo:hi].mT @ x[..., hi:, :]
            x[..., lo:hi, :] = inv.mT @ rhs
        else:
            if lo:
                rhs = rhs - l[..., lo:hi, :lo] @ x[..., :lo, :]
            x[..., lo:hi, :] = inv @ rhs
    return x[..., 0] if vec else x


def panel_inverses(l: torch.Tensor, block_size: int) -> torch.Tensor:
    """(..., nb, p, p) explicit inverses of L's diagonal panels, the
    ragged last panel padded with an identity (twin of
    ``chol.panel_inverses``)."""
    m = l.shape[-1]
    p = block_size
    nb = -(-m // p)
    diag = torch.zeros(l.shape[:-2] + (nb, p, p), dtype=l.dtype, device=l.device)
    for i in range(nb):
        lo, hi = i * p, min((i + 1) * p, m)
        diag[..., i, : hi - lo, : hi - lo] = l[..., lo:hi, lo:hi]
        if hi - lo < p:
            diag[..., i, hi - lo :, hi - lo :].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    eye = torch.eye(p, dtype=l.dtype, device=l.device).expand(diag.shape)
    return torch.linalg.solve_triangular(diag, eye, upper=False)


def chol_solve(chol_l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b given the lower factor L."""
    return tri_solve(chol_l, tri_solve(chol_l, b), trans=True)


def chol_logdet(chol_l: torch.Tensor) -> torch.Tensor:
    """log det(L L^T) = 2 * sum(log diag(L)); batched over leading dims."""
    diag = torch.diagonal(chol_l, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1)
