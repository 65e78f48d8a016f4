"""Fixed-iteration batched conjugate gradient for the u-draw's
(R + D) solve — twin of ``smk_tpu/ops/cg.py``.

Every function batches over leading axes (the sampler's K subsets): a
matrix is (..., m, m), a vector (..., m). The iteration count is fixed
and the divisions are eps-guarded, as in the twin, so no step reads a
device value on the host.

The bf16 operator. The twin's product multiplies bf16 R by a bf16
vector with ``preferred_element_type=float32``: each product of two
bf16 values is exact in fp32, and the sum and the result stay fp32.
``torch.matmul`` of two bf16 tensors would return bf16 instead (every
output rounded to 8 mantissa bits), so it is never used here. On the
card the product is ``torch.bmm(..., out_dtype=torch.float32)``; on the
CPU, where that overload does not exist, it is the upcast form
``R.float() @ x.bfloat16().float()`` — the same exact products with
fp32 accumulation.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from smk_torch.ops.chol import chol_solve, jittered_cholesky, tri_solve


def bf16_matvec(r_mv: torch.Tensor, x: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """R x for a bf16 matrix (..., m, m) and a vector (..., m) rounded to
    bf16: exact products, sums and result in ``out_dtype`` (fp32, or
    fp64 in a float64 fit, as the twin's preferred_element_type)."""
    xb = x.to(torch.bfloat16)
    if r_mv.is_cuda and out_dtype == torch.float32:
        batch = r_mv.shape[:-2]
        m = r_mv.shape[-1]
        out = torch.bmm(
            r_mv.reshape(-1, m, m), xb.reshape(-1, m, 1), out_dtype=torch.float32
        )
        return out.reshape(batch + (m,))
    return (r_mv.to(out_dtype) @ xb.to(out_dtype)[..., None])[..., 0]


def shifted_correlation_operator(r, shift, matvec_dtype, acc_dtype):
    """The u-draw's operator x -> R x + shift * x with R stored in
    ``matvec_dtype`` and ``acc_dtype`` accumulation. Returns (matvec,
    jacobi_diag, apply_r) as the twin: the operator, its diagonal
    (unit correlation diagonal + shift) and R alone (the Matheron
    back-multiply)."""
    r_mv = r.to(matvec_dtype)

    if matvec_dtype == torch.bfloat16:

        def apply_r(x):
            return bf16_matvec(r_mv, x, acc_dtype)

    else:

        def apply_r(x):
            return (r_mv @ x.to(matvec_dtype)[..., None])[..., 0].to(acc_dtype)

    def matvec(x):
        return apply_r(x) + shift * x

    return matvec, 1.0 + shift, apply_r


def nystrom_factor(k_mr: torch.Tensor, rr_jitter: float = 1e-4) -> torch.Tensor:
    """Z = K_mr chol(K_rr)^{-T} (..., m, r) from the first r columns of
    the masked correlation: Z Z^T is its rank-r Nystrom approximation
    from the first-r-rows landmarks."""
    r = k_mr.shape[-1]
    eye_r = torch.eye(r, dtype=k_mr.dtype, device=k_mr.device)
    l_rr = jittered_cholesky(k_mr[..., :r, :], rr_jitter)
    inv_l = tri_solve(l_rr, eye_r.expand(l_rr.shape))  # L_rr^{-1}
    return k_mr @ inv_l.mT


def nystrom_apply(z: torch.Tensor, shift: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """v -> M^{-1} v for M = Z Z^T + diag(shift) by Woodbury:
    M^{-1} = S - S Z (I_r + Z^T S Z)^{-1} Z^T S, S = diag(shift)^{-1}.
    z: (..., m, r); shift: scalar or (..., m); v: (..., m)."""
    m, r = z.shape[-2:]
    eye_r = torch.eye(r, dtype=z.dtype, device=z.device)
    s = 1.0 / (torch.zeros(z.shape[:-1], dtype=z.dtype, device=z.device) + shift)
    w = z * s[..., None]
    c = jittered_cholesky(eye_r + z.mT @ w, 0.0)
    e = chol_solve(c, eye_r.expand(c.shape))  # (r, r) inner inverse

    def precond(v):
        return s * v - (w @ (e @ (w.mT @ v[..., None])))[..., 0]

    return precond


def nystrom_preconditioner(k_mr, shift, rr_jitter: float = 1e-4):
    """Rank-r Nystrom preconditioner for R + diag(shift): the one-shot
    composition of :func:`nystrom_factor` and :func:`nystrom_apply`."""
    return nystrom_apply(nystrom_factor(k_mr, rr_jitter), shift)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    n_iters: int = 64,
    diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """``n_iters`` (P)CG steps for A x = b from x = 0, b (..., m). ``diag``
    is a Jacobi preconditioner (A's diagonal); ``precond`` (r -> M^{-1} r)
    takes precedence over it."""
    eps = 1e-20
    if precond is None:
        inv_diag = None if diag is None else 1.0 / torch.clamp(diag, min=eps)

        def precond(r):
            return r if inv_diag is None else inv_diag * r

    x = torch.zeros_like(b)
    r = b
    z = precond(b)
    p = z
    rz = torch.sum(b * z, dim=-1, keepdim=True)
    for _ in range(n_iters):
        ap = matvec(p)
        alpha = rz / (torch.sum(p * ap, dim=-1, keepdim=True) + eps)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.sum(r * z, dim=-1, keepdim=True)
        beta = rz_new / (rz + eps)
        p = z + beta * p
        rz = rz_new
    return x
