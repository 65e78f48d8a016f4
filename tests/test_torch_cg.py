"""The port's CG solver and its operators (smk_torch/ops/cg.py) against
the JAX twin (smk_tpu/ops/cg.py), on the same numpy inputs, on the CPU.

The systems are the sampler's: a masked exponential correlation R~ at
m = 64 with 5 pad rows, shifted by jitter + d, d from [0.5, 2] on real
rows and 1e8 on pad rows, K = 3 subsets. The twin solves one subset at
a time (vmapped here); the port batches the K axis itself.

Tolerances: every step is the same fp32 formula in both packages, so
results differ by reduction order only: a few ulps per step, compounded
over the CG iterations (observed <= 2e-6 relative); asserted at 1e-5
relative (+ 1e-5 absolute). The bf16 operator's product holds exact
products in both packages, so it too differs by fp32 accumulation order
only (observed <= 2.4e-7; asserted 1e-6). A CG solve through the bf16
operator rounds its search vector to bf16 every step: an entry an fp32
ulp apart in the two packages can land on neighbouring bf16 values, and
the iterations carry that on (observed 2.0e-4 absolute, 1.1e-3 relative
over 32 Jacobi steps); asserted at 2e-3 absolute + 5e-3 relative.
"""

# smklint: test-budget=eager ops and single small jitted twin calls at m = 64, K = 3
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.ops import cg as jcg
from smk_torch.ops import cg as tcg

K, M, N_PAD, RANK = 3, 64, 5, 16
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-3, atol=2e-3)


def _system(seed=0):
    """(r (K, m, m) masked correlation, shift (K, m), b (K, m))."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(K, M, 2))
    dist = np.linalg.norm(coords[:, :, None] - coords[:, None], axis=-1)
    r = np.exp(-6.0 * dist)
    mask = np.ones((K, M))
    mask[:, -N_PAD:] = 0.0
    mm = mask[:, :, None] * mask[:, None, :]
    r = mm * r + (1.0 - mm) * np.eye(M)
    d = np.where(mask > 0, rng.uniform(0.5, 2.0, size=(K, M)), 1e8)
    shift = 1e-5 + d
    b = rng.normal(size=(K, M))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(r), f32(shift), f32(b)


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("mv_dtype", ["float32", "bfloat16"])
def test_shifted_operator_matches_twin(mv_dtype):
    r, shift, b = _system(1)
    jd, td = getattr(jnp, mv_dtype), getattr(torch, mv_dtype)
    want_mv, want_diag, want_r = zip(*[
        (np.asarray(mv(_j(b[k]))), np.asarray(dg), np.asarray(ar(_j(b[k]))))
        for k in range(K)
        for mv, dg, ar in [jcg.shifted_correlation_operator(_j(r[k]), _j(shift[k]), jd, jnp.float32)]
    ])
    mv, diag, apply_r = tcg.shifted_correlation_operator(_t(r), _t(shift), td, torch.float32)
    got_r = apply_r(_t(b))
    assert got_r.dtype == torch.float32
    np.testing.assert_allclose(got_r.numpy(), np.stack(want_r), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mv(_t(b)).numpy(), np.stack(want_mv), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(diag.numpy(), np.stack(want_diag))


def test_bf16_product_keeps_fp32_sums():
    """The bf16 operator's product is the twin's preferred_element_type
    = fp32 product: exact products of the bf16 matrix and the bf16
    vector, summed in fp32. It is not bf16 @ bf16 (a bf16 output)."""
    r, _, b = _system(2)
    r_mv = _t(r).to(torch.bfloat16)
    got = tcg.bf16_matvec(r_mv, _t(b))
    want = np.stack([
        np.asarray(jnp.matmul(_j(r[k]).astype(jnp.bfloat16), _j(b[k]).astype(jnp.bfloat16),
                              preferred_element_type=jnp.float32))
        for k in range(K)
    ])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # a float64 sum of the same exact products agrees to fp32 rounding
    exact = r_mv.double() @ _t(b).to(torch.bfloat16).double()[..., None]
    np.testing.assert_allclose(got.numpy(), exact[..., 0].numpy(), rtol=1e-6, atol=1e-6)
    # ... and the result is not rounded to bf16, as bf16 @ bf16 would be
    rounded = (r_mv @ _t(b).to(torch.bfloat16)[..., None])[..., 0]
    assert rounded.dtype == torch.bfloat16
    assert not torch.equal(got, rounded.float())


def test_nystrom_factor_and_apply_match_twin():
    r, shift, b = _system(3)
    z_want = np.stack([np.asarray(jcg.nystrom_factor(_j(r[k][:, :RANK]))) for k in range(K)])
    z = tcg.nystrom_factor(_t(r)[..., :RANK])
    assert tuple(z.shape) == (K, M, RANK)
    np.testing.assert_allclose(z.numpy(), z_want, **TOL)
    pre_want = np.stack([
        np.asarray(jcg.nystrom_apply(_j(z_want[k]), _j(shift[k]))(_j(b[k]))) for k in range(K)
    ])
    got = tcg.nystrom_apply(_t(z_want), _t(shift))(_t(b))
    np.testing.assert_allclose(got.numpy(), pre_want, **TOL)
    # the one-shot composition is the two halves
    np.testing.assert_allclose(
        tcg.nystrom_preconditioner(_t(r)[..., :RANK], _t(shift))(_t(b)).numpy(),
        tcg.nystrom_apply(z, _t(shift))(_t(b)).numpy(), rtol=0, atol=0,
    )


@pytest.mark.parametrize("precond", ["jacobi", "nystrom"])
@pytest.mark.parametrize("mv_dtype", ["float32", "bfloat16"])
def test_cg_solve_matches_twin(precond, mv_dtype):
    """8 PCG steps on K = 3 systems, batched in the port, vmapped in the
    twin, from the same inputs; the solve is also a solve (its relative
    residual is small against the dense solution)."""
    r, shift, b = _system(4)
    iters = 8 if precond == "nystrom" else 32
    jd, td = getattr(jnp, mv_dtype), getattr(torch, mv_dtype)

    def twin(rk, sk, bk):
        mv, dg, _ = jcg.shifted_correlation_operator(rk, sk, jd, jnp.float32)
        if precond == "nystrom":
            pre = jcg.nystrom_apply(jcg.nystrom_factor(rk[:, :RANK]), sk)
            return jcg.cg_solve(mv, bk, iters, precond=pre)
        return jcg.cg_solve(mv, bk, iters, diag=dg)

    want = np.asarray(jax.jit(jax.vmap(twin))(_j(r), _j(shift), _j(b)))
    mv, dg, _ = tcg.shifted_correlation_operator(_t(r), _t(shift), td, torch.float32)
    if precond == "nystrom":
        pre = tcg.nystrom_apply(tcg.nystrom_factor(_t(r)[..., :RANK]), _t(shift))
        got = tcg.cg_solve(mv, _t(b), iters, precond=pre)
    else:
        got = tcg.cg_solve(mv, _t(b), iters, diag=dg)
    np.testing.assert_allclose(got.numpy(), want, **(BF16_TOL if mv_dtype == "bfloat16" else TOL))
    dense = np.linalg.solve(r.astype(np.float64) + np.eye(M) * shift[:, None, :], b[..., None])[..., 0]
    rel = np.linalg.norm(got.numpy() - dense) / np.linalg.norm(dense)
    # observed 2e-7 / 1.4e-5 (fp32 Jacobi / Nystrom), 1.6e-3 (bf16 Nystrom)
    assert rel < (5e-2 if mv_dtype == "bfloat16" else 1e-3)
