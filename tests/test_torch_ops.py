"""Each ops/utils/parallel module of the port against its JAX twin, on
the same inputs (numpy, from a seed), on the CPU.

Tolerances: both packages compute in fp32 with the same formulas; they
differ in reduction order and in the libm/LAPACK routines underneath, so
deterministic numerics agree to a few fp32 ulps of the values involved
(stated per test). Exact contracts — zero diagonals, NaN factors on a
non-positive-definite input, row gathers — are compared exactly.
"""

# smklint: test-budget=eager ops on arrays of at most a few thousand floats; every JAX reference is a single small call
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.data import ebird as jebird
from smk_tpu.ops import chol as jchol
from smk_tpu.ops import distance as jdist
from smk_tpu.ops import glm as jglm
from smk_tpu.ops import kernels as jkern
from smk_tpu.ops import polya_gamma as jpg
from smk_tpu.ops import quantiles as jq
from smk_tpu.ops import truncnorm as jtn
from smk_tpu.parallel import combine as jcomb
from smk_tpu.parallel import partition as jpart
from smk_tpu.utils import diagnostics as jdiag
from smk_torch.data import ebird as tebird
from smk_torch.ops import chol as tchol
from smk_torch.ops import distance as tdist
from smk_torch.ops import factor_cache as tfc
from smk_torch.ops import glm as tglm
from smk_torch.ops import kernels as tkern
from smk_torch.ops import polya_gamma as tpg
from smk_torch.ops import quantiles as tq
from smk_torch.ops import truncnorm as ttn
from smk_torch.parallel import combine as tcomb
from smk_torch.parallel import partition as tpart
from smk_torch.utils import diagnostics as tdiag
from smk_torch.utils.tracing import PhaseTimes, phase_timer


def _t(a):
    return torch.as_tensor(np.array(a))


def _rng(seed=0):
    return np.random.default_rng(seed)


def _spd(rng, k, m, scale=1.0):
    a = rng.normal(size=(k, m, m)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / m + scale * np.eye(m, dtype=np.float32)).astype(np.float32)


class TestDistanceAndKernels:
    def test_distances_match_twin(self):
        rng = _rng(1)
        a = rng.uniform(size=(50, 2)).astype(np.float32)
        b = rng.uniform(size=(13, 2)).astype(np.float32)
        # the norm trick cancels near coincident points: a few ulps of
        # the squared norms (~1), so 1e-5 absolute on distances
        np.testing.assert_allclose(
            tdist.cross_distance(_t(a), _t(b)).numpy(),
            np.asarray(jdist.cross_distance(jnp.asarray(a), jnp.asarray(b))),
            atol=1e-5,
        )
        got = tdist.pairwise_distance(_t(a)).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jdist.pairwise_distance(jnp.asarray(a))), atol=1e-5
        )
        assert (np.diagonal(got) == 0.0).all()
        np.testing.assert_array_equal(got, got.T)

    @pytest.mark.parametrize("model", ["exponential", "matern32", "matern52"])
    def test_correlation_and_stack_match_twin(self, model):
        rng = _rng(2)
        dist = rng.uniform(0, 2, size=(20, 20)).astype(np.float32)
        phis = np.asarray([4.0, 6.5, 11.0], np.float32)
        # elementwise exp: a few fp32 ulps of values <= 1
        np.testing.assert_allclose(
            tkern.correlation(_t(dist), torch.tensor(6.5), model).numpy(),
            np.asarray(jkern.correlation(jnp.asarray(dist), jnp.float32(6.5), model)),
            atol=1e-6,
        )
        np.testing.assert_allclose(
            tkern.correlation_stack(_t(dist), _t(phis), model).numpy(),
            np.asarray(jkern.correlation_stack(jnp.asarray(dist), jnp.asarray(phis), model)),
            atol=1e-6,
        )

    def test_unknown_model_raises(self):
        with pytest.raises(ValueError, match="unknown cov model"):
            tkern.correlation(torch.zeros(2, 2), torch.tensor(1.0), "spherical")


class TestCholesky:
    def test_factors_and_solves_match_twin(self):
        rng = _rng(3)
        mat = _spd(rng, 3, 24)
        b = rng.normal(size=(3, 24, 5)).astype(np.float32)
        shift = rng.uniform(0.5, 2.0, size=(3, 24)).astype(np.float32)
        # LAPACK vs XLA's factorization: relative 1e-5 of O(1) entries
        tol = dict(atol=2e-5, rtol=2e-5)
        l_t = tchol.jittered_cholesky(_t(mat), 1e-3)
        l_j = jchol.jittered_cholesky(jnp.asarray(mat), 1e-3)
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **tol)
        assert (np.triu(l_t.numpy()[0], 1) == 0).all()
        np.testing.assert_allclose(
            tchol.shifted_cholesky(_t(mat), _t(shift)).numpy(),
            np.asarray(jax.vmap(jchol.shifted_cholesky)(jnp.asarray(mat), jnp.asarray(shift))),
            **tol,
        )
        np.testing.assert_allclose(
            tchol.batched_shifted_cholesky(_t(mat), _t(shift[0])).numpy(),
            np.asarray(jchol.batched_shifted_cholesky(jnp.asarray(mat), jnp.asarray(shift[0]))),
            **tol,
        )
        for trans in (False, True):
            np.testing.assert_allclose(
                tchol.tri_solve(l_t, _t(b), trans=trans).numpy(),
                np.asarray(jax.vmap(lambda l, x: jchol.tri_solve(l, x, trans=trans))(l_j, jnp.asarray(b))),
                atol=1e-4, rtol=1e-4,
            )
        vec = b[..., 0]
        np.testing.assert_allclose(
            tchol.chol_solve(l_t, _t(vec)).numpy(),
            np.asarray(jax.vmap(jchol.chol_solve)(l_j, jnp.asarray(vec))),
            atol=1e-4, rtol=1e-4,
        )
        np.testing.assert_allclose(
            tchol.chol_logdet(l_t).numpy(), np.asarray(jchol.chol_logdet(l_j)), atol=1e-4
        )

    def test_transposed_solve_solves_lt(self):
        rng = _rng(4)
        l = tchol.jittered_cholesky(_t(_spd(rng, 1, 16)[0]), 1e-4)
        b = torch.as_tensor(rng.normal(size=16).astype(np.float32))
        x = tchol.tri_solve(l, b, trans=True)
        np.testing.assert_allclose((l.T @ x).numpy(), b.numpy(), atol=1e-4)

    def test_non_pd_factor_is_all_nan_like_the_twin(self):
        rng = _rng(5)
        good = _spd(rng, 1, 6)[0]
        bad = -np.eye(6, dtype=np.float32)
        stack = np.stack([good, bad])
        got = tchol.jittered_cholesky(_t(stack), 1e-5).numpy()
        want = np.asarray(jchol.jittered_cholesky(jnp.asarray(stack), 1e-5))
        low = np.tril(np.ones((6, 6), bool))
        assert np.isnan(want[1][low]).all() and (want[1][~low] == 0).all()
        np.testing.assert_array_equal(got[1], want[1])
        assert np.isfinite(got[0]).all()
        np.testing.assert_array_equal(
            tchol.finite_factor(torch.as_tensor(got)).numpy(),
            np.asarray(jchol.finite_factor(jnp.asarray(want))),
        )
        assert tchol.finite_factor(torch.as_tensor(got)).tolist() == [True, False]

    @pytest.mark.parametrize("m, block", [(40, 16), (12, 16)])
    @pytest.mark.parametrize("trans", [False, True])
    @pytest.mark.parametrize("carried", [False, True])
    @pytest.mark.parametrize("vec", [False, True])
    def test_blocked_tri_solve_matches_twin(self, m, block, trans, carried, vec):
        """Panel substitution with explicit panel inverses, forward and
        transposed, with the inverses carried or built in the call, at
        m = 40 (a ragged 8-row tail panel) and at m <= block (the native
        solve). Both packages run the same panel products; the port skips
        the exact-zero terms of the padded tail (observed <= 3e-6 relative
        of O(1) solutions); asserted 2e-5."""
        rng = _rng(15)
        l_np = np.linalg.cholesky(_spd(rng, 3, m).astype(np.float64)).astype(np.float32)
        b = rng.normal(size=(3, m) if vec else (3, m, 5)).astype(np.float32)
        inv_j = jchol.panel_inverses(jnp.asarray(l_np), block) if carried else None
        inv_t = _t(inv_j) if carried else None
        want = np.asarray(jchol.blocked_tri_solve(
            jnp.asarray(l_np), jnp.asarray(b), block, inv_j, trans=trans))
        got = tchol.blocked_tri_solve(_t(l_np), _t(b), block, inv_t, trans=trans)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        native = tchol.tri_solve(_t(l_np), _t(b), trans=trans)
        np.testing.assert_allclose(got.numpy(), native.numpy(), rtol=2e-5, atol=2e-5)

    def test_panel_inverses_match_twin(self):
        """(K, nb, p, p) inverses of the diagonal panels, the ragged last
        one identity-padded: same triangular solve of the same panels
        (observed <= 1e-6 relative); asserted 1e-5."""
        rng = _rng(16)
        l_np = np.linalg.cholesky(_spd(rng, 2, 40).astype(np.float64)).astype(np.float32)
        want = np.asarray(jchol.panel_inverses(jnp.asarray(l_np), 16))
        got = tchol.panel_inverses(_t(l_np), 16)
        assert tuple(got.shape) == want.shape == (2, 3, 16, 16)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        # the padded tail panel's identity block is exact
        np.testing.assert_array_equal(got[:, 2, 8:, 8:].numpy(), np.broadcast_to(np.eye(8), (2, 8, 8)))


class TestPolyaGamma:
    @pytest.mark.parametrize("b", [1, 2])
    def test_sample_pg_from_the_twins_draws(self, b):
        """sample_pg with the twin's own draws injected: its exponentials
        (b = 1) or its gammas (b = 2). The 64-term series sums in another
        order (observed <= 2.4e-7 relative); asserted 2e-6."""
        rng = _rng(17)
        c = rng.normal(0.0, 3.0, size=(30, 2)).astype(np.float32)
        c[0, 0] = 0.0  # the a -> 0 tail limit
        key = jax.random.key(21)
        shape = (64,) + c.shape
        g = (jax.random.exponential(key, shape, jnp.float32) if b == 1
             else jax.random.gamma(key, float(b), shape, jnp.float32))
        want = np.asarray(jpg.sample_pg(key, b, jnp.asarray(c), 64))
        got = tpg.sample_pg(_t(g), b, _t(c), 64)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=0)
        assert (got > 0).all()

    def test_pg_mean_matches_twin(self):
        c = np.concatenate([np.linspace(-8, 8, 41), [1e-6, -5e-5]]).astype(np.float32)
        for b in (1.0, 3.0):
            np.testing.assert_allclose(
                tpg.pg_mean(b, _t(c)).numpy(), np.asarray(jpg.pg_mean(b, jnp.asarray(c))),
                rtol=1e-6, atol=0,
            )

    def test_gamma_draws_have_the_gamma_moments(self):
        """The default noise's Gamma(b, 1) draws (sums of b exponentials):
        mean b and variance b, each within 5 standard errors at 2e5
        draws (the sample variance's is sqrt((2 b^2 + 6 b) / n))."""
        g = torch.Generator().manual_seed(3)
        n = 200_000
        for b in (1, 2, 5):
            x = tpg.gamma_draws(g, b, (n,)).double()
            assert x.shape == (n,) and (x > 0).all()
            assert abs(float(x.mean()) - b) < 5 * (b / n) ** 0.5
            assert abs(float(x.var()) - b) < 5 * ((2 * b * b + 6 * b) / n) ** 0.5


@pytest.mark.parametrize("seed", [0, 5])
def test_make_ebird_proxy_is_the_twins_bit_for_bit(seed):
    """The port's copy of the numpy generator gives the same arrays."""
    got = tebird.make_ebird_proxy(3000, seed=seed)
    want = jebird.make_ebird_proxy(3000, seed=seed)
    for f in ("y", "x", "coords"):
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype and a.shape == w.shape
        np.testing.assert_array_equal(a, w, err_msg=f)
    assert got.covariate_names == want.covariate_names
    assert got.species_names == want.species_names


class TestTruncnorm:
    def test_ndtri_from_log_matches_twin_into_the_deep_tail(self):
        log_p = -np.concatenate([
            np.geomspace(1e-4, 5.0, 40), np.geomspace(5.0, 5e3, 40)
        ]).astype(np.float32)
        got = ttn.ndtri_from_log(_t(log_p)).numpy()
        want = np.asarray(jtn.ndtri_from_log(jnp.asarray(log_p)))
        # Newton-polished quantiles: relative fp32 tolerance
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("weight", [1, 3])
    def test_latents_from_the_same_uniforms_match_twin(self, weight):
        rng = _rng(6)
        mu = rng.normal(0.0, 4.0, size=(30, 2)).astype(np.float32)
        y = rng.integers(0, weight + 1, size=(30, 2)).astype(np.float32)
        key = jax.random.key(11)
        shape = mu.shape if weight == 1 else (weight,) + mu.shape
        # the uniforms the twin draws internally from this key
        u = jax.random.uniform(key, shape, jnp.float32, minval=jtn._TINY, maxval=1.0)
        want = np.asarray(jtn.sample_albert_chib_latent(key, jnp.asarray(mu), jnp.asarray(y), weight))
        got = ttn.sample_albert_chib_latent(_t(u), _t(mu), _t(y), weight).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        if weight == 1:
            assert ((got > 0) == (y > 0)).all()


class TestWarmStart:
    def test_irls_probit_matches_twin(self):
        rng = _rng(7)
        x = np.concatenate([np.ones((300, 1)), rng.normal(size=(300, 2))], 1).astype(np.float32)
        y = (rng.uniform(size=300) < 0.4).astype(np.float32)
        got = tglm.irls_glm(_t(y), _t(x), link="probit")
        want = jglm.irls_glm(jnp.asarray(y), jnp.asarray(x), link="probit")
        # 25 fp32 Newton steps from the same start: converged, so the
        # fixed point agrees to fp32 solve accuracy
        np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), atol=1e-5)
        np.testing.assert_allclose(got.vcov.numpy(), np.asarray(want.vcov), rtol=1e-4, atol=1e-7)

    @pytest.mark.parametrize("weight", [1, 3])
    def test_irls_logit_matches_twin(self, weight):
        rng = _rng(13)
        x = np.concatenate([np.ones((300, 1)), rng.normal(size=(300, 2))], 1).astype(np.float32)
        y = rng.binomial(weight, 0.3, size=300).astype(np.float32)
        mask = (rng.uniform(size=300) > 0.1).astype(np.float32)
        got = tglm.irls_glm(_t(y), _t(x), weight=weight, link="logit", obs_mask=_t(mask))
        want = jglm.irls_glm(jnp.asarray(y), jnp.asarray(x), weight=weight, link="logit",
                             obs_mask=jnp.asarray(mask))
        # converged fp32 Newton iterations: the fixed point to solve accuracy
        np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), atol=1e-5)
        np.testing.assert_allclose(got.vcov.numpy(), np.asarray(want.vcov), rtol=1e-4, atol=1e-7)
        with pytest.raises(ValueError, match="unknown link"):
            tglm.irls_glm(_t(y), _t(x), link="cloglog")


class TestFactorCache:
    def test_tick_and_select_accept(self):
        cur = tfc.FactorCache(None, None, None, torch.zeros(2, 3, 4, 5), torch.zeros(2, 3, 5, 5))
        prop = tfc.tick(cur._replace(krige_w=torch.ones(2, 3, 4, 5),
                                     krige_chol=torch.ones(2, 3, 5, 5)), 3, n_calls=1)
        assert (prop.n_chol, prop.n_chol_calls) == (3, 1)
        accept = torch.tensor([[True, False, True], [False, False, True]])
        out = tfc.select_accept(prop, cur, accept)
        assert out.r_mv is None and out.n_chol == 3
        assert torch.equal(out.krige_w[:, :, 0, 0], accept.float())
        assert torch.equal(out.krige_chol[:, :, 1, 1], accept.float())

    @pytest.mark.parametrize("q", [1, 3])
    def test_scatter_component_matches_twin(self, q):
        """Component j of a one-component proposal cache written where the
        (K,) accept mask holds — per subset, the twin's scatter_component
        (bf16 r_mv included); the inputs are left as they were."""
        from smk_tpu.ops import factor_cache as jfc

        rng = _rng(14)
        shapes = dict(r_mv=(5, 5), nys_z=(5, 2), chol_inv=(2, 3, 3), krige_w=(5, 4),
                      krige_chol=(4, 4))
        k, j = 3, q - 1
        cur = {f: rng.normal(size=(k, q) + sh).astype(np.float32) for f, sh in shapes.items()}
        prop = {f: rng.normal(size=(k, 1) + sh).astype(np.float32) for f, sh in shapes.items()}
        accept = np.array([True, False, True])

        def port(d, n):
            out = {f: _t(v) for f, v in d.items()}
            out["r_mv"] = out["r_mv"].to(torch.bfloat16)
            return tfc.FactorCache(**out, n_chol=n, n_chol_calls=n)

        t_cur, t_prop = port(cur, 0), port(prop, 5)
        before = t_cur.r_mv.clone()
        got = tfc.scatter_component(t_prop, t_cur, j, torch.as_tensor(accept))
        assert got.n_chol == 5 and torch.equal(t_cur.r_mv, before)
        for kk in range(k):
            jc = jfc.FactorCache(**{f: jnp.asarray(v[kk]) for f, v in cur.items()},
                                 n_chol=jnp.int32(0), n_chol_calls=jnp.int32(0))
            jp = jfc.FactorCache(**{f: jnp.asarray(v[kk]) for f, v in prop.items()},
                                 n_chol=jnp.int32(5), n_chol_calls=jnp.int32(5))
            want = jfc.scatter_component(jp, jc, j, jnp.asarray(accept[kk]))
            for f in shapes:
                g = getattr(got, f)[kk]
                w = np.asarray(getattr(want, f))
                if f == "r_mv":
                    assert g.dtype == torch.bfloat16
                    w = torch.as_tensor(np.array(w)).to(torch.bfloat16)
                    assert torch.equal(g, w)
                else:
                    np.testing.assert_array_equal(g.numpy(), w, err_msg=f)


class TestQuantiles:
    def test_grid_interp_summary_resample_match_twin(self):
        rng = _rng(8)
        samples = rng.normal(size=(37, 5)).astype(np.float32)
        # same probabilities, same sort, same interpolation formula:
        # one or two fp32 roundings apart
        # the same linspace formula; XLA may contract it into an FMA,
        # so the probabilities agree to one fp32 ulp
        np.testing.assert_allclose(
            tq.quantile_probs(200).numpy(), np.asarray(jq.quantile_probs(200)),
            rtol=1.2e-7, atol=0,
        )
        grid_t = tq.quantile_grid(_t(samples), 200)
        grid_j = jq.quantile_grid(jnp.asarray(samples), 200)
        # a one-ulp probability moves the fractional index p (n - 1) by
        # ~4e-6 here, times sample gaps of O(1)
        np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), atol=1e-5)
        dense_t = tq.interp_quantile_grid(grid_t, 0.001)
        dense_j = jq.interp_quantile_grid(grid_j, 0.001)
        assert tuple(dense_t.shape) == dense_j.shape == (996, 5)
        np.testing.assert_allclose(dense_t.numpy(), np.asarray(dense_j), atol=1e-5)
        np.testing.assert_allclose(
            tq.credible_summary(_t(samples)).numpy(),
            np.asarray(jq.credible_summary(jnp.asarray(samples))),
            atol=1e-6,
        )
        key = jax.random.key(4)
        idx = jax.random.randint(key, (50,), 0, 996)
        want = jq.inverse_cdf_resample(key, [dense_j], 50)[0]
        got = tq.inverse_cdf_resample(_t(idx), [_t(dense_j)])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_batched_grid_along_dim(self):
        rng = _rng(9)
        draws = rng.normal(size=(3, 21, 4)).astype(np.float32)
        got = tq.quantile_grid(_t(draws), 20, dim=1)
        for k in range(3):
            np.testing.assert_allclose(
                got[k].numpy(), np.asarray(jq.quantile_grid(jnp.asarray(draws[k]), 20)), atol=1e-6
            )

    def test_resample_index_range(self):
        g = torch.Generator().manual_seed(0)
        idx = tq.resample_index(g, 500, 996, "cpu")
        assert idx.shape == (500,) and int(idx.min()) >= 0 and int(idx.max()) < 996


class TestDiagnostics:
    def test_ess_and_rhat_match_twin(self):
        rng = _rng(10)
        n, d = 64, 3
        x = np.zeros((2, n, d), np.float32)
        eps = rng.normal(size=(2, n, d)).astype(np.float32)
        for i in range(1, n):
            x[:, i] = 0.7 * x[:, i - 1] + eps[:, i]
        # FFT autocovariance in fp32: relative 1e-4 of the ESS
        np.testing.assert_allclose(
            tdiag.effective_sample_size(_t(x), dim=1).numpy(),
            np.stack([np.asarray(jdiag.effective_sample_size(jnp.asarray(x[k]))) for k in range(2)]),
            rtol=1e-4,
        )
        np.testing.assert_allclose(
            tdiag.rhat(_t(x)).numpy(), np.asarray(jdiag.rhat(jnp.asarray(x))), rtol=1e-5
        )
        # fewer than 4 draws per chain: NaN, as the twin
        assert torch.isnan(tdiag.rhat(_t(x[:, :2]))).all()


class TestCombine:
    @pytest.mark.parametrize("dup", [False, True])
    def test_combiners_match_twin(self, dup):
        rng = _rng(11)
        grids = np.sort(rng.normal(size=(5, 30, 4)), axis=1).astype(np.float32)
        if dup:  # coincident curves exercise the Vardi–Zhang guard
            grids[1] = grids[0]
            grids[2] = grids[0]
        np.testing.assert_allclose(
            tcomb.combine_quantile_grids(_t(grids)).numpy(),
            np.asarray(jcomb.combine_quantile_grids(jnp.asarray(grids))),
            atol=1e-6,
        )
        # 50 Weiszfeld iterations in fp32, different reduction order
        np.testing.assert_allclose(
            tcomb.combine_quantile_grids(_t(grids), "weiszfeld_median").numpy(),
            np.asarray(jcomb.combine_quantile_grids(jnp.asarray(grids), "weiszfeld_median")),
            atol=1e-4,
        )
        with pytest.raises(ValueError, match="unknown combiner"):
            tcomb.combine_quantile_grids(_t(grids), "trimmed")


class TestPartition:
    def test_random_partition_with_the_twins_permutation(self):
        rng = _rng(12)
        n, q, p = 103, 2, 2
        y = (rng.uniform(size=(n, q)) < 0.5).astype(np.float32)
        x = rng.normal(size=(n, q, p)).astype(np.float32)
        coords = rng.uniform(size=(n, 2)).astype(np.float32)
        key = jax.random.key(5)
        want = jpart.random_partition(key, jnp.asarray(y), jnp.asarray(x), jnp.asarray(coords), 4)
        perm = jax.random.permutation(key, n)
        got = tpart.random_partition(_t(perm), _t(y), _t(x), _t(coords), 4)
        for f in ("y", "x", "mask", "index"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        # real rows are gathered exactly; the pad pseudo-coordinates are
        # a product of constants that XLA may fold in another order
        np.testing.assert_allclose(
            got.coords.numpy(), np.asarray(want.coords), rtol=2.4e-7, atol=0
        )
        assert got.n_subsets == 4 and got.subset_size == 26
        same = tpart.partition_from_indices(_t(y), _t(x), _t(coords), got.index)
        assert torch.equal(same.coords, got.coords)
        g = torch.Generator().manual_seed(1)
        assert sorted(tpart.random_permutation(g, n, "cpu").tolist()) == list(range(n))


def test_phase_timer_records_each_phase():
    times = PhaseTimes()
    with phase_timer(times, "a", torch.device("cpu")):
        pass
    with phase_timer(times, "a"):
        pass
    assert set(times.as_dict()) == {"a"} and times.as_dict()["a"] >= 0.0
