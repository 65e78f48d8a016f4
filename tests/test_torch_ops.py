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

from smk_tpu.ops import chol as jchol
from smk_tpu.ops import distance as jdist
from smk_tpu.ops import glm as jglm
from smk_tpu.ops import kernels as jkern
from smk_tpu.ops import quantiles as jq
from smk_tpu.ops import truncnorm as jtn
from smk_tpu.parallel import combine as jcomb
from smk_tpu.parallel import partition as jpart
from smk_tpu.utils import diagnostics as jdiag
from smk_torch.ops import chol as tchol
from smk_torch.ops import distance as tdist
from smk_torch.ops import factor_cache as tfc
from smk_torch.ops import glm as tglm
from smk_torch.ops import kernels as tkern
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

    def test_logit_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="A6"):
            tglm.irls_glm(torch.zeros(4), torch.ones(4, 1), link="logit")


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
