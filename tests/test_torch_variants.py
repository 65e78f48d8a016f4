"""The sampler knobs of ROADMAP A6 in the port (smk_torch) against the JAX
twin: multiple-try phi (three proposal families, both build paths),
the blocked Cholesky, float64, bf16 correlation builds, several chains,
K-chunked fits, split-R-hat and the matmul precision scope.

The sweep variants replay the JAX key schedule into the port, as
test_torch_sampler.py does, with the multiple-try draws added to the
replay (jax_sweep_noise: the family's forward increments, the Gumbel
draws of the candidate selection and the reverse increments, from
split(fold_in(kprop, j), 3)): init_state and three sweeps (two burn-in,
one collecting) at m = 40 (3 pad rows), q = 2, p = 2, t = 6, K = 2.
The float64 variants run the JAX sweeps under jax.enable_x64 (the
Pallas kernel in interpret mode then builds in float64).

Tolerances: float32 states and draws at test_torch_sampler's TOL (5e-5
absolute + 5e-5 relative; LAPACK vs XLA factorizations at m = 40), the
production-style variant with its bf16 CG operator at BF16_TOL (observed
<= 2e-6 everywhere in float32 but the bf16 builds); float64 at 1e-10
(observed <= 3e-15); the bf16 correlation build at BF16_BUILD_TOL
(below; observed 7.7e-3). Accept vectors are equal exactly in every
variant.
"""

# smklint: test-budget=the JAX reference sweeps run once per variant in a module fixture (two small jit compiles at m=40, interpret-mode Pallas) and the two-chain JAX fit once; each test compares stored arrays or runs the port at n <= 200
import contextlib
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.models.probit_gp import SubsetData as JaxData
from smk_tpu.ops import chol as jchol
from smk_tpu.utils import diagnostics as jdiag
from smk_torch import SMKConfig, api, convert, fit_meta_kriging
from smk_torch.config import check_ported
from smk_torch.models import probit_gp as tp
from smk_torch.ops import chol as tchol
from smk_torch.ops import fused_build as tfb
from smk_torch.parallel import executor
from smk_torch.parallel.partition import random_partition
from smk_torch.utils import diagnostics as tdiag
from test_torch_api import JaxRandomness, _problem
from test_torch_sampler import (
    BF16_TOL,
    K,
    M,
    P,
    PRODUCTION,
    Q,
    STATE_FIELDS,
    T,
    TOL,
    _assert_state,
    _data,
    _port_sweeps,
    _stack,
    jax_sweep_noise,
)

TOL64 = dict(atol=1e-10, rtol=1e-10)
# a bf16 correlation entry can round to the neighbouring bf16 value where
# the two packages' intermediates differ (XLA may keep -phi * dist in
# fp32 inside its fusion; PyTorch rounds each bf16 op): 2^-8 relative
BF16_BUILD_TOL = dict(atol=2e-2, rtol=2e-2)
MTM = dict(phi_sampler="collapsed", phi_proposals=3, phi_update_every=2, phi_step=2.0)

# (fused_build, other SMKConfig fields, dtype)
VARIANTS = {
    "mtm-gaussian-off": ("off", MTM, "float32"),
    "mtm-gaussian-pallas": ("pallas", MTM, "float32"),
    "mtm-student_t-off": ("off", dict(MTM, phi_proposal_family="student_t"), "float32"),
    "mtm-student_t-pallas": ("pallas", dict(MTM, phi_proposal_family="student_t"), "float32"),
    "mtm-mixture-off": ("off", dict(MTM, phi_proposal_family="mixture"), "float32"),
    "mtm-mixture-pallas": ("pallas", dict(MTM, phi_proposal_family="mixture"), "float32"),
    # the production sampler's CG u-draw (no S-factor threading)
    "mtm-production-pallas": (
        "pallas", dict(PRODUCTION, phi_proposals=3, phi_proposal_family="student_t"),
        "float32"),
    # a step so wide that every candidate's logit lands where its
    # sigmoid is exactly 0 or 1: every forward weight is -inf
    "mtm-all-inf": ("off", dict(MTM, phi_step=1e4), "float32"),
    "chol-blocked-pallas": (
        "pallas", dict(phi_sampler="collapsed", chol_block_size=16, trisolve_block_size=16,
                       phi_step=4.0), "float32"),
    "bf16-build-off": ("off", dict(build_dtype="bfloat16"), "float32"),
    "f64-off": ("off", {}, "float64"),
    "f64-mtm-pallas": ("pallas", MTM, "float64"),
}


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def _reference(name):
    """Three JAX sweeps per subset (burn, burn, collect) of variant
    ``name``, with the noise each consumed, stored as numpy."""
    fused, extra, dtype = VARIANTS[name]
    arrays = _data()
    if dtype == "float64":
        arrays = tuple(a.astype(np.float64) for a in arrays)
    coords, x, y, mask, coords_test, x_test, beta0 = arrays
    cfg = dict(n_subsets=K, n_samples=8, fused_build=fused, dtype=dtype, **extra)
    collapsed = cfg.get("phi_sampler") == "collapsed"
    with _x64(dtype):
        jdt = jnp.float64 if dtype == "float64" else jnp.float32
        jcfg = JaxConfig(**cfg)
        jm = JaxSampler(jcfg)
        keys = jax.random.split(jax.random.key(3), K)
        data = [
            JaxData(*(jnp.asarray(a[k]) for a in (coords, x, y, mask)),
                    jnp.asarray(coords_test), jnp.asarray(x_test))
            for k in range(K)
        ]
        states = [jm.init_state(keys[k], data[k], jnp.asarray(beta0)) for k in range(K)]
        init = {f: _stack(states, f) for f in STATE_FIELDS}
        consts = [jm._consts(d) for d in data]
        caches = [jm._solve_cache(consts[k], data[k].mask, states[k]) for k in range(K)]
        steps = {c: jax.jit(lambda d, cs, carry, it, c=c: jm._gibbs_step(d, cs, carry, it, collect=c))
                 for c in (False, True)}
        sweeps = []
        for it, collect in enumerate((False, False, True)):
            if collect:
                caches = [jm._solve_cache(consts[k], data[k].mask, states[k], predict=True)
                          for k in range(K)]
            noise, draws = [], []
            for k in range(K):
                noise.append(jax_sweep_noise(
                    states[k].key, M, Q, P, T, collapsed=collapsed,
                    proposals=jcfg.phi_proposals, family=jcfg.phi_proposal_family, dtype=jdt,
                )[1])
                (states[k], caches[k]), out = steps[collect](
                    data[k], consts[k], (states[k], caches[k]), jnp.asarray(it)
                )
                draws.append(out)
            sweeps.append({
                "noise": [None if noise[0][i] is None
                          else np.stack([np.asarray(n[i]) for n in noise]) for i in range(11)],
                "state": {f: _stack(states, f) for f in STATE_FIELDS},
                "draws": None if not collect else tuple(
                    np.stack([np.asarray(d[i]) for d in draws]) for i in range(2)
                ),
            })
    tol = TOL64 if dtype == "float64" else TOL
    if extra.get("cg_matvec_dtype") == "bfloat16":
        tol = BF16_TOL
    if extra.get("build_dtype") == "bfloat16":
        tol = BF16_BUILD_TOL
    return {
        "name": name, "fused": fused == "pallas", "weight": 1, "tol": tol,
        "config": SMKConfig(**cfg), "init": init, "sweeps": sweeps,
        "data": tp.SubsetData(*(torch.as_tensor(a) for a in (coords, x, y, mask, coords_test, x_test))),
        "beta0": torch.as_tensor(beta0),
    }


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def reference(request):
    return _reference(request.param)


def test_variant_init_state_matches_twin(reference):
    model = tp.SpatialGPSampler(reference["config"])
    state = model.init_state(reference["data"], reference["beta0"])
    _assert_state(state, reference["init"], reference)
    assert state.chol_r.dtype == reference["data"].x.dtype


def test_variant_three_sweeps_match_twin(reference):
    """Every state field after each of the three sweeps, and the
    collected draws; the accept vectors exactly."""
    _, _, out, _ = _port_sweeps(reference, 3)
    for it in range(3):
        _assert_state(out[it][0], reference["sweeps"][it]["state"], reference)
    params, w_star = out[2][1]
    want_params, want_w = reference["sweeps"][2]["draws"]
    np.testing.assert_allclose(params.numpy(), want_params, **reference["tol"])
    np.testing.assert_allclose(w_star.numpy(), want_w, **reference["tol"])


def test_variant_build_calls_follow_the_sweep_formula(reference):
    """Fused: the plain builds of init and three sweeps are what
    probit_gp.build_calls counts (multiple-try: two shifted builds per
    component per update, of depths J+1 and J-1); unfused: none."""
    tfb.reset_counts()
    _port_sweeps(reference, 3)
    calls = dict(tfb.PLAIN_CALLS)
    if not reference["fused"]:
        assert sum(calls.values()) == 0
        return
    assert calls == tp.build_calls(reference["config"], Q, 3, 2)


def test_variant_factorization_counts(reference):
    """The collecting sweep's factorizations per subset (the cache is
    rebuilt at the collecting entry): a multiple-try update counts
    (J+1) + (J-1) + 1 logical factorizations in 3 batched calls per
    component, a single-try one 2 + 1 in 3; thread_s adds none."""
    model, _, _, cache = _port_sweeps(reference, 3)
    cfg = reference["config"]
    if cfg.phi_sampler != "collapsed":
        return
    j = cfg.phi_proposals
    per_comp = (2 * j + 1, 3) if j > 1 else (3, 3)
    assert (cache.n_chol, cache.n_chol_calls) == (Q * per_comp[0], Q * per_comp[1])


def test_mtm_every_forward_weight_minus_inf_selects_index_zero_and_rejects():
    """With a step of 1e4 every candidate's sigmoid is exactly 0 or 1 in
    sweep 0, so every forward log-weight is -inf: the selection falls on
    index 0 (argmax of -inf + Gumbel) and the -inf forward sum rejects
    the move in both packages; phi stays where it was."""
    ref = _reference("mtm-all-inf")
    state0 = ref["init"]
    eps = ref["sweeps"][0]["noise"][2]  # (K, q, J) forward increments
    lo, hi = ref["config"].priors.phi_min, ref["config"].priors.phi_max
    phi = torch.as_tensor(state0["phi"])
    t_cur = torch.log((phi - lo) / (hi - phi))
    sig = torch.sigmoid(t_cur[..., None] + 1e4 * torch.as_tensor(eps))
    assert bool(torch.isinf(torch.log(sig * (1.0 - sig))).all())
    _, _, out, _ = _port_sweeps(ref, 1)
    assert float(out[0][0].phi_accept.sum()) == 0.0
    assert float(ref["sweeps"][0]["state"]["phi_accept"].sum()) == 0.0
    assert torch.equal(out[0][0].phi, phi)


# ----------------------------------------------------------------------
# the blocked Cholesky
# ----------------------------------------------------------------------
def _spd(rng, batch, m):
    pts = rng.uniform(size=(batch, m, 2))
    dist = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    return np.exp(-6.0 * dist).astype(np.float32)


@pytest.mark.parametrize(
    "m, block, bad_row",
    [(40, 16, None), (48, 16, None), (12, 16, None), (40, 16, 20)],
    ids=["ragged", "multiple", "m-le-block", "non-pd-block"],
)
def test_blocked_cholesky_matches_twin(m, block, bad_row):
    """m not a multiple of the block (identity pad), a multiple, m at
    most the block (the native factor), and a diagonal block that is
    not positive definite in one of two batch elements: NaN in the same
    places as the twin's (its block column and every later one), the
    rest equal to fp32 roundoff."""
    a = _spd(np.random.default_rng(m), 2, m)
    if bad_row is not None:
        a[1, bad_row, bad_row] = -1.0
    jit = 2e-4
    want = np.asarray(jchol.blocked_cholesky(jnp.asarray(a), jit, block))
    got = tchol.blocked_cholesky(torch.as_tensor(a), jit, block).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), **TOL)
    assert np.isnan(want).any() == (bad_row is not None)
    if bad_row is not None:
        assert np.isfinite(got[0]).all()
        assert np.isfinite(got[1, :, : bad_row // block * block]).all()


# ----------------------------------------------------------------------
# several chains, K chunks, split-R-hat
# ----------------------------------------------------------------------
CHAIN_KW = dict(n_subsets=2, n_samples=16, n_chains=2)


@pytest.fixture(scope="module")
def chain_fits():
    data = _problem()
    key = jax.random.key(11)
    ref = jax_fit(key, *data, config=JaxConfig(**CHAIN_KW))
    port = fit_meta_kriging(*data, config=SMKConfig(**CHAIN_KW), randomness=JaxRandomness(key),
                            device="cpu")
    return ref, port


@pytest.mark.parametrize(
    "field",
    ["param_grid", "w_grid", "p_quant", "sample_par", "phi_accept_rate", "param_rhat",
     "w_rhat", "subset_results.param_samples", "subset_results.w_samples"],
)
def test_two_chain_fit_matches_twin_draw_for_draw(chain_fits, field):
    """A whole n_chains=2 fit: K*C = 4 chain streams (the twin's
    split(key, K*C) reshaped (K, C)), the draws pooled chain-major, the
    cross-chain R-hat and the chain-averaged accept rate."""
    ref, port = chain_fits
    got, want = port, ref
    for part in field.split("."):
        got, want = getattr(got, part), getattr(want, part)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_two_chain_fit_sums_ess_over_chains(chain_fits):
    ref, port = chain_fits
    for f in ("param_ess", "w_ess"):
        np.testing.assert_allclose(getattr(port, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-4)
    n_kept = SMKConfig(**CHAIN_KW).n_kept
    assert tuple(port.subset_results.param_samples.shape[:2]) == (2, 2 * n_kept)
    assert bool(torch.isfinite(port.param_rhat).all())


def test_split_rhat_matches_twin():
    draws = np.random.default_rng(5).normal(size=(3, 40, 4)).cumsum(1).astype(np.float32)
    got = tdiag.split_rhat(torch.as_tensor(draws))
    want = np.stack([np.asarray(jdiag.split_rhat(jnp.asarray(d))) for d in draws])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(tdiag.split_rhat(torch.as_tensor(draws[0, :, 0])).numpy(),
                               np.asarray(jdiag.split_rhat(jnp.asarray(draws[0, :, 0]))),
                               rtol=1e-5)


@pytest.mark.parametrize("n_chains", [1, 2])
def test_chunked_fit_equals_the_unchunked_run(n_chains):
    """fit_subsets_vmap(chunk_size=...) runs the subsets a chunk at a
    time, each chunk with its own rows' generators: the same draws as
    one batched run."""
    y, x, coords, coords_test, x_test = (torch.as_tensor(a) for a in _problem())
    cfg = SMKConfig(n_subsets=4, n_samples=8, n_chains=n_chains, fused_build="pallas",
                    phi_sampler="collapsed", phi_proposals=2)
    part = random_partition(torch.randperm(y.shape[0], generator=torch.Generator().manual_seed(0)),
                            y, x, coords, 4)
    model = tp.SpatialGPSampler(cfg)
    whole = executor.fit_subsets_vmap(model, part, coords_test, x_test)
    guard = model.guard_rejects
    chunked = executor.fit_subsets_vmap(model, part, coords_test, x_test, chunk_size=2)
    for f in tp.SubsetResult._fields:
        np.testing.assert_allclose(getattr(chunked, f).numpy(), getattr(whole, f).numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    assert torch.equal(model.guard_rejects, guard)
    assert tuple(guard.shape) == (4 * n_chains,)
    with pytest.raises(ValueError, match="divide"):
        executor.fit_subsets_vmap(model, part, coords_test, x_test, chunk_size=3)


# ----------------------------------------------------------------------
# the remaining knobs
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "knob",
    [dict(phi_sampler="collapsed", phi_proposals=2),
     dict(phi_sampler="collapsed", phi_proposal_family="student_t"),
     dict(n_chains=2), dict(chol_block_size=512), dict(build_dtype="bfloat16"),
     dict(dtype="float64"), dict(matmul_precision="default")],
)
def test_a6_knobs_are_ported(knob):
    check_ported(SMKConfig(**knob))


def test_matmul_precision_scope_restores_the_callers_settings():
    """On the card the fit runs under the config's precision and hands
    the caller's settings back; on the CPU it sets nothing (the twin's
    CPU backend computes fp32 products in full fp32 whatever the
    precision), so a "default" fit there equals a "highest" one."""
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = False
        for name, inside in (("highest", ("highest", False)), ("tensorfloat32", ("high", True)),
                             ("bfloat16", ("medium", True))):
            with api.matmul_precision(name, "cuda"):
                assert (torch.get_float32_matmul_precision(),
                        torch.backends.cudnn.allow_tf32) == inside
            assert torch.get_float32_matmul_precision() == "high"
            assert torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(RuntimeError):
            with api.matmul_precision("highest", "cuda"):
                raise RuntimeError("a failing fit")
        assert torch.get_float32_matmul_precision() == "high"
        data = _problem()
        fits = [fit_meta_kriging(*data, config=SMKConfig(n_subsets=2, n_samples=6,
                                                         matmul_precision=mp),
                                 seed=2, device="cpu") for mp in ("default", "highest")]
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.equal(fits[0].p_quant, fits[1].p_quant)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_mtm_workspace_and_warning_match_twin():
    for j in (1, 4, 8):
        kw = dict(phi_sampler="collapsed", phi_proposals=j)
        assert SMKConfig(**kw).mtm_workspace_bytes(3906) == JaxConfig(**kw).mtm_workspace_bytes(3906)
    assert SMKConfig(phi_sampler="collapsed", phi_proposals=4).mtm_workspace_bytes(3906) == (
        2 * 5 * 3906 * 3906 * 4)
    with pytest.warns(UserWarning, match="phi_proposals=4"):
        SMKConfig(phi_sampler="collapsed", phi_proposals=4).warn_if_mtm_workspace_large(16384)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SMKConfig(phi_sampler="collapsed", phi_proposals=4).warn_if_mtm_workspace_large(1024)


def test_generator_noise_draws_the_multiple_try_fields():
    """J > 1: kprop (K, q, J), the Gumbel draws (K, q, J) and the reverse
    increments (K, q, J - 1), from each row's own generator, after the
    single-try fields (whose numbers do not move); the families' draws
    are symmetric increments (student_t's tails are heavier than the
    gaussian's, the mixture's wide half is 8 times as wide)."""
    base = tp.SweepShapes(k=2, m=7, q=2, p=3, t=4)
    single = tp.GeneratorNoise(tp.subset_generators(0, 2, "cpu"), base)(0, True)
    for family in ("gaussian", "student_t", "mixture"):
        shapes = base._replace(proposals=4, family=family)
        nz = tp.GeneratorNoise(tp.subset_generators(0, 2, "cpu"), shapes)(0, True)
        assert tuple(nz.kprop.shape) == tuple(nz.ksel.shape) == (2, 2, 4)
        assert tuple(nz.krev.shape) == (2, 2, 3)
        for f in ("kz", "kb", "kphi", "ku_prior", "ku_noise", "ka", "ka_u", "kpred"):
            assert torch.equal(getattr(nz, f), getattr(single, f)), f
    assert single.ksel is None and single.krev is None
    gen = torch.Generator().manual_seed(4)
    n = 200_000
    draws = {f: tp.mtm_proposal_eps(gen, (n,), f) for f in ("gaussian", "student_t", "mixture")}
    for f, d in draws.items():
        assert abs(float(d.mean())) < 0.05, f
    # median |x|: 0.674 (gaussian), 0.765 (t with 3 df), 1.47 (the mixture)
    med = {f: float(d.abs().median()) for f, d in draws.items()}
    assert 0.65 < med["gaussian"] < 0.70 and 0.73 < med["student_t"] < 0.80
    assert 1.40 < med["mixture"] < 1.55
    kurt = {f: float((d ** 4).mean() / (d ** 2).mean() ** 2) for f, d in draws.items()}
    assert 2.8 < kurt["gaussian"] < 3.2 and kurt["student_t"] > 6.0 and kurt["mixture"] > 4.5
    g = tp.gumbel_draws(gen, (n,))
    assert abs(float(g.mean()) - 0.5772) < 0.02
    # K * C generators, subset-major: row k * C + c
    keys = executor.subset_chain_keys(0, 2, 3, "cpu")
    assert [g.initial_seed() for g in keys] == [
        g.initial_seed() for g in tp.subset_generators(0, 6, "cpu")]
    shapes = tp.sweep_shapes(SMKConfig(n_chains=2, phi_sampler="collapsed", phi_proposals=3,
                                       phi_proposal_family="mixture"), 5, 7, 2, 3, 4)
    assert (shapes.k, shapes.proposals, shapes.family) == (10, 3, "mixture")
    assert tp.sweep_shapes(SMKConfig(phi_proposal_family="mixture"), 5, 7, 2, 3, 4).family == "gaussian"


def test_state_from_numpy_carries_chains_and_float64():
    """A JAX state with a (K, C) lead becomes K*C rows, subset-major; a
    float64 state stays float64."""
    rng = np.random.default_rng(1)
    shapes = dict(beta=(Q, P), u=(M, Q), a=(Q, Q), phi=(Q,), chol_r=(Q, M, M),
                  phi_accept=(Q,), phi_log_step=(Q,))
    src = {f: rng.normal(size=(K, 2) + s) for f, s in shapes.items()}
    state, gens = convert.sampler_state_from_numpy(src)
    assert len(gens) == 2 * K
    assert state.beta.dtype == torch.float64 and tuple(state.beta.shape) == (2 * K, Q, P)
    assert torch.equal(state.u[3], torch.as_tensor(src["u"][1, 1]))
    state32, _ = convert.sampler_state_from_numpy({f: a.astype(np.float32) for f, a in src.items()})
    assert state32.chol_r.dtype == torch.float32


@pytest.mark.gpu
def test_double_tile_kernel_matches_plain_version():
    """The double kernels (every float64 build on the card: the masked
    and shifted builds on the symmetric kernel, the cross build with a
    row mask and the small square stack on the narrow one) against
    their plain version at float64: 12 launches, none of the double tile
    kernel (the reference) or of the float32 kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused build kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, m, t = 2, 147, 33
    coords = torch.rand((k, m, 2), generator=gen, device=dev, dtype=torch.float64)
    test = torch.rand((t, 2), generator=gen, device=dev, dtype=torch.float64)
    phis = 4.0 + 8.0 * torch.rand((k, 3), generator=gen, device=dev, dtype=torch.float64)
    mask = (torch.rand((k, m), generator=gen, device=dev) > 0.1).double()
    shift = 0.5 + torch.rand((k, m), generator=gen, device=dev, dtype=torch.float64)
    tfb.reset_counts()
    for model in ("exponential", "matern32", "matern52"):
        cases = [
            (tfb.fused_masked_shifted_build(coords, phis, mask, shift, model),
             tfb.plain_build(coords, coords, phis, model, mask=mask, shift=shift, zero_diag=True)),
            (tfb.fused_masked_correlation_stack(coords, phis, mask, model),
             tfb.plain_build(coords, coords, phis, model, mask=mask, zero_diag=True)),
            (tfb.fused_cross_correlation(coords, test, phis, model, row_mask=mask),
             tfb.plain_build(coords, test[None], phis, model, row_mask=mask)),
            (tfb.fused_correlation_stack(test, phis, model),
             tfb.plain_build(test[None].expand(k, t, 2), test[None], phis, model, zero_diag=True)),
        ]
        for got, want in cases:
            assert got.dtype == torch.float64
            torch.testing.assert_close(got, want, atol=1e-13, rtol=1e-13)
    assert tfb.LAYOUT_LAUNCHES[tfb.SYMMETRIC_F64] == 6
    assert tfb.LAYOUT_LAUNCHES[tfb.NARROW_F64] == 6
    assert sum(tfb.LAYOUT_LAUNCHES.values()) == 12
    assert tfb.LAYOUT_LAUNCHES[tfb.TILED_F64] == 0
    with pytest.raises(TypeError, match="float32 or float64"):
        tfb.fused_correlation_stack(test.half(), phis, "exponential")
