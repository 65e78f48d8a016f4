"""The port's K-batched sampler (smk_torch/models/probit_gp.py) against
the JAX sampler, draw for draw.

The JAX sampler draws its randomness from nine subkeys per sweep; the
port takes one SweepNoise per sweep from a noise source. The replay
below draws exactly the numbers the JAX sweep draws from its keys
(jax.random inside this file), so both samplers consume the same
numbers: init_state, one sweep and three sweeps (two burn-in, one
collecting) are compared at m = 40 (3 pad rows), q = 2, p = 2, t = 6,
K = 2, for fused_build "off" and "pallas" (the JAX Pallas kernel in
interpret mode, the port's plain version), and for the variants in
VARIANTS (uncached kriging, normal A prior, tempering, a sparse phi
schedule, binomial trials; the production sampler — collapsed phi,
Nystrom CG with a bf16 operator, blocked solves — on both build paths
and with the logit link; conditional phi with a Jacobi CG; the
collapsed sampler handing its S-factor to the Cholesky u-draw; logit
with two trials). The factor cache after three sweeps is compared too.

Tolerances: every state field, the collected draws and the accept
vectors agree to fp32 roundoff (observed <= 2e-6; asserted at 5e-5
absolute + 5e-5 relative, which leaves room for LAPACK vs XLA
factorizations at m = 40), the accept vectors exactly; the bf16
operator's variants are held at BF16_TOL (its comment gives the
observed error) — except the PAD rows of u on the fused path:
there the u-draw forms R~ s + jit s as S s - d s with d = 1e8 (the pad
rows' pseudo-noise), which cancels two ~1e4-sized terms, so pad-row
latents agree only to ~1e-7 of 1e4 (observed 6e-4; asserted 1e-2).
Pad latents enter no likelihood and no prediction.
"""

# smklint: test-budget=the JAX sweeps run once per config variant in a module fixture (two small jit compiles, interpret-mode Pallas at m=40); each test compares stored arrays
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.config import PriorConfig as JaxPriors
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.models.probit_gp import SubsetData as JaxData
from smk_tpu.models.probit_gp import mtm_proposal_eps
from smk_torch import convert
from smk_torch.config import PriorConfig, SMKConfig
from smk_torch.models import probit_gp as tp
from smk_torch.ops import fused_build as tfb

K, M, Q, P, T = 2, 40, 2, 2, 6
N_PAD = 3
STATE_FIELDS = ("beta", "u", "a", "phi", "chol_r", "phi_accept", "phi_log_step")
CACHE_FIELDS = ("r_mv", "nys_z", "chol_inv", "krige_w", "krige_chol")
TOL = dict(atol=5e-5, rtol=5e-5)
# with the bf16 CG operator, an entry of R~ or of a CG vector whose fp32
# values in the two packages differ by an ulp can round to neighbouring
# bf16 values, which moves the draw by up to ~2^-9 of its scale: observed
# 6.2e-3 relative on u and w, 1.2e-3 on the params (accept vectors equal)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def jax_sweep_noise(key, m, q, p, t, weight=1, *, collapsed=False, link="probit",
                    n_terms=64, proposals=1, family="gaussian", dtype=jnp.float32):
    """The numbers one JAX sweep draws from ``key``
    (probit_gp.py:700-702 and the draw sites it feeds), and the key the
    sweep carries on. Collapsed: component j's proposal and accept
    numbers are scalars from fold_in(kprop, j) and fold_in(kphi, j)
    (probit_gp.py:1015-1018, :1176-1184), the proposal an increment of
    ``family``; with ``proposals`` = J > 1 the multiple-try draws from
    split(fold_in(kprop, j), 3) (probit_gp.py:1073-1079, :1130,
    :1161-1164): J forward increments, the Gumbel draws of the
    candidate selection (jax.random.categorical is argmax(logits +
    gumbel(key))) and J - 1 reverse increments, the last two else None.
    Logit: kz feeds sample_pg's exponential (weight 1) or gamma draws
    (polya_gamma.py:61-63). ``dtype``: the sweep's working dtype."""
    key, kz, kb, kphi, kprop, ku_prior, ku_noise, ka, kpred = jax.random.split(key, 9)
    f32 = dtype
    rows = jax.random.split(ka, q + 1)
    ka_ = jnp.zeros((q, q), f32)
    for l in range(q):
        ka_ = ka_.at[l, : l + 1].set(jax.random.normal(rows[l], (l + 1,), f32))

    def per_component(k, n):
        return jnp.stack([jax.random.normal(kk, (n,), f32) for kk in jax.random.split(k, q)])

    if link == "logit":
        shape = (n_terms, m, q)
        z = (jax.random.exponential(kz, shape, f32) if weight == 1
             else jax.random.gamma(kz, float(weight), shape, f32))
    else:
        z = jax.random.uniform(
            kz, (m, q) if weight == 1 else (weight, m, q), f32, minval=1e-7, maxval=1.0
        )
    sel = rev = None
    if collapsed and proposals > 1:
        keys = [jax.random.split(jax.random.fold_in(kprop, j), 3) for j in range(q)]
        prop = jnp.stack([mtm_proposal_eps(ks[0], (proposals,), f32, family) for ks in keys])
        sel = jnp.stack([jax.random.gumbel(ks[1], (proposals,), f32) for ks in keys])
        rev = jnp.stack([mtm_proposal_eps(ks[2], (proposals - 1,), f32, family) for ks in keys])
    elif collapsed:
        prop = jnp.stack([mtm_proposal_eps(jax.random.fold_in(kprop, j), (), f32, family)
                          for j in range(q)])
    if collapsed:
        acc = jnp.stack([jax.random.uniform(jax.random.fold_in(kphi, j), (), f32, minval=1e-12)
                         for j in range(q)])
    else:
        prop = jax.random.normal(kprop, (q,), f32)
        acc = jax.random.uniform(kphi, (q,), f32, minval=1e-12)
    return key, (
        z,
        jax.random.normal(kb, (q, p), f32),
        prop,
        acc,
        per_component(ku_prior, m),
        per_component(ku_noise, m),
        ka_,
        jax.random.uniform(rows[q], (), f32, minval=1e-12),
        per_component(kpred, t),
        sel,
        rev,
    )


def to_sweep_noise(arrays, collect):
    nz = tp.SweepNoise(*(None if a is None else torch.as_tensor(np.array(a)) for a in arrays))
    return nz if collect else nz._replace(kpred=None)


class JaxSweepReplay:
    """A noise source replaying the JAX key schedule of K subsets (or K*C
    (subset, chain) rows) from their chain keys (one sweep per call, in
    order)."""

    def __init__(self, keys, shapes: tp.SweepShapes, *, collapsed=False, dtype=jnp.float32):
        self.keys = keys
        self._draw = jax.jit(jax.vmap(
            lambda kk: jax_sweep_noise(
                kk, shapes.m, shapes.q, shapes.p, shapes.t, shapes.weight,
                collapsed=collapsed, link=shapes.link, n_terms=shapes.pg_n_terms,
                proposals=shapes.proposals, family=shapes.family, dtype=dtype,
            )
        ))
        self.next_it = 0

    def __call__(self, it, collect):
        assert it == self.next_it, "sweeps must be replayed in order"
        self.next_it += 1
        self.keys, arrays = self._draw(self.keys)
        return to_sweep_noise(arrays, collect)

    def subset(self, lo, hi):
        """The replay of rows [lo, hi) alone, from their own keys (a
        K-chunked run's chunk, as GeneratorNoise.subset)."""
        assert self.next_it == 0, "a chunk replays from the first sweep"
        part = copy.copy(self)
        part.keys = self.keys[lo:hi]
        return part


def _data(weight=1):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(K, M, 2)).astype(np.float32)
    x = np.concatenate(
        [np.ones((K, M, Q, 1)), rng.normal(size=(K, M, Q, P - 1))], -1
    ).astype(np.float32)
    y = rng.binomial(weight, 0.5, size=(K, M, Q)).astype(np.float32)
    mask = np.ones((K, M), np.float32)
    mask[:, -N_PAD:] = 0.0
    y[:, -N_PAD:] = 0.0
    x[:, -N_PAD:] = 0.0
    coords[:, -N_PAD:] += 5.0  # far-away pad pseudo-coordinates
    coords_test = rng.uniform(size=(T, 2)).astype(np.float32)
    x_test = np.ones((T, Q, P), np.float32)
    beta0 = np.array([[0.1, -0.2], [0.3, 0.05]], np.float32)
    return coords, x, y, mask, coords_test, x_test, beta0


def _stack(states, field):
    return np.stack([np.asarray(getattr(s, field)) for s in states])


# the production sampler of bench.py:rung_config at this size: collapsed
# phi on a sparse schedule, the Nystrom-CG u-draw with a bf16 operator,
# blocked triangular solves; rank and block below m = 40 so both engage
PRODUCTION = dict(
    phi_sampler="collapsed", phi_update_every=2, u_solver="cg", cg_precond="nystrom",
    cg_precond_rank=8, cg_iters=8, cg_matvec_dtype="bfloat16", trisolve_block_size=16,
    phi_step=4.0,
)

# (fused_build, other SMKConfig fields, binomial weight): the default
# config on both build paths, then the uncached kriging draw with the
# normal A prior, tempering and a sparse phi schedule, then binomial
# trials; the production sampler on both build paths, conditional phi
# with a Jacobi-CG fp32 u-draw, the collapsed sampler handing its
# S-factor to the Cholesky u-draw, and the logit link (with the
# production sampler, and with two trials: the gamma draws)
VARIANTS = {
    "off": ("off", {}, 1),
    "pallas": ("pallas", {}, 1),
    "pallas-nocache-normal-every2": (
        "pallas",
        dict(krige_cache=False, phi_update_every=2,
             priors=dict(a_prior="normal", temper="power")),
        1,
    ),
    "off-weight2": ("off", {}, 2),
    "production-off": ("off", PRODUCTION, 1),
    "production-pallas": ("pallas", PRODUCTION, 1),
    "conditional-cg-jacobi": (
        "off", dict(u_solver="cg", cg_precond="jacobi", cg_iters=16,
                    trisolve_block_size=16), 1,
    ),
    "collapsed-chol": (
        "pallas", dict(phi_sampler="collapsed", phi_update_every=2,
                       trisolve_block_size=16, phi_step=4.0), 1,
    ),
    "logit-production": ("pallas", dict(PRODUCTION, link="logit"), 1),
    "logit-weight2": ("off", dict(link="logit"), 2),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def reference(request):
    """Three JAX sweeps per subset (burn, burn, collect) with the noise
    each consumed, stored as numpy."""
    fused, extra, weight = VARIANTS[request.param]
    coords, x, y, mask, coords_test, x_test, beta0 = _data(weight)
    extra = dict(extra)
    priors = extra.pop("priors", {})
    cfg = dict(n_subsets=K, n_samples=8, fused_build=fused, **extra)
    jm = JaxSampler(JaxConfig(**cfg, priors=JaxPriors(**priors)), weight=weight)
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
            caches = [
                jm._solve_cache(consts[k], data[k].mask, states[k], predict=True)
                for k in range(K)
            ]
        noise, draws = [], []
        for k in range(K):
            noise.append(jax_sweep_noise(
                states[k].key, M, Q, P, T, weight,
                collapsed=cfg.get("phi_sampler") == "collapsed", link=cfg.get("link", "probit"),
            )[1])
            (states[k], caches[k]), out = steps[collect](
                data[k], consts[k], (states[k], caches[k]), jnp.asarray(it)
            )
            draws.append(out)
        sweeps.append({
            "noise": [np.stack([np.asarray(n[i]) for n in noise]) for i in range(9)],
            "state": {f: _stack(states, f) for f in STATE_FIELDS},
            "draws": None if not collect else tuple(
                np.stack([np.asarray(d[i]) for d in draws]) for i in range(2)
            ),
        })
    return {
        "fused": fused == "pallas", "weight": weight,
        "tol": BF16_TOL if extra.get("cg_matvec_dtype") == "bfloat16" else TOL,
        "config": SMKConfig(**cfg, priors=PriorConfig(**priors)),
        "init": init, "sweeps": sweeps,
        # the factor cache after the three sweeps, K stacked
        "cache": {f: None if getattr(caches[0], f) is None
                  else np.stack([np.asarray(getattr(c, f)) for c in caches])
                  for f in CACHE_FIELDS},
        "data": tp.SubsetData(*(torch.as_tensor(a) for a in (coords, x, y, mask, coords_test, x_test))),
        "beta0": torch.as_tensor(beta0),
    }


def _assert_state(got: tp.SamplerState, want: dict, ref: dict):
    tol, fused = ref["tol"], ref["fused"]
    for f in STATE_FIELDS:
        g = getattr(got, f).numpy()
        w = want[f]
        if f == "u":
            np.testing.assert_allclose(g[:, :-N_PAD], w[:, :-N_PAD], **tol, err_msg=f)
            pad_tol = dict(atol=1e-2, rtol=0) if fused else tol
            np.testing.assert_allclose(g[:, -N_PAD:], w[:, -N_PAD:], **pad_tol, err_msg="u pad")
        elif f == "phi_accept":
            np.testing.assert_array_equal(g, w, err_msg=f)  # equal accept vectors
        else:
            np.testing.assert_allclose(g, w, **tol, err_msg=f)


def _port_sweeps(ref, n):
    model = tp.SpatialGPSampler(ref["config"], weight=ref["weight"])
    data = ref["data"]
    state = model.init_state(data, ref["beta0"])
    consts = model._consts(data)
    cache = model._solve_cache(consts, data.mask, state)
    out = []
    for it in range(n):
        collect = it == 2
        if collect:
            cache = model._solve_cache(consts, data.mask, state, predict=True)
        noise = to_sweep_noise(ref["sweeps"][it]["noise"], collect)
        state, cache, draws = model._gibbs_step(
            data, consts, state, cache, it, noise, collect=collect
        )
        out.append((state, draws))
    return model, state, out, cache


def test_init_state_matches_twin(reference):
    model = tp.SpatialGPSampler(reference["config"], weight=reference["weight"])
    state = model.init_state(reference["data"], reference["beta0"])
    _assert_state(state, reference["init"], reference)


def test_one_sweep_matches_twin(reference):
    _, state, _, _ = _port_sweeps(reference, 1)
    _assert_state(state, reference["sweeps"][0]["state"], reference)


def test_three_sweeps_burn_and_collect_match_twin(reference):
    _, state, out, _ = _port_sweeps(reference, 3)
    for it in range(3):
        _assert_state(out[it][0], reference["sweeps"][it]["state"], reference)
    params, w_star = out[2][1]
    want_params, want_w = reference["sweeps"][2]["draws"]
    np.testing.assert_allclose(params.numpy(), want_params, **reference["tol"])
    np.testing.assert_allclose(w_star.numpy(), want_w, **reference["tol"])
    # the accept vectors of the three sweeps: some moves accepted, some
    # not, the same ones in both packages
    acc = reference["sweeps"][2]["state"]["phi_accept"]
    n_upd = sum(1 for it in range(3) if it % reference["config"].phi_update_every == 0)
    assert 0 < acc.sum() < n_upd * K * Q


def test_factor_cache_after_three_sweeps_matches_twin(reference):
    """The carried operators after the three sweeps — the CG matrix (bf16
    or fp32), the Nystrom factor, the panel inverses, the kriging
    operators — equal the twin's, carried over by
    convert.factor_cache_from_numpy: the same fields populated, the same
    dtypes. A bf16 entry may sit one bf16 step (2^-8 relative, <= 4e-3
    for entries <= 1) from the twin's, where the fp32 entries differ by
    an ulp; everything else is held at the sweep tolerance."""
    _, _, _, cache = _port_sweeps(reference, 3)
    want = convert.factor_cache_from_numpy(reference["cache"], device="cpu")
    for f in CACHE_FIELDS:
        g, w = getattr(cache, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f
        tol = dict(atol=4e-3, rtol=0) if g.dtype == torch.bfloat16 else reference["tol"]
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), **tol, err_msg=f)
    cfg = reference["config"]
    assert (cache.r_mv is not None) == (cfg.u_solver == "cg")
    assert (cache.chol_inv is not None) == (0 < cfg.trisolve_block_size < M)


def test_build_calls_follow_the_sweep_formula(reference):
    """On the fused path the builds of init and three sweeps (two burn-in,
    one collecting) are those the sampler's formula counts
    (probit_gp.build_calls: init, each scan entry, each update sweep,
    each u-draw, the kriging cache), which chip_smoke.py checks on the
    card; the distance-matrix path calls no fused build."""
    tfb.reset_counts()
    _port_sweeps(reference, 3)
    calls = dict(tfb.PLAIN_CALLS)
    if not reference["fused"]:
        assert sum(calls.values()) == 0
        return
    assert calls == tp.build_calls(reference["config"], Q, 3, 2)


def test_run_with_default_generators(reference):
    """run() with the default per-subset generators: finite compressed
    posteriors of the right shapes, reproducible from the seed."""
    cfg = reference["config"]
    model = tp.SpatialGPSampler(cfg, weight=reference["weight"])
    data = reference["data"]
    runs = [
        model.run(data, model.init_state(data, reference["beta0"]), seed=5)
        for _ in range(2)
    ]
    res = runs[0]
    n_par = tp.n_params(Q, P)
    assert tuple(res.param_grid.shape) == (K, cfg.n_quantiles, n_par)
    assert tuple(res.w_grid.shape) == (K, cfg.n_quantiles, T * Q)
    assert tuple(res.param_samples.shape) == (K, cfg.n_kept, n_par)
    assert torch.isfinite(res.param_grid).all() and torch.isfinite(res.w_grid).all()
    assert ((res.phi_accept_rate >= 0) & (res.phi_accept_rate <= 1)).all()
    assert torch.equal(runs[0].param_grid, runs[1].param_grid)


def test_sweep_noise_shapes_and_ranges():
    shapes = tp.SweepShapes(k=3, m=7, q=2, p=3, t=4, weight=1)
    gens = tp.subset_generators(0, 3, "cpu")
    nz = tp.GeneratorNoise(gens, shapes)(0, True)
    assert tuple(nz.kz.shape) == (3, 7, 2) and float(nz.kz.min()) >= 1e-7
    assert tuple(nz.kb.shape) == (3, 2, 3)
    assert tuple(nz.ku_prior.shape) == tuple(nz.ku_noise.shape) == (3, 2, 7)
    assert tuple(nz.ka.shape) == (3, 2, 2) and tuple(nz.ka_u.shape) == (3,)
    assert tuple(nz.kpred.shape) == (3, 2, 4)
    assert tp.GeneratorNoise(gens, shapes)(1, False).kpred is None
    binom = tp.draw_sweep_noise(torch.Generator().manual_seed(1),
                                shapes._replace(weight=4), collect=False)
    assert tuple(binom.kz.shape) == (4, 7, 2)
    # one independent stream per subset
    assert not torch.equal(nz.kb[0], nz.kb[1])
