"""The port's Vecchia/NNGP subset engine (smk_torch/ops/vecchia.py and
its seam in models/probit_gp.py) against the JAX twin.

Ops: every function of ops/vecchia.py, K = 2 subsets of m = 60 from a
ragged n = 113 (7 pad rows on the far line), two decays per subset (a
middle axis, as the sampler's q), nn 4 and 16, float32 and float64
(the twin under jax.enable_x64), and the bf16 correlation build. Each
twin function runs vmapped over the subsets and decays (as the twin's
sampler runs it); the port's runs K-batched.
The port's own neighbor build is held to the twin's as sets where
valid; the other ops take the twin's geometry, so that a near-tie at
the nn-th neighbor (the two packages' distances agree to fp32 roundoff)
cannot pick a different site. Then the masking law the twin's
tests/test_vecchia.py pins, on the port: pad sites are identities, the
first site has no predecessors, no real site conditions on a pad, pad
terms are phi-free; F^T is the adjoint of F and q_diag the diagonal of
the materialized Q.

Sampler: init_state, one sweep and three sweeps (two burn-in, one
collecting) of the Vecchia sampler draw for draw against the twin's,
by the replay of test_torch_sampler.py (jax_sweep_noise), at m = 40
(3 pad rows), K = 2, p = 2, t = 6: q = 1 with nn 16, q = 2 with nn 4
on a sparse phi schedule under the logit link, and two chains; the twin's
neighbor geometry, converted, is fed to the port. Then one whole
fit_meta_kriging against the twin's at n = 197 (one pad row), where
each package builds its own geometry.

Tolerances: float32 1e-5 + 1e-5 |x| for the ops (observed <= 8e-6 on a
loglik of ~56); float64 1e-12 (observed <= 2e-14); the bf16 build at
test_torch_sampler's BF16_TOL; sweeps and the fit at its TOL (5e-5 +
5e-5 |x|), the accept vectors equal.
"""

# smklint: test-budget=each JAX reference (ops per subset, three jitted sweeps per variant at m=40, one vecchia fit at n=197) runs once in a module fixture; each test compares stored arrays or runs the port at m <= 100
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.models.probit_gp import SubsetData as JaxData
from smk_tpu.ops import vecchia as jv
from smk_torch import SMKConfig, convert, fit_meta_kriging
from smk_torch.models import probit_gp as tp
from smk_torch.ops import fused_build as tfb
from smk_torch.ops import vecchia as tv
from smk_torch.parallel.partition import partition_from_indices
from test_torch_api import JaxRandomness, _problem
from test_torch_sampler import BF16_TOL, STATE_FIELDS, TOL, _data, _stack, jax_sweep_noise

K = 2
# ops: subsets of OPS_M rows from a ragged n, t test sites, two decays
OPS_M, OPS_PAD, OPS_T = 60, 7, 7
PHIS = np.array([[4.0, 9.5], [6.0, 11.0]])
JIT = 1e-5
TOL32 = dict(atol=1e-5, rtol=1e-5)
TOL64 = dict(atol=1e-12, rtol=1e-12)
MODEL = "exponential"


def _x64(dtype):
    return jax.enable_x64(True) if dtype == "float64" else contextlib.nullcontext()


def _t(a, long=False):
    return torch.as_tensor(np.array(a), dtype=torch.long if long else None)


# ----------------------------------------------------------------------
# ops
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ops_world(nn, dtype):
    """The port's partition of a ragged n into K subsets and everything
    the twin computes on it, per subset k and decay j, as numpy."""
    rng = np.random.default_rng(nn)
    npt = np.float64 if dtype == "float64" else np.float32
    n = K * OPS_M - OPS_PAD
    pts = rng.uniform(size=(n, 2)).astype(npt)
    zeros = torch.zeros((n, 1), dtype=getattr(torch, dtype))
    # the last subset's tail is OPS_PAD pad rows (a random partition of a
    # ragged n pads fewer than K rows)
    index = torch.cat([torch.as_tensor(rng.permutation(n)), torch.full((OPS_PAD,), -1)])
    part = partition_from_indices(zeros, zeros[..., None], torch.as_tensor(pts),
                                  index.reshape(K, OPS_M))
    coords, mask = part.coords.numpy(), part.mask.numpy()
    ct = rng.uniform(size=(OPS_T, 2)).astype(npt)
    phi = PHIS.astype(npt)
    u, w, b_vec, eps1, eps2 = (rng.normal(size=(K, 2, OPS_M)).astype(npt) for _ in range(5))
    c_safe = rng.uniform(0.5, 2.0, size=(K, 2, OPS_M)).astype(npt)
    z = rng.normal(size=(K, 2, OPS_T)).astype(npt)
    out = {"coords": coords, "mask": mask, "ct": ct, "phi": phi, "u": u, "w": w,
           "b_vec": b_vec, "c_safe": c_safe, "eps1": eps1, "eps2": eps2, "z": z}
    with _x64(dtype):
        a = {f: jnp.asarray(v) for f, v in out.items()}
        geo = jax.vmap(lambda c, mk: jv.build_neighbor_consts(c, mk, nn))(a["coords"], a["mask"])
        tgeo = jax.vmap(lambda c, mk: jv.build_test_neighbor_consts(c, mk, a["ct"], nn))(
            a["coords"], a["mask"])
        for name, g in (("nbr", geo), ("tnbr", tgeo)):
            for i, f in enumerate(("idx", "dist", "valid")):
                out[f"{name}_{f}"] = np.asarray(g[i])
                a[f"{name}_{f}"] = g[i]

        def per(fn, *names):
            """fn over subsets k and decays j: the arguments ``names`` of
            a, each (K, 2, ...) or, where its name is shared by the
            decays (geometry), (K, ...)."""
            inner = tuple(None if n.startswith(("nbr", "tnbr")) else 0 for n in names)
            return np.asarray(jax.jit(jax.vmap(jax.vmap(fn, in_axes=inner)))(
                *(a[n] for n in names)))

        for pre, key in (("nbr", "packed"), ("tnbr", "tpacked")):
            out[key] = per(lambda d, v, ph: jv.vecchia_coeffs(d, v, ph, JIT, MODEL),
                           f"{pre}_dist", f"{pre}_valid", "phi")
            a[key] = jnp.asarray(out[key])
        if dtype == "float32":
            out["packed_bf16"] = per(
                lambda d, v, ph: jv.vecchia_coeffs(d, v, ph, JIT, MODEL, "bfloat16"),
                "nbr_dist", "nbr_valid", "phi")
        out["loglik"] = per(jv.vecchia_loglik, "packed", "nbr_idx", "u")
        out["f"] = per(jv.vecchia_f_matvec, "packed", "nbr_idx", "u")
        out["ft"] = per(jv.vecchia_ft_matvec, "packed", "nbr_idx", "w")
        out["q"] = per(jv.vecchia_q_matvec, "packed", "nbr_idx", "u")
        out["q_diag"] = per(jv.vecchia_q_diag, "packed", "nbr_idx")
        out["draw"] = per(lambda *x: jv.vecchia_posterior_draw(*x, 8), "packed", "nbr_idx",
                          "b_vec", "c_safe", "eps1", "eps2")
        out["krige"] = per(jv.vecchia_krige_draw, "tpacked", "tnbr_idx", "u", "z")
    return out


OPS_CASES = [(nn, dt) for nn in (4, 16) for dt in ("float32", "float64")]


@pytest.fixture(scope="module", params=OPS_CASES, ids=[f"nn{nn}-{dt}" for nn, dt in OPS_CASES])
def ops(request):
    nn, dtype = request.param
    w = _ops_world(nn, dtype)
    return {**w, "nn": nn, "dtype": dtype, "tol": TOL64 if dtype == "float64" else TOL32}


def _sets(idx, valid):
    return [[set(idx[k, i][valid[k, i] > 0].tolist()) for i in range(idx.shape[1])]
            for k in range(idx.shape[0])]


def test_neighbor_sets_match_twin(ops):
    """The port's own neighbor build: the same valid slots and, where
    valid, the same neighbor sets (train predecessors and test sites);
    the block distances of those sets agree in the twin's order (the
    norm-trick distances of both packages differ by fp32 roundoff:
    observed 3.1e-6)."""
    got = tv.build_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]), ops["nn"])
    tgot = tv.build_test_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]), _t(ops["ct"]),
                                         ops["nn"])
    for pre, (idx, dist, valid) in (("nbr", got), ("tnbr", tgot)):
        assert idx.dtype == torch.long
        np.testing.assert_array_equal(valid.numpy(), ops[f"{pre}_valid"])
        assert _sets(idx.numpy(), valid.numpy()) == _sets(ops[f"{pre}_idx"], ops[f"{pre}_valid"])
        # at the seeded inputs the valid slots come in the twin's order
        live = ops[f"{pre}_valid"] > 0
        np.testing.assert_array_equal(idx.numpy()[live], ops[f"{pre}_idx"][live])
        blk = np.concatenate([live, np.ones(live.shape[:-1] + (1,), bool)], -1)
        both = blk[..., :, None] & blk[..., None, :]
        np.testing.assert_allclose(dist.numpy()[both], ops[f"{pre}_dist"][both], **ops["tol"])


def _geo(ops, pre="nbr"):
    return _t(ops[f"{pre}_dist"])[:, None], _t(ops[f"{pre}_valid"])[:, None]


def _packed(ops):
    return _t(ops["packed"]), _t(ops["nbr_idx"], long=True)


OPS = {
    "coeffs": lambda o: tv.vecchia_coeffs(*_geo(o), _t(o["phi"]), JIT, MODEL),
    "test_coeffs": lambda o: tv.vecchia_coeffs(*_geo(o, "tnbr"), _t(o["phi"]), JIT, MODEL),
    "loglik": lambda o: tv.vecchia_loglik(*_packed(o), _t(o["u"])),
    "f": lambda o: tv.vecchia_f_matvec(*_packed(o), _t(o["u"])),
    "ft": lambda o: tv.vecchia_ft_matvec(*_packed(o), _t(o["w"])),
    "q": lambda o: tv.vecchia_q_matvec(*_packed(o), _t(o["u"])),
    "q_diag": lambda o: tv.vecchia_q_diag(*_packed(o)),
    "draw": lambda o: tv.vecchia_posterior_draw(
        _t(o["packed"]).flatten(0, 1), _t(o["nbr_idx"], long=True).repeat_interleave(2, 0),
        *(_t(o[f]).flatten(0, 1) for f in ("b_vec", "c_safe", "eps1", "eps2")), 8,
    ).reshape(K, 2, -1),
    "krige": lambda o: tv.vecchia_krige_draw(_t(o["tpacked"]), _t(o["tnbr_idx"], long=True),
                                             _t(o["u"]), _t(o["z"])),
}
WANT = {"coeffs": "packed", "test_coeffs": "tpacked"}


@pytest.mark.parametrize("op", sorted(OPS))
def test_op_matches_twin(ops, op):
    """Each op K-batched, with a middle axis of two decays (the
    posterior draw takes one packed set a row, so the (K, 2) rows are
    flattened into its batch), against the twin per subset and decay."""
    got = OPS[op](ops)
    want = ops[WANT.get(op, op)]
    assert got.dtype == getattr(torch, ops["dtype"])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **ops["tol"])


def test_bf16_build_matches_twin():
    """build_dtype="bfloat16": the correlation in bf16, the factor in
    fp32 (the result's dtype)."""
    o = _ops_world(16, "float32")
    got = tv.vecchia_coeffs(*_geo(o), _t(o["phi"]), JIT, MODEL, "bfloat16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), o["packed_bf16"], **BF16_TOL)


def test_unpack_coeffs_splits_b_and_d(ops):
    b, d = tv.unpack_coeffs(_t(ops["packed"]))
    assert tuple(b.shape) == ops["packed"].shape[:-1] + (ops["nn"],)
    np.testing.assert_array_equal(d.numpy(), ops["packed"][..., -1])


def test_non_pd_block_gives_nan_coefficients():
    """A conditioning block that is not positive definite (two copies of
    one neighbor, no jitter) gives NaN coefficients at that site alone,
    as the twin's factor does."""
    o = _ops_world(4, "float32")
    dist = o["nbr_dist"].copy()
    blk = dist[0, 20]  # neighbors 0 and 1 of site 20 coincide
    blk[1, :], blk[:, 1] = blk[0, :], blk[:, 0]
    blk[0, 1] = blk[1, 0] = blk[1, 1] = 0.0
    got = tv.vecchia_coeffs(_t(dist), _t(o["nbr_valid"]), _t(o["phi"][:, 0]), 0.0, MODEL)
    want = np.asarray(jv.vecchia_coeffs(jnp.asarray(dist[0]), jnp.asarray(o["nbr_valid"][0]),
                                        jnp.float32(o["phi"][0, 0]), 0.0, MODEL))
    bad = ~np.isfinite(got.numpy())
    assert bad[0, 20].all() and bad.sum() == bad[0, 20].size
    np.testing.assert_array_equal(bad[0], ~np.isfinite(want))


# the masking law ------------------------------------------------------
def test_pad_sites_are_identity(ops):
    b, d = tv.unpack_coeffs(tv.vecchia_coeffs(*_geo(ops), _t(ops["phi"]), JIT, MODEL))
    pad = np.broadcast_to(ops["mask"][:, None] == 0, b.shape[:-1])
    assert pad.sum() == 2 * OPS_PAD
    assert np.all(b.numpy()[pad] == 0.0)
    np.testing.assert_allclose(d.numpy()[pad], np.sqrt(1.0 + JIT), rtol=1e-6)


def test_first_site_has_no_predecessors(ops):
    idx, _, valid = tv.build_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]), ops["nn"])
    b, d = tv.unpack_coeffs(tv.vecchia_coeffs(*_geo(ops), _t(ops["phi"]), JIT, MODEL))
    assert np.all(valid.numpy()[:, 0] == 0.0)
    assert np.all(b.numpy()[:, :, 0] == 0.0)
    np.testing.assert_allclose(d.numpy()[:, :, 0], np.sqrt(1.0 + JIT), rtol=1e-6)
    # site i has min(i, nn) predecessors while no pad precedes it
    n_real = valid.numpy()[1].sum(-1)
    np.testing.assert_array_equal(n_real[: OPS_M - OPS_PAD],
                                  np.minimum(np.arange(OPS_M - OPS_PAD), ops["nn"]))


def test_valid_sites_never_condition_on_pads(ops):
    idx, _, valid = tv.build_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]), ops["nn"])
    tidx, _, tvalid = tv.build_test_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]),
                                                    _t(ops["ct"]), ops["nn"])
    for i, v in ((idx, valid), (tidx, tvalid)):
        pointed = np.take_along_axis(ops["mask"], i.numpy().reshape(K, -1), 1).reshape(i.shape)
        assert np.all(pointed[v.numpy() > 0] == 1.0)
    assert np.all(valid.numpy()[ops["mask"] == 0] == 0.0)


def test_pad_contribution_is_phi_free(ops):
    """Moving a pad site's u changes the loglik at two decays by the
    same amount: its term cancels in an MH ratio."""
    packed = tv.vecchia_coeffs(*_geo(ops), _t(ops["phi"]), JIT, MODEL)
    idx = _t(ops["nbr_idx"], long=True)
    u = _t(ops["u"])[:, :1].expand(-1, 2, -1)  # one u, both decays
    u2 = u.clone()
    u2[1, :, -1] += 3.0  # the last row of subset 1 is a pad
    ratio = lambda v: tv.vecchia_loglik(packed, idx, v)[:, 1] - tv.vecchia_loglik(  # noqa: E731
        packed, idx, v)[:, 0]
    np.testing.assert_allclose(ratio(u2).numpy(), ratio(u).numpy(), atol=1e-4)


def test_reverse_neighbors_list_every_slot_once(ops):
    """Each slot i * nn + s appears once, in the list of the site it
    points at, in ascending order; the rest is the zero slot. Invalid
    slots of the port's own build point at their own site."""
    idx, _, valid = tv.build_neighbor_consts(_t(ops["coords"]), _t(ops["mask"]), ops["nn"])
    for nbr in (idx, _t(ops["nbr_idx"], long=True)):
        rev = tv.reverse_neighbors(nbr).numpy()
        k, m, nn = nbr.shape
        flat = nbr.reshape(k, -1).numpy()
        for kk in range(k):
            live = rev[kk][rev[kk] < m * nn]
            np.testing.assert_array_equal(np.sort(live), np.arange(m * nn))
            for j in range(m):
                slots = rev[kk, j][rev[kk, j] < m * nn]
                np.testing.assert_array_equal(slots, np.flatnonzero(flat[kk] == j))
    sites = np.broadcast_to(np.arange(idx.shape[1])[:, None], idx.shape[1:])
    np.testing.assert_array_equal(idx.numpy()[valid.numpy() == 0],
                                  np.broadcast_to(sites, idx.shape)[valid.numpy() == 0])


def _dense_q(packed, idx):
    m = packed.shape[-2]
    eye = torch.eye(m, dtype=packed.dtype)
    cols = [tv.vecchia_q_matvec(packed, idx, eye[i].expand(packed.shape[:-1])) for i in range(m)]
    return torch.stack(cols, dim=-1)  # (..., m, m), column i = Q e_i


def test_ft_is_adjoint_of_f(ops):
    packed, idx = _packed(ops)
    v, w = _t(ops["u"]), _t(ops["w"])
    lhs = torch.sum(tv.vecchia_f_matvec(packed, idx, v) * w, dim=-1)
    rhs = torch.sum(v * tv.vecchia_ft_matvec(packed, idx, w), dim=-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), **ops["tol"])


def test_q_diag_matches_materialized_diagonal(ops):
    packed, idx = _packed(ops)
    q = _dense_q(packed, idx)
    np.testing.assert_allclose(tv.vecchia_q_diag(packed, idx).numpy(),
                               torch.diagonal(q, dim1=-2, dim2=-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(q.numpy(), q.mT.numpy(), atol=1e-4)  # symmetric


# ----------------------------------------------------------------------
# the sampler
# ----------------------------------------------------------------------
# (q, other SMKConfig fields); nn 16 unless given
SAMPLER_VARIANTS = {
    "q1": (1, {}),
    "q2-logit-every2-nn4": (2, dict(link="logit", phi_update_every=2, n_neighbors=4)),
    "q1-chains2": (1, dict(n_chains=2, n_neighbors=8)),
}
GEO_FIELDS = ("nbr_idx", "nbr_dist", "nbr_valid", "tnbr_idx", "tnbr_dist", "tnbr_valid")


def _port_consts(jconsts):
    """The twin's per-row BuildConsts stacked and converted: the six
    neighbor fields, indices int64, and the reverse lists the port adds;
    the dense fields None."""
    fields = {f: _t(np.stack([np.asarray(getattr(c, f)) for c in jconsts]), long="idx" in f)
              for f in GEO_FIELDS}
    return tp.BuildConsts(None, None, None, None, None, **fields,
                          nbr_rev=tv.reverse_neighbors(fields["nbr_idx"]))


@functools.lru_cache(maxsize=None)
def _sampler_reference(name):
    q, extra = SAMPLER_VARIANTS[name]
    coords, x, y, mask, coords_test, x_test, beta0 = _data()
    x, y, x_test, beta0 = x[:, :, :q], y[:, :, :q], x_test[:, :q], beta0[:q]
    cfg = dict(n_subsets=K, n_samples=8, subset_engine="vecchia", **extra)
    c = cfg.get("n_chains", 1)
    jm = JaxSampler(JaxConfig(**cfg))
    keys = jax.random.split(jax.random.key(3), K * c)
    data = [JaxData(*(jnp.asarray(a[r // c]) for a in (coords, x, y, mask)),
                    jnp.asarray(coords_test), jnp.asarray(x_test)) for r in range(K * c)]
    states = [jm.init_state(keys[r], data[r], jnp.asarray(beta0)) for r in range(K * c)]
    init = {f: _stack(states, f) for f in STATE_FIELDS}
    consts = [jm._consts(d) for d in data]
    caches = [jm._solve_cache(consts[r], data[r].mask, states[r]) for r in range(K * c)]
    steps = {cl: jax.jit(lambda d, cs, carry, it, cl=cl: jm._gibbs_step(d, cs, carry, it,
                                                                         collect=cl))
             for cl in (False, True)}
    m, p, t = coords.shape[1], x.shape[-1], coords_test.shape[0]
    sweeps = []
    for it, collect in enumerate((False, False, True)):
        if collect:
            caches = [jm._solve_cache(consts[r], data[r].mask, states[r], predict=True)
                      for r in range(K * c)]
        noise, draws = [], []
        for r in range(K * c):
            noise.append(jax_sweep_noise(states[r].key, m, q, p, t, link=cfg.get("link",
                                                                                "probit"))[1])
            (states[r], caches[r]), out = steps[collect](data[r], consts[r],
                                                         (states[r], caches[r]), jnp.asarray(it))
            draws.append(out)
        sweeps.append({
            "noise": [np.stack([np.asarray(n[i]) for n in noise]) for i in range(9)],
            "state": {f: _stack(states, f) for f in STATE_FIELDS},
            "draws": None if not collect else tuple(
                np.stack([np.asarray(d[i]) for d in draws]) for i in range(2)),
        })
    return {
        "q": q, "config": SMKConfig(**cfg), "init": init, "sweeps": sweeps,
        "consts": _port_consts(consts),
        "n_chol": [int(cc.n_chol) for cc in caches],
        "data": tp.SubsetData(*(torch.as_tensor(a) for a in (coords, x, y, mask, coords_test,
                                                              x_test))),
        "beta0": torch.as_tensor(beta0),
    }


@pytest.fixture(scope="module", params=sorted(SAMPLER_VARIANTS))
def sampler_ref(request):
    return _sampler_reference(request.param)


def _assert_vecchia_state(got, want):
    for f in STATE_FIELDS:
        g = getattr(got, f).numpy()
        if f == "phi_accept":
            np.testing.assert_array_equal(g, want[f], err_msg=f)
        else:
            assert g.shape == want[f].shape, f
            np.testing.assert_allclose(g, want[f], **TOL, err_msg=f)


def _port_vecchia_sweeps(ref, n):
    model = tp.SpatialGPSampler(ref["config"])
    data = model.chain_data(ref["data"])
    consts = ref["consts"]
    state = model.init_state(data, ref["beta0"], consts=consts)
    cache = model._solve_cache(consts, data.mask, state)
    out = []
    for it in range(n):
        collect = it == 2
        if collect:
            cache = model._solve_cache(consts, data.mask, state, predict=True)
        noise = tp.SweepNoise(*(torch.as_tensor(a) for a in ref["sweeps"][it]["noise"]))
        if not collect:
            noise = noise._replace(kpred=None)
        state, cache, draws = model._gibbs_step(data, consts, state, cache, it, noise,
                                                collect=collect)
        out.append((state, draws))
    return state, out, cache


def test_vecchia_init_state_matches_twin(sampler_ref):
    """The packed coefficients at phi0, (K*C, q, m, nn+1) in chol_r,
    from the twin's geometry and from the port's own."""
    model = tp.SpatialGPSampler(sampler_ref["config"])
    data = model.chain_data(sampler_ref["data"])
    for consts in (sampler_ref["consts"], None):
        state = model.init_state(data, sampler_ref["beta0"], consts=consts)
        _assert_vecchia_state(state, sampler_ref["init"])
    nn = sampler_ref["config"].n_neighbors
    assert tuple(state.chol_r.shape[-2:]) == (data.mask.shape[-1], nn + 1)


def test_vecchia_one_sweep_matches_twin(sampler_ref):
    state, _, _ = _port_vecchia_sweeps(sampler_ref, 1)
    _assert_vecchia_state(state, sampler_ref["sweeps"][0]["state"])


def test_vecchia_three_sweeps_burn_and_collect_match_twin(sampler_ref):
    _, out, _ = _port_vecchia_sweeps(sampler_ref, 3)
    for it in range(3):
        _assert_vecchia_state(out[it][0], sampler_ref["sweeps"][it]["state"])
    params, w_star = out[2][1]
    want_params, want_w = sampler_ref["sweeps"][2]["draws"]
    np.testing.assert_allclose(params.numpy(), want_params, **TOL)
    np.testing.assert_allclose(w_star.numpy(), want_w, **TOL)
    assert np.isfinite(want_w).all() and want_w.std() > 0


def test_vecchia_sweeps_build_nothing_dense(sampler_ref):
    """No fused build and no dense operator: build_calls counts 0 for
    every entry point, the cache carries nothing, and the collecting
    sweep counts q coefficient builds (one call) per update, as the
    twin's counter."""
    tfb.reset_counts()
    _, _, cache = _port_vecchia_sweeps(sampler_ref, 3)
    assert sum(tfb.PLAIN_CALLS.values()) == sum(tfb.LAUNCHES.values()) == 0
    cfg = sampler_ref["config"]
    assert set(tp.build_calls(cfg, sampler_ref["q"], 8, 6).values()) == {0}
    assert all(getattr(cache, f) is None for f in ("r_mv", "nys_z", "chol_inv", "krige_w",
                                                   "krige_chol"))
    assert [cache.n_chol] * len(sampler_ref["n_chol"]) == sampler_ref["n_chol"]


def test_vecchia_state_from_numpy_carries_packed_coefficients(sampler_ref):
    """convert.sampler_state_from_numpy takes a twin state whose chol_r
    is packed (K*C, q, m, nn+1) as it is, and the port continues the
    chain from it as the twin does."""
    want = sampler_ref["sweeps"][0]["state"]
    state, gens = convert.sampler_state_from_numpy(want, device="cpu")
    assert tuple(state.chol_r.shape) == want["chol_r"].shape
    assert len(gens) == want["beta"].shape[0]
    model = tp.SpatialGPSampler(sampler_ref["config"])
    data = model.chain_data(sampler_ref["data"])
    consts = sampler_ref["consts"]
    noise = tp.SweepNoise(*(torch.as_tensor(a) for a in sampler_ref["sweeps"][1]["noise"]))
    nxt, _, _ = model._gibbs_step(data, consts, state, model._solve_cache(consts, data.mask, state),
                                  1, noise._replace(kpred=None), collect=False)
    _assert_vecchia_state(nxt, sampler_ref["sweeps"][1]["state"])


# ----------------------------------------------------------------------
# the whole fit
# ----------------------------------------------------------------------
FIT_N = 197  # K = 2 subsets of m = 99: one pad row
FIT_KW = dict(n_subsets=K, n_samples=8, subset_engine="vecchia", n_neighbors=8)


@pytest.fixture(scope="module")
def vecchia_fits():
    data = tuple(a[:FIT_N] for a in _problem()[:3]) + _problem()[3:]
    key = jax.random.key(7)
    ref = jax_fit(key, *data, config=JaxConfig(**FIT_KW))
    port = fit_meta_kriging(*data, config=SMKConfig(**FIT_KW), randomness=JaxRandomness(key),
                            device="cpu")
    return ref, port


@pytest.mark.parametrize("field", ["param_grid", "w_grid", "p_quant", "param_quant",
                                   "sample_par", "phi_accept_rate"])
def test_vecchia_whole_fit_matches_twin(vecchia_fits, field):
    ref, port = vecchia_fits
    got, want = getattr(port, field).numpy(), np.asarray(getattr(ref, field))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_vecchia_fit_without_a_card_needs_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_meta_kriging(*_problem(), config=SMKConfig(**FIT_KW))


def test_vecchia_fit_chunked_equals_unchunked():
    """chunk_size runs each subset with its own rows' generators: the
    same draws as the unchunked fit, to fp32 roundoff (the CPU's batched
    products round differently at another batch size, for the dense
    engine as well)."""
    data = _problem()
    cfg = SMKConfig(**FIT_KW)
    a = fit_meta_kriging(*data, config=cfg, seed=2, device="cpu")
    b = fit_meta_kriging(*data, config=cfg, seed=2, device="cpu", chunk_size=1)
    for f in ("param_grid", "w_grid", "p_quant"):
        np.testing.assert_allclose(getattr(b, f).numpy(), getattr(a, f).numpy(), **TOL,
                                   err_msg=f)
