"""The port's bucket programs (smk_torch/compile/programs.py, warmup.py,
the sampler's chunk program in models/probit_gp.py and its use in
parallel/recovery.py and serve/engine.py) on the CPU, where a program
is its static-buffer body run directly with no capture.

- **The keys**: the port's ``_DIGEST_NEUTRAL`` is the twin's; kind and
  length lead, every data dimension moves a key, the trailing phase
  field; the neutral knobs (the store's included) do not.
- **The plan**: ``chunk_plan_lengths`` equals the twin's on a grid, and
  the port's buckets carry each chunk's phase.
- **The chunk program**: through the executor's ``_run_chunk`` (the
  static-buffer program, called again for every chunk of its bucket),
  bitwise ``burn_chunk`` / ``sample_chunk`` over update and non-update
  sweeps with the Robbins–Monro gain, probit and logit, the collapsed
  sampler's guard counts, pieces under ``chunk_size`` and the compacted
  rows of a noise source; each noise source's snapshot after a program
  chunk equals its snapshot after an eager chunk. Held against the
  twin's ``burn_chunk`` / ``sample_chunk`` on the twin's keys at the
  sweep tolerance 5e-5 + 5e-5 |x|.
- **precompile, then fit**: every acquisition of the fit is ``"l1"``,
  and the fit draws what an uncompiled fit draws.
- **The engine**: after ``swap_artifact`` it serves the new generation,
  bitwise ``predict_at`` on the new artifact with the slice's noise,
  and the swap built nothing.
- On the card (``gpu``-marked, skipped here): captured chunks and
  serving programs bitwise their eager runs.
"""

# smklint: test-budget=one module fixture runs the twin's burn/sample chunks (three small scan compiles, ~10-20 s) at K = 2, m = 24; every port test runs the port at m <= 24 in well under the gate
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.compile import programs as jprograms
from smk_tpu.compile import warmup as jwarmup
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.models.probit_gp import SubsetData as JaxData
from smk_torch import SMKConfig
from smk_torch.api import FactorCache, predict_at
from smk_torch.compile import programs, warmup
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import recovery
from smk_torch.parallel.executor import make_mesh
from smk_torch.parallel.partition import random_partition
from smk_torch.serve import PredictionEngine, load_artifact, save_artifact
from smk_torch.serve.engine import torch_noise
from smk_torch.utils.tracing import ChunkPipelineStats

from test_torch_sampler import JaxSweepReplay

K, M, Q, P, T = 2, 24, 2, 2, 4
TOL = dict(atol=5e-5, rtol=5e-5)
STATE_FIELDS = tp.SamplerState._fields


# -- the keys ----------------------------------------------------------------


def test_digest_neutral_fields_are_the_twins():
    assert programs._DIGEST_NEUTRAL == jprograms._DIGEST_NEUTRAL


def _model(**kw):
    return tp.SpatialGPSampler(SMKConfig(n_subsets=K, n_samples=12, **kw))


def test_chunk_key_layout():
    model = _model(phi_update_every=2)
    dims = dict(k=K, chunk_size=None, m=M, q=Q, p=P, t=T, d=2)
    key = programs.chunk_bucket_key(model, "burn", 5, *dims.values(), phase=1)
    assert key[:2] == ("burn", 5) and key[-1] == 1
    assert key[-2] == programs.config_digest(model.config)
    assert len(key) == 19 and key[11:18] == model.program_bucket_fields()[:2] + (
        "off", "dense", 16, "float32", key[-2])
    # every data dimension, and the phase, moves the key
    for name in dims:
        other = dict(dims, **{name: (dims[name] or 0) + 1})
        assert programs.chunk_bucket_key(model, "burn", 5, *other.values(), phase=1) != key
    assert programs.chunk_bucket_key(model, "burn", 5, *dims.values(), phase=0) != key
    # the neutral knobs do not: a store-armed run resolves the same keys
    armed = _model(phi_update_every=2, compile_store_dir="/store", xla_cache_dir="/l3",
                   chunk_pipeline="overlap", watchdog=True)
    assert programs.chunk_bucket_key(armed, "burn", 5, *dims.values(), phase=1) == key
    assert programs.aux_bucket_key(model, "stats", K, M, Q, P)[0] == "stats"
    # a mesh appends its topology fingerprint (ROADMAP A9a)
    mesh = make_mesh(1, device="cpu")
    meshed = programs.chunk_bucket_key(model, "burn", 5, *dims.values(), mesh=mesh, phase=1)
    assert meshed[:-1] == key and meshed[-1] == programs.topology_fingerprint(mesh)
    with pytest.raises(warmup.MeshSpecError):
        warmup.mesh_from_spec((1,), "H100", device="cpu")
    part, ct, xt = _fit_problem()
    for kw in (dict(mesh=mesh), dict(mesh_spec=((1,), "cpu"))):
        assert warmup.precompile(model, part, ct, xt, chunk_iters=4, **kw)["topology"] == \
            programs.topology_fingerprint(mesh)


@pytest.mark.parametrize("n_burn,n_samples,chunk_iters", [
    (0, 1, 1), (3, 10, 4), (6, 12, 3), (7, 20, 5), (10, 10, 3), (5, 17, 100), (12, 40, 7),
])
def test_chunk_plan_lengths_match_twin(n_burn, n_samples, chunk_iters):
    got = warmup.chunk_plan_lengths(n_burn, n_samples, chunk_iters)
    assert got == jwarmup.chunk_plan_lengths(n_burn, n_samples, chunk_iters)
    for e in (1, 2, 3):
        buckets = warmup.chunk_plan_buckets(n_burn, n_samples, chunk_iters, e)
        assert sorted({b[:2] for b in buckets}) == sorted(set(got))
        assert all(b[3] % e == b[2] for b in buckets)


# -- the chunk program against the eager chunks --------------------------------


def _data(seed=0, *, k=K, m=M, q=Q, weight=1):
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.ones((k, m, q, 1)), rng.normal(size=(k, m, q, P - 1))], -1)
    mask = np.ones((k, m), np.float32)
    mask[:, -3:] = 0.0
    y = rng.binomial(weight, 0.5, size=(k, m, q)).astype(np.float32) * mask[..., None]
    coords = rng.uniform(size=(k, m, 2))
    coords[:, -3:] += 5.0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return tp.SubsetData(f(coords), f(x * mask[..., None, None]), f(y), f(mask),
                         f(rng.uniform(size=(T, 2))), torch.ones((T, q, P)))


PRODUCTION = dict(phi_sampler="collapsed", phi_update_every=2, u_solver="cg",
                  cg_precond="nystrom", cg_precond_rank=8, cg_iters=8,
                  trisolve_block_size=16, phi_step=4.0, fused_build="pallas")

# (config fields, chunk_size, compacted rows)
CHUNK_CASES = {
    "probit-every2": (dict(phi_update_every=2), None, None),
    "logit-production": (dict(PRODUCTION, link="logit"), None, None),
    "collapsed-chol": (dict(phi_sampler="collapsed", phi_update_every=3, phi_step=4.0,
                            fused_build="pallas"), None, None),
    "pieces": (dict(phi_update_every=2, n_chains=2), 1, None),
    "compacted": (dict(PRODUCTION), None, [1]),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_program_bitwise_eager(case):
    """Five chunks (burn 0-2, burn 3-5, burn 6-8 at phases 0/1/0 of
    phi_update_every = 2 — each bucket's program called again — then
    two collecting chunks) through the executor's chunk runner, against
    burn_chunk / sample_chunk on an identically seeded source: states,
    draws, guard counts and the noise snapshots, bitwise."""
    fields, chunk_size, rows = CHUNK_CASES[case]
    model_p = _model(**fields)
    model_e = _model(**fields)
    cfg = model_p.config
    data = _data()
    if rows is not None:
        sel = torch.as_tensor(rows)
        data = data._replace(coords=data.coords[sel], x=data.x[sel], y=data.y[sel],
                             mask=data.mask[sel])
    k = data.x.shape[0]
    cdata = model_p.chain_data(data)
    noise_p, noise_e = (model_p.default_noise(data, seed=5), model_e.default_noise(data, seed=5))
    if rows is not None:  # the compacted rows of a wider source
        wide = _data()
        noise_p = model_p.default_noise(wide, seed=5).rows(rows)
        noise_e = model_e.default_noise(wide, seed=5).rows(rows)
    ctx = recovery._ProgramCtx(None, ChunkPipelineStats(), k, chunk_size)
    pieces = recovery._pieces(model_p, cdata, noise_p, k, cfg.n_chains, chunk_size, ctx)
    consts = model_e._consts(cdata)
    st_p = st_e = model_p.init_state(cdata, consts=consts)
    for kind, start, n in (("burn", 0, 3), ("burn", 3, 3), ("burn", 6, 3),
                           ("samp", 9, 2), ("samp", 11, 2)):
        st_p, dr_p = recovery._run_chunk(model_p, kind, pieces, st_p, start, n)
        if kind == "burn":
            st_e, dr_e = model_e.burn_chunk(cdata, consts, st_e, noise_e, start, n), None
        else:
            st_e, dr_e = model_e.sample_chunk(cdata, consts, st_e, noise_e, start, n)
        for f, a, b in zip(STATE_FIELDS, st_p, st_e):
            assert torch.equal(a, b), (kind, start, f)
        assert (dr_p is None) == (dr_e is None)
        if dr_p is not None:
            assert torch.equal(dr_p[0], dr_e[0]) and torch.equal(dr_p[1], dr_e[1])
        assert np.array_equal(noise_p.snapshot(), noise_e.snapshot())
        if model_e.guard_rejects is None:
            assert model_p.guard_rejects is None
        else:
            assert torch.equal(model_p.guard_rejects, model_e.guard_rejects)
    keys = [p["key"] for p in ctx.stats.programs]
    phases = {(k_[0], k_[1], k_[-1]) for k_ in keys}
    e = cfg.phi_update_every
    assert phases == {("burn", "3", str(s % e)) for s in (0, 3, 6)} | {("samp", "2", str(s % e))
                                                                       for s in (9, 11)}
    assert all(p["source"] == "fresh" for p in ctx.stats.programs)


def test_graph_program_on_the_cpu_copies_into_its_static_buffers():
    """A program's static buffers are its own: an input changed in place
    after a call is copied again, an output never aliases an input."""
    prog = programs.GraphProgram(lambda a, b: (a, a + b), ("k",), "cpu")
    a, b = torch.ones(3), torch.zeros(3)
    o1, s1 = prog(a, b)
    assert torch.equal(s1, a) and o1 is not a and o1.data_ptr() != prog._static[0].data_ptr()
    a.add_(1.0)  # changed in place: copied again at the next call
    o2, s2 = prog(a, b)
    assert torch.equal(s2, torch.full((3,), 2.0)) and torch.equal(o1, torch.ones(3))
    with pytest.raises(ValueError, match="structure"):
        prog(a)


@pytest.fixture(scope="module")
def twin_chunks():
    """The twin's burn_chunk (sweep 0, then sweep 1: phases 0 and 1 of
    phi_update_every = 2, with the Robbins–Monro gain) and sample_chunk
    (sweep 2) vmapped over K = 2, from its initial state and keys: three
    sweeps, the chain length the sweep tolerance is stated for
    (test_torch_sampler.py)."""
    data = _data(3)
    fields = dict(n_subsets=K, n_samples=4, phi_update_every=2, burn_in_frac=0.5)
    jm = JaxSampler(JaxConfig(**fields))
    jdata = JaxData(*(jnp.asarray(a.numpy()) for a in data))
    dax = JaxData(0, 0, 0, 0, None, None)
    beta0 = jnp.asarray([[0.1, -0.2], [0.3, 0.05]], jnp.float32)
    keys = jax.random.split(jax.random.key(3), K)
    init = jax.vmap(lambda kk, d: jm.init_state(kk, d, beta0), in_axes=(0, dax))(keys, jdata)
    out = {"init": init, "data": data, "fields": fields}
    st = init
    for name, start in (("b0", 0), ("b1", 1)):
        st = jax.jit(jax.vmap(lambda d, s, a=start: jm.burn_chunk(d, s, a, 1),
                              in_axes=(dax, 0)))(jdata, st)
        out[name] = st
    out["s0"] = jax.jit(jax.vmap(lambda d, s: jm.sample_chunk(d, s, 2, 1),
                                 in_axes=(dax, 0)))(jdata, st)
    return out


def test_chunk_program_matches_twin_chunks(twin_chunks):
    ref = twin_chunks
    model = tp.SpatialGPSampler(SMKConfig(**ref["fields"]))
    data = ref["data"]
    init = ref["init"]
    state = tp.SamplerState(*(torch.as_tensor(np.array(getattr(init, f)))
                              for f in STATE_FIELDS))
    shapes = tp.sweep_shapes(model.config, K, M, Q, P, T)
    noise = JaxSweepReplay(init.key, shapes)
    ctx = recovery._ProgramCtx(None, None, K, None)
    pieces = [recovery._Piece(0, K, data, model._consts(data), noise, ctx)]
    for name, kind, start, n in (("b0", "burn", 0, 1), ("b1", "burn", 1, 1),
                                 ("s0", "samp", 2, 1)):
        state, draws = recovery._run_chunk(model, kind, pieces, state, start, n)
        want = ref[name][0] if kind == "samp" else ref[name]
        for f in STATE_FIELDS:
            g = getattr(state, f).numpy()
            w = np.asarray(getattr(want, f))
            if f == "u":  # pad latents: see test_torch_sampler.py
                g, w = g[:, :-3], w[:, :-3]
            if f == "phi_accept":
                np.testing.assert_array_equal(g, w, err_msg=f"{name} {f}")
            else:
                np.testing.assert_allclose(g, w, **TOL, err_msg=f"{name} {f}")
        if kind == "samp":
            np.testing.assert_allclose(draws[0].numpy(), np.asarray(ref[name][1][0]), **TOL)
            np.testing.assert_allclose(draws[1].numpy(), np.asarray(ref[name][1][1]), **TOL)


# -- precompile, then fit --------------------------------------------------------


def _fit_problem(seed=0, n=40):
    rng = np.random.default_rng(seed)
    q, p, t = 1, 2, 4
    y = torch.as_tensor((rng.uniform(size=(n, q)) < 0.5).astype(np.float32))
    x = torch.as_tensor(np.concatenate([np.ones((n, q, 1)), rng.normal(size=(n, q, p - 1))],
                                       -1).astype(np.float32))
    coords = torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32))
    part = random_partition(torch.randperm(n, generator=torch.Generator().manual_seed(0)),
                            y, x, coords, 2)
    return part, torch.as_tensor(rng.uniform(size=(t, 2)).astype(np.float32)), torch.ones((t, q, p))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_precompile_then_fit_every_acquisition_is_l1(adaptive):
    fields = dict(n_subsets=2, n_samples=20, phi_update_every=2, fault_policy="quarantine")
    if adaptive:
        fields.update(adaptive_schedule="on", live_diagnostics=True, n_chains=2)
    part, ct, xt = _fit_problem()
    model = tp.SpatialGPSampler(SMKConfig(**fields))
    report = warmup.precompile(model, part, ct, xt, chunk_iters=3)
    assert report["n_programs"] > 0 and report["store_dir"] is None
    assert {p["key"][0] for p in report["programs"]} >= {"burn", "samp", "stats", "finalize"}
    stats = ChunkPipelineStats()
    got = recovery.fit_subsets_chunked(model, part, ct, xt, chunk_iters=3, pipeline_stats=stats)
    chunk_keys = [p for p in stats.programs if p["key"][0] in ("burn", "samp")]
    assert chunk_keys and all(p["source"] == "l1" for p in stats.programs), stats.programs
    want = recovery.fit_subsets_chunked(tp.SpatialGPSampler(SMKConfig(**fields)), part, ct, xt,
                                        chunk_iters=3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_precompile_of_a_padded_partition_per_group():
    from smk_torch.parallel.partition import padded_partition

    rng = np.random.default_rng(1)
    n = 50
    y = torch.as_tensor((rng.uniform(size=(n, 1)) < 0.5).astype(np.float32))
    x = torch.ones((n, 1, 2))
    coords = torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32))
    assign = [np.arange(0, 12), np.arange(12, 20), np.arange(20, 50)]
    part = padded_partition(y, x, coords, assign, ladder=(8, 16, 32))
    model = tp.SpatialGPSampler(SMKConfig(n_subsets=3, n_samples=8))
    report = warmup.precompile(model, part, torch.rand(3, 2), torch.ones((3, 1, 2)),
                               chunk_iters=4)
    assert [b["bucket"] for b in report["buckets"]] == list(part.buckets)
    ms = {p["key"][4] for p in report["programs"] if p["key"][0] in ("burn", "samp")}
    assert ms == {str(b) for b in part.buckets}


# -- the engine ----------------------------------------------------------------


def _made_fit(seed, n_draws=24, t=5, q=1, p=2):
    rng = np.random.default_rng(seed)
    n_q, n_par = 21, q * p + q * (q + 1) // 2 + q
    grid = np.sort(rng.normal(size=(n_q, n_par)), axis=0)
    grid[:, q * p] = np.linspace(0.5, 1.5, n_q)
    grid[:, -q:] = np.linspace(3.0, 8.0, n_q)[:, None]
    return types.SimpleNamespace(
        sample_par=grid[rng.integers(0, n_q, n_draws)].astype(np.float32),
        sample_w=rng.normal(size=(n_draws, t * q)).astype(np.float32),
        param_grid=grid.astype(np.float32),
        w_grid=np.sort(rng.normal(size=(n_q, t * q)), axis=0).astype(np.float32),
    )


def test_engine_after_swap_serves_the_new_generation(tmp_path):
    cfg = SMKConfig(n_quantiles=21)
    ct = np.random.default_rng(9).uniform(size=(5, 2)).astype(np.float32)
    paths = [save_artifact(str(tmp_path / f"g{i}.npz"), _made_fit(i), ct, config=cfg)
             for i in range(2)]
    eng = PredictionEngine(paths[0], buckets=(4, 8), device="cpu")
    built = [p.info()["key"] for p in programs.programs_of(eng)]
    rng = np.random.default_rng(4)
    cq = rng.uniform(size=(6, 2)).astype(np.float32)
    xq = rng.normal(size=(6, 1, 2)).astype(np.float32)
    before = eng.predict(cq, xq, seed=2)
    out = eng.swap_artifact(paths[1])
    assert out["generation"] == 1
    after = eng.predict(cq, xq, seed=2)
    assert [p.info()["key"] for p in programs.programs_of(eng)] == built  # nothing built
    art = load_artifact(paths[1])
    fit = types.SimpleNamespace(**{f: torch.as_tensor(getattr(art, f))
                                   for f in ("sample_par", "sample_w", "param_grid")})
    want, _ = predict_at(fit, art.coords_test, cq, xq, config=cfg,
                         cache=FactorCache(None, None, None,
                                           krige_chol=torch.as_tensor(art.chol_tt)),
                         eps=torch_noise(2, (24, 8, 1), torch.float32, "cpu")[:, :6])
    np.testing.assert_array_equal(after.p_quant, want.p_quant.numpy())
    assert not np.array_equal(before.p_quant, after.p_quant)
    eng.close()


# -- on the card -----------------------------------------------------------------


@pytest.mark.gpu
def test_graph_chunks_bitwise_eager_on_the_card():
    """Captured chunk programs replayed against burn_chunk /
    sample_chunk on the card (states, draws, noise snapshots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    dev = torch.device("cuda")
    fields = dict(PRODUCTION, link="logit")
    model_p, model_e = _model(**fields), _model(**fields)
    data = tp.SubsetData(*(a.to(dev) for a in _data()))
    cdata = model_p.chain_data(data)
    noise_p, noise_e = model_p.default_noise(data, 5), model_e.default_noise(data, 5)
    ctx = recovery._ProgramCtx(None, None, K, None)
    pieces = recovery._pieces(model_p, cdata, noise_p, K, 1, None, ctx)
    consts = model_e._consts(cdata)
    st_p = st_e = model_p.init_state(cdata, consts=consts)
    for kind, start, n in (("burn", 0, 2), ("burn", 2, 2), ("burn", 4, 2), ("samp", 6, 2),
                           ("samp", 8, 2)):
        st_p, dr_p = recovery._run_chunk(model_p, kind, pieces, st_p, start, n)
        if kind == "burn":
            st_e, dr_e = model_e.burn_chunk(cdata, consts, st_e, noise_e, start, n), None
        else:
            st_e, dr_e = model_e.sample_chunk(cdata, consts, st_e, noise_e, start, n)
        assert all(torch.equal(a, b) for a, b in zip(st_p, st_e))
        if dr_p is not None:
            assert torch.equal(dr_p[0], dr_e[0]) and torch.equal(dr_p[1], dr_e[1])
        assert np.array_equal(noise_p.snapshot(), noise_e.snapshot())
    assert all(p.replays > 0 for p in programs.programs_of(model_p))
