"""The port's public API (smk_torch/api.py) end to end against
smk_tpu.api.fit_meta_kriging, draw for draw, plus the port's contracts:
state conversion from the JAX package, the device rule, unported knobs,
and that no port module imports JAX or the JAX package.

The whole-fit comparison replays the JAX fit's randomness into the
port (FitRandomness below): the partition permutation of the fit key's
first split, each subset's sweep keys, and the resample indices. n =
200, K = 2, q = 2, p = 2, t = 6, 8 sweeps (6 burn-in, 2 kept), for
fused_build "off" and "pallas" (interpret-mode Pallas in the JAX fit),
for the production sampler (collapsed phi every 2nd sweep, Nystrom
CG with a bf16 operator, blocked solves) with the logit link, and for
a K-chunked fit (chunk_size=1: each subset a chunk of its own, in both
packages).

Tolerance: the fits agree to fp32 roundoff through 8 sweeps, quantile
compression, combine and resample (observed <= 7e-6; the production
logit fit <= 1.9e-6, accept rates equal); asserted at 5e-5 absolute +
5e-5 relative.
"""

# smklint: test-budget=the four JAX reference fits (6-35 s each on this CPU) run once each in a module fixture; every test compares stored arrays or runs the port at n <= 200
import ast
import os
import pathlib
import warnings

import jax
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.config import PriorConfig as JaxPriors
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.parallel import partition as jpart
from smk_torch import SMKConfig, api, convert, fit_meta_kriging
from smk_torch.config import PriorConfig
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import partition as tpart
from test_torch_sampler import JaxSweepReplay

N, Q, P, T, KSUB, NS = 200, 2, 2, 6, 2, 8
TOL = dict(atol=5e-5, rtol=5e-5)
REPO = pathlib.Path(__file__).resolve().parents[1]


class JaxRandomness:
    """Every random number of a JAX fit with ``key``, for the port:
    the key splits as api.py:671, the subset keys as
    executor.subset_chain_keys, the sweeps as JaxSweepReplay."""

    def __init__(self, key, *, collapsed=False):
        self.k_part, self.k_fit, self.k_resample = jax.random.split(key, 3)
        self.collapsed = collapsed

    def permutation(self, n):
        return torch.as_tensor(np.array(jax.random.permutation(self.k_part, n)))

    def sweep_noise(self, shapes):
        return JaxSweepReplay(jax.random.split(self.k_fit, shapes.k), shapes,
                              collapsed=self.collapsed)

    def resample_index(self, n_draws, n_grid):
        idx = jax.random.randint(self.k_resample, (n_draws,), 0, n_grid)
        return torch.as_tensor(np.array(idx))


def _problem():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = np.concatenate(
        [np.ones((N, Q, 1)), rng.normal(size=(N, Q, P - 1))], -1
    ).astype(np.float32)
    y = (rng.uniform(size=(N, Q)) < 0.5).astype(np.float32)
    coords_test = rng.uniform(size=(T, 2)).astype(np.float32)
    x_test = np.ones((T, Q, P), np.float32)
    return y, x, coords, coords_test, x_test


# the production sampler (bench.py:rung_config) with the logit link at
# this size: rank and block below m = 100 so both engage
PRODUCTION_LOGIT = dict(
    fused_build="pallas", link="logit", phi_sampler="collapsed", phi_update_every=2,
    phi_step=4.0, u_solver="cg", cg_precond="nystrom", cg_precond_rank=16, cg_iters=8,
    cg_matvec_dtype="bfloat16", trisolve_block_size=32,
)
FIT_CONFIGS = {
    "off": dict(fused_build="off"),
    "pallas": dict(fused_build="pallas"),
    "production-logit": PRODUCTION_LOGIT,
    "chunked": dict(fused_build="off"),
}
# fit_meta_kriging's chunk_size, by FIT_CONFIGS key (None elsewhere)
FIT_CHUNK_SIZE = {"chunked": 1}


@pytest.fixture(scope="module", params=sorted(FIT_CONFIGS))
def fits(request):
    data = _problem()
    kw = dict(n_subsets=KSUB, n_samples=NS, **FIT_CONFIGS[request.param])
    chunk = FIT_CHUNK_SIZE.get(request.param)
    key = jax.random.key(7)
    ref = jax_fit(key, *data, config=JaxConfig(**kw), chunk_size=chunk)
    rng = JaxRandomness(key, collapsed=kw.get("phi_sampler") == "collapsed")
    port = fit_meta_kriging(*data, config=SMKConfig(**kw), randomness=rng, device="cpu",
                            chunk_size=chunk)
    return {"ref": ref, "port": port, "key": key, "data": data, "kw": kw}


@pytest.mark.parametrize(
    "field",
    ["param_grid", "w_grid", "p_quant", "param_quant", "w_quant", "sample_par",
     "p_samples", "phi_accept_rate"],
)
def test_whole_fit_matches_twin_draw_for_draw(fits, field):
    got = getattr(fits["port"], field).numpy()
    want = np.asarray(getattr(fits["ref"], field))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_subset_draws_and_diagnostics_match_twin(fits):
    got, want = fits["port"].subset_results, fits["ref"].subset_results
    np.testing.assert_allclose(got.param_samples.numpy(), np.asarray(want.param_samples), **TOL)
    np.testing.assert_allclose(got.w_samples.numpy(), np.asarray(want.w_samples), **TOL)
    np.testing.assert_allclose(got.param_ess.numpy(), np.asarray(want.param_ess), rtol=1e-4)
    assert set(fits["port"].phase_seconds) == {
        "partition", "warm_start", "subset_fits", "combine", "resample_predict"
    }


def test_combine_and_predict_from_the_twins_grids(fits):
    """grids_from_numpy: the JAX fit's subset grids, combined and
    resampled by the port (with the JAX resample indices), give the
    JAX fit's combined posterior and predictions."""
    ref = fits["ref"]
    cfg = SMKConfig(**fits["kw"])
    pg, wg = convert.grids_from_numpy(ref.subset_results.param_grid, ref.subset_results.w_grid,
                                      device="cpu")
    param_grid, w_grid = api.combine(pg, wg, cfg)
    np.testing.assert_allclose(param_grid.numpy(), np.asarray(ref.param_grid), atol=1e-6)
    idx = JaxRandomness(fits["key"]).resample_index(cfg.resample_size, 996)
    sample_par, _, p_samples, _, _, p_quant = api.resample_predict(
        param_grid, w_grid, torch.as_tensor(fits["data"][4]), idx, cfg
    )
    np.testing.assert_allclose(sample_par.numpy(), np.asarray(ref.sample_par), atol=1e-5)
    np.testing.assert_allclose(p_quant.numpy(), np.asarray(ref.p_quant), atol=1e-5)


def test_sampler_state_and_partition_from_numpy_round_trip(fits):
    """A JAX partition and the JAX init states, carried into the port,
    equal what the port builds itself; a state carried back out as
    numpy converts to the same tensors."""
    y, x, coords, coords_test, x_test = fits["data"]
    k_part = jax.random.split(fits["key"], 3)[0]
    jp = jpart.random_partition(k_part, y, x, coords, KSUB)
    part = convert.partition_from_numpy(jp, device="cpu")
    mine = tpart.partition_from_indices(
        torch.as_tensor(y), torch.as_tensor(x), torch.as_tensor(coords), part.index
    )
    for f in ("y", "x", "mask", "index"):
        assert torch.equal(getattr(part, f), getattr(mine, f))
    from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
    from smk_tpu.parallel.executor import init_subset_states, stacked_subset_data

    jm = JaxSampler(JaxConfig(**fits["kw"]))
    beta0 = np.array([[0.2, -0.1], [0.0, 0.3]], np.float32)
    jstate = init_subset_states(
        jm, jax.random.split(fits["key"], KSUB),
        stacked_subset_data(jp, coords_test, x_test), beta0,
    )
    state, gens = convert.sampler_state_from_numpy(jstate, seed=3, device="cpu")
    assert len(gens) == KSUB
    model = tp.SpatialGPSampler(SMKConfig(**fits["kw"]))
    data = tp.SubsetData(part.coords, part.x, part.y, part.mask,
                         torch.as_tensor(coords_test), torch.as_tensor(x_test))
    mine = model.init_state(data, torch.as_tensor(beta0))
    for f in ("beta", "u", "a", "phi", "phi_accept", "phi_log_step"):
        assert torch.equal(getattr(state, f), getattr(mine, f)), f
    np.testing.assert_allclose(state.chol_r.numpy(), mine.chol_r.numpy(), **TOL)
    back, _ = convert.sampler_state_from_numpy(
        {f: getattr(state, f).numpy() for f in convert._STATE_FIELDS}, device="cpu"
    )
    for f in convert._STATE_FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f))
    with pytest.raises(ValueError, match="leading K"):
        convert.sampler_state_from_numpy({f: np.asarray(getattr(state, f))[0]
                                          for f in convert._STATE_FIELDS}, device="cpu")


def test_chunk_size_must_divide_k():
    with pytest.raises(ValueError, match="must divide K=4"):
        fit_meta_kriging(*_problem(), config=SMKConfig(n_subsets=4, n_samples=4),
                         chunk_size=3, device="cpu")


@pytest.mark.parametrize("q, temper, warns",
                         [(2, "power", True), (3, "power", True), (1, "power", False),
                          (2, "none", False)])
def test_tempered_multivariate_warning_matches_twin(q, temper, warns):
    """Power tempering is validated at q = 1 only: both packages warn, in
    the same words, where it meets q >= 2, and are silent otherwise."""
    twin = JaxConfig(priors=JaxPriors(temper=temper))
    mine = SMKConfig(priors=PriorConfig(temper=temper))
    if warns:
        with pytest.warns(UserWarning, match="temper='power'") as want:
            twin.warn_if_tempered_multivariate(q)
        with pytest.warns(UserWarning, match="temper='power'") as got:
            mine.warn_if_tempered_multivariate(q)
        assert [str(w.message) for w in got] == [str(w.message) for w in want]
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            twin.warn_if_tempered_multivariate(q)
            mine.warn_if_tempered_multivariate(q)


def test_tempered_multivariate_fit_warns():
    """The fit calls the warning once q is known (here q = 2)."""
    cfg = SMKConfig(n_subsets=2, n_samples=8, priors=PriorConfig(temper="power"))
    with pytest.warns(UserWarning, match="temper='power' with q>=2"):
        fit_meta_kriging(*_problem(), config=cfg, seed=3, device="cpu")


def test_no_device_given_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_meta_kriging(*_problem(), config=SMKConfig(n_subsets=2, n_samples=4))


@pytest.mark.parametrize("name,args", [
    ("sampler_state_from_numpy", ({f: np.zeros((2, 1, 2), np.float32)
                                   for f in convert._STATE_FIELDS},)),
    ("factor_cache_from_numpy", ({f: None for f in ("r_mv", "nys_z", "chol_inv", "krige_w",
                                                      "krige_chol")},)),
    ("partition_from_numpy", ({f: np.zeros((2, 3, 1)) for f in ("y", "x", "coords", "mask",
                                                                "index")},)),
    ("grids_from_numpy", (np.zeros((2, 5, 3)), np.zeros((2, 5, 4)))),
    ("meta_kriging_result_from_numpy", ({},)),
])
def test_convert_without_a_device_goes_to_the_card_or_raises(monkeypatch, name, args):
    """Like every entry point of the port, the carry-over functions put
    their tensors on the CUDA device unless given ``device``: with no
    card they raise the port's error, never a quiet drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available; pass device='cpu'"):
        getattr(convert, name)(*args)
    if name == "grids_from_numpy":
        pg, wg = convert.grids_from_numpy(*args, device="cpu")
        assert pg.device.type == wg.device.type == "cpu"


def test_default_randomness_fit_is_finite_and_seeded():
    data = _problem()
    cfg = SMKConfig(n_subsets=2, n_samples=8, fused_build="pallas")
    a = fit_meta_kriging(*data, config=cfg, seed=1, device="cpu")
    b = fit_meta_kriging(*data, config=cfg, seed=1, device="cpu")
    assert tuple(a.p_quant.shape) == (3, T * Q)
    assert torch.isfinite(a.p_quant).all() and torch.isfinite(a.param_quant).all()
    assert ((a.p_quant >= 0) & (a.p_quant <= 1)).all()
    assert torch.equal(a.p_quant, b.p_quant)
    assert api.param_names(Q, P)[-Q:] == ["phi[0]", "phi[1]"]


@pytest.mark.parametrize(
    "knob, item",
    [
        (dict(xla_cache_dir="xla_cache"), "A10"),
        (dict(compile_store_dir="store"), "A10"),
    ],
)
def test_unported_knobs_raise_naming_their_roadmap_item(knob, item, tmp_path, monkeypatch):
    """The program store's two directory knobs (ROADMAP ``item``) are
    ported now: each no longer raises, the fit with it draws exactly
    what the fit without it draws, and xla_cache_dir arms the kernel
    build directory (compile/xla_cache.py)."""
    from smk_torch import config as tconfig
    from smk_torch.compile import xla_cache

    monkeypatch.setattr(xla_cache, "_ARMED", None)
    knob_name, value = next(iter(knob.items()))
    assert knob_name not in {k for k, _, _ in tconfig._UNPORTED}
    cfg = SMKConfig(n_samples=40, **{knob_name: str(tmp_path / value)})
    a = fit_meta_kriging(*_problem(), config=cfg, seed=1, device="cpu", chunk_iters=10)
    b = fit_meta_kriging(*_problem(), config=SMKConfig(n_samples=40), seed=1, device="cpu",
                         chunk_iters=10)
    assert torch.equal(a.p_quant, b.p_quant) and torch.equal(a.param_quant, b.param_quant)
    assert (xla_cache.armed_dir() == str(tmp_path / value)) == (knob_name == "xla_cache_dir")


@pytest.mark.parametrize("knob", ["live_diagnostics", "run_log_dir", "profile_dir",
                                  "adaptive_schedule"])
def test_telemetry_and_adaptive_knobs_now_run(knob, tmp_path):
    """The chunked executor's last knobs run through the public fit: the
    three observational ones bitwise the plain chunked fit, the adaptive
    schedule with its result fields filled."""
    base = dict(n_subsets=2, n_samples=16 if knob == "adaptive_schedule" else 8, n_chains=2)
    extra = {"live_diagnostics": dict(live_diagnostics=True),
             "run_log_dir": dict(run_log_dir=str(tmp_path / "logs")),
             "profile_dir": dict(profile_dir=str(tmp_path / "prof"), profile_chunks="1:2"),
             "adaptive_schedule": dict(live_diagnostics=True, adaptive_schedule="on",
                                       target_rhat=1.5, target_ess=4.0, adapt_patience=1)}
    got = fit_meta_kriging(*_problem(), config=SMKConfig(**base, **extra[knob]), seed=3,
                           device="cpu", chunk_iters=4)
    if knob == "adaptive_schedule":
        assert len(got.frozen_at) == 2 and 0.0 <= got.chunks_saved_frac < 1.0
        assert torch.isfinite(got.p_quant).all()
        return
    want = fit_meta_kriging(*_problem(), config=SMKConfig(**base), seed=3, device="cpu",
                            chunk_iters=4)
    for f in ("param_grid", "w_grid", "p_quant"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert (got.run_log_path is not None) == (knob == "run_log_dir")
    if knob == "profile_dir":
        assert os.listdir(tmp_path / "prof")


@pytest.mark.parametrize("knob", [dict(chunk_pipeline="overlap"), dict(watchdog=True)])
def test_overlap_and_watchdog_knobs_now_run(knob):
    """Both knobs run through the public fit, on the chunked path (where
    they act) bitwise the default sync, unwatched fit."""
    cfg = SMKConfig(n_subsets=2, n_samples=8)
    want = fit_meta_kriging(*_problem(), config=cfg, seed=3, device="cpu", chunk_iters=3)
    got = fit_meta_kriging(*_problem(), config=SMKConfig(**dict(
        n_subsets=2, n_samples=8, **knob)), seed=3, device="cpu", chunk_iters=3)
    for f in ("param_grid", "w_grid", "p_quant"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_config_validates_like_the_twin():
    with pytest.raises(ValueError, match="fused_build"):
        SMKConfig(fused_build="triton")
    with pytest.raises(ValueError, match="a_prior"):
        SMKConfig(priors=PriorConfig(a_prior="flat"))
    assert SMKConfig(n_samples=40.0).n_samples == 40
    assert (SMKConfig(n_samples=40).n_burn_in, SMKConfig(n_samples=40).n_kept) == (30, 10)
    twin, mine = JaxConfig(), SMKConfig()
    assert {f: getattr(twin, f) for f in JaxConfig.__dataclass_fields__} == {
        f: getattr(mine, f) for f in SMKConfig.__dataclass_fields__
        if f != "priors"
    } | {"priors": twin.priors}
    assert vars(twin.priors) == vars(mine.priors)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "smk_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files for mod in _imports(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "smk_tpu")
    ]
    assert bad == []


@pytest.mark.gpu
def test_fit_on_the_card_runs_the_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused build kernel has no CPU mode")
    from smk_torch.ops import fused_build as tfb

    tfb.reset_counts()
    res = fit_meta_kriging(
        *_problem(), config=SMKConfig(n_subsets=2, n_samples=8, fused_build="pallas")
    )
    assert torch.isfinite(res.p_quant).all()
    assert tfb.LAUNCHES["fused_masked_shifted_build"] == Q * 8
    assert sum(tfb.PLAIN_CALLS.values()) == 0
