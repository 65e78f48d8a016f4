"""The port's R front-end (``r/meta_kriging_torch.R``) replayed from
Python, class for class as tests/test_r_frontend.py replays the JAX
package's (``r/meta_kriging_tpu.R``).

No R runtime ships here, so the R file is exercised by replicating,
step for step, each conversion, keyword and attribute access its code
makes through reticulate (``replay_meta_kriging_binary``,
``replay_live_loop``), and by reading the R text for the knobs whose
fit-level behaviour other test files hold:

- the call sequence on the twin's R-style inputs (n = 96, t = 5, q = 2,
  p = 2): the result list's fields, shapes and names; the replayed port
  call held against the twin's replayed call, the twin's key schedule
  injected through ``randomness=`` (tests/test_torch_api.JaxRandomness),
  at test_torch_api.py's tolerance (5e-5 absolute + 5e-5 relative; the
  ESS at 1e-4 relative); the ``seed=`` route bitwise a direct
  ``fit_meta_kriging`` call;
- the two R files' public surface: the same six functions, arguments
  and returned list names (the port's ``smk.predict.serve`` adds
  ``backend``); the port's file names neither the JAX package nor JAX;
  ``backend = "gpu"`` with no card raises the port's error;
- the extended options (k.prior, n.report, checkpoint.path,
  compile.store.dir), the run-log directory, the scale-out, adaptive,
  subset-engine and resilience knobs, config overrides and integer
  coercion, the bad-shape messages, against the port's SMKConfig and
  API;
- the serving and live-fit wiring, and a replay of smk.live.fit,
  smk.ingest, smk.refit and smk.predict.serve on the CPU.

One twin fit (the call sequence's, a module fixture); every other fit is
the port's on the CPU at n <= 96.
"""

# smklint: test-budget=one JAX reference fit (n=96, K=4, 60 sweeps, ~10 s) in a module fixture; port fits at n <= 96 (about a second each) and a LiveFit loop at n = 64 (~5 s); the rest reads the R text
import importlib
import os
import re

import jax
import numpy as np
import pytest
import torch

from test_torch_api import JaxRandomness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R_PORT = os.path.join(REPO, "r", "meta_kriging_torch.R")
R_TWIN = os.path.join(REPO, "r", "meta_kriging_tpu.R")
TOL = dict(atol=5e-5, rtol=5e-5)


def _r_src(path=R_PORT) -> str:
    with open(path) as f:
        return f.read()


def _r_simplify2array_aperm(mats):
    """R: aperm(simplify2array(list of n x p), c(1, 3, 2)) -> n x q x p.

    ``simplify2array`` stacks the list along a NEW LAST axis (n, p, q);
    ``aperm(c(1, 3, 2))`` permutes to (n, q, p)."""
    stacked = np.stack(mats, axis=-1)  # (n, p, q)
    return np.transpose(stacked, (0, 2, 1))  # (n, q, p)


def _to_r(a):
    """R's ``.smk.to_r``: a tensor comes home from its device first."""
    if hasattr(a, "cpu"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _device(backend):
    """R's ``.smk.device``."""
    return "cuda" if backend == "gpu" else "cpu"


# meta_kriging_binary's defaults, as R sends them through reticulate (an
# R double arrives as a Python float; the R code wraps the integer ones
# in as.integer)
R_DEFAULTS = dict(
    weight=1.0, n_core=20.0, n_samples=5000.0, burn_in=0.75, cov_model="exponential",
    combiner="wasserstein_mean", link="probit", k_prior="invwishart", phi_proposals=1,
    phi_proposal_family="gaussian", fused_build="off", subset_engine="dense",
    n_neighbors=16, build_dtype="float32", partition_method="random", bucket_ladder=None,
    chunk_pipeline="sync", adaptive_schedule="off", target_rhat=1.05, target_ess=100.0,
    adapt_max_extra_frac=0.5, fault_policy="abort", fault_max_retries=2, watchdog=False,
    dist_init_timeout_s=120.0, ckpt_commit_timeout_s=120.0, n_report=None,
    checkpoint_path=None, compile_store_dir=None, run_log_dir=None, n_devices=None,
    backend="gpu", seed=0, config_overrides=None,
)


def replay_meta_kriging_binary(pkg, y, x, coords, coords_test, x_test, *, inject=None,
                               **r_args):
    """``meta_kriging_binary(...)`` of the R file of ``pkg`` ("smk_torch":
    r/meta_kriging_torch.R; "smk_tpu": r/meta_kriging_tpu.R), step for
    step: the layout conversions, the modifyList config merge, the
    keyword set of the fit call, the returned list. ``r_args`` are the R
    arguments (dots as underscores); ``inject``: extra keywords for the
    fit call that no R caller passes (the tests' randomness). Returns
    (the R list as a dict, the Python result, the progress lines)."""
    a = dict(R_DEFAULTS, **r_args)
    if pkg == "smk_tpu" and a["backend"] == "gpu":
        a["backend"] = "tpu"
    if isinstance(y, np.ndarray):
        y = [y]
    q, p = len(y), x[0].shape[1]
    y_arr = np.column_stack([np.asarray(v, np.float64) for v in y])  # sapply
    x_arr = _r_simplify2array_aperm(x)
    xt_arr = _r_simplify2array_aperm(x_test)
    smk = importlib.import_module(pkg)
    cfg_args = {**dict(
        n_subsets=int(a["n_core"]), n_samples=int(a["n_samples"]), burn_in_frac=a["burn_in"],
        cov_model=a["cov_model"], combiner=a["combiner"], link=a["link"],
        phi_proposals=int(a["phi_proposals"]), phi_proposal_family=a["phi_proposal_family"],
        fused_build=a["fused_build"], subset_engine=a["subset_engine"],
        n_neighbors=int(a["n_neighbors"]), build_dtype=a["build_dtype"],
        partition_method=a["partition_method"],
        bucket_ladder=None if a["bucket_ladder"] is None else [int(v) for v in
                                                               a["bucket_ladder"]],
        chunk_pipeline=a["chunk_pipeline"], adaptive_schedule=a["adaptive_schedule"],
        target_rhat=a["target_rhat"], target_ess=a["target_ess"],
        adapt_max_extra_frac=a["adapt_max_extra_frac"], fault_policy=a["fault_policy"],
        fault_max_retries=int(a["fault_max_retries"]), watchdog=a["watchdog"],
        dist_init_timeout_s=a["dist_init_timeout_s"],
        ckpt_commit_timeout_s=a["ckpt_commit_timeout_s"],
        compile_store_dir=a["compile_store_dir"], run_log_dir=a["run_log_dir"],
        priors=smk.PriorConfig(a_prior=a["k_prior"])), **(a["config_overrides"] or {})}
    cfg = smk.SMKConfig(**cfg_args)
    extra, lines = {}, []
    if a["n_report"] is not None:
        extra["chunk_iters"] = int(a["n_report"])
        extra["progress"] = lambda info: lines.append(
            "smk [%s] iteration %d/%d  phi acceptance %.3f" % (
                info["phase"], info["iteration"], info["n_samples"], info["phi_accept_rate"]))
    if a["checkpoint_path"] is not None:
        extra["checkpoint_path"] = a["checkpoint_path"]
    if a["n_devices"] is not None:
        extra["n_devices"] = int(a["n_devices"])
    arrays = [np.asarray(v, np.float32) for v in (y_arr, x_arr, coords, coords_test, xt_arr)]
    if pkg == "smk_torch":
        res = smk.fit_meta_kriging(*arrays, config=cfg, weight=int(a["weight"]),
                                   seed=int(a["seed"]), device=_device(a["backend"]),
                                   **extra, **(inject or {}))
        api = importlib.import_module("smk_torch.api")
    else:
        res = smk.fit_meta_kriging(jax.random.key(int(a["seed"])), *arrays, config=cfg,
                                   weight=int(a["weight"]), **extra, **(inject or {}))
        api = smk.api
    out = {
        "result": _to_r(res.param_grid), "result2": _to_r(res.w_grid),
        "SamplePar": _to_r(res.sample_par), "Samplew": _to_r(res.sample_w),
        "p.sample": _to_r(res.p_samples), "param.quant": _to_r(res.param_quant),
        "w.quant": _to_r(res.w_quant), "p.quant": _to_r(res.p_quant),
        "phi.accept": _to_r(res.phi_accept_rate), "ess": _to_r(res.param_ess),
        "rhat": _to_r(res.param_rhat), "w.ess": _to_r(res.w_ess),
        "w.rhat": _to_r(res.w_rhat), "ess.per.sec": res.latent_ess_per_sec,
        "phases": dict(res.phase_seconds),
        "subsets.dropped": [int(v) for v in res.subsets_dropped],
        "domains.dropped": [int(v) for v in res.domains_dropped],
        "run.log.path": res.run_log_path, "pad.waste.frac": res.pad_waste_frac,
        "frozen.at": None if res.frozen_at is None else [int(v) for v in res.frozen_at],
        "chunks.saved.frac": res.chunks_saved_frac,
        "param.names": list(api.param_names(q, p)),
    }
    return out, res, lines


@pytest.fixture(scope="module")
def r_style_inputs():
    """Inputs exactly as an R user of the reference holds them (the
    twin's fixture): q separate response vectors and design matrices."""
    rng = np.random.default_rng(7)
    n, t, q, p = 96, 5, 2, 2
    y_list = [rng.integers(0, 2, n).astype(np.float64) for _ in range(q)]
    x_list = [rng.normal(size=(n, p)) for _ in range(q)]
    xt_list = [rng.normal(size=(t, p)) for _ in range(q)]
    coords = rng.uniform(size=(n, 2))
    coords_test = rng.uniform(size=(t, 2))
    return y_list, x_list, coords, coords_test, xt_list


# the twin's call-sequence test: the keyword set the R code passes, with
# the reference workflow's link
CALL = dict(n_core=4, n_samples=60, burn_in=0.5, link="logit", backend="cpu",
            config_overrides=dict(n_quantiles=20, resample_size=50))


@pytest.fixture(scope="module")
def replayed(r_style_inputs):
    """The R call replayed through each package: the twin's (its key
    from ``seed``), the port's fed the twin's key schedule, and the
    port's on its own seeded randomness."""
    twin = replay_meta_kriging_binary("smk_tpu", *r_style_inputs, **CALL)
    port = replay_meta_kriging_binary(
        "smk_torch", *r_style_inputs, **CALL,
        inject=dict(randomness=JaxRandomness(jax.random.key(0))))
    seeded = replay_meta_kriging_binary("smk_torch", *r_style_inputs, **dict(CALL, seed=3))
    return {"twin": twin, "port": port, "seeded": seeded}


class TestRFrontendCallSequence:
    def test_full_call_sequence(self, r_style_inputs, replayed):
        y_list, x_list, coords, coords_test, xt_list = r_style_inputs
        q, p = len(y_list), x_list[0].shape[1]
        t = coords_test.shape[0]
        x_arr = _r_simplify2array_aperm(x_list)
        for j in range(q):  # aperm correctness: each response's design round-trips
            np.testing.assert_array_equal(x_arr[:, j, :], x_list[j])
        import smk_torch as smk
        from smk_torch.models.probit_gp import n_params

        assert hasattr(smk, "SMKConfig") and hasattr(smk, "fit_meta_kriging")
        assert hasattr(importlib.import_module("smk_torch.api"), "param_names")
        out, res, _ = replayed["seeded"]
        d_par = n_params(q, p)
        shapes = {"result": (20, d_par), "result2": (20, t * q), "SamplePar": (50, d_par),
                  "Samplew": (50, t * q), "p.sample": (50, t * q), "param.quant": (3, d_par),
                  "w.quant": (3, t * q), "p.quant": (3, t * q), "phi.accept": (4, q),
                  "ess": (4, d_par), "rhat": (4, d_par), "w.ess": (4, t * q),
                  "w.rhat": (4, t * q)}
        for name, shape in shapes.items():
            assert out[name].shape == shape, name
            assert np.isfinite(out[name]).all(), name
        assert ((out["p.sample"] >= 0) & (out["p.sample"] <= 1)).all()
        assert set(out["phases"]) == {"partition", "warm_start", "subset_fits", "combine",
                                      "resample_predict"}
        names = out["param.names"]
        assert len(names) == d_par and names[0] == "beta[0,0]" and names[-1] == f"phi[{q - 1}]"
        assert out["subsets.dropped"] == out["domains.dropped"] == []
        assert out["frozen.at"] is None and out["chunks.saved.frac"] is None
        assert out["pad.waste.frac"] is None and out["run.log.path"] is None
        assert res.param_grid.device.type == "cpu"

    @pytest.mark.parametrize("name", ["result", "result2", "SamplePar", "Samplew", "p.sample",
                                      "param.quant", "w.quant", "p.quant", "phi.accept"])
    def test_replayed_call_matches_the_twins(self, replayed, name):
        got, want = replayed["port"][0][name], replayed["twin"][0][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)

    def test_replayed_draws_and_diagnostics_match_the_twins(self, replayed):
        got, want = replayed["port"][1].subset_results, replayed["twin"][1].subset_results
        np.testing.assert_allclose(got.param_samples.numpy(), np.asarray(want.param_samples),
                                   **TOL)
        np.testing.assert_allclose(got.w_samples.numpy(), np.asarray(want.w_samples), **TOL)
        np.testing.assert_allclose(replayed["port"][0]["ess"], replayed["twin"][0]["ess"],
                                   rtol=1e-4)
        assert replayed["port"][0]["param.names"] == replayed["twin"][0]["param.names"]
        assert set(replayed["port"][0]) == set(replayed["twin"][0])

    def test_seed_route_is_bitwise_a_direct_call(self, r_style_inputs, replayed):
        from smk_torch import SMKConfig, fit_meta_kriging
        from smk_torch.config import PriorConfig

        y_list, x_list, coords, coords_test, xt_list = r_style_inputs
        direct = fit_meta_kriging(
            np.column_stack(y_list).astype(np.float32),
            _r_simplify2array_aperm(x_list).astype(np.float32), coords.astype(np.float32),
            coords_test.astype(np.float32), _r_simplify2array_aperm(xt_list).astype(np.float32),
            config=SMKConfig(n_subsets=4, n_samples=60, burn_in_frac=0.5, link="logit",
                             n_quantiles=20, resample_size=50,
                             priors=PriorConfig(a_prior="invwishart")),
            weight=1, seed=3, device="cpu")
        res = replayed["seeded"][1]
        for f in ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "p_quant",
                  "param_quant", "w_quant", "phi_accept_rate", "param_ess"):
            assert torch.equal(getattr(res, f), getattr(direct, f)), f
        # the seed picks the chain: the twin-keyed replay is another
        assert not torch.equal(res.param_grid, replayed["port"][1].param_grid)


def _r_functions(src):
    """{name: (argument names, the returned list's names)} of the R
    file's top-level ``name <- function(...)`` definitions."""
    out = {}
    for m in re.finditer(r"^([A-Za-z_.][\w.]*) <- function\(", src, re.M):
        i, depth = m.end(), 1
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        args = [a.split("=")[0].strip() for a in _top_level_split(src[m.end():i - 1])]
        body_end = src.find("\n}\n", i)
        body = src[i:body_end if body_end >= 0 else len(src)]
        tail = body[body.rfind("\n  list(\n"):] if "\n  list(\n" in body else ""
        names = re.findall(r"^    ([A-Za-z][\w.]*) = ", tail, re.M)
        out[m.group(1)] = (args, names)
    return out


def _top_level_split(s):
    parts, depth, cur, quote = [], 0, "", None
    for ch in s:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0 and not quote:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return [p for p in parts + [cur] if p.strip()]


class TestPublicSurface:
    PUBLIC = ("meta_kriging_binary", "plot_smk_traces", "smk.predict.serve", "smk.live.fit",
              "smk.ingest", "smk.refit")

    def test_same_functions_arguments_and_result_names_as_the_twins_file(self):
        port, twin = _r_functions(_r_src()), _r_functions(_r_src(R_TWIN))
        for name in self.PUBLIC:
            assert name in port and name in twin, name
            p_args, p_names = port[name]
            t_args, t_names = twin[name]
            want = t_args + ["backend"] if name == "smk.predict.serve" else t_args
            assert p_args == want, name
            assert p_names == t_names, name
        assert len(port["meta_kriging_binary"][1]) == 22
        assert "backend = c(\"gpu\", \"cpu\")" in _r_src()

    def test_the_ports_file_names_neither_the_jax_package_nor_jax(self):
        src = _r_src()
        assert "smk_tpu" not in src and not re.search(r"jax", src, re.I)
        assert not re.search(r'import\("(smk_tpu|jax)', src)
        assert 'reticulate::import("smk_torch")' in src
        assert 'reticulate::import("smk_torch.serve")' in src
        assert "seed = as.integer(seed)" in src
        assert "device = .smk.device(backend)" in src
        assert 'if (backend == "gpu") "cuda" else "cpu"' in src
        assert "the GPU backend (smk_torch) needs the 'reticulate' package" in src

    def test_gpu_backend_without_a_card_raises_the_ports_error(self, r_style_inputs,
                                                              monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="none is available; pass device='cpu'"):
            replay_meta_kriging_binary("smk_torch", *r_style_inputs,
                                       **dict(CALL, backend="gpu"))


class TestRFrontendExtendedOptions:
    def test_k_prior_report_checkpoint_kwargs(self, r_style_inputs, tmp_path):
        """k.prior maps to PriorConfig(a_prior=...), n.report to
        chunk_iters + a progress callable whose sprintf fields exist,
        checkpoint.path to checkpoint_path."""
        ckpt = os.path.join(tmp_path, "r_frontend.npz")
        out, res, lines = replay_meta_kriging_binary(
            "smk_torch", *r_style_inputs, **dict(CALL, n_samples=40, n_report=10,
                                                  checkpoint_path=ckpt, k_prior="invwishart"))
        assert os.path.exists(ckpt)
        assert np.isfinite(out["p.quant"]).all()
        assert len(lines) == 4 and lines[0].startswith("smk [burn] iteration 10/40")

    def test_compile_store_dir_arg_wired(self):
        r_src = _r_src()
        assert "compile.store.dir = NULL" in r_src
        assert "compile_store_dir = compile.store.dir" in r_src

    def test_compile_store_dir_kwarg(self, r_style_inputs, tmp_path):
        """Two R-session-style calls (fresh config and model objects)
        through one store directory give the same combined grids
        bitwise (on the CPU the store holds no kernel library)."""
        store = os.path.join(tmp_path, "prog_store")
        kw = dict(CALL, n_samples=20, n_report=10, compile_store_dir=store)
        one = replay_meta_kriging_binary("smk_torch", *r_style_inputs, **kw)[0]
        two = replay_meta_kriging_binary("smk_torch", *r_style_inputs, **kw)[0]
        np.testing.assert_array_equal(one["result"], two["result"])
        np.testing.assert_array_equal(one["result2"], two["result2"])


class TestRunLogDir:
    def test_run_log_dir_arg_wired(self):
        r_src = _r_src()
        assert "run.log.dir = NULL" in r_src
        assert "run_log_dir = run.log.dir" in r_src
        assert "run.log.path = res$run_log_path" in r_src
        assert "python -m smk_torch.obs summarize <path>" in r_src

    def test_run_log_dir_kwarg(self, r_style_inputs, tmp_path):
        from smk_torch.obs.summarize import load_run, summarize

        log_dir = os.path.join(tmp_path, "runlogs")
        out, _, _ = replay_meta_kriging_binary(
            "smk_torch", *r_style_inputs, **dict(
                CALL, n_samples=16, n_report=8, run_log_dir=log_dir,
                config_overrides=dict(n_quantiles=20, resample_size=50,
                                      live_diagnostics=True)))
        path = out["run.log.path"]
        assert path is not None and os.path.dirname(path) == log_dir
        assert len(os.listdir(log_dir)) == 1
        s = summarize(path)
        assert not s["truncated"] and s["n_orphan_spans"] == 0
        assert s["root_span"]["name"] == "fit_meta_kriging"
        assert {"partition", "warm_start", "subset_fits", "combine", "resample_predict"} <= {
            sp["name"] for sp in load_run(path)["spans"]}


class TestScaleOutKnobs:
    def test_n_devices_arg_wired(self):
        import inspect

        from smk_torch import fit_meta_kriging

        r_src = _r_src()
        assert "n.devices = NULL" in r_src
        assert "extra$n_devices <- as.integer(n.devices)" in r_src
        assert "n_devices" in inspect.signature(fit_meta_kriging).parameters

    def test_ragged_mesh_composition_wired(self, r_style_inputs):
        from smk_torch.api import MetaKrigingResult

        r_src = _r_src()
        assert "must be divisible by n.devices" not in r_src
        assert "composes with every partition.method" in r_src
        assert "pad.waste.frac = res$pad_waste_frac" in r_src
        assert "pad_waste_frac" in MetaKrigingResult._fields
        # n.devices on the CPU: virtual entries, the coherent fit's plan
        out, _, _ = replay_meta_kriging_binary(
            "smk_torch", *r_style_inputs, **dict(CALL, n_samples=8, n_devices=2,
                                                  partition_method="coherent"))
        assert 0.0 <= out["pad.waste.frac"] < 1.0 and np.isfinite(out["p.quant"]).all()


class TestAdaptiveKnobs:
    def test_adaptive_schedule_knobs_wired(self, r_style_inputs):
        from smk_torch.api import MetaKrigingResult
        from smk_torch.config import SMKConfig

        r_src = _r_src()
        for s in ('adaptive.schedule = c("off", "on")', "target.rhat = 1.05",
                  "target.ess = 100", "adapt.max.extra.frac = 0.5",
                  "adaptive.schedule <- match.arg(adaptive.schedule)",
                  "adaptive_schedule = adaptive.schedule", "target_rhat = target.rhat",
                  "target_ess = target.ess", "adapt_max_extra_frac = adapt.max.extra.frac",
                  "chunks.saved.frac = res$chunks_saved_frac",
                  "frozen.at = if (is.null(res$frozen_at)) NULL"):
            assert s in r_src, s
        assert {"frozen_at", "chunks_saved_frac"} <= set(MetaKrigingResult._fields)
        cfg = SMKConfig()
        assert (cfg.adaptive_schedule, cfg.target_rhat, cfg.target_ess,
                cfg.adapt_max_extra_frac) == ("off", 1.05, 100.0, 0.5)
        with pytest.raises(ValueError, match="adaptive_schedule"):
            SMKConfig(adaptive_schedule="sometimes")
        with pytest.raises(ValueError, match="target_rhat"):
            SMKConfig(target_rhat=1.0)
        out, _, _ = replay_meta_kriging_binary(
            "smk_torch", *r_style_inputs, **dict(
                CALL, n_samples=40, n_report=10, adaptive_schedule="on", target_rhat=1.5,
                target_ess=8.0, config_overrides=dict(n_quantiles=20, resample_size=50,
                                                      live_diagnostics=True, n_chains=2)))
        assert len(out["frozen.at"]) == 4 and 0.0 <= out["chunks.saved.frac"] < 1.0


class TestSubsetEngineKnobs:
    def test_subset_engine_knobs_wired(self):
        from smk_torch.config import SMKConfig

        r_src = _r_src()
        for s in ('subset.engine = c("dense", "vecchia")', "n.neighbors = 16L",
                  'build.dtype = c("float32",', "subset.engine <- match.arg(subset.engine)",
                  "build.dtype <- match.arg(build.dtype)", "subset_engine = subset.engine",
                  "n_neighbors = as.integer(n.neighbors)", "build_dtype = build.dtype"):
            assert s in r_src, s
        cfg = SMKConfig()
        assert (cfg.subset_engine, cfg.n_neighbors, cfg.build_dtype) == ("dense", 16, "float32")
        with pytest.raises(ValueError, match="subset_engine"):
            SMKConfig(subset_engine="nngp")
        with pytest.raises(ValueError, match="n_neighbors"):
            SMKConfig(n_neighbors=0)
        with pytest.raises(ValueError, match="build_dtype"):
            SMKConfig(build_dtype="float16")


class TestResilienceKnobs:
    def test_watchdog_and_dist_init_args_wired(self):
        r_src = _r_src()
        for s in ("watchdog = FALSE", "dist.init.timeout.s = 120", "watchdog = watchdog",
                  "dist_init_timeout_s = dist.init.timeout.s",
                  "domains.dropped = as.integer(unlist(res$domains_dropped))"):
            assert s in r_src, s

    def test_ckpt_commit_timeout_wired(self):
        from smk_torch.config import SMKConfig

        r_src = _r_src()
        assert "ckpt.commit.timeout.s = 120" in r_src
        assert "ckpt_commit_timeout_s = ckpt.commit.timeout.s" in r_src
        assert SMKConfig(ckpt_commit_timeout_s=30.0).ckpt_commit_timeout_s == 30.0
        with pytest.raises(ValueError, match="ckpt_commit_timeout_s"):
            SMKConfig(ckpt_commit_timeout_s=0.0)

    def test_partition_method_and_ladder_wired(self):
        from smk_torch.config import SMKConfig

        r_src = _r_src()
        assert 'partition.method = c("random",' in r_src
        assert "bucket.ladder = NULL" in r_src
        assert "partition_method = partition.method" in r_src
        assert "bucket_ladder = if (is.null(bucket.ladder)) NULL else" in r_src
        assert SMKConfig(partition_method="coherent").partition_method == "coherent"
        assert SMKConfig(bucket_ladder=[8, 16, 32]).bucket_ladder == (8, 16, 32)
        with pytest.raises(ValueError, match="partition_method"):
            SMKConfig(partition_method="zorder")
        with pytest.raises(ValueError, match="ascending"):
            SMKConfig(bucket_ladder=(16, 8))

    def test_config_accepts_r_double_spellings(self):
        from smk_torch.config import SMKConfig

        cfg = SMKConfig(dist_init_retries=2.0, dist_init_timeout_s=60.0, watchdog=True,
                        watchdog_min_deadline_s=5.0, watchdog_margin=3.0)
        assert cfg.dist_init_retries == 2 and isinstance(cfg.dist_init_retries, int)
        with pytest.raises(ValueError, match="watchdog_margin"):
            SMKConfig(watchdog_margin=0.5)
        with pytest.raises(ValueError, match="watchdog must be"):
            SMKConfig(watchdog="yes")
        with pytest.raises(ValueError, match="dist_init_timeout_s"):
            SMKConfig(dist_init_timeout_s=0.0)

    def test_resilience_knobs_run(self, r_style_inputs):
        """fault.policy, fault.max.retries and watchdog as R sends them,
        through a fit: a healthy quarantined, watched fit drops nothing
        and is bitwise the plain fit."""
        plain = replay_meta_kriging_binary("smk_torch", *r_style_inputs,
                                           **dict(CALL, n_samples=20, n_report=10))[0]
        armed = replay_meta_kriging_binary(
            "smk_torch", *r_style_inputs, **dict(CALL, n_samples=20, n_report=10,
                                                  fault_policy="quarantine",
                                                  fault_max_retries=3.0, watchdog=True))[0]
        assert armed["subsets.dropped"] == armed["domains.dropped"] == []
        np.testing.assert_array_equal(armed["result"], plain["result"])


class TestConfigOverrides:
    def test_overrides_merge_like_modifyList(self):
        import smk_torch as smk

        base = dict(n_subsets=4, n_samples=60, burn_in_frac=0.5, cov_model="exponential",
                    combiner="wasserstein_mean", link="probit",
                    priors=smk.PriorConfig(a_prior="invwishart"))
        overrides = dict(u_solver="cg", cg_iters=8, cg_precond="nystrom", cg_precond_rank=64,
                         cov_model="matern32")
        cfg = smk.SMKConfig(**{**base, **overrides})
        assert cfg.cg_precond == "nystrom" and cfg.cov_model == "matern32"
        assert cfg.n_subsets == 4

    def test_integer_fields_coerced_from_r_doubles(self):
        import smk_torch as smk

        cfg = smk.SMKConfig(n_subsets=4.0, n_samples=60.0, cg_iters=8.0, cg_precond_rank=64.0,
                            phi_update_every=2.0)
        assert cfg.n_subsets == 4 and isinstance(cfg.n_subsets, int)
        assert cfg.cg_iters == 8 and isinstance(cfg.cg_iters, int)
        with pytest.raises(ValueError, match="cg_iters"):
            smk.SMKConfig(cg_iters=8.5)
        assert smk.SMKConfig(cg_iters=np.float64(8.0)).cg_iters == 8
        assert smk.SMKConfig(cg_iters=np.int64(8)).cg_iters == 8

    def test_integer_fields_reject_bool_and_strings(self):
        import smk_torch as smk

        with pytest.raises(ValueError, match="cg_iters"):
            smk.SMKConfig(cg_iters=True)
        with pytest.raises(ValueError, match="n_samples"):
            smk.SMKConfig(n_samples=False)
        with pytest.raises(ValueError, match="cg_iters"):
            smk.SMKConfig(cg_iters="8")
        with pytest.raises(ValueError, match="n_samples"):
            smk.SMKConfig(n_samples=float("inf"))


class TestInputShapeValidation:
    """fit_meta_kriging fails at the boundary with named shapes, as the
    twin's does."""

    def _args(self):
        rng = np.random.default_rng(0)
        n, q, p, t = 40, 1, 2, 3
        return dict(
            y=rng.integers(0, 2, (n, q)).astype(np.float32),
            x=rng.normal(size=(n, q, p)).astype(np.float32),
            coords=rng.uniform(size=(n, 2)).astype(np.float32),
            coords_test=rng.uniform(size=(t, 2)).astype(np.float32),
            x_test=rng.normal(size=(t, q, p)).astype(np.float32),
        )

    @pytest.mark.parametrize("field,bad_shape,msg", [
        ("y", (40,), "y must be"),
        ("x", (40, 2, 2), "x must be"),
        ("coords", (39, 2), "coords must be"),
        ("coords_test", (3, 3), "coords_test must be"),
        ("x_test", (4, 1, 2), "x_test must be"),
    ])
    def test_bad_shapes_named(self, field, bad_shape, msg):
        from smk_torch import SMKConfig, fit_meta_kriging

        args = self._args()
        args[field] = np.zeros(bad_shape, np.float32)
        with pytest.raises(ValueError, match=msg):
            fit_meta_kriging(config=SMKConfig(n_subsets=2, n_samples=20, burn_in_frac=0.5),
                             device="cpu", **args)


class TestServePassThrough:
    def test_predict_serve_wired(self):
        r_src = _r_src()
        for s in ("smk.predict.serve <- function(artifact.path", "deadline.ms = NULL",
                  ".smk.serve.engines", "get0(eng_key, envir = .smk.serve.engines)",
                  "file.info(artifact.path)", 'as.numeric(art_info$mtime), "|", art_info$size',
                  "args$deadline_s <- deadline.ms / 1000", "serve$PredictionEngine",
                  "compile_store_dir <- compile.store.dir",
                  "rows.degraded = as.logical(to_r(res$rows_degraded))",
                  "health = eng$health()",
                  "eng_args <- list(artifact.path, device = .smk.device(backend))"):
            assert s in r_src, s

    def test_coalesce_and_fleet_wired(self):
        r_src = _r_src()
        for s in ("coalesce.window.ms = NULL", "n.replicas = NULL",
                  "coalesce_window_ms <- coalesce.window.ms", "serve$ReplicaFleet",
                  "n_replicas <- as.integer(n.replicas)",
                  "if (is.null(coalesce.window.ms)) 0 else coalesce.window.ms",
                  "if (is.null(n.replicas)) 1 else n.replicas", "held.s = res$held_s"):
            assert s in r_src, s
        # the device rides the engine key and its eviction suffix
        assert r_src.count('"|",\n    backend\n') == 1 and '"|", backend\n' in r_src

    def test_coalesce_window_config_validation(self):
        import smk_torch as smk

        assert smk.SMKConfig().coalesce_window_ms == 0.0
        assert smk.SMKConfig(coalesce_window_ms=25.0).coalesce_window_ms == 25.0
        with pytest.raises(ValueError, match="coalesce_window_ms"):
            smk.SMKConfig(coalesce_window_ms=-1.0)


class TestLiveFitWiring:
    def test_live_fit_ingest_refit_wired(self):
        r_src = _r_src()
        for s in ("smk.live.fit <- function(gen.dir", "smk.ingest <- function(gen.dir",
                  "smk.refit <- function(gen.dir", 'partition_method = "coherent"',
                  "serve$LiveFit", ".smk.live.fits", "get0(gen.dir, envir = .smk.live.fits)",
                  "do.call(live$ingest, args)",
                  "dirty.subsets = as.integer(unlist(receipt$dirty_subsets))",
                  "live$refit(", "as.integer(report$generation)",
                  "refit.speedup = report$refit_speedup", "skipped = isTRUE(report$skipped)",
                  "as.integer(seed), full = isTRUE(full)"):
            assert s in r_src, s

    def test_live_loop_and_serve_replayed(self, tmp_path):
        """smk.live.fit, smk.ingest of rows into one subset, smk.refit
        (dirty) and smk.predict.serve on the published generation, each
        replayed with R's conversions and keywords (backend "cpu")."""
        out = replay_live_loop(str(tmp_path / "gens"), backend="cpu", k=4, n=64, t=5,
                               n_samples=16, n_new=8, n_query=6)
        fit, ing, ref, srv = out["fit"], out["ingest"], out["refit"], out["serve"]
        assert fit["generation"] == 0 and sum(fit["subset.sizes"]) == fit["n.rows"] == 64
        assert ing["n.rows"] == 8 and ing["generation"] == 0
        assert ing["dirty.subsets"] == sorted(set(ing["routed.subsets"]))
        assert ref["generation"] == 1 and ref["refit.subsets"] == ing["dirty.subsets"]
        assert not ref["skipped"] and ref["refit.wall.s"] > 0.0
        assert srv["p.quant"].shape == (3, 6, 1) and np.isfinite(srv["p.quant"]).all()
        assert not srv["rows.degraded"].any() and srv["health"]["state"] == "ready"


def replay_live_loop(gen_dir, *, backend, k, n, t, n_samples, n_new, n_query, seed=0):
    """smk.live.fit -> smk.ingest -> smk.refit -> smk.predict.serve of
    r/meta_kriging_torch.R, replayed: the R lists of the four calls."""
    from smk_torch import SMKConfig, serve

    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(n, 2))
    y = [rng.integers(0, 2, n).astype(np.float64)]
    x = [rng.normal(size=(n, 2))]
    ct = rng.uniform(size=(t, 2))
    xt = [rng.normal(size=(t, 2))]
    # smk.live.fit
    cfg = SMKConfig(n_subsets=int(k), n_samples=int(n_samples), burn_in_frac=0.75,
                    cov_model="exponential", combiner="wasserstein_mean", link="probit",
                    partition_method="coherent", bucket_ladder=None, run_log_dir=None)
    live = serve.LiveFit(gen_dir, config=cfg, coords_test=np.asarray(ct, np.float64),
                         x_test=_r_simplify2array_aperm(xt).astype(np.float64), weight=1,
                         device=_device(backend))
    manifest = live.fit(int(seed), np.column_stack(y).astype(np.float64),
                        _r_simplify2array_aperm(x).astype(np.float64),
                        np.asarray(coords, np.float64))
    fit = {"generation": int(manifest["generation"]), "artifact": manifest["artifact"],
           "n.rows": live.n_rows, "subset.sizes": [int(v) for v in live.subset_sizes],
           "gen.dir": gen_dir}
    # smk.ingest: new rows near subset 0's first rows
    near = coords[:n_new] + rng.normal(scale=1e-3, size=(n_new, 2))
    receipt = live.ingest(np.column_stack([rng.integers(0, 2, n_new).astype(np.float64)]),
                          coords_new=np.asarray(near, np.float64),
                          x_new=_r_simplify2array_aperm([rng.normal(size=(n_new, 2))]))
    ingest = {"n.rows": int(receipt.n_rows),
              "routed.subsets": sorted(int(v) for v in receipt.routed_subsets),
              "dirty.subsets": [int(v) for v in receipt.dirty_subsets],
              "dirty.group.frac": receipt.dirty_group_frac,
              "generation": int(receipt.generation)}
    # smk.refit (dirty), seed 1L
    report = live.refit(1, full=False)
    refit = {"generation": None if report.generation is None else int(report.generation),
             "refit.subsets": [int(v) for v in report.refit_subsets],
             "reused.subsets": [int(v) for v in report.reused_subsets],
             "dirty.group.frac": report.dirty_group_frac, "refit.wall.s": report.refit_wall_s,
             "refit.speedup": report.refit_speedup, "rhat.max": report.param_rhat_max,
             "skipped": bool(report.skipped)}
    # smk.predict.serve on the published generation
    art = os.path.join(gen_dir, serve.generation_artifact_name(refit["generation"]))
    eng = serve.PredictionEngine(art, device=_device(backend))
    res = eng.predict(rng.uniform(size=(n_query, 2)).astype(np.float32),
                      _r_simplify2array_aperm([rng.normal(size=(n_query, 2))]).astype(
                          np.float32), seed=0)
    srv = {"p.quant": _to_r(res.p_quant), "rows.degraded": _to_r(res.rows_degraded).astype(bool),
           "buckets": [int(v) for v in res.buckets], "request.id": res.request_id,
           "latency.s": res.latency_s, "held.s": res.held_s, "health": eng.health()}
    return {"fit": fit, "ingest": ingest, "refit": refit, "serve": srv}
