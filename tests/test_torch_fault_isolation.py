"""The port's fault-isolation engine (``fault_policy="quarantine"`` in
smk_torch/parallel/recovery.py, smk_torch/testing/faults.py,
smk_torch/parallel/domains.py and the survival mask of
smk_torch/parallel/combine.py) against the JAX package's.

The same ``inject_subset_nan`` schedules run in both packages on the
twin's own test problem (tests/test_fault_isolation.py: K = 4, m = 16,
24 sweeps, phi every 2nd sweep, chunks of 4), the port replaying the
JAX keys (tests/test_torch_recovery.ChunkedJaxReplay, whose ``fork``
folds the attempt into the key held at chunk start, as the twin's
refork does). Both engines must write the same fault ledger — the
retried, dropped and deferred subsets, the attempts, the chunk and
iteration — and the draws agree at the sweep tolerance (5e-5 absolute
+ 5e-5 relative), NaN where the twin's are NaN. The JAX fits run once
each in a module fixture on one shared model.
"""

# smklint: test-budget=six JAX quarantine fits at m=16 on one shared model (one compile set) in a module fixture; the port's fits at that size take under a second each
import dataclasses
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.parallel import combine as jcomb
from smk_tpu.parallel import domains as jdom
from smk_tpu.parallel import partition as jpart
from smk_tpu.parallel import recovery as jrec
from smk_tpu.testing import faults as jfaults
from smk_tpu.utils.tracing import ChunkPipelineStats as JaxStats
from smk_torch import SMKConfig, convert, fit_meta_kriging
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import combine as comb
from smk_torch.parallel import domains as dom
from smk_torch.parallel import recovery as rec
from smk_torch.testing import faults as tfaults
from smk_torch.testing.faults import corrupt_segment, inject_subset_nan
from smk_torch.utils.checkpoint import segment_path
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_recovery import replay

K, N, Q, P, T = 4, 64, 1, 2, 3
CFG = dict(n_subsets=K, n_samples=24, burn_in_frac=0.5, phi_update_every=2,
           fault_policy="quarantine")
CHUNK = 4
TOL = dict(atol=5e-5, rtol=5e-5)
# scenario -> ([(subset, at_iteration, max_fires, skip_fires)], domains)
SCENARIOS = {
    "no_fault": ([], None),
    "one_retry": ([(1, 14, 1, 0)], None),
    "exhausted": ([(1, 14, 99, 0)], None),
    "deferred_recovers": ([(1, 14, 3, 0), (2, 14, 1, 2)], None),
    "terminal_spare": ([(2, 22, 99, 0)], None),
    "whole_domain": ([(0, 14, 99, 0), (1, 14, 99, 0)], 2),
}


def _problem():
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = rng.normal(size=(N, Q, P)).astype(np.float32)
    y = rng.integers(0, 2, size=(N, Q)).astype(np.float32)
    ct = rng.uniform(size=(T, 2)).astype(np.float32)
    xt = rng.normal(size=(T, Q, P)).astype(np.float32)
    return y, x, coords, ct, xt


@pytest.fixture(scope="module")
def problem():
    y, x, coords, ct, xt = _problem()
    jp = jpart.random_partition(jax.random.key(0), *map(jnp.asarray, (y, x, coords)), K)
    return {"jpart": jp, "ct": jnp.asarray(ct), "xt": jnp.asarray(xt),
            "key": jax.random.key(1), "part": convert.partition_from_numpy(jp, device="cpu"),
            "ct_t": torch.as_tensor(ct), "xt_t": torch.as_tensor(xt)}


def _inject(module, schedule):
    import contextlib

    stack = contextlib.ExitStack()
    for subset, at, fires, skip in schedule:
        stack.enter_context(module.inject_subset_nan(subset, at, max_fires=fires,
                                                     skip_fires=skip))
    return stack


def run_twin(model, problem, scenario):
    schedule, n_domains = SCENARIOS[scenario]
    stats = JaxStats()
    dmap = None if n_domains is None else jdom.FailureDomainMap.from_n_domains(K, n_domains)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with _inject(jfaults, schedule):
            res = jrec.fit_subsets_chunked(
                model, problem["jpart"], problem["ct"], problem["xt"], problem["key"],
                chunk_iters=CHUNK, pipeline_stats=stats, domain_map=dmap)
    return res, stats


def run_port(problem, scenario, *, policy="quarantine", **kw):
    schedule, n_domains = SCENARIOS[scenario]
    cfg = SMKConfig(**dict(CFG, fault_policy=policy))
    stats = ChunkPipelineStats()
    dmap = None if n_domains is None else dom.FailureDomainMap.from_n_domains(K, n_domains)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with _inject(tfaults, schedule):
            res = rec.fit_subsets_chunked(
                tp.SpatialGPSampler(cfg), problem["part"], problem["ct_t"], problem["xt_t"],
                replay(problem["key"], cfg, K, problem["part"].subset_size, t=T),
                chunk_iters=CHUNK, pipeline_stats=stats, domain_map=dmap, **kw)
    return res, stats


@pytest.fixture(scope="module")
def runs(problem):
    model = JaxSampler(JaxConfig(**CFG))
    return {name: {"twin": run_twin(model, problem, name), "port": run_port(problem, name)}
            for name in SCENARIOS}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_fault_ledger_matches_twin(runs, scenario):
    (_, want), (_, got) = runs[scenario]["twin"], runs[scenario]["port"]
    assert got.fault_events == want.fault_events
    assert got.fault_summary() == want.fault_summary()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_draws_match_twin_nan_where_the_twin_is_nan(runs, scenario):
    (want, _), (got, _) = runs[scenario]["twin"], runs[scenario]["port"]
    for f in ("param_samples", "w_samples", "param_grid", "phi_accept_rate"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   equal_nan=True, err_msg=f, **TOL)
    np.testing.assert_array_equal(rec.find_failed_subsets(got),
                                  jrec.find_failed_subsets(want))


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_overlap_pipeline_keeps_the_twins_fault_ledger(problem, runs, scenario):
    """Under chunk_pipeline="overlap" a fault is found one chunk late,
    with the successor in flight; the rewind discards it, so the ledger
    is the twin's and the draws are the sync run's, bit for bit."""
    schedule, n_domains = SCENARIOS[scenario]
    cfg = SMKConfig(**dict(CFG, chunk_pipeline="overlap"))
    stats = ChunkPipelineStats()
    dmap = None if n_domains is None else dom.FailureDomainMap.from_n_domains(K, n_domains)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with _inject(tfaults, schedule):
            res = rec.fit_subsets_chunked(
                tp.SpatialGPSampler(cfg), problem["part"], problem["ct_t"], problem["xt_t"],
                replay(problem["key"], cfg, K, problem["part"].subset_size, t=T),
                chunk_iters=CHUNK, pipeline_stats=stats, domain_map=dmap)
    (_, want), (sync_res, _) = runs[scenario]["twin"], runs[scenario]["port"]
    assert stats.fault_events == want.fault_events
    assert stats.fault_summary() == want.fault_summary()
    for a, b in zip(res, sync_res):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_scenarios_exercise_retry_drop_and_deferral(runs):
    """The schedules cover what they are named for (the twin's
    tests/test_fault_isolation.py expectations, on the port)."""
    summ = {name: r["port"][1].fault_summary() for name, r in runs.items()}
    assert summ["no_fault"]["n_events"] == 0
    assert summ["one_retry"]["retry_attempts"] == {"1": 1}
    assert summ["one_retry"]["subsets_dropped"] == []
    assert summ["exhausted"]["subsets_dropped"] == [1]
    assert summ["deferred_recovers"]["subsets_dropped"] == []
    assert summ["deferred_recovers"]["retry_attempts"] == {"1": 3, "2": 1}
    assert [e["deferred"] for e in runs["terminal_spare"]["port"][1].fault_events
            if e["deferred"]] == [[2]]
    assert summ["whole_domain"]["domains_dropped"] == [0]
    assert summ["whole_domain"]["subsets_dropped"] == [0, 1]


def test_fault_free_quarantine_is_bitwise_abort(problem, runs):
    abort, _ = run_port(problem, "no_fault", policy="abort")
    quarantine, _ = runs["no_fault"]["port"]
    for a, b in zip(abort, quarantine):
        assert torch.equal(a, b)


def test_survivors_of_a_retry_are_bitwise_the_uninjected_run(runs):
    clean, _ = runs["no_fault"]["port"]
    retried, _ = runs["one_retry"]["port"]
    assert torch.equal(clean.param_samples[[0, 2, 3]], retried.param_samples[[0, 2, 3]])
    assert torch.isfinite(retried.param_samples).all()
    assert not torch.equal(clean.param_samples[1], retried.param_samples[1])


@pytest.mark.parametrize("method", ["wasserstein_mean", "weiszfeld_median"])
def test_degraded_combine_matches_twin(runs, method):
    (want_res, _), (got_res, _) = runs["exhausted"]["twin"], runs["exhausted"]["port"]
    mask = np.ones(K, bool)
    mask[1] = False
    want = jcomb.combine_quantile_grids(want_res.param_grid, method, survival_mask=mask,
                                        min_surviving_frac=0.5)
    got = comb.combine_quantile_grids(got_res.param_grid, method, survival_mask=mask,
                                      min_surviving_frac=0.5)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(comb.SubsetSurvivalError) as ei:
        comb.combine_quantile_grids(got_res.param_grid, method, survival_mask=mask,
                                    min_surviving_frac=0.95)
    assert (ei.value.n_surviving, ei.value.n_total) == (3, K)


MASK_CASES = {
    "all_alive": (np.ones(6, bool), 0.5, None),
    "one_dead": (np.array([1, 0, 1, 1, 1, 1], bool), 0.5, None),
    "below_floor": (np.array([1, 0, 0, 0, 1, 0], bool), 0.5, None),
    "domain_floor": (np.array([1, 1, 1, 0, 0, 0], bool), 0.5, [0, 0, 0, 1, 1, 2]),
    "domains_ok": (np.array([1, 0, 1, 0, 1, 1], bool), 0.5, [0, 0, 1, 1, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_apply_survival_mask_matches_twin(case):
    mask, frac, doms = MASK_CASES[case]
    grids = np.random.default_rng(1).normal(size=(6, 5, 3)).astype(np.float32)
    try:
        want = jcomb.apply_survival_mask(jnp.asarray(grids), mask, min_surviving_frac=frac,
                                         domain_of_subset=doms)
    except jcomb.SubsetSurvivalError as e:
        with pytest.raises(comb.SubsetSurvivalError) as ei:
            comb.apply_survival_mask(torch.as_tensor(grids), mask,
                                     min_surviving_frac=frac, domain_of_subset=doms)
        assert type(ei.value).__name__ == type(e).__name__
        assert (ei.value.n_surviving, ei.value.n_total) == (e.n_surviving, e.n_total)
        return
    t = torch.as_tensor(grids)
    got = comb.apply_survival_mask(t, mask, min_surviving_frac=frac, domain_of_subset=doms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mask.all():
        assert got is t


def test_domain_survival_error_is_a_subset_survival_error():
    assert issubclass(comb.DomainSurvivalError, comb.SubsetSurvivalError)
    e = comb.DomainSurvivalError(1, 3, 0.5)
    assert "failure domains" in str(e) and (e.n_surviving, e.n_total) == (1, 3)


@pytest.mark.parametrize("k, n", [(4, 1), (4, 2), (7, 3), (5, 5)])
def test_failure_domain_map_matches_twin(k, n):
    mine = dom.FailureDomainMap.from_n_domains(k, n)
    twin = jdom.FailureDomainMap.from_n_domains(k, n)
    assert mine.summary() == twin.summary()
    assert dom.FailureDomainMap.derive(k).summary() == jdom.FailureDomainMap.derive(k).summary()
    assert mine.domains_of([0, k - 1]) == twin.domains_of([0, k - 1])
    rng = np.random.default_rng(k * 10 + n)
    for _ in range(20):
        dead = rng.uniform(size=k) < 0.3
        bad = (rng.uniform(size=k) < 0.5) & ~dead
        assert mine.whole_domain_faults(bad, dead) == twin.whole_domain_faults(bad, dead)


def test_failure_domain_map_rejects_like_twin():
    for cls in (dom.FailureDomainMap, jdom.FailureDomainMap):
        with pytest.raises(ValueError, match="n_domains"):
            cls.from_n_domains(3, 4)
        with pytest.raises(ValueError, match="outside"):
            cls(domain_of_subset=(0, 2), labels=("a", "b"))
        with pytest.raises(ValueError, match="at least one subset"):
            cls(domain_of_subset=(0, 0), labels=("a", "b"))


@pytest.fixture(scope="module")
def golden_ckpt(problem, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "g.npz")
    res, _ = run_port(problem, "no_fault", checkpoint_path=path)
    return res, path


def _copy(src, dst_dir):
    dst_dir.mkdir()
    dst = str(dst_dir / "g.npz")
    shutil.copy(src, dst)
    for i in range(3):
        shutil.copy(segment_path(src, i), segment_path(dst, i))
    return dst


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_abort_rejects_a_corrupt_segment_loudly(problem, golden_ckpt, tmp_path, mode):
    path = _copy(golden_ckpt[1], tmp_path / mode)
    corrupt_segment(path, 1, mode)
    with pytest.raises(ValueError, match="corrupt draw segment"):
        run_port(problem, "no_fault", policy="abort", checkpoint_path=path)


def test_quarantine_on_a_corrupt_segment_names_lenient_resume(problem, golden_ckpt, tmp_path):
    """Under quarantine a corrupt segment resumes leniently, with a
    warning that names it: the rows outside the hole are the golden
    run's, the hole is re-sampled finite."""
    ref, src = golden_ckpt
    path = _copy(src, tmp_path / "q")
    corrupt_segment(path, 1, "bitflip")
    with pytest.warns(RuntimeWarning, match="lenient resume"):
        res = rec.fit_subsets_chunked(
            tp.SpatialGPSampler(SMKConfig(**CFG)), problem["part"], problem["ct_t"],
            problem["xt_t"], replay(problem["key"], SMKConfig(**CFG), K,
                                    problem["part"].subset_size, t=T),
            chunk_iters=CHUNK, checkpoint_path=path)
    assert torch.isfinite(res.param_samples).all()
    assert torch.equal(res.param_samples[:, :4], ref.param_samples[:, :4])
    assert torch.equal(res.param_samples[:, 8:], ref.param_samples[:, 8:])


def test_clean_checkpoint_resumes_to_the_same_result(problem, golden_ckpt, tmp_path):
    res, src = golden_ckpt
    again, _ = run_port(problem, "no_fault", checkpoint_path=_copy(src, tmp_path / "c"))
    assert torch.equal(res.param_samples, again.param_samples)


def test_manifest_carries_the_fault_ledger(problem, tmp_path):
    path = str(tmp_path / "f.npz")
    run_port(problem, "exhausted", checkpoint_path=path)
    from smk_torch.utils.checkpoint import load_pytree

    like = {"state": tp.SamplerState(*([np.zeros(0)] * 7)),
            "layout": tp.SamplerState(*([np.zeros(0)] * 7)), "noise": {"keys": 0, "next": 0},
            **dict.fromkeys(("it", "meta", "ident", "version", "seg_base", "n_segments",
                             "filled", "fault_attempts", "fault_dead", "fault_domain",
                             "fault_domain_attempts", "fault_domain_dead"), 0)}
    m = load_pytree(path, like)
    np.testing.assert_array_equal(m["fault_dead"], [0, 1, 0, 0])
    np.testing.assert_array_equal(m["fault_attempts"], [0, 3, 0, 0])


def test_fit_meta_kriging_stamps_subsets_dropped():
    y, x, coords, ct, xt = _problem()
    cfg = SMKConfig(**CFG)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with inject_subset_nan(2, 14, max_fires=99):
            res = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, device="cpu",
                                   chunk_iters=CHUNK)
    assert res.subsets_dropped == (2,)
    assert res.domains_dropped == ()
    assert torch.isfinite(res.p_quant).all() and torch.isfinite(res.param_grid).all()
    assert not torch.isfinite(res.subset_results.param_grid[2]).all()
    clean = fit_meta_kriging(y, x, coords, ct, xt, config=dataclasses.replace(cfg),
                             device="cpu", chunk_iters=CHUNK)
    assert clean.subsets_dropped == () and clean.pad_waste_frac is None


def test_quantile_grid_of_a_column_with_a_nan_is_nan_like_twin():
    """A dropped subset keeps NaN grids: jnp.quantile gives a NaN column
    wherever the draws hold a NaN, and the port's quantile grid does too
    (finite columns unchanged)."""
    from smk_tpu.ops.quantiles import quantile_grid as jax_quantile_grid
    from smk_torch.ops.quantiles import quantile_grid

    draws = np.random.default_rng(3).normal(size=(12, 3)).astype(np.float32)
    draws[5, 1] = np.nan
    want = np.asarray(jax_quantile_grid(jnp.asarray(draws), 20))
    got = quantile_grid(torch.as_tensor(draws), 20).numpy()
    assert np.isnan(got[:, 1]).all() and np.isfinite(got[:, [0, 2]]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
