"""The port's adaptive schedule (smk_torch/parallel/schedule.py, the K
ladder of smk_torch/compile/buckets.py, the adaptive regime of
smk_torch/parallel/recovery.py and models/probit_gp.finalize_masked)
against the JAX package's.

- The scheduler: the twin's and the port's AdaptiveScheduler are fed the
  same ``observe`` sequences (the twin's own unit scenarios); the
  decisions, ``summary()`` and ``to_arrays()`` must be identical, and so
  must ``k_ladder`` and ``compaction_rung``.
- An adaptive fit on the twin's integration problem (n = 64, K = 4,
  m = 16, two chains, 80 sweeps in chunks of 10, target_rhat 1.5,
  target_ess 8, patience 1): one JAX fit in a module fixture, the port
  fed the replayed JAX keys (tests/test_torch_recovery.ChunkedJaxReplay).
  First the margin: every live statistic the schedule compared stands
  more than 1e-3 (relative) from its target, so the port's fp32
  statistics cannot flip a decision; then ``frozen_at`` and the kept
  counts must be equal and the masked finalize's outputs within the
  sweep tolerance (5e-5 absolute + 5e-5 relative).
- A kill at the first freeze boundary resumed from the checkpoint and
  the scheduler sidecar is bitwise the uninterrupted port fit.
- A reopen, a port fit on the port's own noise with the live statistics
  scripted (K = 8, m = 8, one chain): a budget-frozen straggler that a
  later grant reopens writes, after its gap, the draws its chain makes
  without a pause in the fixed-schedule fit of the same problem and
  noise (its state and its stream wait where it stopped); the boundaries
  the fit reported, replayed in the twin's scheduler, give the same
  summary.
- The refusals, with the twin's messages.
"""

# smklint: test-budget=scheduler parity is host numpy (ms); one JAX adaptive fit in a module fixture (m=16, ~30 s of compiles) and port fits at that size (~1 s each)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.compile import buckets as jbuckets
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.parallel import partition as jpart
from smk_tpu.parallel import recovery as jrec
from smk_tpu.parallel import schedule as jsched
from smk_tpu.utils.tracing import ChunkPipelineStats as JaxStats
from smk_torch import convert
from smk_torch.compile import buckets as tbuckets
from smk_torch.config import SMKConfig
from smk_torch.models import probit_gp as tp
from smk_torch.obs.reporter import read_jsonl
from smk_torch.parallel import partition as tpart
from smk_torch.parallel import recovery as rec
from smk_torch.parallel import schedule as tsched
from smk_torch.testing.faults import corrupt_segment
from smk_torch.utils import checkpoint as ckpt
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_recovery import replay

TOL = dict(atol=5e-5, rtol=5e-5)
GOOD, BAD = 1.05, 2.5



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's fits here are a few (m, m) products of m <= 96 a sweep:
    one thread runs them as fast, and does not contend with the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------
# the K ladder and the scheduler, host numpy
# ---------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 23, 32])
def test_k_ladder_and_compaction_rungs_match_twin(k):
    assert tbuckets.k_ladder(k) == jbuckets.k_ladder(k)
    for dev in (1, 2, 4):
        if k % dev:
            with pytest.raises(ValueError):
                tbuckets.compaction_rung(1, k, dev)
            continue
        for n in range(1, k + 1):
            assert tbuckets.compaction_rung(n, k, dev) == jbuckets.compaction_rung(n, k, dev)
    for bad in (0, k + 1):
        with pytest.raises(ValueError):
            tbuckets.compaction_rung(bad, k)
    assert tbuckets.ceil_to_multiple(7, 4) == jbuckets.ceil_to_multiple(7, 4) == 8


def _scheds(k=4, n_kept=40, chunk_iters=10, **knobs):
    base = dict(n_subsets=k, n_samples=80, burn_in_frac=0.5, live_diagnostics=True,
                adaptive_schedule="on", target_rhat=1.1, target_ess=50.0,
                adapt_patience=2, min_samples_before_stop=10, adapt_max_extra_frac=0.5)
    base.update(knobs)
    return (jsched.AdaptiveScheduler(JaxConfig(**base), k=k, n_kept=n_kept,
                                     chunk_iters=chunk_iters),
            tsched.AdaptiveScheduler(SMKConfig(**base), k=k, n_kept=n_kept,
                                     chunk_iters=chunk_iters))


def _dec(d):
    return (d.active, d.newly_frozen, d.newly_budget_frozen, d.newly_reopened, d.grant,
            d.all_done)


# (scheduler knobs, [(it, span, written, kc, rhat, ess, kind, exhausted)],
#  stops: {step: (ids, it)}) — the twin's unit scenarios
_ESS = [99.0] * 4
SCENARIOS = {
    "patience": ({}, [(50, (0, 10), range(4), 4, [GOOD] * 4, _ESS, "samp", False),
                      (60, (10, 20), range(4), 4, [GOOD] * 4, _ESS, "samp", False)], {}),
    "min-samples": (dict(adapt_patience=1, min_samples_before_stop=15),
                    [(50, (0, 10), range(4), 4, [GOOD] * 4, _ESS, "samp", False),
                     (60, (10, 20), range(4), 4, [GOOD] * 4, _ESS, "samp", False)], {}),
    "streak-reset": ({}, [(50, (0, 10), range(4), 4, [GOOD] * 4, _ESS, "samp", False),
                          (60, (10, 20), range(4), 4, [BAD, GOOD, GOOD, GOOD], _ESS, "samp",
                           False),
                          (70, (20, 30), [0], 1, [GOOD, 1, 1, 1], _ESS, "samp", False),
                          (80, (30, 40), [0], 1, [GOOD, 1, 1, 1], _ESS, "samp", False)], {}),
    "nan-never-converges": (
        dict(adapt_patience=1),
        [(50, (0, 10), range(4), 4, [np.nan, GOOD, GOOD, GOOD], [99.0, np.nan, 99.0, 99.0],
          "samp", False),
         (60, (10, 20), [0, 1], 2, [np.nan, GOOD, GOOD, GOOD], [99.0, np.nan, 99.0, 99.0],
          "samp", False)], {}),
    "low-ess": (dict(adapt_patience=1), [(50, (0, 10), range(4), 4, [GOOD] * 4,
                                          [10.0, 99.0, 99.0, 99.0], "samp", False)], {}),
    "grant-strict": (dict(adapt_patience=1), [
        (50, (0, 10), range(4), 4, [GOOD] * 3 + [BAD], _ESS, "samp", False),
        (60, (10, 20), [3], 1, [1, 1, 1, BAD], _ESS, "samp", False),
        (70, (20, 30), [3], 1, [1, 1, 1, BAD], _ESS, "samp", False),
        (80, (30, 40), [3], 1, [1, 1, 1, BAD], _ESS, "samp", True),
        (90, (40, 50), [3], 1, [1, 1, 1, GOOD], _ESS, "extra", True)], {}),
    "break-even-freezes": (dict(adapt_patience=1), [
        (50, (0, 10), range(4), 4, [GOOD] * 3 + [BAD], _ESS, "samp", False),
        (60, (10, 20), [3], 3, [1, 1, 1, BAD], _ESS, "samp", True)], {}),
    "allowance-capped": (dict(adapt_patience=1, adapt_max_extra_frac=0.25), [
        (50, (0, 10), range(4), 4, [GOOD] * 3 + [BAD], _ESS, "samp", False),
        (60, (10, 20), [3], 1, [1, 1, 1, BAD], _ESS, "samp", False),
        (70, (20, 30), [3], 1, [1, 1, 1, BAD], _ESS, "samp", False),
        (80, (30, 40), [3], 1, [1, 1, 1, BAD], _ESS, "samp", True),
        (90, (40, 50), [3], 1, [1, 1, 1, BAD], _ESS, "extra", True),
        (100, (50, 60), [3], 1, [1, 1, 1, BAD], _ESS, "extra", True)], {}),
    "ranked-nan-worst": (dict(adapt_patience=1), [
        (50, (0, 10), range(4), 4, [GOOD, GOOD, BAD, BAD], _ESS, "samp", False),
        (60, (10, 20), [2, 3], 2, [1, 1, BAD, BAD], _ESS, "samp", False),
        (70, (20, 30), [2, 3], 2, [1, 1, BAD, BAD], _ESS, "samp", False),
        (80, (30, 40), [2, 3], 2, [1, 1, 2.0, np.nan], [99.0, 99.0, 99.0, np.nan], "samp",
         True)], {}),
    "idempotent-replay": (dict(adapt_patience=1), [
        (50, (0, 10), range(4), 4, [GOOD] * 3 + [BAD], _ESS, "samp", False),
        (50, (0, 10), range(4), 4, [GOOD] * 3 + [BAD], _ESS, "samp", False)], {}),
}
_ESS8 = [99.0] * 8
SCENARIOS["budget-freeze-reopen"] = (dict(n_subsets=8, adapt_patience=1), [
    (50, (0, 10), range(8), 8, [GOOD] * 2 + [BAD] * 6, _ESS8, "samp", False),
    (60, (10, 20), range(2, 8), 6, [1, 1] + [BAD] * 6, _ESS8, "samp", False),
    (70, (20, 30), range(2, 8), 6, [1, 1] + [BAD] * 6, _ESS8, "samp", False),
    (80, (30, 40), range(2, 8), 6, [1, 1, GOOD, 2.5, 2.4, 2.3, 2.2, 2.1], _ESS8, "samp", True),
    (90, (40, 50), [3, 4, 5, 6], 4, [1, 1, 1, GOOD, GOOD, GOOD, GOOD, 2.1], _ESS8, "extra",
     True),
    (100, (50, 60), [7], 1, [1] * 7 + [GOOD], _ESS8, "extra", True)], {4: ([7], 80)})


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_decisions_and_sidecar_match_twin(name):
    knobs, steps, stops = SCENARIOS[name]
    k = knobs.get("n_subsets", 4)
    twin, port = _scheds(k=k, **knobs)
    for i, (it, span, written, kc, rh, es, kind, exhausted) in enumerate(steps):
        if i in stops:
            twin.mark_stopped(*stops[i])
            port.mark_stopped(*stops[i])
        kw = dict(kind=kind, it=it, span=span, written=list(written), kc_dispatched=kc,
                  rhat_max=np.asarray(rh, np.float64), ess_min=np.asarray(es, np.float64),
                  plan_exhausted=exhausted)
        assert _dec(port.observe(**kw)) == _dec(twin.observe(**kw)), (name, i)
        assert port.pending_extras(it) == twin.pending_extras(it)
    assert port.summary() == twin.summary()
    jt, pt = twin.to_arrays(), port.to_arrays()
    assert sorted(jt) == sorted(pt)
    for key in jt:
        np.testing.assert_array_equal(pt[key], jt[key], err_msg=key)
    # the port's sidecar restores into the twin's and back
    again = _scheds(k=k, **knobs)[1]
    again.restore_arrays(jt)
    assert again.summary() == port.summary()
    assert tsched.SCHED_STATE_VERSION == jsched.SCHED_STATE_VERSION


def test_sidecar_geometry_and_version_refused():
    blobs = _scheds()[1].to_arrays()
    with pytest.raises(ValueError, match="geometry"):
        _scheds(k=2, n_subsets=2)[1].restore_arrays(blobs)
    bad = dict(blobs, version=np.asarray(99, np.int64))
    with pytest.raises(ValueError, match="version"):
        _scheds()[1].restore_arrays(bad)


# ---------------------------------------------------------------------
# an adaptive fit against the twin's (the twin's integration problem)
# ---------------------------------------------------------------------
N_KEPT = 40
ADAPT = dict(n_subsets=4, n_samples=80, burn_in_frac=0.5, live_diagnostics=True,
             adaptive_schedule="on", target_rhat=1.5, target_ess=8.0, adapt_patience=1,
             min_samples_before_stop=8, adapt_max_extra_frac=0.5, n_chains=2)
CHUNK = 10
FIELDS = ("param_grid", "w_grid", "phi_accept_rate", "param_samples", "w_samples",
          "param_ess", "param_rhat", "w_ess", "w_rhat")


def _twin_problem(n, k, seed=7):
    rng = np.random.default_rng(seed)
    q, p, t = 1, 2, 5
    coords = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(n, q, p)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 2, size=(n, q)), jnp.float32)
    ct = jnp.asarray(rng.uniform(size=(t, 2)), jnp.float32)
    xt = jnp.asarray(rng.normal(size=(t, q, p)), jnp.float32)
    jp = jpart.random_partition(jax.random.key(0), y, x, coords, k)
    return {"jpart": jp, "ct": ct, "xt": xt, "key": jax.random.key(1),
            "part": convert.partition_from_numpy(jp, device="cpu"),
            "ct_t": torch.as_tensor(np.array(ct)), "xt_t": torch.as_tensor(np.array(xt))}


def _live_events(log_dir):
    (path,) = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    return [r["attrs"] for r in read_jsonl(path)
            if r.get("kind") == "event" and r.get("name") == "live_diagnostics"]


def _port_fit(prob, cfg_kw, **kw):
    cfg = SMKConfig(**cfg_kw)
    stats = kw.pop("pipeline_stats", None) or ChunkPipelineStats()
    noise = replay(prob["key"], cfg, cfg.n_subsets, prob["part"].subset_size, t=5)
    res = rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), prob["part"], prob["ct_t"],
                                  prob["xt_t"], noise, chunk_iters=CHUNK,
                                  pipeline_stats=stats, **kw)
    return res, stats


def _twin_fit(prob, cfg_kw, **kw):
    stats = JaxStats()
    res = jrec.fit_subsets_chunked(JaxSampler(JaxConfig(**cfg_kw)), prob["jpart"], prob["ct"],
                                   prob["xt"], prob["key"], chunk_iters=CHUNK,
                                   pipeline_stats=stats, **kw)
    return res, stats


def _twin_fields(res, c):
    """The twin's (K, C, ...) result as the port's (K, C*n, ...) pooled
    fields (a single-chain result passes through)."""
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def adaptive(tmp_path_factory):
    prob = _twin_problem(64, 4)
    jdir, pdir = tmp_path_factory.mktemp("jlog"), tmp_path_factory.mktemp("plog")
    twin_res, twin_stats = _twin_fit(prob, dict(ADAPT, run_log_dir=str(jdir)))
    port_res, port_stats = _port_fit(prob, dict(ADAPT, run_log_dir=str(pdir)))
    return {"prob": prob, "twin": (twin_res, twin_stats, _live_events(str(jdir))),
            "port": (port_res, port_stats, _live_events(str(pdir)))}


def test_live_statistics_clear_the_targets_by_a_margin(adaptive):
    """The decisions are thresholds on fp32 statistics: every value the
    schedule compared stands more than 1e-3 relative from its target, in
    the twin's run, and the port's values agree with the twin's."""
    twin_ev, port_ev = adaptive["twin"][2], adaptive["port"][2]
    assert len(port_ev) == len(twin_ev) > 0
    for te, pe in zip(twin_ev, port_ev):
        assert te["iteration"] == pe["iteration"]
        for key, target in (("rhat_max", ADAPT["target_rhat"]), ("ess_min", ADAPT["target_ess"])):
            tv = np.asarray(te[key], np.float64)
            pv = np.asarray(pe[key], np.float64)
            fin = np.isfinite(tv)
            assert (np.isfinite(pv) == fin).all()
            assert (np.abs(tv[fin] - target) > 1e-3 * target).all(), (te["iteration"], key, tv)
            np.testing.assert_allclose(pv[fin], tv[fin], rtol=1e-3)


def test_adaptive_fit_freezes_grants_and_matches_twin(adaptive):
    twin_res, twin_stats, _ = adaptive["twin"]
    port_res, port_stats, _ = adaptive["port"]
    ja, pa = twin_stats.adaptive, port_stats.adaptive
    assert pa["frozen_at"] == ja["frozen_at"]
    assert pa["kept_counts"] == ja["kept_counts"]
    for key in ("subset_chunks_dispatched", "subset_chunks_baseline", "chunks_saved_frac",
                "extra_granted", "saved_slots", "spent_slots", "n_frozen", "frozen_counts"):
        assert pa[key] == ja[key], key
    assert pa["n_frozen"] >= 1 and pa["extra_granted"] >= 1
    assert max(pa["kept_counts"]) > N_KEPT
    assert pa["subset_chunks_dispatched"] < pa["subset_chunks_baseline"]
    want = _twin_fields(twin_res, 2)
    for f in FIELDS:
        got = getattr(port_res, f).numpy()
        np.testing.assert_allclose(got, want[f].reshape(got.shape), equal_nan=True,
                                   err_msg=f, **TOL)
    agg = port_stats.aggregate()
    assert agg["frozen_at"] == pa["frozen_at"]
    assert agg["chunks_saved_frac"] == pa["chunks_saved_frac"]
    assert agg["ess_per_second_adaptive"] is not None
    assert port_stats.adaptive["host_mirror_bytes"] > 0


def test_kill_at_the_freeze_boundary_resumes_bitwise(adaptive, tmp_path):
    prob = adaptive["prob"]
    full = adaptive["port"][0]
    first = min(f for f in adaptive["port"][1].adaptive["frozen_at"] if f >= 0)
    n_chunks = first // CHUNK  # the chunk whose boundary froze the first subset
    path = str(tmp_path / "ck.npz")
    assert _port_fit(prob, ADAPT, checkpoint_path=path, stop_after_chunks=n_chunks)[0] is None
    assert os.path.exists(ckpt.sidecar_path(path, "sched"))
    resumed, stats = _port_fit(prob, ADAPT, checkpoint_path=path)
    for f in FIELDS:
        assert torch.equal(getattr(resumed, f).nan_to_num(7.0),
                           getattr(full, f).nan_to_num(7.0)), f
    assert stats.adaptive["frozen_at"] == adaptive["port"][1].adaptive["frozen_at"]


def test_off_is_the_fixed_schedule_bitwise(adaptive):
    prob = adaptive["prob"]
    off = dict(ADAPT, adaptive_schedule="off")
    armed = _port_fit(prob, off)[0]
    plain = _port_fit(prob, dict(off, live_diagnostics=False))[0]
    for f in FIELDS:
        assert torch.equal(getattr(armed, f).nan_to_num(7.0),
                           getattr(plain, f).nan_to_num(7.0)), f


# ---------------------------------------------------------------------
# a reopen, with scripted statistics
# ---------------------------------------------------------------------
REOPEN = dict(n_subsets=8, n_samples=50, burn_in_frac=0.2, live_diagnostics=True,
              adaptive_schedule="on", target_rhat=1.1, target_ess=50.0, adapt_patience=1,
              min_samples_before_stop=10, adapt_max_extra_frac=0.5)
# the live R-hat each sampling boundary reports, by boundary (the twin's
# budget-freeze-and-reopen scenario): 0, 1 freeze first; at plan
# exhaustion 2 freezes, 3-6 are granted an extra chunk and 7 is
# budget-frozen; then 3-6 converge and 7 reopens; then 7 converges
SCRIPT = [[GOOD] * 2 + [BAD] * 6, [1, 1] + [BAD] * 6, [1, 1] + [BAD] * 6,
          [1, 1, GOOD, 2.5, 2.4, 2.3, 2.2, 2.1], [1, 1, 1, GOOD, GOOD, GOOD, GOOD, 2.1],
          [1] * 7 + [GOOD]]
def _scripted(base, script, seen):
    """The scheduler with the live statistics replaced by ``script``;
    every observe call's arguments are appended to ``seen``."""
    class Scripted(base):
        def observe(self, **kw):
            step = getattr(self, "_step", 0)
            self._step = step + 1
            kw["rhat_max"] = np.asarray(script[step], np.float64)
            kw["ess_min"] = np.full(8, 99.0)
            seen.append(dict(kw))
            return super().observe(**kw)
    return Scripted


def _reopen_port_fit(cfg_kw, script=None):
    """A port fit of the K = 8 problem on the port's own noise (one
    seeded generator a row), the scheduler scripted by ``script``."""
    rng = np.random.default_rng(11)
    n, t = 64, 5
    f = torch.float32
    coords = torch.tensor(rng.uniform(size=(n, 2)), dtype=f)
    x = torch.tensor(rng.normal(size=(n, 1, 2)), dtype=f)
    y = torch.tensor(rng.integers(0, 2, size=(n, 1)), dtype=f)
    ct = torch.tensor(rng.uniform(size=(t, 2)), dtype=f)
    xt = torch.tensor(rng.normal(size=(t, 1, 2)), dtype=f)
    g = torch.Generator()
    g.manual_seed(0)
    part = tpart.random_partition(tpart.random_permutation(g, n, "cpu"), y, x, coords, 8)
    cfg = SMKConfig(**cfg_kw)
    assert cfg.n_burn_in == 10
    model = tp.SpatialGPSampler(cfg)
    noise = model.default_noise(rec.stacked_subset_data(part, ct, xt), seed=5)
    seen, stats = [], ChunkPipelineStats()
    with pytest.MonkeyPatch.context() as mp:
        if script is not None:
            mp.setattr(rec, "AdaptiveScheduler",
                       _scripted(tsched.AdaptiveScheduler, script, seen))
        res = rec.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=CHUNK,
                                      pipeline_stats=stats)
    return res, stats, seen


@pytest.fixture(scope="module")
def reopened():
    """The scripted adaptive fit, and the reference: the fixed schedule
    on the same problem and noise, ten sweeps longer (burn-in 10, 50
    kept), where every subset runs without a pause."""
    fixed = dict(REOPEN, n_samples=60, burn_in_frac=1 / 6, live_diagnostics=False,
                 adaptive_schedule="off")
    return _reopen_port_fit(REOPEN, SCRIPT), _reopen_port_fit(fixed)


def test_reopened_straggler_continues_its_own_stream(reopened):
    """7 sits out the first extra chunk budget-frozen and is reopened
    for the second: its state and its stream wait where it stopped, so
    its 50 draws are the first 50 of its chain in the fixed-schedule
    fit, the last ten written after the gap."""
    (res, stats, _), (ref, _, _) = reopened
    pa = stats.adaptive
    assert pa["extra_granted"] == 2
    # 7: its 40 base draws, a gap at [40, 50), then [50, 60)
    assert pa["kept_counts"][7] == 50 and pa["frozen_at"][7] == 70
    assert pa["kept_counts"][3] == 50 and pa["frozen_at"][3] == 60
    for f in ("param_samples", "w_samples"):
        got, want = getattr(res, f)[7], getattr(ref, f)[7]
        torch.testing.assert_close(got[:40], want[:40], **TOL, msg=f)
        assert not got[40:50].any(), f  # the gap holds no draw
        torch.testing.assert_close(got[50:60], want[40:50], **TOL, msg=f)


def test_reopen_decisions_replay_in_the_twins_scheduler(reopened):
    """The boundaries the port's executor reported, fed to the twin's
    scheduler (host numpy, the same script): the same summary."""
    (_, stats, seen), _ = reopened
    assert len(seen) == 6
    twin = jsched.AdaptiveScheduler(JaxConfig(**REOPEN), k=8, n_kept=40, chunk_iters=CHUNK)
    for kw in seen:
        twin.observe(**kw)
    summary = twin.summary()
    assert {key: stats.adaptive[key] for key in summary} == summary


# ---------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------
def test_chunk_size_refused_like_twin():
    prob = _twin_problem(64, 4)
    with pytest.raises(ValueError, match="incompatible with chunk_size"):
        _port_fit(prob, ADAPT, chunk_size=2)
    with pytest.raises(ValueError, match="incompatible with chunk_size"):
        _twin_fit(prob, ADAPT, chunk_size=2)


@pytest.mark.parametrize("knobs, match", [
    (dict(chunk_pipeline="overlap"), "requires chunk_pipeline='sync'"),
    (dict(live_diagnostics=False), "requires live_diagnostics=True"),
])
def test_config_refusals_match_twin(knobs, match):
    for cls in (SMKConfig, JaxConfig):
        with pytest.raises(ValueError, match=match):
            cls(**dict(ADAPT, **knobs))


@pytest.mark.parametrize("fault", ["no_sidecar", "unpaired_sidecar", "fixed_checkpoint",
                                   "holes"])
def test_resume_refusals(adaptive, tmp_path, fault):
    prob = adaptive["prob"]
    cfg = dict(ADAPT, fault_policy="quarantine") if fault == "holes" else ADAPT
    path = str(tmp_path / "ck.npz")
    if fault == "fixed_checkpoint":
        # a fixed-schedule checkpoint with kept draws: another run identity
        _port_fit(prob, dict(ADAPT, adaptive_schedule="off"), checkpoint_path=path,
                  stop_after_chunks=6)
        with pytest.raises(ValueError, match="different run"):
            _port_fit(prob, cfg, checkpoint_path=path)
        return
    assert _port_fit(prob, cfg, checkpoint_path=path, stop_after_chunks=6)[0] is None
    side = ckpt.sidecar_path(path, "sched")
    if fault == "no_sidecar":
        os.remove(side)
        match = "no scheduler sidecar"
    elif fault == "unpaired_sidecar":
        blobs = ckpt.load_sidecar(path, "sched")
        for pfx in ("cur_", "prev_"):
            blobs[pfx + "ledger"] = blobs[pfx + "ledger"].copy()
            blobs[pfx + "ledger"][4] = 999
        ckpt.save_sidecar(path, "sched", blobs)
        match = "does not pair"
    else:
        corrupt_segment(path, 0, mode="bitflip")
        match = "lenient holes"
    with pytest.raises(ValueError, match=match):
        _port_fit(prob, cfg, checkpoint_path=path)
