"""The port's run telemetry (smk_torch/obs: the run log, the streaming
monitor, device memory and profiling) against the JAX package's
(smk_tpu/obs), and its hooks in the chunked executor.

- The reporter and the run log: round trip, torn trailing line, span
  tree, ``close``, unique file names; ``summarize`` of one log by both
  packages (coverage, orphans, chunk breakdown) equal.
- The streaming monitor: the same draws folded into both monitors; the
  (K,) ``rhat_max`` and ``ess_min`` must agree at every boundary to 1e-5
  relative (NaN where the twin's is NaN): several chains, one chain (NaN
  until its second half fills) and the adaptive masked fold-in. The
  final boundary's (K, d) R-hat equals the port's post-hoc ``rhat`` to
  1e-4 relative.
- In a fit (the port's chunked executor on the CPU, K = 4, m = 24):
  the armed monitor and run log leave the draws bitwise unchanged; the
  log carries the chunk, live-diagnostics, checkpoint-write, fault and
  watchdog events and summarizes with no orphan; a lenient resume with
  the monitor armed warns as the twin's does; a coherent fit's total
  streaming ESS is the sum of its bucket groups' last values.
- Profiling: ``parse_chunk_range`` as the twin's, no capture without a
  directory, and a CPU window whose trace ``summarize_trace`` reads.
"""

# smklint: test-budget=stdlib and torch host units are ms; the streaming parity runs the twin's tiny jits; the fits are the port's at K=4, m=24, 16-24 sweeps on the CPU (~1-2 s each); no JAX fit
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.obs import streaming as jstream
from smk_tpu.obs import summarize as jsummarize
from smk_tpu.obs.profiling import parse_chunk_range as jparse
from smk_torch import SMKConfig, fit_meta_kriging
from smk_torch.models import probit_gp as tp
from smk_torch.obs import streaming as tstream
from smk_torch.obs.events import RunLog, open_run_log
from smk_torch.obs.memory import device_memory_stats, hbm_watermark
from smk_torch.obs.profiling import (
    PROFILE_CHUNKS_ENV,
    PROFILE_DIR_ENV,
    ProfilerCapture,
    parse_chunk_range,
    summarize_trace,
)
from smk_torch.obs.reporter import JsonlWriter, read_jsonl, write_records
from smk_torch.obs.summarize import build_tree, load_run, main, summarize
from smk_torch.parallel import domains as dom
from smk_torch.parallel import recovery as rec
from smk_torch.parallel.partition import random_partition, random_permutation
from smk_torch.testing import faults as tfaults
from smk_torch.utils.diagnostics import rhat
from smk_torch.utils import tracing
from smk_torch.utils.tracing import ChunkPipelineStats



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
# reporter and run log
# ---------------------------------------------------------------------
def test_write_read_round_trip(tmp_path):
    p = str(tmp_path / "a.jsonl")
    recs = [{"i": i, "ok": True, "x": float("nan") if i == 2 else 1.5} for i in range(5)]
    write_records(p, recs)
    back = read_jsonl(p)
    assert back[2]["x"] is None  # strict JSON: NaN is null
    assert [r["i"] for r in back] == list(range(5))


def test_torn_trailing_line_skipped_and_malformed_middle_raises(tmp_path):
    p = str(tmp_path / "b.jsonl")
    write_records(p, [{"i": 0}, {"i": 1}])
    with open(p, "a") as f:
        f.write('{"i": 2, "torn": tr')
    assert read_jsonl(p) == [{"i": 0}, {"i": 1}]
    with pytest.raises(ValueError):
        read_jsonl(p, strict=True)
    q = str(tmp_path / "c.jsonl")
    with open(q, "w") as f:
        f.write('{"i": 0}\nnot json\n{"i": 2}\n')
    with pytest.raises(ValueError, match="malformed"):
        read_jsonl(q)


def test_writer_flushes_per_record_and_refuses_after_close(tmp_path):
    p = str(tmp_path / "d.jsonl")
    w = JsonlWriter(p)
    w.write({"i": 0})
    assert read_jsonl(p) == [{"i": 0}]
    w.close()
    with pytest.raises(ValueError):
        w.write({"i": 1})


def test_span_tree_events_and_counters(tmp_path):
    p = str(tmp_path / "run.jsonl")
    log = RunLog(p, name="t", meta={"k": 2})
    with log.span("root"):
        log.event("top_event", a=1)
        with log.span("child", tag="x"):
            log.event("inner_event", arr=np.arange(3), t=torch.tensor(2.5))
    log.counter("bytes", 10)
    log.counter("bytes", 5)
    log.close()
    recs = read_jsonl(p)
    assert recs[0]["kind"] == "run_start" and recs[0]["meta"] == {"k": 2}
    assert recs[-1]["kind"] == "run_end" and recs[-1]["counters"] == {"bytes": 15}
    spans = {r["name"]: r for r in recs if r["kind"] == "span"}
    assert spans["child"]["parent"] == spans["root"]["span_id"]
    assert spans["root"]["parent"] is None
    events = {r["name"]: r for r in recs if r["kind"] == "event"}
    assert events["top_event"]["span"] == spans["root"]["span_id"]
    assert events["inner_event"]["span"] == spans["child"]["span_id"]
    assert events["inner_event"]["attrs"]["arr"] == [0, 1, 2]
    assert events["inner_event"]["attrs"]["t"] == 2.5


def test_close_is_idempotent_and_truncation_visible(tmp_path):
    p = str(tmp_path / "run2.jsonl")
    log = RunLog(p, name="t")
    cm = log.span("never_closed")
    cm.__enter__()
    log.event("mid")
    log.close()
    log.close()
    log.event("after")  # dropped: the log is closed
    run = load_run(p)
    assert run["end"]["open_spans"] == 1
    assert run["spans"] == [] and [e["name"] for e in run["events"]] == ["mid"]


def test_open_run_log_names_unique_files(tmp_path):
    a = open_run_log(str(tmp_path), name="fit")
    b = open_run_log(str(tmp_path), name="fit")
    a.close()
    b.close()
    assert a.path != b.path and len(os.listdir(tmp_path)) == 2
    assert os.path.basename(a.path).startswith("fit_") and a.path.endswith(".jsonl")


def _make_log(path):
    log = RunLog(path, name="fit")
    with log.span("fit"):
        with log.span("partition"):
            pass
        with log.span("subset_fits"):
            log.event("chunk", chunk=0, host_stall_s=0.5, host_work_s=0.6, dispatch_s=0.01,
                      d2h_bytes=100, hbm_peak_bytes=1234)
            log.event("live_diagnostics", iteration=6, rhat_max=[1.1, 1.2], ess_min=[4.0, 5.0])
            log.event("ckpt_write", seconds=0.25, nbytes=4096)
    log.close()


@pytest.mark.parametrize("orphan", [False, True])
def test_summarize_matches_twin(tmp_path, orphan):
    """One log, summarized by both packages: the span tree's health and
    the chunk breakdown agree; an edited parent id is an orphan."""
    p = str(tmp_path / "run.jsonl")
    _make_log(p)
    if orphan:
        recs = read_jsonl(p)
        for r in recs:
            if r.get("kind") == "span" and r["name"] == "partition":
                r["parent"] = 999
        with open(p, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    mine, twin = summarize(p), jsummarize.summarize(p)
    for key in ("n_orphan_spans", "root_coverage", "truncated", "root_span", "chunks",
                "ckpt_writes", "live_diagnostics", "n_spans", "n_events"):
        assert mine[key] == twin[key], key
    assert mine["n_orphan_spans"] == int(orphan)
    if orphan:
        assert build_tree(load_run(p)["spans"])[2][0]["name"] == "partition"


def test_summarize_cli(tmp_path, capsys):
    p = str(tmp_path / "run.jsonl")
    _make_log(p)
    assert main([p]) == 0
    out = capsys.readouterr().out
    assert "span tree" in out and "fit" in out
    assert main([p, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["n_orphan_spans"] == 0
    from smk_torch.obs.__main__ import main as cli

    assert cli(["summarize", p, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["chunks"]["hbm_peak_bytes"] == 1234
    assert cli(["nope"]) == 2


# ---------------------------------------------------------------------
# the streaming monitor against the twin's
# ---------------------------------------------------------------------
def _ar1(shape, rho, seed):
    rng = np.random.default_rng(seed)
    k, c, n, d = shape
    draws = np.zeros(shape, np.float32)
    e = rng.normal(size=shape)
    for t in range(1, n):
        draws[:, :, t] = rho * draws[:, :, t - 1] + e[:, :, t]
    return draws


# (shape (K, C, n, d), chunk length, masked)
STREAM_CASES = {
    "chains2": ((3, 2, 120, 4), 20, False),
    "one-chain-nan-until-second-half": ((2, 1, 80, 3), 10, False),
    "ragged-last-chunk": ((2, 2, 75, 2), 20, False),
    "masked-freeze": ((4, 2, 100, 3), 10, True),
    "masked-one-chain": ((3, 1, 60, 2), 10, True),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_statistics_match_twin_at_every_boundary(case):
    shape, chunk, masked = STREAM_CASES[case]
    k, c, n, d = shape
    draws = _ar1(shape, 0.6, seed=len(case))
    n_half = n // 2
    make_j = jstream.make_stream_update_masked if masked else jstream.make_stream_update
    make_t = tstream.make_stream_update_masked if masked else tstream.make_stream_update
    ju, tu = jax.jit(make_j(n_half, c)), make_t(n_half, c)
    js = jstream.init_stream(k, c, d, per_subset_counts=masked)
    ts = tstream.init_stream(k, c, d, per_subset_counts=masked)
    jstats, tstats = jax.jit(jstream.make_stream_stats(c)), tstream.make_stream_stats(c)
    saw_nan = False
    for i, a in enumerate(range(0, n, chunk)):
        x = draws[:, :, a:a + chunk]
        if masked:
            live = np.ones(k, bool)
            live[: min(i // 2, k - 1)] = False  # subsets freeze one after another
            js = ju(js, jnp.asarray(x), jax.device_put(np.int32(a)), jnp.asarray(live))
            ts = tu(ts, torch.as_tensor(x), a, torch.as_tensor(live))
        else:
            js = ju(js, jnp.asarray(x), jax.device_put(np.int32(a)))
            ts = tu(ts, torch.as_tensor(x), a)
        want = [np.asarray(v) for v in jstats(js)]
        got = [v.numpy() for v in tstats(ts)]
        for w, g, name in zip(want[2:], got[2:], ("rhat_max", "ess_min")):
            assert (np.isnan(g) == np.isnan(w)).all(), (case, i, name)
            saw_nan |= bool(np.isnan(w).any())
            np.testing.assert_allclose(g, w, rtol=1e-5, equal_nan=True, err_msg=f"{case} {i}")
    if c == 1:
        assert saw_nan  # one chain: NaN until the second half fills
    if not masked:
        # at the last boundary the halves are post-hoc rhat's halves
        s_rhat, _ = tstream.stream_diagnostics(ts)
        post = np.stack([rhat(torch.as_tensor(draws[i])).numpy() for i in range(k)])
        np.testing.assert_allclose(s_rhat, post, rtol=1e-4)
    assert tstream.fetch_nbytes(k) == jstream.fetch_nbytes(k) == 8 * k


def test_masked_frozen_rows_keep_their_freeze_values():
    k, c, n, d = 3, 2, 40, 2
    draws = _ar1((k, c, n, d), 0.3, seed=9)
    upd = tstream.make_stream_update_masked(n // 2, c)
    st = tstream.init_stream(k, c, d, per_subset_counts=True)
    st = upd(st, torch.as_tensor(draws[:, :, :10]), 0, torch.ones(k, dtype=torch.bool))
    frozen = [t.clone() for t in st]
    st = upd(st, torch.as_tensor(draws[:, :, 10:20]), 10,
             torch.tensor([False, True, True]))
    for before, after in zip(frozen, st):
        assert torch.equal(before[0], after[0])
    with pytest.raises(ValueError, match="per_subset_counts"):
        upd(tstream.init_stream(k, c, d), torch.as_tensor(draws[:, :, :10]), 0,
            torch.ones(k, dtype=torch.bool))


# ---------------------------------------------------------------------
# the executor's hooks
# ---------------------------------------------------------------------
K = 4


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    n, q, p, t = 96, 1, 2, 5
    f = torch.float32
    coords = torch.tensor(rng.uniform(size=(n, 2)), dtype=f)
    x = torch.tensor(np.concatenate([np.ones((n, q, 1)), rng.normal(size=(n, q, p - 1))], -1),
                     dtype=f)
    y = torch.tensor(rng.integers(0, 2, size=(n, q)), dtype=f)
    ct = torch.tensor(rng.uniform(size=(t, 2)), dtype=f)
    xt = torch.tensor(rng.normal(size=(t, q, p)), dtype=f)
    g = torch.Generator()
    g.manual_seed(0)
    part = random_partition(random_permutation(g, n, "cpu"), y, x, coords, K)
    return {"part": part, "ct": ct, "xt": xt, "raw": (y.numpy(), x.numpy(), coords.numpy(),
                                                      ct.numpy(), xt.numpy())}


BASE = dict(n_subsets=K, n_samples=24, burn_in_frac=0.5, n_chains=2)
FIELDS = ("param_grid", "w_grid", "phi_accept_rate", "param_samples", "w_samples")


def _fit(problem, cfg_kw=None, faults=(), **kw):
    cfg = SMKConfig(**dict(BASE, **(cfg_kw or {})))
    stats = kw.pop("pipeline_stats", None) or ChunkPipelineStats()
    with contextlib.ExitStack() as stack:
        for f in faults:
            stack.enter_context(f)
        res = rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), problem["part"], problem["ct"],
                                      problem["xt"], chunk_iters=4, pipeline_stats=stats, **kw)
    return res, stats


def _log(log_dir):
    (name,) = os.listdir(log_dir)
    return os.path.join(log_dir, name)


@pytest.fixture(scope="module")
def plain(problem):
    return _fit(problem)[0]


def test_armed_monitor_and_run_log_leave_the_draws_bitwise(problem, plain, tmp_path):
    calls = []
    res, stats = _fit(problem, dict(live_diagnostics=True, run_log_dir=str(tmp_path)),
                      progress=calls.append)
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(plain, f)), f
    sampling = [c for c in calls if c["phase"] == "sample"]
    assert sampling and all("live_rhat_max" in c and "live_ess_min" in c for c in sampling)
    assert "live_rhat_max" not in calls[0]  # burn-in boundaries carry none
    agg = stats.aggregate()
    assert agg["live_rhat_final"] == stats.chunks[-1]["live_rhat_max"]
    assert agg["ess_per_second"] is not None and agg["live_ess_sum_final"] > 0
    assert agg["hbm_peak_bytes"] is None  # the CPU has no allocator stats
    # the boundary's one copy: the guard's K + 1 values and 2 K statistics
    assert stats.chunks[-1]["d2h_bytes"] == (K + 1 + 2 * K) * 4
    s = summarize(_log(str(tmp_path)))
    assert s["n_orphan_spans"] == 0 and not s["truncated"]
    assert s["root_span"]["name"] == "fit_subsets_chunked"
    assert s["root_coverage"] >= 0.95
    assert s["live_diagnostics"]["n_boundaries"] == 3
    assert s["chunks"]["n_chunks"] == 6


def test_fit_meta_kriging_run_log_and_result_fields(problem, tmp_path):
    cfg = SMKConfig(n_subsets=2, n_samples=16, n_chains=2, live_diagnostics=True,
                    run_log_dir=str(tmp_path))
    res = fit_meta_kriging(*problem["raw"], config=cfg, seed=3, device="cpu", chunk_iters=4)
    assert res.run_log_path is not None and os.path.exists(res.run_log_path)
    assert res.frozen_at is None and res.chunks_saved_frac is None
    s = summarize(res.run_log_path)
    assert s["root_span"]["name"] == "fit_meta_kriging" and s["n_orphan_spans"] == 0
    assert s["root_coverage"] >= 0.95
    names = {r["name"] for r in read_jsonl(res.run_log_path) if r.get("kind") == "span"}
    assert {"partition", "warm_start", "subset_fits", "chunk_loop", "finalize", "combine",
            "resample_predict", "fit_meta_kriging"} <= names
    end = read_jsonl(res.run_log_path)[-1]
    assert end["kind"] == "run_end" and end["attrs"]["pipeline"]["live_rhat_final"] is not None


def test_run_log_carries_faults_checkpoint_writes_and_the_watchdog(problem, tmp_path):
    logs = tmp_path / "logs"
    with pytest.warns(RuntimeWarning, match="quarantine"):
        _fit(problem, dict(fault_policy="quarantine", watchdog=True, run_log_dir=str(logs)),
             faults=[tfaults.inject_subset_nan(1, 14)],
             checkpoint_path=str(tmp_path / "ck.npz"))
    s = summarize(_log(str(logs)))
    assert s["faults"] and s["faults"][0]["retried"] == [1]
    assert s["ckpt_writes"]["n"] == 6 and s["ckpt_writes"]["bytes"] > 0
    assert [w["action"] for w in read_jsonl(_log(str(logs)))
            if w.get("name") == "watchdog" for w in [w["attrs"]]][:1] == ["armed"]


def test_run_log_records_a_fired_watchdog(problem, tmp_path):
    with tfaults.stall_chunk(18, max_stall_s=60.0):
        with pytest.raises(dom.ChunkTimeoutError):
            _fit(problem, dict(watchdog=True, watchdog_min_deadline_s=2.0, watchdog_margin=4.0,
                               run_log_dir=str(tmp_path)))
    s = summarize(_log(str(tmp_path)))
    assert len(s["watchdog"]["fired"]) == 1 and s["watchdog"]["fired"][0]["chunk"] == 4


def test_memory_stats_are_none_on_the_cpu():
    assert device_memory_stats(torch.device("cpu")) is None
    assert hbm_watermark(torch.device("cpu")) == {"available": False}


# ---------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------
@pytest.mark.parametrize("spec", [None, "", "3", "1:4", " 2:5 ", "0:1"])
def test_parse_chunk_range_matches_twin(spec):
    assert parse_chunk_range(spec) == jparse(spec)


@pytest.mark.parametrize("spec", ["a", "3:3", "5:2", "1:2:3", "-1"])
def test_parse_chunk_range_refuses_like_twin(spec):
    for parse in (parse_chunk_range, jparse):
        with pytest.raises(ValueError):
            parse(spec)


def test_capture_arms_only_with_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv(PROFILE_DIR_ENV, raising=False)
    monkeypatch.delenv(PROFILE_CHUNKS_ENV, raising=False)
    assert ProfilerCapture.from_config(SMKConfig()) is None
    assert ProfilerCapture.from_config(SMKConfig(profile_chunks="2:4")) is None
    cap = ProfilerCapture.from_config(SMKConfig(profile_dir=str(tmp_path)))
    assert (cap.start, cap.stop) == (0, 1)
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path / "env"))
    monkeypatch.setenv(PROFILE_CHUNKS_ENV, "2:4")
    cap = ProfilerCapture.from_config(SMKConfig(profile_dir=str(tmp_path), profile_chunks="0"))
    assert cap.out_dir == str(tmp_path / "env") and (cap.start, cap.stop) == (2, 4)
    assert not cap.maybe_start(1) and not cap.active and not cap.maybe_stop(3)


def test_cpu_window_in_a_fit_writes_a_readable_trace(problem, plain, tmp_path):
    prof_dir, log_dir = tmp_path / "prof", tmp_path / "log"
    res, _ = _fit(problem, dict(profile_dir=str(prof_dir), profile_chunks="1:3",
                                run_log_dir=str(log_dir)))
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(plain, f)), f
    s = summarize_trace(str(prof_dir))
    assert s is not None and s["trace_path"].endswith(".trace.json.gz")
    assert sorted(s["scope_us"]) == ["smk_chunk[1]", "smk_chunk[2]"]
    assert all(sc["host_us"] > 0 for sc in s["scopes"])
    events = [r["name"] for r in read_jsonl(_log(str(log_dir))) if r.get("kind") == "event"]
    assert events.count("profile_start") == 1 and events.count("profile_stop") == 1


def test_lenient_resume_with_live_diagnostics_warns(problem, tmp_path):
    """As the twin's: the surviving segments are not replayed into the
    monitor while corrupt ranges await refill."""
    path = str(tmp_path / "ck.npz")
    cfg = dict(fault_policy="quarantine", live_diagnostics=True)
    assert _fit(problem, cfg, checkpoint_path=path, stop_after_chunks=5)[0] is None
    tfaults.corrupt_segment(path, 0, mode="bitflip")
    with pytest.warns(RuntimeWarning, match="live_diagnostics on a lenient"):
        res, stats = _fit(problem, cfg, checkpoint_path=path)
    assert torch.isfinite(res.param_grid).all()
    # the refill chunks fold nothing in; the sampling boundaries after
    # the resume carry the monitor's verdict
    assert [c["iteration"] for c in stats.chunks if "live_rhat_max" in c] == [24]


def test_ragged_fit_sums_each_groups_last_ess_and_logs_its_groups(tmp_path):
    """A coherent fit runs one bucket group after another: the
    aggregate's total streaming ESS is the sum of each group's last
    value (the twin's _group_ess_final), and the run log has a span per
    group."""
    rng = np.random.default_rng(0)
    n = 200
    centers = rng.uniform(size=(6, 2))
    coords = (centers[rng.integers(0, 6, n)] + 0.04 * rng.normal(size=(n, 2))).astype(np.float32)
    x = np.concatenate([np.ones((n, 1, 1)), rng.normal(size=(n, 1, 1))], -1).astype(np.float32)
    y = (rng.uniform(size=(n, 1)) < 0.5).astype(np.float32)
    ct, xt = rng.uniform(size=(5, 2)).astype(np.float32), np.ones((5, 1, 2), np.float32)
    stats = ChunkPipelineStats()
    # two sampling chunks a group: batch-means ESS needs two batches
    cfg = SMKConfig(n_subsets=K, n_samples=32, n_chains=2, partition_method="coherent",
                    live_diagnostics=True, run_log_dir=str(tmp_path))
    res = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, seed=1, device="cpu",
                           chunk_iters=4, pipeline_stats=stats)
    groups = stats.ragged_groups
    assert len(groups) == 2 and all(g["live_ess_sum_final"] is not None for g in groups)
    assert stats.aggregate()["live_ess_sum_final"] == pytest.approx(
        sum(g["live_ess_sum_final"] for g in groups))
    s = summarize(res.run_log_path)
    assert s["n_orphan_spans"] == 0 and s["root_coverage"] >= 0.95
    spans = [r for r in read_jsonl(res.run_log_path) if r.get("kind") == "span"]
    assert sum(r["name"] == "bucket_group" for r in spans) == 2
    assert sum(r["name"] == "fit_subsets_ragged" for r in spans) == 1


# ---------------------------------------------------------------------
# the span recorder (utils/tracing.record_spans)
# ---------------------------------------------------------------------
# the benchmark's production sampler at tiny sizes: collapsed phi every 4
# sweeps, the Nystrom CG u-draw, the fused build's CPU version
PRODUCTION = dict(phi_sampler="collapsed", phi_update_every=4, u_solver="cg",
                  cg_precond="nystrom", cg_precond_rank=8, cg_iters=4, fused_build="pallas")


def _tiny_data(q: int, n: int = 64, t: int = 4, seed: int = 5):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    x = np.concatenate([np.ones((n, q, 1)), rng.normal(size=(n, q, 1))], -1).astype(np.float32)
    y = (rng.uniform(size=(n, q)) < 0.5).astype(np.float32)
    ct = rng.uniform(size=(t, 2)).astype(np.float32)
    xt = np.ones((t, q, 2), np.float32)
    return y, x, coords, ct, xt


def _tiny_fit(q: int = 1, **cfg_kw):
    cfg = SMKConfig(**dict(dict(n_subsets=2, n_samples=12, burn_in_frac=0.5), **cfg_kw))
    return fit_meta_kriging(*_tiny_data(q), config=cfg, seed=11, device="cpu")


def test_span_tree_of_a_fit():
    with tracing.record_spans() as rec:
        _tiny_fit(**PRODUCTION)
    spans = rec.spans
    by_id = {s["span_id"]: s for s in spans}
    parent = {s["span_id"]: by_id[s["parent"]]["name"] if s["parent"] is not None else None
              for s in spans}
    named = lambda n: [s for s in spans if s["name"] == n]  # noqa: E731
    (root,) = named("fit_meta_kriging")
    assert root["parent"] is None and root["attrs"] == {"n": 64, "K": 2, "rows": 2}
    assert sorted(s["name"] for s in spans if s["parent"] == root["span_id"]) == sorted(
        ["partition", "warm_start", "subset_fits", "combine", "resample_predict"])
    sweeps, noise = named("smk.sweep"), named("smk.noise")
    assert [s["attrs"]["it"] for s in sweeps] == list(range(12))
    assert [s["attrs"]["phi"] for s in sweeps] == [it % 4 == 0 for it in range(12)]
    assert [s["attrs"]["collect"] for s in sweeps] == [it >= 6 for it in range(12)]
    assert len(noise) == 12 and all(parent[s["span_id"]] == "subset_fits" for s in noise)
    # each sweep's noise is drawn just before it, a sibling under subset_fits
    for nz, sw in zip(noise, sweeps):
        assert nz["parent"] == sw["parent"] and nz["t1"] <= sw["t0"]
        assert nz["attrs"] == {"rows": 2}
    stage_names = {"smk.latent", "smk.beta", "smk.phi", "smk.u_draw", "smk.a", "smk.krige"}
    for sw in sweeps:
        kids = sorted((s for s in spans if s["parent"] == sw["span_id"]), key=lambda s: s["t0"])
        names = [s["name"] for s in kids]
        want = ["smk.latent", "smk.beta"] + (
            ["smk.u_draw", "smk.phi", "smk.u_draw"] if sw["attrs"]["phi"] else ["smk.u_draw"]
        ) + ["smk.a"] + (["smk.krige"] if sw["attrs"]["collect"] else [])
        assert names == want
        # the stages tile the sweep: each opens where the last closed,
        # the last closes with it
        assert kids[0]["t0"] >= sw["t0"] and kids[-1]["t1"] == sw["t1"]
        assert all(a["t1"] == b["t0"] for a, b in zip(kids, kids[1:]))
    for s in named("smk.factor") + named("smk.build"):
        assert parent[s["span_id"]] in stage_names | {"smk.cache", "smk.init", "warm_start",
                                                      "resample_predict"}
    assert all(parent[s["span_id"]] == "subset_fits" for s in named("smk.init"))
    m_factors = [s for s in named("smk.factor") if s["attrs"]["m"] == 32]
    assert m_factors and all(s["attrs"]["batch"] in (2,) for s in m_factors)


def _updates(n: int, every: int) -> int:
    return sum(1 for it in range(n) if it % every == 0)


@pytest.mark.parametrize("case", ["production_q2_logit_chains", "conditional_chol",
                                  "collapsed_chol_reuse"])
def test_factor_mm_counts_the_m_by_m_factorizations(case):
    """The counter sums the m x m factorizations over batch rows: the
    benchmark's count (harness/work.factorizations: R~ of each
    component at the start, then S_cur, S_prop and R~(phi') per update
    sweep and component) under the production sampler, and the other
    samplers' own counts."""
    n, rows = 12, 2
    if case == "production_q2_logit_chains":
        q, kw = 2, dict(PRODUCTION, link="logit", n_chains=2)
        rows, want_per = 4, 1 + 3 * _updates(n, 4)
    elif case == "conditional_chol":
        q, kw = 1, {}
        want_per = 1 + 2 * n  # R~(phi') and the u-draw's S each sweep
    else:
        q, kw = 1, dict(phi_sampler="collapsed", phi_update_every=4)
        u = _updates(n, 4)
        want_per = 1 + 3 * u + (n - u)  # the threaded S-factor between updates
    with tracing.record_spans() as rec:
        _tiny_fit(q, **kw)
    # every sweep's noise drawn row by row on the CPU (ops/sweep_noise)
    assert rec.counters == {"factor_mm": rows * q * want_per, "noise_rows_rowwise": rows * n}


def test_recording_off_records_nothing_and_reads_no_clock(monkeypatch):
    import itertools
    import tracemalloc

    def no_clock():
        raise AssertionError("a span site read the clock with nothing armed")

    monkeypatch.setattr(tracing, "monotonic_ns", no_clock)
    monkeypatch.setattr(tracing, "clock_anchor", no_clock)
    assert tracing._RECORDER is None
    res = _tiny_fit(**PRODUCTION)  # every span site of a fit, unarmed
    assert torch.isfinite(res.p_quant).all()
    site = lambda: tracing.span("smk.noise", rows=4)  # noqa: E731
    assert site() is site() is tracing.span("smk.sweep")  # one shared object
    for _ in range(10):  # warm the interpreter's caches
        with site():
            tracing.stage("smk.beta")
            tracing.count("factor_mm", 3)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 1000):  # no loop counter to allocate
            with site():
                tracing.stage("smk.beta")
                tracing.count("factor_mm", 3)
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after - before == 0


def test_the_draws_are_bitwise_with_recording_on_and_off(tmp_path):
    off = _tiny_fit(**PRODUCTION)
    with tracing.record_spans():
        on = _tiny_fit(**PRODUCTION)
    logged = _tiny_fit(**dict(PRODUCTION, run_log_dir=str(tmp_path)))
    for res in (on, logged):
        assert torch.equal(res.p_quant, off.p_quant)
        assert torch.equal(res.subset_results.param_grid, off.subset_results.param_grid)
        assert torch.equal(res.subset_results.w_grid, off.subset_results.w_grid)


def test_two_threads_keep_separate_stacks():
    """Two threads open nested spans at the same time: each span's
    parent is its own thread's; a thread started through
    under_current_span opens its first span under the starter's span,
    another thread at the top."""
    import threading

    barrier = threading.Barrier(2, timeout=30)

    def work(tag, wait=True):
        with tracing.span(f"outer.{tag}"):
            if wait:
                barrier.wait()  # both outer spans open at once
            with tracing.span(f"inner.{tag}"):
                tracing.stage(f"stage.{tag}")
                if wait:
                    barrier.wait()

    with tracing.record_spans() as rec:
        with tracing.span("main"):
            threads = [threading.Thread(target=tracing.under_current_span(
                lambda tag=tag: work(tag))) for tag in "ab"]
            threads.append(threading.Thread(target=lambda: work("c", wait=False)))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
    by_name = {s["name"]: s for s in rec.spans}
    by_id = {s["span_id"]: s for s in rec.spans}
    for tag in "abc":
        assert by_id[by_name[f"stage.{tag}"]["parent"]]["name"] == f"inner.{tag}"
        assert by_id[by_name[f"inner.{tag}"]["parent"]]["name"] == f"outer.{tag}"
    assert by_name["outer.a"]["parent"] == by_name["outer.b"]["parent"] == by_name["main"][
        "span_id"]
    assert by_name["outer.c"]["parent"] is None


def test_a_span_under_a_capture_records_nothing(monkeypatch):
    with tracing.record_spans() as rec:
        monkeypatch.setattr(tracing, "capturing", lambda: True)
        with tracing.span("captured") as sid:
            tracing.stage("smk.beta")
            tracing.count("factor_mm", 5)
        monkeypatch.undo()
        with tracing.span("replay"):
            pass
    assert sid is None
    assert [s["name"] for s in rec.spans] == ["replay"] and rec.counters == {}


def test_spans_land_on_a_cpu_profiler_trace(tmp_path):
    """The export's Unix-clock bounds lay a span onto the Chrome trace's
    user_annotation event of the same range (baseTimeNanoseconds + 1000
    ts), within 1 ms: the median over five ranges, so that one range
    the scheduler interrupts between its two stamps cannot decide."""
    import statistics

    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.record_spans() as rec:
            for i in range(5):
                with record_function(f"probe{i}"), tracing.span(f"probe{i}"):
                    for _ in range(10):
                        x = torch.tanh(x @ x)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = int(doc["baseTimeNanoseconds"])
    ann = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    errs = []
    for sp in rec.export():
        ev = ann[sp["name"]]
        start = base + 1000 * float(ev["ts"])
        errs += [abs(sp["t0"] - start), abs(sp["t1"] - (start + 1000 * float(ev["dur"])))]
    assert len(errs) == 10 and statistics.median(errs) < 1e6, errs
    assert tracing.to_unix_ns(rec.spans[0]["t0"], rec.anchor) == rec.export()[0]["t0"]


def test_run_log_gets_the_span_totals_and_the_factor_counter(tmp_path):
    res = _tiny_fit(**dict(PRODUCTION, run_log_dir=str(tmp_path)))
    recs = read_jsonl(res.run_log_path)
    totals = {r["name"]: r for r in recs if r.get("kind") == "span_total"}
    assert totals["smk.sweep"]["count"] == 12 and totals["smk.noise"]["count"] == 12
    assert totals["fit_meta_kriging"]["count"] == 1
    for t in totals.values():
        assert 0.0 <= t["self_s"] <= t["total_s"] + 1e-6
    assert recs[-1]["kind"] == "run_end"
    assert recs[-1]["counters"] == {"factor_mm": 2 * (1 + 3 * _updates(12, 4)),
                                    "noise_rows_rowwise": 2 * 12}
    s = summarize(res.run_log_path)
    assert {t["name"] for t in s["span_totals"]} == set(totals)
    assert s["n_orphan_spans"] == 0 and tracing._RECORDER is None


@pytest.mark.parametrize("path", ["smk_torch/utils/tracing.py", "smk_torch/models/probit_gp.py",
                                  "smk_torch/ops/chol.py", "smk_torch/ops/fused_build.py",
                                  "smk_torch/parallel/executor.py", "smk_torch/api.py",
                                  "smk_torch/compile/programs.py", "smk_torch/obs/events.py"])
def test_span_sites_lint_clean(path):
    from smk_torch.analysis import lint_paths

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint_paths([os.path.join(repo, path)], repo_root=repo)
    assert findings == [], "\n".join(f.render() for f in findings)
