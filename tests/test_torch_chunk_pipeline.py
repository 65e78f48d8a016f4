"""The port's overlap pipeline, background writer, lenient resume and chunk
watchdog (smk_torch/parallel/recovery.py, utils/checkpoint.BackgroundWriter,
parallel/domains.ChunkWatchdog, testing/faults.py) against the JAX
package's.

The JAX chunked fits run once each in a module fixture, on one model per
pipeline (K = 4 subsets of m = 24, q = 1, p = 2, t = 5, 24 sweeps with 12
burn-in, phi every 2nd sweep, fault_policy="quarantine", chunks of 4: three
burn-in and three sampling chunks), the port replaying the JAX keys
(tests/test_torch_recovery.ChunkedJaxReplay). The port's draws agree with
the twin's at the sweep tolerance (5e-5 absolute + 5e-5 relative), NaN
where the twin's are NaN, and its fault ledgers equal the twin's; the port
against itself (overlap against sync, resumes, the armed watchdog) is held
bitwise.
"""

# smklint: test-budget=two JAX chunked model compiles (sync and overlap, ~30 s together) and ten warm JAX fits in a module fixture; every test runs the port at m=24 in well under a second a fit
import contextlib
import os
import shutil
import threading
import time
import warnings
import zipfile

import numpy as np
import pytest
import torch

from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.parallel import domains as jdom
from smk_tpu.parallel import recovery as jrec
from smk_tpu.testing import faults as jfaults
from smk_tpu.utils.tracing import ChunkPipelineStats as JaxStats
from smk_torch import SMKConfig, convert
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import domains as dom
from smk_torch.parallel import recovery as rec
from smk_torch.testing import faults as tfaults
from smk_torch.utils import checkpoint as ckpt
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_recovery import _problem as recovery_problem
from test_torch_recovery import replay

K, T = 4, 5
CHUNK = 4
CFG = dict(n_subsets=K, n_samples=24, burn_in_frac=0.5, phi_update_every=2,
           fault_policy="quarantine")
TOL = dict(atol=5e-5, rtol=5e-5)
FIELDS = ("param_samples", "w_samples", "param_grid", "phi_accept_rate")
# the draws of a lenient refill: segment 1 covers kept draws [4, 8)
HOLE = (4, 8)


@pytest.fixture(scope="module")
def problem():
    """tests/test_torch_recovery.py's problem: n = 96, m = 24, t = 5."""
    jp, ct, xt, key = recovery_problem()
    return {"jpart": jp, "ct": ct, "xt": xt, "key": key,
            "part": convert.partition_from_numpy(jp),
            "ct_t": torch.as_tensor(np.array(ct)), "xt_t": torch.as_tensor(np.array(xt))}


def port_fit(problem, mode="sync", *, faults=(), cfg_kw=None, part=None, **kw):
    """The port's chunked fit in ``mode`` with the replayed JAX keys,
    under the fault contexts ``faults`` (callables of the faults module);
    returns (result, stats)."""
    cfg = SMKConfig(**dict(CFG, chunk_pipeline=mode, **(cfg_kw or {})))
    stats = ChunkPipelineStats()
    part = problem["part"] if part is None else part
    noise = replay(problem["key"], cfg, K, part.subset_size, t=T)
    with contextlib.ExitStack() as stack:
        for f in faults:
            stack.enter_context(f(tfaults))
        res = rec.fit_subsets_chunked(
            tp.SpatialGPSampler(cfg), part, problem["ct_t"], problem["xt_t"], noise,
            chunk_iters=CHUNK, pipeline_stats=stats, **kw)
    return res, stats


def twin_fit(models, problem, mode="sync", *, faults=(), **kw):
    stats = JaxStats()
    with contextlib.ExitStack() as stack:
        for f in faults:
            stack.enter_context(f(jfaults))
        res = jrec.fit_subsets_chunked(
            models[mode], problem["jpart"], problem["ct"], problem["xt"], problem["key"],
            chunk_iters=CHUNK, pipeline_stats=stats, **kw)
    return res, stats


def _copy_ckpt(src, dst_dir):
    """A copy of a finished checkpoint (manifest and its three segments)."""
    os.makedirs(dst_dir)
    dst = os.path.join(dst_dir, "g.npz")
    shutil.copy(src, dst)
    for i in range(3):
        shutil.copy(ckpt.segment_path(src, i), ckpt.segment_path(dst, i))
    return dst


def _retry(m):
    return m.inject_subset_nan(2, 14, max_fires=1)


def _dead_domain(m):
    return m.dead_domain([0, 1], 14)


# (pipeline, fault contexts, failure domains) of the runs both packages make
SCENARIOS = {
    "overlap_clean": ("overlap", (), None),
    "overlap_retry": ("overlap", (_retry,), None),
    "overlap_dead_domain": ("overlap", (_dead_domain,), 2),
}


@pytest.fixture(scope="module")
def twin(problem, tmp_path_factory):
    """The twin's runs: the SCENARIOS, and a golden sync checkpoint
    resumed leniently after each kind of damage to segment 1."""
    models = {mode: JaxSampler(JaxConfig(**dict(CFG, chunk_pipeline=mode)))
              for mode in ("sync", "overlap")}
    out = {}
    root = tmp_path_factory.mktemp("twin")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for name, (mode, faults, n_dom) in SCENARIOS.items():
            dmap = None if n_dom is None else jdom.FailureDomainMap.from_n_domains(K, n_dom)
            path = str(root / f"{name}.npz") if name == "overlap_clean" else None
            out[name] = twin_fit(models, problem, mode, faults=faults, domain_map=dmap,
                                 checkpoint_path=path)
        golden = str(root / "golden.npz")
        out["golden"] = twin_fit(models, problem, checkpoint_path=golden)
        for damage in ("bitflip", "truncate"):
            path = _copy_ckpt(golden, str(root / damage))
            jfaults.corrupt_segment(path, 1, damage)
            out[f"refill_{damage}"] = twin_fit(models, problem, checkpoint_path=path)
    return out


@pytest.fixture(scope="module")
def port_golden(problem, tmp_path_factory):
    """The port's sync run with a checkpoint at every boundary."""
    path = str(tmp_path_factory.mktemp("port") / "golden.npz")
    res, stats = port_fit(problem, checkpoint_path=path)
    return res, stats, path


def _bitwise(a, b):
    """Two results equal bit for bit (NaN where the other is NaN)."""
    return all(np.array_equal(x.numpy(), y.numpy(), equal_nan=True) for x, y in zip(a, b))


def _assert_matches_twin(got, want):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   equal_nan=True, err_msg=f, **TOL)


# ----------------------------------------------------------------------
# overlap against sync and against the twin
# ----------------------------------------------------------------------
def test_overlap_is_bitwise_sync_and_matches_the_twins_overlap(problem, twin, port_golden,
                                                               tmp_path):
    sync_res, _, _ = port_golden
    res, stats = port_fit(problem, "overlap", checkpoint_path=str(tmp_path / "ov.npz"))
    assert _bitwise(res, sync_res)
    _assert_matches_twin(res, twin["overlap_clean"][0])
    agg, want = stats.aggregate(), twin["overlap_clean"][1].aggregate()
    assert agg["mode"] == want["mode"] == "overlap"
    # six chunks and the terminal drain, as the twin records them
    assert agg["n_chunks"] == want["n_chunks"] == 7
    assert [c["phase"] for c in stats.chunks] == ["burn"] * 3 + ["sample"] * 3 + ["drain"]
    assert len(agg["ckpt_boundary_bytes"]) == len(want["ckpt_boundary_bytes"]) == 6
    assert 0.0 < agg["overlap_efficiency"] <= 1.0
    assert stats.host_staging_bytes > 0


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_overlap_fault_ledger_and_draws_match_twin(problem, twin, scenario):
    mode, faults, n_dom = SCENARIOS[scenario]
    dmap = None if n_dom is None else dom.FailureDomainMap.from_n_domains(K, n_dom)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        res, stats = port_fit(problem, mode, faults=faults, domain_map=dmap)
        sync_res, sync_stats = port_fit(problem, "sync", faults=faults, domain_map=dmap)
    want_res, want_stats = twin[scenario]
    assert stats.fault_events == want_stats.fault_events
    assert stats.fault_summary() == want_stats.fault_summary()
    _assert_matches_twin(res, want_res)
    # the rewind discards the successor in flight: bitwise the sync run
    assert stats.fault_events == sync_stats.fault_events
    assert _bitwise(res, sync_res)


def test_overlap_dead_domain_runs_the_domain_ladder(twin):
    summary = twin["overlap_dead_domain"][1].fault_summary()
    assert summary["domains_dropped"] == [0] and summary["subsets_dropped"] == [0, 1]


@pytest.mark.parametrize("first, then", [("overlap", "sync"), ("sync", "overlap")])
def test_a_resume_works_in_either_pipeline(problem, port_golden, tmp_path, first, then):
    """The pipeline is not part of the run identity: a run killed in one
    resumes in the other, bitwise the uninterrupted run."""
    path = str(tmp_path / "x.npz")
    assert port_fit(problem, first, checkpoint_path=path, stop_after_chunks=4)[0] is None
    res, _ = port_fit(problem, then, checkpoint_path=path)
    assert _bitwise(res, port_golden[0])


def test_overlap_guard_raises_before_any_save(problem, tmp_path):
    """nan_guard under overlap raises at the bad boundary before any save
    of it: a run non-finite from chunk one (a NaN coordinate in subset 1,
    the twin's case) leaves no checkpoint."""
    part = problem["part"]
    coords = part.coords.clone()
    coords[1, 0, 0] = float("nan")
    path = str(tmp_path / "g.npz")
    with pytest.raises(rec.SubsetNaNError) as ei:
        port_fit(problem, "overlap", cfg_kw=dict(fault_policy="abort"),
                 part=part._replace(coords=coords), checkpoint_path=path, nan_guard=True)
    assert ei.value.subset_ids == [1] and ei.value.iteration == CHUNK
    assert not os.path.exists(path)


# ----------------------------------------------------------------------
# lenient resume
# ----------------------------------------------------------------------
@pytest.mark.parametrize("damage", ["bitflip", "truncate"])
def test_lenient_refill_matches_the_twins_refill(problem, twin, port_golden, tmp_path,
                                                damage):
    """A damaged segment under quarantine becomes a hole, re-sampled by
    extending the chain: the draws equal the twin's refill, the rows
    outside the hole are the golden run's bitwise, and the closing
    rewrite leaves one clean segment (a second resume is silent and
    returns the same draws)."""
    golden, _, src = port_golden
    path = _copy_ckpt(src, str(tmp_path / damage))
    tfaults.corrupt_segment(path, 1, damage)
    with pytest.warns(RuntimeWarning, match="re-sampled"):
        res, stats = port_fit(problem, checkpoint_path=path)
    want_res, want_stats = twin[f"refill_{damage}"]
    _assert_matches_twin(res, want_res)
    assert stats.fault_events == want_stats.fault_events == []
    a, b = HOLE
    got = res.param_samples
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :a], golden.param_samples[:, :a])
    assert torch.equal(got[:, b:], golden.param_samples[:, b:])
    assert not torch.equal(got[:, a:b], golden.param_samples[:, a:b])
    assert [c["phase"] for c in stats.chunks] == ["fill"]
    assert sorted(f for f in os.listdir(os.path.dirname(path)) if ".seg" in f) == [
        os.path.basename(ckpt.segment_path(path, 3))]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again, _ = port_fit(problem, "overlap", checkpoint_path=path)
    assert _bitwise(res, again)


def test_lenient_resume_holes_a_missing_and_an_overlapping_segment(problem, port_golden,
                                                                  tmp_path):
    golden, _, src = port_golden
    path = _copy_ckpt(src, str(tmp_path / "gone"))
    os.remove(ckpt.segment_path(path, 2))
    seg = ckpt.load_segment(path, 0)
    ckpt.save_segment(path, 1, seg["param"], seg["w"], 0, 4)  # overlaps segment 0
    with pytest.warns(RuntimeWarning, match="re-sampled"):
        res, stats = port_fit(problem, checkpoint_path=path)
    assert [c["iteration"] for c in stats.chunks] == [28, 32]  # two holes, two fills
    assert torch.isfinite(res.param_samples).all()
    assert torch.equal(res.param_samples[:, :4], golden.param_samples[:, :4])


def test_truncated_segment_fails_structurally_and_abort_stays_loud(problem, port_golden,
                                                                  tmp_path):
    path = _copy_ckpt(port_golden[2], str(tmp_path / "t"))
    tfaults.corrupt_segment(path, 2, "truncate")
    with pytest.raises((zipfile.BadZipFile, OSError, ValueError)):
        ckpt.load_segment(path, 2)
    with pytest.raises(ValueError, match="corrupt draw segment"):
        port_fit(problem, cfg_kw=dict(fault_policy="abort"), checkpoint_path=path)


# ----------------------------------------------------------------------
# the background writer and its degrade path
# ----------------------------------------------------------------------
def test_background_writer_orders_and_surfaces_errors():
    done = []
    w = ckpt.BackgroundWriter()
    assert w.submit(lambda: done.append(1)) == 1
    assert w.submit(lambda: done.append(2)) == 2
    w.flush()
    assert done == [1, 2]
    # a failing job records its error and every later job is skipped
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    seq = w.submit(lambda: done.append(3))
    w.wait_done(seq)
    assert isinstance(w.error, OSError) and done == [1, 2]
    with pytest.warns(RuntimeWarning, match="ended before any"):
        w.close()
    w.close()  # idempotent, and warns once
    with pytest.raises(RuntimeError):
        w.submit(lambda: None)


def test_unacknowledged_writer_error_warns_at_close():
    w = ckpt.BackgroundWriter()
    w.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    w.flush()
    with pytest.warns(RuntimeWarning, match="ended before any"):
        w.close()
    w2 = ckpt.BackgroundWriter()
    w2.submit(lambda: (_ for _ in ()).throw(OSError("x")))
    w2.flush()
    w2.acknowledge_error()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        w2.close()


def test_degraded_writer_falls_back_to_sync_writes(tmp_path):
    """The twin's unit case: a failed background write is warned about at
    the next boundary, which rewrites one merged segment at a fresh index
    inline and unlinks the superseded one."""
    path = str(tmp_path / "d.npz")
    state = rec._host_state(tp.SamplerState(*(torch.zeros(3) for _ in range(7))))
    noise = np.zeros((2, 4), np.uint8)
    draws = (np.ones((2, 8, 3), np.float32), np.ones((2, 8, 2), np.float32))
    writer = ckpt.BackgroundWriter()
    ck = rec._SegmentedCheckpoint(
        path, np.zeros(6, np.int64), np.zeros(4, np.uint32), writer=writer,
        full_draws=lambda filled: (draws[0][:, :filled], draws[1][:, :filled]),
        fault_src=lambda: (np.zeros(2, np.int64),) * 3 + (np.zeros(1, np.int64),) * 2)
    assert "ckpt_job" in ck.save(state, noise, (draws[0][:, :4], draws[1][:, :4], 0, 4), 4, 4)
    writer.flush()
    assert os.path.exists(path)
    writer.submit(lambda: (_ for _ in ()).throw(OSError("disk full")))
    writer.flush()
    with pytest.warns(RuntimeWarning, match="degrading"):
        entry = ck.save(state, noise, (draws[0][:, 4:6], draws[1][:, 4:6], 4, 6), 6, 6)
    assert ck.degraded and entry["ckpt_bytes"] > 0
    assert (ck.seg_base, ck.n_segments) == (1, 1)
    seg = ckpt.load_segment(path, ck.seg_base)
    assert (seg["start"], seg["stop"]) == (0, 6)
    assert not os.path.exists(ckpt.segment_path(path, 0))
    writer.close()


def test_final_chunk_writer_failure_surfaces_and_recovers(problem, twin, tmp_path):
    """The last boundary's job fails (six boundaries: job 6): the drain
    warns and rewrites a full checkpoint, whose resume returns the run."""
    path = str(tmp_path / "w.npz")
    with pytest.warns(RuntimeWarning, match="background checkpoint writer"):
        res, _ = port_fit(problem, "overlap", checkpoint_path=path,
                          faults=(lambda m: m.fail_writer_job(6),))
    _assert_matches_twin(res, twin["overlap_clean"][0])
    again, _ = port_fit(problem, "overlap", checkpoint_path=path)
    assert _bitwise(res, again)


def test_mid_run_writer_failure_degrades_and_stays_consistent(problem, port_golden, tmp_path):
    path = str(tmp_path / "m.npz")
    with pytest.warns(RuntimeWarning, match="degrading"):
        res, _ = port_fit(problem, "overlap", checkpoint_path=path, stop_after_chunks=5,
                          faults=(lambda m: m.fail_writer_job(4),))
    assert res is None
    resumed, _ = port_fit(problem, "sync", checkpoint_path=path)
    assert _bitwise(resumed, port_golden[0])


def test_manifest_kill_resumes_bitwise(problem, twin, port_golden, tmp_path):
    """A kill between a segment landing and its manifest (the crash
    window) leaves the previous consistent view; the resume completes."""
    path = str(tmp_path / "k.npz")
    with pytest.raises(tfaults.SimulatedKill):
        port_fit(problem, checkpoint_path=path, faults=(lambda m: m.kill_at_manifest(5),))
    res, _ = port_fit(problem, checkpoint_path=path)
    assert _bitwise(res, port_golden[0])
    _assert_matches_twin(res, twin["golden"][0])


# ----------------------------------------------------------------------
# the staging buffers
# ----------------------------------------------------------------------
def test_staging_slot_waits_for_the_job_that_reads_it():
    writer = ckpt.BackgroundWriter()
    staging = rec._HostStaging(2, writer)
    release = threading.Event()
    slot0, views0, _ = staging.take([torch.full((8,), 1.0)], 0)
    staging.claim(slot0, writer.submit(lambda: release.wait(timeout=30.0)))
    slot1, _, waited = staging.take([torch.full((8,), 2.0)], 0)
    assert slot1 != slot0 and waited < 1.0
    staging.claim(slot1, writer.submit(lambda: None))
    took = {}
    thread = threading.Thread(target=lambda: took.update(
        out=staging.take([torch.full((8,), 3.0)], 0)))
    thread.start()
    time.sleep(0.3)
    assert thread.is_alive()  # slot 0 is still read by its job
    np.testing.assert_array_equal(views0[0], np.ones(8, np.float32))
    release.set()
    thread.join(timeout=30.0)
    slot2, views2, waited2 = took["out"]
    assert slot2 == slot0 and waited2 > 0
    np.testing.assert_array_equal(views2[0], np.full(8, 3.0, np.float32))
    writer.close()


def test_slow_writes_never_see_a_later_boundary(problem, port_golden, tmp_path,
                                                monkeypatch):
    """The first boundary's write blocks until the host loop, two chunks
    on, has to wait for its buffer: the loop waits (staging_wait_s), and
    every manifest holds its own boundary's state, the one the sync run
    wrote."""
    gate = threading.Event()
    real_wait = ckpt.BackgroundWriter.wait_done
    real_manifest = rec._SegmentedCheckpoint._write_manifest
    seen = {}

    def waiting(self, seq):
        gate.set()
        return real_wait(self, seq)

    def blocked(self, state_np, noise_np, it, fault=None):
        if self.writer is not None and it == CHUNK:
            assert gate.wait(timeout=60.0)
        seen.setdefault(self.path, {})[it] = [np.array(a) for a in state_np.arrays]
        return real_manifest(self, state_np, noise_np, it, fault)

    monkeypatch.setattr(ckpt.BackgroundWriter, "wait_done", waiting)
    monkeypatch.setattr(rec._SegmentedCheckpoint, "_write_manifest", blocked)
    sync_path, ov_path = str(tmp_path / "s.npz"), str(tmp_path / "o.npz")
    port_fit(problem, "sync", checkpoint_path=sync_path)
    res, stats = port_fit(problem, "overlap", checkpoint_path=ov_path)
    assert gate.is_set() and sum(c.get("staging_wait_s", 0.0) for c in stats.chunks) > 0
    assert sorted(seen[ov_path]) == sorted(seen[sync_path]) == [4, 8, 12, 16, 20, 24]
    for it, leaves in seen[sync_path].items():
        for a, b in zip(leaves, seen[ov_path][it]):
            np.testing.assert_array_equal(a, b)
    assert _bitwise(res, port_golden[0])


# ----------------------------------------------------------------------
# the watchdog
# ----------------------------------------------------------------------
WALLS = {"rising": (0.5, 2.0, 1.0), "flat": (0.01,), "spike_rolls_out": (100.0,) + (1.0,) * 32,
         "many": tuple(0.1 * i for i in range(40))}


@pytest.mark.parametrize("walls", sorted(WALLS))
@pytest.mark.parametrize("floor, margin", [(0.001, 3.0), (10.0, 2.0), (1.0, 10.0)])
def test_watchdog_deadline_arithmetic_matches_twin(walls, floor, margin):
    dmap, jmap = dom.FailureDomainMap.single_host(4), jdom.FailureDomainMap.single_host(4)
    mine = dom.ChunkWatchdog(dmap, min_deadline_s=floor, margin=margin)
    theirs = jdom.ChunkWatchdog(jmap, min_deadline_s=floor, margin=margin)
    assert mine.deadline_s is theirs.deadline_s is None
    for w in WALLS[walls]:
        mine.observe(w)
        theirs.observe(w)
        assert mine.estimate_s == theirs.estimate_s
        assert mine.deadline_s == pytest.approx(theirs.deadline_s)


def test_watchdog_rejects_and_runs_like_twin():
    for cls, dmap in ((dom.ChunkWatchdog, dom.FailureDomainMap.single_host(4)),
                      (jdom.ChunkWatchdog, jdom.FailureDomainMap.single_host(4))):
        with pytest.raises(ValueError, match="margin"):
            cls(dmap, margin=0.5)
        with pytest.raises(ValueError, match="min_deadline_s"):
            cls(dmap, min_deadline_s=0.0)
    wd = dom.ChunkWatchdog(dom.FailureDomainMap.single_host(4), min_deadline_s=5.0,
                           margin=1.0)
    assert wd.run(lambda: 42) == 42 and wd.deadline_s == 5.0  # observed inline
    with pytest.raises(KeyError, match="inner"):
        wd.run(lambda: {}["inner"])
    ev = threading.Event()
    try:
        with pytest.raises(dom.ChunkTimeoutError) as exc:
            wd.run(lambda: ev.wait(timeout=30.0), chunk=7, iteration=42, deadline_s=0.05)
    finally:
        ev.set()
    assert (exc.value.chunk, exc.value.iteration, exc.value.domains) == (7, 42, [0])
    assert exc.value.domain_labels == ["process:0"] and wd.fired == 1


def test_armed_watchdog_is_bitwise_the_unwatched_run(problem, port_golden, twin):
    res, _ = port_fit(problem, "overlap", cfg_kw=dict(watchdog=True,
                                                      watchdog_min_deadline_s=30.0),
                      domain_map=dom.FailureDomainMap.from_n_domains(K, 2))
    assert _bitwise(res, port_golden[0])
    _assert_matches_twin(res, twin["overlap_clean"][0])


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_stalled_chunk_becomes_a_typed_timeout(problem, mode):
    """The twin's case: the stall lands on the second (samp, 4) chunk
    (the first dispatch of each kind and length runs unguarded), and the
    deadline turns it into ChunkTimeoutError naming the domains."""
    start = time.perf_counter()
    with tfaults.stall_chunk(18, max_stall_s=60.0) as inj:
        with pytest.raises(dom.ChunkTimeoutError) as exc:
            port_fit(problem, mode, cfg_kw=dict(watchdog=True, watchdog_min_deadline_s=2.0,
                                                watchdog_margin=4.0),
                     domain_map=dom.FailureDomainMap.from_n_domains(K, 2))
    assert inj.fires == 1 and time.perf_counter() - start < 30.0
    assert exc.value.domains == [0, 1]
    assert exc.value.domain_labels == ["domain:0", "domain:1"]
    assert exc.value.chunk == 4 and exc.value.iteration == 20


# ----------------------------------------------------------------------
# injector scoping
# ----------------------------------------------------------------------
def test_injectors_are_armed_only_inside_their_context():
    seam = rec._run_chunk
    submit = ckpt.BackgroundWriter.submit
    manifest = rec._SegmentedCheckpoint._write_manifest
    done = []
    with tfaults.fail_writer_job(1):
        w = ckpt.BackgroundWriter()
        w.submit(lambda: done.append(1))
        w.flush()
        assert isinstance(w.error, tfaults.ChaosError)
        w.acknowledge_error()
        w.close()
    w2 = ckpt.BackgroundWriter()
    w2.submit(lambda: done.append(2))
    w2.close()
    assert done == [2]
    with tfaults.stall_chunk(3) as inj, tfaults.dead_domain([0, 1], 5) as injs:
        assert rec._run_chunk is not seam and len(injs) == 2
    assert inj.release.is_set() and rec._run_chunk is seam
    with tfaults.kill_at_manifest(1):
        assert rec._SegmentedCheckpoint._write_manifest is not manifest
    assert ckpt.BackgroundWriter.submit is submit
    assert rec._SegmentedCheckpoint._write_manifest is manifest
