"""The distributed checkpoint of the port (smk_torch/parallel/checkpoint.py,
format 8), its executor wiring (parallel/recovery.py), its injectors
(testing/faults.kill_process_at_generation, torn_shard, resplit_shards),
``FailureDomainMap.from_shard_rows`` and the ``ckpt_commit`` telemetry.

Held against the JAX package on the same inputs, exactly:
``identity_config_repr`` (the same bytes over several configs),
``leaf_identity_sums`` (the same integers for float32, float64, int64,
int32, bool, uint8, float16, 0-d and empty leaves, the 8-byte ones under
``jax.enable_x64``, and composing across row splits), the shard file names, ``from_shard_rows`` (domains, labels and
the rejections), ``checkpoint_supported`` and the ``ckpt_commit`` block
of ``summarize`` on one run log.

In one process under ``FORCE_DISTRIBUTED_FOR_TESTING`` (the one-shard
layout; barriers on no process group), at the twin's small problem (K =
4, 64 rows, 24 sweeps of which 12 burn-in, chunks of 4: three burn-in and
three sampling generations), the port against its own uncheckpointed
run, bitwise: a multi-generation commit, a kill between shard-land and
manifest-publish rolled back, torn-generation orphans found and
overwritten, a resume that finds format 8 without the hook, a wrong
noise seed rejected by the identity, a torn segment refilled leniently
and a second resume clean, a torn state shard's typed error naming its
owner, the strict reader, elastic resumes from a checkpoint re-split as
two processes' shards (with and without holes, the re-based chain, a
torn shard's owner), a writer failure's typed abort on a multi-process
layout, the overlap pipeline, the adaptive refusal, and single-process
runs still writing format 7. The identity's fold is the same for one
process over all rows and two processes over their own (the all-gather
stood in for in-process).
"""

# smklint: test-budget=port-only fits at K=4, m=16, 24 sweeps (~0.3 s each, ~30 of them); the twin's leaf sums, config reprs and one summarize, no twin fit
import contextlib
import dataclasses
import glob
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.obs import summarize as jsummarize
from smk_tpu.parallel import checkpoint as jdck
from smk_tpu.parallel.domains import FailureDomainMap as JaxDomainMap
from smk_torch.config import SMKConfig
from smk_torch.models.probit_gp import SpatialGPSampler
from smk_torch.obs.events import RunLog
from smk_torch.obs.summarize import summarize
from smk_torch.parallel import checkpoint as dck
from smk_torch.parallel import recovery as rec
from smk_torch.parallel.checkpoint import (
    CkptCommitError,
    DistributedCheckpoint,
    LocalShardSnapshot,
    ShardLayout,
    distributed_run_identity,
    fetch_global,
    identity_config_repr,
    is_distributed_manifest,
    leaf_identity_sums,
    local_tree_nbytes,
    local_tree_np,
    shard_segment_prefix,
    shard_state_path,
)
from smk_torch.parallel.domains import FailureDomainMap
from smk_torch.parallel.executor import stacked_subset_data
from smk_torch.parallel.partition import random_partition
from smk_torch.testing.faults import (
    SimulatedKill,
    kill_process_at_generation,
    resplit_shards,
    torn_shard,
)
from smk_torch.utils.checkpoint import BackgroundWriter, load_pytree, save_segment, segment_path
from smk_torch.utils.tracing import ChunkPipelineStats

K, N_SAMPLES, CHUNK = 4, 24, 4


@pytest.fixture(scope="module")
def prob():
    """The twin's problem (numpy seed 7: n = 64, q = 1, p = 2, t = 3),
    one quarantine model, and the uncheckpointed reference run."""
    rng = np.random.default_rng(7)
    n, q, p, t = 64, 1, 2, 3
    coords = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(n, q, p)), dtype=torch.float32)
    y = torch.as_tensor(rng.integers(0, 2, size=(n, q)), dtype=torch.float32)
    ct = torch.as_tensor(rng.uniform(size=(t, 2)), dtype=torch.float32)
    xt = torch.as_tensor(rng.normal(size=(t, q, p)), dtype=torch.float32)
    part = random_partition(torch.randperm(n, generator=torch.Generator().manual_seed(0)),
                            y, x, coords, K)
    cfg = SMKConfig(n_subsets=K, n_samples=N_SAMPLES, burn_in_frac=0.5, phi_update_every=2,
                    fault_policy="quarantine")
    model = SpatialGPSampler(cfg)
    prob = dict(model=model, part=part, ct=ct, xt=xt, cfg=cfg)
    ref = run(prob)
    return dict(prob, ref_param=ref.param_samples, ref_w=ref.w_samples)


@pytest.fixture
def force_v8():
    dck.FORCE_DISTRIBUTED_FOR_TESTING = True
    try:
        yield
    finally:
        dck.FORCE_DISTRIBUTED_FOR_TESTING = False


def run(prob, path=None, stop=None, pstats=None, seed=0, model=None):
    m = prob["model"] if model is None else model
    data = stacked_subset_data(prob["part"], prob["ct"], prob["xt"])
    return rec.fit_subsets_chunked(m, prob["part"], prob["ct"], prob["xt"],
                                   m.default_noise(data, seed), chunk_iters=CHUNK,
                                   checkpoint_path=path, stop_after_chunks=stop,
                                   pipeline_stats=pstats)


def bitwise(prob, res, upto=None):
    got, want = res.param_samples, prob["ref_param"]
    if upto is not None:
        got, want = got[:, :upto], want[:, :upto]
    return torch.equal(got, want) and (upto is not None or torch.equal(res.w_samples,
                                                                       prob["ref_w"]))


def caught_messages(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in caught]


def manifest(path):
    return load_pytree(path, dck._manifest_like())


# -- held against the twin ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, dict(n_subsets=8, cov_model="matern32", phi_sampler="collapsed"),
    dict(n_chains=2, link="logit", chunk_pipeline="overlap", watchdog=True),
    dict(adaptive_schedule="on", live_diagnostics=True, ckpt_commit_timeout_s=5.0),
    dict(fault_policy="quarantine", partition_method="coherent", dtype="float64"),
])
def test_identity_config_repr_is_the_twins(kw):
    assert identity_config_repr(SMKConfig(**kw)) == jdck.identity_config_repr(JaxConfig(**kw))
    assert rec.identity_config_repr is identity_config_repr


def test_identity_config_repr_normalizes_resume_legal_knobs():
    base = identity_config_repr(SMKConfig())
    assert identity_config_repr(SMKConfig(ckpt_commit_timeout_s=5.0, watchdog=True,
                                          chunk_pipeline="overlap")) == base
    assert identity_config_repr(SMKConfig(cov_model="matern32")) != base


LEAVES = {
    "float32": np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32),
    "float64": np.random.default_rng(2).normal(size=(4, 3)),
    "int64": np.arange(-7, 17, dtype=np.int64).reshape(6, 4) * 123456789,
    "int32": np.arange(-5, 13, dtype=np.int32).reshape(6, 3),
    "bool": np.random.default_rng(3).integers(0, 2, size=(6, 2)).astype(bool),
    "uint8": np.arange(240, 252, dtype=np.uint8).reshape(6, 2),
    "float16": np.random.default_rng(4).normal(size=(6, 2)).astype(np.float16),
    "0-d": np.float32(3.25),
    "empty": np.zeros((0, 3), np.float32),
}


@pytest.mark.parametrize("name", sorted(LEAVES))
@pytest.mark.parametrize("offset", [0, 7, 2 ** 32 - 3])
def test_leaf_identity_sums_are_the_twins(name, offset):
    arr = LEAVES[name]
    # the twin holds an 8-byte array as such only under jax_enable_x64
    wide = np.asarray(arr).dtype.itemsize == 8
    with jax.enable_x64(True) if wide else contextlib.nullcontext():
        want = np.asarray(jdck.leaf_identity_sums(jnp.asarray(arr), offset))
    got = leaf_identity_sums(arr, offset)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    if np.ndim(arr):
        assert np.array_equal(leaf_identity_sums(torch.as_tensor(arr), offset), want)


@pytest.mark.parametrize("name", ["float32", "float64", "int64", "bool"])
def test_leaf_identity_sums_compose_across_row_splits(name):
    arr = LEAVES[name]
    row = int(np.prod(arr.shape[1:]))
    whole = leaf_identity_sums(arr).astype(np.uint64)
    for cuts in ((2, 4), (1, 5), (3,)):
        edges = (0,) + cuts + (arr.shape[0],)
        parts = sum(leaf_identity_sums(arr[a:b], a * row).astype(np.uint64)
                    for a, b in zip(edges[:-1], edges[1:]))
        assert np.array_equal(whole, parts % (2 ** 32))


@pytest.mark.parametrize("path,pid,gen", [("/tmp/a.npz", 0, 1), ("ck", 7, 12345),
                                          ("x/y.ckpt", 123, 99999)])
def test_shard_names_are_the_twins(path, pid, gen):
    assert shard_state_path(path, pid, gen) == jdck.shard_state_path(path, pid, gen)
    assert shard_segment_prefix(path, pid) == jdck.shard_segment_prefix(path, pid)


@pytest.mark.parametrize("rows", [[[0, 2], [2, 4]], [[0, 4]], [[0, 1], [1, 5], [5, 8]],
                                  [[1, 2], [2, 4]], [[0, 2], [3, 4]], [[0, 2], [2, 2]], []])
def test_from_shard_rows_is_the_twins(rows):
    try:
        want = JaxDomainMap.from_shard_rows(rows)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            FailureDomainMap.from_shard_rows(rows)
        assert str(got.value) == str(e)
        return
    got = FailureDomainMap.from_shard_rows(rows)
    assert (got.domain_of_subset, got.labels) == (want.domain_of_subset, want.labels)


def test_checkpoint_supported_and_the_trivial_layout():
    assert dck.checkpoint_supported(None) == jdck.checkpoint_supported(None)
    lay = ShardLayout.current(K, None)
    assert (lay.row_ranges, lay.rows, lay.is_leader, lay.n_processes) == (((0, K),), (0, K),
                                                                           True, 1)


def test_local_tree_helpers_and_fetch_global_on_one_shard():
    tree = {"a": torch.arange(12.0).reshape(4, 3), "b": (np.ones((4, 2), np.int64),)}
    snap = LocalShardSnapshot(tree)
    got, want = snap.get(), local_tree_np(tree)
    assert snap.nbytes == local_tree_nbytes(tree) == 12 * 4 + 8 * 8
    assert np.array_equal(got["a"], want["a"]) and np.array_equal(got["b"][0], want["b"][0])
    lay = ShardLayout.current(4, None)
    assert np.array_equal(fetch_global(tree["a"], lay), tree["a"].numpy())


def test_identity_fold_does_not_depend_on_the_topology(prob, monkeypatch):
    """One process over all K rows, and two processes over their own
    (process 1's all-gathered payload handed to process 0), give the same
    vector; a flipped y or another noise seed changes it."""
    model, part, ct, xt, cfg = (prob[k] for k in ("model", "part", "ct", "xt", "cfg"))
    data = stacked_subset_data(part, ct, xt)
    beta = torch.zeros(1, 2)
    one = distributed_run_identity(cfg, model.default_noise(data), data, beta,
                                   ShardLayout.current(K, None))
    assert np.array_equal(one, distributed_run_identity(
        cfg, model.default_noise(data), data, beta, ShardLayout.current(K, None)))
    ranges = ((0, 1), (1, K))
    payloads = {}

    def local(pid):
        a, b = ranges[pid]
        sub = data._replace(coords=data.coords[a:b], x=data.x[a:b], y=data.y[a:b],
                            mask=data.mask[a:b])
        return sub, model.default_noise(data).subset(a, b), ShardLayout(pid, ranges, K)

    def capture(tag, payload, timeout_s):
        payloads["p1"] = payload
        return [payload]

    monkeypatch.setattr(dck, "allgather_bytes", capture)
    sub, noise, lay = local(1)
    distributed_run_identity(cfg, noise, sub, beta, lay)
    monkeypatch.setattr(dck, "allgather_bytes",
                        lambda tag, payload, timeout_s: [payload, payloads["p1"]])
    sub, noise, lay = local(0)
    assert np.array_equal(distributed_run_identity(cfg, noise, sub, beta, lay), one)
    monkeypatch.undo()
    flipped = data._replace(y=data.y.clone())
    flipped.y[0, 0, 0] = 1.0 - flipped.y[0, 0, 0]
    assert not np.array_equal(one, distributed_run_identity(
        cfg, model.default_noise(data), flipped, beta, ShardLayout.current(K, None)))
    assert not np.array_equal(one, distributed_run_identity(
        cfg, model.default_noise(data, 9), data, beta, ShardLayout.current(K, None)))


def test_ckpt_commit_events_and_summarize_block_match_the_twin(tmp_path):
    log_path = str(tmp_path / "run.jsonl")
    log = RunLog(log_path, name="t")
    ps = ChunkPipelineStats(run_log=log)
    with log.span("root"):
        ps.add_ckpt_commit(0.01, generation=1, it=4, filled=0, n_processes=2)
        with log.span("ckpt_commit", generation=2):
            ps.add_ckpt_commit(0.02, generation=2, it=8, filled=4, n_processes=2)
    log.close()
    assert ps.ckpt_generations == 2 and abs(ps.ckpt_commit_s - 0.03) < 1e-9
    agg = ps.aggregate()
    assert (agg["ckpt_generations"], agg["ckpt_commit_s"]) == (2, 0.03)
    mine, twin = summarize(log_path), jsummarize.summarize(log_path)
    assert mine["ckpt_commit"] == twin["ckpt_commit"]
    assert (mine["ckpt_commit"]["n_generations"], mine["ckpt_commit"]["last_generation"],
            mine["ckpt_commit"]["n_processes"]) == (2, 2, 2)


# -- generations, commits and rollback (one process, the testing hook) ----------

def test_multi_generation_commit_bitwise_and_manifest(prob, tmp_path, force_v8):
    path = str(tmp_path / "ck.npz")
    ps = ChunkPipelineStats()
    res = run(prob, path=path, pstats=ps)
    assert bitwise(prob, res)
    assert is_distributed_manifest(path)
    man = manifest(path)
    assert int(man["version"][0]) == 8 and int(man["generation"][0]) == 6
    assert np.array_equal(man["shard_rows"], [[0, K]]) and int(man["n_processes"][0]) == 1
    assert ps.ckpt_generations == 6 and ps.aggregate()["ckpt_generations"] == 6
    assert len(ps.ckpt_boundary_bytes) == 6
    # one state shard (the older generations unlinked) and three segments
    assert glob.glob(path + ".p000.g*.state.npz") == [shard_state_path(path, 0, 6)]
    assert len(glob.glob(path + ".p000.seg*.npz")) == 3


def test_overlap_pipeline_commits_the_same_generations(prob, tmp_path, force_v8):
    model = SpatialGPSampler(dataclasses.replace(prob["cfg"], chunk_pipeline="overlap"))
    path = str(tmp_path / "ov.npz")
    ps = ChunkPipelineStats()
    assert bitwise(prob, run(prob, path=path, pstats=ps, model=model))
    assert int(manifest(path)["generation"][0]) == 6 and ps.ckpt_generations == 6
    assert run(prob, path=str(tmp_path / "ov2.npz"), stop=4, model=model) is None
    assert bitwise(prob, run(prob, path=str(tmp_path / "ov2.npz"), model=model))


def test_kill_between_land_and_publish_rolls_back(prob, tmp_path, force_v8):
    path = str(tmp_path / "kill.npz")
    with pytest.raises(SimulatedKill):
        with kill_process_at_generation(3) as ctr:
            run(prob, path=path)
    assert ctr["publishes"] == 3
    assert int(manifest(path)["generation"][0]) == 2
    assert os.path.exists(shard_state_path(path, 0, 3))  # the orphan
    assert os.path.exists(shard_state_path(path, 0, 2))  # the committed one
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert any("orphan shard" in m and "generation 3" in m for m in msgs)
    assert bitwise(prob, res)


def test_torn_generation_orphans_detected_and_overwritten(prob, tmp_path, force_v8):
    path = str(tmp_path / "torn_gen.npz")
    assert run(prob, path=path, stop=4) is None  # generation 4, one sampling segment
    shutil.copy(shard_state_path(path, 0, 4), shard_state_path(path, 0, 5))
    prefix = shard_segment_prefix(path, 0)
    shutil.copy(segment_path(prefix, 0), segment_path(prefix, 1))
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert any("orphan shard" in m and "generation 5" in m and "shard:0" in m for m in msgs)
    assert bitwise(prob, res)


def test_resume_detection_without_the_hook(prob, tmp_path, force_v8):
    path = str(tmp_path / "auto.npz")
    assert run(prob, path=path, stop=4) is None
    dck.FORCE_DISTRIBUTED_FOR_TESTING = False
    assert bitwise(prob, run(prob, path=path))
    assert int(manifest(path)["generation"][0]) == 6


def test_wrong_noise_seed_is_rejected_by_the_identity(prob, tmp_path, force_v8):
    path = str(tmp_path / "ident.npz")
    assert run(prob, path=path, stop=4) is None
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        run(prob, path=path, seed=99)


def test_adaptive_schedule_is_refused_under_format_8(prob, tmp_path, force_v8):
    model = SpatialGPSampler(dataclasses.replace(prob["cfg"], adaptive_schedule="on",
                                                 live_diagnostics=True))
    with pytest.raises(NotImplementedError, match="adaptive_schedule='on'"):
        run(prob, path=str(tmp_path / "ad.npz"), model=model)


# -- torn shards ------------------------------------------------------------------

def test_torn_segment_lenient_refill_and_second_resume_clean(prob, tmp_path, force_v8):
    path = str(tmp_path / "lenient.npz")
    run(prob, path=path)
    torn_shard(path, 0, "segment")  # the last segment: kept draws [8, 12)
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert any("re-sampled" in m for m in msgs)
    got = res.param_samples
    assert bool(torch.isfinite(got).all())
    assert bitwise(prob, res, upto=8) and not torch.equal(got[:, 8:], prob["ref_param"][:, 8:])
    again = run(prob, path=path)
    assert torch.equal(again.param_samples, got)


def test_torn_state_shard_is_a_typed_error_naming_its_owner(prob, tmp_path, force_v8):
    path = str(tmp_path / "state.npz")
    assert run(prob, path=path, stop=4) is None
    torn_shard(path, 0, "state")
    with pytest.raises(ValueError, match="carried-state shard.*owner shard:0"):
        run(prob, path=path)
    with pytest.raises(ValueError, match="unknown torn_shard kind"):
        torn_shard(path, 0, "bogus")


def test_strict_reader_rejects_a_missing_segment(tmp_path):
    path = str(tmp_path / "u.npz")
    meta = np.asarray([8, 4, 4, 3, 2, 1], np.int64)
    ck = DistributedCheckpoint(path, meta, np.zeros(1, np.uint32), ShardLayout.current(4, None))
    save_segment(shard_segment_prefix(path, 0), 0, np.zeros((4, 2, 3), np.float32),
                 np.zeros((4, 2, 2), np.float32), 0, 2)
    ck.n_segments, ck.filled = 2, 4  # the manifest claims two; the disk has one
    with pytest.raises(ValueError, match="corrupt draw segment"):
        ck._read_own_segments(0, (0, 4), np.float32, 3, 2, lenient=False)
    _, _, holes = ck._read_own_segments(0, (0, 4), np.float32, 3, 2, lenient=True)
    assert holes == [(2, 4)]


# -- elastic resume -------------------------------------------------------------

def test_elastic_resume_from_a_two_process_checkpoint(prob, tmp_path, force_v8):
    path = str(tmp_path / "elastic.npz")
    assert run(prob, path=path, stop=4) is None
    resplit_shards(path, [[0, 2], [2, 4]])
    assert os.path.exists(shard_state_path(path, 1, 4))
    dck.FORCE_DISTRIBUTED_FOR_TESTING = False
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert any("elastic resume" in m and "shard owners ['shard:0', 'shard:1']" in m
               for m in msgs)
    # each row's generator state went back to its row: the whole chain is
    # the uninterrupted one
    assert bitwise(prob, res)


def test_elastic_resume_rebases_the_chain_for_the_next_resume(prob, tmp_path, force_v8):
    path = str(tmp_path / "rebase.npz")
    assert run(prob, path=path, stop=4) is None
    resplit_shards(path, [[0, 2], [2, 4]])
    assert run(prob, path=path, stop=1) is None  # one more chunk under the new layout
    man = manifest(path)
    assert int(man["n_processes"][0]) == 1 and int(man["generation"][0]) == 6
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert not any("elastic resume" in m for m in msgs)
    assert bitwise(prob, res)


def test_elastic_with_holes_suspends_appends_until_the_refill(prob, tmp_path, force_v8):
    path = str(tmp_path / "suspend.npz")
    assert run(prob, path=path, stop=5) is None  # filled 8, two segments
    resplit_shards(path, [[0, 2], [2, 4]])
    torn_shard(path, 1, "segment")  # kept draws [4, 8) of subsets 2-3
    gen = int(manifest(path)["generation"][0])
    _, msgs = caught_messages(lambda: run(prob, path=path, stop=1))
    assert any("commits are suspended" in m for m in msgs)
    man = manifest(path)
    assert int(man["generation"][0]) == gen and int(man["n_processes"][0]) == 2
    res = run(prob, path=path)
    got = res.param_samples
    assert bool(torch.isfinite(got).all())
    assert torch.equal(run(prob, path=path).param_samples, got)
    assert int(manifest(path)["n_processes"][0]) == 1


def test_elastic_with_a_torn_shard_names_the_owner(prob, tmp_path, force_v8):
    path = str(tmp_path / "elastic_torn.npz")
    assert run(prob, path=path, stop=4) is None
    resplit_shards(path, [[0, 2], [2, 4]])
    torn_shard(path, 1, "segment")
    dck.FORCE_DISTRIBUTED_FOR_TESTING = False
    res, msgs = caught_messages(lambda: run(prob, path=path))
    assert any(".p001.seg00000.npz" in m and "re-sampled" in m for m in msgs)
    got = res.param_samples
    assert bool(torch.isfinite(got).all())
    assert torch.equal(prob["ref_param"][:, 4:8], got[:, 4:8])


def test_writer_failure_aborts_a_multi_process_layout(tmp_path):
    meta = np.asarray([8, 4, 4, 3, 2, 1], np.int64)

    def failed_writer():
        w = BackgroundWriter()
        w.submit(lambda: (_ for _ in ()).throw(OSError("disk")))
        w.flush()
        assert w.error is not None
        return w

    multi = ShardLayout(process_id=0, row_ranges=((0, 2), (2, 4)), k=4)
    ck = DistributedCheckpoint(str(tmp_path / "m.npz"), meta, np.zeros(1, np.uint32), multi,
                               writer=failed_writer())
    with pytest.raises(CkptCommitError, match="unilaterally"):
        ck._check_degrade()
    ck.writer.close()
    one = DistributedCheckpoint(str(tmp_path / "o.npz"), meta, np.zeros(1, np.uint32),
                                ShardLayout.current(4, None), writer=failed_writer())
    _, msgs = caught_messages(one._check_degrade)
    assert one.degraded and one._need_full
    assert any("degrading to synchronous" in m for m in msgs)
    one.writer.close()


def test_single_process_checkpoints_stay_format_7(prob, tmp_path):
    path = str(tmp_path / "v7.npz")
    assert run(prob, path=path, stop=4) is None
    assert not is_distributed_manifest(path)
    man = load_pytree(path, {**dict.fromkeys(
        ("it", "meta", "ident", "version", "seg_base", "n_segments", "filled",
         "fault_attempts", "fault_dead", "fault_domain", "fault_domain_attempts",
         "fault_domain_dead"), np.zeros(0)),
        "state": rec.SamplerState(*([np.zeros(0)] * len(rec.SamplerState._fields))),
        "layout": rec.SamplerState(*([np.zeros(0)] * len(rec.SamplerState._fields))),
        "noise": np.zeros(0)})
    assert int(man["version"][0]) == rec.CKPT_VERSION == 7
    assert bitwise(prob, run(prob, path=path))
    assert not glob.glob(path + ".p0*")
