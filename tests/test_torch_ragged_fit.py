"""Coherent (ragged) fits end to end in the port: ``fit_meta_kriging(
config=SMKConfig(partition_method="coherent"))`` through the host ragged
fan-out (smk_torch/parallel/recovery._fit_ragged_chunked) against the JAX
package's fit, and the ragged fan-out's own contracts.

Clustered data (six Gaussian clusters, n = 200, K = 4) splits into
subsets of 56, 44, 54 and 46 rows, padded onto two buckets (64 and 45):
two bucket groups, each one ordinary chunked fit (16 sweeps in chunks
of 4). The port replays the JAX keys (tests/test_torch_recovery
.ChunkedJaxReplay): each group draws the rows of its global subset ids,
as the twin slices its once-split keys. Tolerance: 5e-5 absolute + 5e-5
relative, as the other whole-fit comparisons, on the combined grids,
the predictions and the acceptance; the raw per-subset draws of the
last sweeps at 1e-4 (fp32 roundoff grows over the 16 sweeps: observed
5.8e-5 absolute on a draw of 0.15, where the grids stay within
5e-5). The ragged fan-out's own
contracts (one exact bucket against the plain partition, kill and
resume) are held bitwise.
"""

# smklint: test-budget=one JAX coherent fit (two bucket groups at m <= 64, one chunk length) in a module fixture; the port's fits at n = 200 take about a second each
import os

import jax
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.config import SMKConfig as JaxConfig
from smk_torch import SMKConfig, fit_meta_kriging
from smk_torch.config import check_ported
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import partition as tpart
from smk_torch.parallel import recovery as rec
from smk_torch.testing.faults import inject_subset_nan
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_api import JaxRandomness
from test_torch_recovery import ChunkedJaxReplay

N, K, Q, P, T = 200, 4, 1, 2, 5
CHUNK = 4
TOL = dict(atol=5e-5, rtol=5e-5)
KW = dict(n_subsets=K, n_samples=16, partition_method="coherent")


def _clustered():
    rng = np.random.default_rng(0)
    centers = rng.uniform(size=(6, 2))
    coords = (centers[rng.integers(0, 6, N)] + 0.04 * rng.normal(size=(N, 2))).astype(np.float32)
    x = np.concatenate([np.ones((N, Q, 1)), rng.normal(size=(N, Q, P - 1))],
                       -1).astype(np.float32)
    y = (rng.uniform(size=(N, Q)) < 0.5).astype(np.float32)
    ct = rng.uniform(size=(T, 2)).astype(np.float32)
    xt = np.ones((T, Q, P), np.float32)
    return y, x, coords, ct, xt


class ChunkedJaxRandomness(JaxRandomness):
    """JaxRandomness whose sweep noise is the chunked executor's replay."""

    def sweep_noise(self, shapes):
        return ChunkedJaxReplay(jax.random.split(self.k_fit, shapes.k), shapes,
                                collapsed=self.collapsed)


@pytest.fixture(scope="module")
def fits():
    data = _clustered()
    key = jax.random.key(3)
    ref = jax_fit(key, *data, config=JaxConfig(**KW), chunk_iters=CHUNK)
    stats = ChunkPipelineStats()
    port = fit_meta_kriging(*data, config=SMKConfig(**KW), randomness=ChunkedJaxRandomness(key),
                            device="cpu", chunk_iters=CHUNK, pipeline_stats=stats)
    return {"ref": ref, "port": port, "stats": stats, "data": data}


def test_the_data_makes_two_bucket_groups():
    y, x, coords, _, _ = map(torch.as_tensor, _clustered())
    part = tpart.coherent_partition(y, x, coords, K)
    assert part.sizes == (56, 44, 54, 46)
    assert part.buckets == (45, 64)


@pytest.mark.parametrize("field", ["param_grid", "w_grid", "p_quant", "param_quant",
                                   "sample_par", "phi_accept_rate"])
def test_coherent_fit_matches_twin(fits, field):
    np.testing.assert_allclose(getattr(fits["port"], field).numpy(),
                               np.asarray(getattr(fits["ref"], field)), **TOL)


def test_coherent_fit_subsets_come_back_in_original_order(fits):
    np.testing.assert_allclose(fits["port"].subset_results.param_samples.numpy(),
                               np.asarray(fits["ref"].subset_results.param_samples),
                               atol=1e-4, rtol=1e-4)
    assert fits["port"].pad_waste_frac == fits["ref"].pad_waste_frac == 0.0
    assert [g["bucket"] for g in fits["stats"].ragged_groups] == [45, 64]
    assert [g["n_subsets"] for g in fits["stats"].ragged_groups] == [1, 3]


def _part_and_noise(part_kind, seed=5, **kw):
    y, x, coords, ct, xt = map(torch.as_tensor, _clustered())
    if part_kind == "coherent":
        part = tpart.coherent_partition(y, x, coords, K)
        m = max(part.buckets)
    else:
        idx = np.random.default_rng(1).permutation(N)[: K * 45].reshape(K, 45)
        part = (tpart.padded_partition(y, x, coords, list(idx)) if part_kind == "padded"
                else tpart.partition_from_indices(y, x, coords, torch.as_tensor(idx)))
        m = 45
    cfg = SMKConfig(**dict(KW, fault_policy="quarantine", **kw))
    shapes = tp.sweep_shapes(cfg, K, m, Q, P, T)
    noise = tp.GeneratorNoise(tp.subset_generators(seed, shapes.k, "cpu"), shapes)
    return cfg, part, noise, ct, xt


def test_one_exact_bucket_is_bitwise_the_plain_partition_fit():
    """The collapsed sampler, so the finite-factor guard's per-row counts
    (instrumentation) are compared too."""
    results, guards = {}, {}
    for kind in ("padded", "plain"):
        cfg, part, noise, ct, xt = _part_and_noise(kind, phi_sampler="collapsed",
                                                   phi_update_every=2)
        if kind == "padded":
            assert isinstance(part, tpart.PaddedPartition) and part.buckets == (45,)
        model = tp.SpatialGPSampler(cfg)
        results[kind] = rec.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=CHUNK)
        guards[kind] = model.guard_rejects
    for a, b in zip(results["padded"], results["plain"]):
        assert torch.equal(a, b)
    assert torch.equal(guards["padded"], guards["plain"])


def test_two_group_guard_counts_come_back_per_subset():
    cfg, part, noise, ct, xt = _part_and_noise("coherent", phi_sampler="collapsed",
                                               phi_update_every=2)
    model = tp.SpatialGPSampler(cfg)
    rec.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=CHUNK)
    assert model.guard_rejects.shape == (K,)


def test_ragged_kill_and_resume_replays_only_the_interrupted_group(tmp_path):
    def run(**kw):
        cfg, part, noise, ct, xt = _part_and_noise("coherent")
        stats = ChunkPipelineStats()
        res = rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), part, ct, xt, noise,
                                      chunk_iters=CHUNK, pipeline_stats=stats, **kw)
        return res, stats

    path = str(tmp_path / "r.npz")
    full, _ = run()
    # the bucket-45 group takes 4 chunks, then 2 of the bucket-64 group's 4
    killed, stats = run(checkpoint_path=path, stop_after_chunks=6)
    assert killed is None and len(stats.chunks) == 6
    assert os.path.exists(path + ".b00045") and os.path.exists(path + ".b00064")
    done_mtime = os.path.getmtime(path + ".b00045")
    resumed, stats = run(checkpoint_path=path)
    assert len(stats.chunks) == 2  # only the interrupted group's remaining chunks
    assert os.path.getmtime(path + ".b00045") == done_mtime
    for a, b in zip(full, resumed):
        assert torch.equal(a, b)


def test_ragged_fault_ids_come_back_global():
    cfg, part, noise, ct, xt = _part_and_noise("coherent")
    stats = ChunkPipelineStats()
    with pytest.warns(RuntimeWarning, match="non-finite"):
        with inject_subset_nan(0, 6, max_fires=99):  # row 0 of each group
            res = rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), part, ct, xt, noise,
                                          chunk_iters=CHUNK, pipeline_stats=stats)
    first_rows = sorted(g.subset_ids[0] for g in part.groups)
    assert first_rows == [0, 1]
    assert stats.fault_summary()["subsets_dropped"] == first_rows
    assert sorted({j for e in stats.fault_events for j in e["retried"]}) == first_rows
    np.testing.assert_array_equal(rec.find_failed_subsets(res), first_rows)


def test_ragged_nan_guard_names_global_subsets():
    cfg, part, noise, ct, xt = _part_and_noise("coherent")
    cfg = SMKConfig(**KW)
    with inject_subset_nan(2, 1, max_fires=99):  # row 2 exists in the bucket-64 group only
        with pytest.raises(rec.SubsetNaNError) as ei:
            rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), part, ct, xt, noise,
                                    chunk_iters=CHUNK, nan_guard=True)
    assert ei.value.subset_ids == [part.groups[1].subset_ids[2]]


def test_bucket_ladder_and_quarantine_run_through_the_api(fits):
    y, x, coords, ct, xt = fits["data"]
    res = fit_meta_kriging(y, x, coords, ct, xt, device="cpu", chunk_iters=8, seed=1,
                           config=SMKConfig(**dict(KW, bucket_ladder=(50, 70),
                                                   fault_policy="quarantine")))
    assert torch.isfinite(res.p_quant).all()
    assert res.subsets_dropped == () and res.pad_waste_frac == 0.0


@pytest.mark.parametrize("knob", [
    dict(adaptive_schedule="on", live_diagnostics=True),
    dict(live_diagnostics=True),
    dict(run_log_dir="logs"),
    dict(profile_dir="profiles"),
])
def test_the_executors_last_knobs_pass_the_port_check(knob):
    """The executor's last knobs (ROADMAP A8c) are ported: none of them
    raises (tests/test_torch_obs.py and tests/test_torch_adaptive.py
    hold them against the twin)."""
    check_ported(SMKConfig(**knob))


@pytest.mark.parametrize("knob", [
    dict(partition_method="coherent"), dict(bucket_ladder=(64, 128)),
    dict(fault_policy="quarantine"), dict(chunk_pipeline="overlap"), dict(watchdog=True),
])
def test_ported_knobs_no_longer_raise(knob):
    check_ported(SMKConfig(**knob))


def test_ragged_fit_with_the_default_noise_runs():
    """No noise source given: one generator per (subset, chain) row of the
    whole ragged partition, seeded from 0, as SpatialGPSampler's default."""
    cfg, part, _, ct, xt = _part_and_noise("coherent")
    res = rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), part, ct, xt, chunk_iters=8)
    assert res.param_grid.shape[0] == K and torch.isfinite(res.param_grid).all()
