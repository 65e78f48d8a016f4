"""The device mesh of the port (smk_torch/parallel/executor.py and what
sits on it) against the JAX package on its forced 8-device CPU mesh
(tests/conftest.py): the layout oracle, ``sub_mesh``, the ragged-mesh
planner and its entry stacks, failure domains over a mesh and over a
plan, the topology fingerprint and ``mesh_from_spec``, case for case;
then fits.

- ``fit_meta_kriging(n_devices=8, device="cpu")`` against the twin's
  ``fit_meta_kriging(key, ..., n_devices=8)``, draw for draw through the
  key replay of tests/test_torch_api.py, at the sweep tolerance 5e-5 +
  5e-5·|x|. The meshed fit is bitwise the port's unmeshed fit on meshes
  whose blocks hold two or more subsets; on 8 entries (one subset a
  block) at the sweep tolerance, because the CPU's batched
  matrix-vector product (``torch.matmul`` of a (B, m, m) stack with
  (B, m, 1)) sums in another order at a batch of one (a GEMV path).
- A coherent fit on a 4-entry mesh (its two bucket groups fused into one
  plan entry) against the twin's ragged mesh fit, with
  ``pad_waste_frac`` and ``domains_dropped`` equal.
- The meshed chunked executor (chunk_iters, quarantine with an injected
  NaN) bitwise against the unmeshed one; ``precompile(mesh=)`` followed
  by a meshed fit that finds every program in L1.
- ``sharded_cholesky`` and ``sharded_matvec`` on 8 entries against the
  twin's and against ``blocked_cholesky``.
- The kernel wrapper launches on its output's device.
- The adaptive schedule over a mesh (A9c): the twin's adaptive problem
  on a 2-entry mesh against the twin's meshed fit, draw for draw by the
  replayed keys (frozen_at, kept counts, every rung even, the fields at
  the sweep tolerance, the ``adaptive_mesh_replan`` events equal); on 4
  entries (K = 8, scripted statistics, the port's own noise) the
  executor's consults replayed in the twin's AdaptiveScheduler
  (n_devices=4), decision for decision, and each replan event against
  the twin's rung and planner.

Three twin fits (each a module fixture); the rest is host math or port
fits at n <= 200.
"""

# smklint: test-budget=three JAX meshed reference fits (n=200: 8 sweeps over 8 virtual devices, ~10 s; a coherent ragged mesh fit, 16 sweeps, ~20 s; the adaptive problem on 2 devices, ~25 s), each in a module fixture; the rest is host integer math or port fits at n <= 200 (about a second each)
import contextlib
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.compile import buckets as jbuckets
from smk_tpu.compile import programs as jprograms
from smk_tpu.compile import warmup as jwarmup
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.ops.chol import blocked_cholesky as jax_blocked_cholesky
from smk_tpu.parallel import domains as jdomains
from smk_tpu.parallel import executor as jexec
from smk_tpu.parallel import partition as jpart
from smk_tpu.parallel import sharded_chol as jsc
from smk_torch import SMKConfig, fit_meta_kriging
from smk_torch.compile import buckets, programs, warmup
from smk_torch.models import probit_gp as tp
from smk_torch.ops import fused_build
from smk_torch.ops.chol import blocked_cholesky
from smk_torch.parallel import domains, executor, partition, recovery, sharded_chol
from smk_torch.testing.faults import inject_subset_nan
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_api import JaxRandomness
from test_torch_ragged_fit import ChunkedJaxRandomness, _clustered

TOL = dict(atol=5e-5, rtol=5e-5)
RESULT_FIELDS = ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "p_quant",
                 "param_quant", "w_quant", "phi_accept_rate")


def _same(a, b) -> bool:
    """Bitwise equal, NaN where NaN (diagnostics of short runs are NaN)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _twin_mesh(n):
    return jexec.make_mesh(n)


def _port_mesh(n):
    return executor.make_mesh(n, device="cpu")


# -- the layout oracle ------------------------------------------------------


@pytest.mark.parametrize("k,n", [(8, 8), (16, 8), (9, 8), (4, 2), (6, 4), (5, 1), (12, 3)])
def test_layout_oracle_matches_twin(k, n):
    assert executor.fits_layout(k, n) == jexec.fits_layout(k, n)
    if jexec.fits_layout(k, n):
        assert executor.require_divisible_layout(k, n) == jexec.require_divisible_layout(k, n)
        got = [e.id for e in executor.subset_device_assignment(k, _port_mesh(n))]
        want = [d.id for d in jexec.subset_device_assignment(k, _twin_mesh(n))]
        assert got == want
        assert (executor.all_process_row_ranges(k, _port_mesh(n))
                == jexec.all_process_row_ranges(k, _twin_mesh(n)))
        assert (executor.process_row_range(k, _port_mesh(n))
                == jexec.process_row_range(k, _twin_mesh(n)))
    else:
        with pytest.raises(executor.SubsetLayoutError, match="plan_ragged_mesh") as e:
            executor.require_divisible_layout(k, n, what="chunk_size")
        assert isinstance(e.value, ValueError) and "chunk_size" in str(e.value)
    with pytest.raises(executor.SubsetLayoutError):
        executor.require_divisible_layout(k, 0)


def test_sub_mesh_and_make_mesh_contract():
    mesh = _port_mesh(8)
    assert mesh.size == 8 and mesh.devices.shape == (8,) and mesh.axis_names == ("subsets",)
    assert executor.sub_mesh(mesh, 8) is mesh
    sub = executor.sub_mesh(mesh, 3)
    assert [e.id for e in sub.entries] == [d.id for d in jexec.sub_mesh(_twin_mesh(8), 3)
                                           .devices.flat]
    for bad in (0, 9):
        with pytest.raises(ValueError):
            executor.sub_mesh(mesh, bad)
    with pytest.raises(ValueError):
        executor.make_mesh(0, device="cpu")
    assert mesh.home == torch.device("cpu") and not mesh.multi_process
    assert mesh.device_kind == "cpu"


def test_no_card_mesh_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        executor.make_mesh(2)
    with pytest.raises(warmup.MeshSpecError, match="no CUDA device"):
        warmup.mesh_from_spec((1,), "NVIDIA H100 80GB HBM3")


# -- the ragged-mesh planner --------------------------------------------------

PLAN_CASES = [
    ([16], [9], 8, 0.25), ([16], [16], 8, 0.25), ([16], [11], 8, 0.25),
    ([16], [17], 8, 0.25), ([16], [5], 4, 0.25), ([16], [13], 4, 0.25), ([16], [3], 2, 0.25),
    ([16, 23, 32], [9, 3, 2], 8, 0.25), ([8, 11, 16], [1, 2, 2], 8, 0.25),
    ([8, 64], [1, 1], 8, 0.25), ([8, 64], [1, 1], 8, 0.9), ([16, 23], [2, 3], 8, 0.25),
    ([11, 16, 23, 32, 45], [2, 9, 1, 3, 16], 8, 0.25),
    ([11, 16, 23, 32, 45], [2, 9, 1, 3, 16], 1, 0.25),
    ([11, 16, 23, 32, 45], [2, 9, 1, 3, 16], 4, 0.5), ([11, 16], [3, 2], 8, 0.5),
]


@pytest.mark.parametrize("bs,ks,d,frac", PLAN_CASES)
def test_plan_ragged_mesh_matches_twin(bs, ks, d, frac):
    got = buckets.plan_ragged_mesh(bs, ks, d, fuse_max_rows_frac=frac)
    want = jbuckets.plan_ragged_mesh(bs, ks, d, fuse_max_rows_frac=frac)
    assert got.summary() == want.summary()
    assert [tuple(e) for e in got.entries] == [tuple(e) for e in want.entries]
    assert got.pad_waste_frac < got.waste_bound
    for e in got.entries:
        assert e.pad_mask == jbuckets.RaggedMeshEntry(*e).pad_mask
        assert got.entry_of_group(e.group_ids[0]) == want.entry_of_group(e.group_ids[0])
    assert buckets._k_layout(max(ks), d) == jbuckets._k_layout(max(ks), d)


@pytest.mark.parametrize("args", [([], [], 8), ([16, 23], [4], 8), ([16], [4], 0),
                                  ([23, 16], [4, 4], 8), ([16], [0], 8)])
def test_plan_ragged_mesh_refusals_match_twin(args):
    with pytest.raises(ValueError):
        jbuckets.plan_ragged_mesh(*args)
    with pytest.raises(ValueError):
        buckets.plan_ragged_mesh(*args)
    with pytest.raises(ValueError):
        buckets.plan_ragged_mesh([16], [4], 8, fuse_max_rows_frac=1.0)


def _tiny_padded(pkg):
    """The twin's test_ragged_mesh._tiny_padded_partition in either
    package: sizes 10, 10, 10 (bucket 11) and 14, 16 (bucket 16)."""
    rng = np.random.default_rng(7)
    n = 60
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    y = rng.integers(0, 2, size=(n, 1)).astype(np.float32)
    x = rng.normal(size=(n, 1, 2)).astype(np.float32)
    perm = rng.permutation(n)
    asg = [perm[:10], perm[10:20], perm[20:30], perm[30:44], perm[44:60]]
    if pkg == "twin":
        return jpart.padded_partition(jnp.asarray(y), jnp.asarray(x), jnp.asarray(coords), asg)
    return partition.padded_partition(torch.as_tensor(y), torch.as_tensor(x),
                                      torch.as_tensor(coords), asg)


@pytest.mark.parametrize("d,frac", [(1, 0.25), (2, 0.25), (8, 0.5), (4, 0.25)])
def test_ragged_mesh_entry_partition_matches_twin(d, frac):
    pp, jp = _tiny_padded("port"), _tiny_padded("twin")
    plan = buckets.plan_ragged_mesh(list(pp.buckets), [len(g.subset_ids) for g in pp.groups],
                                    d, fuse_max_rows_frac=frac)
    for e in plan.entries:
        got, ids = partition.ragged_mesh_entry_partition(pp, e)
        want, jids = jpart.ragged_mesh_entry_partition(jp, jbuckets.RaggedMeshEntry(*e))
        assert ids == jids
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if len(e.group_ids) == 1 and not e.pad_k:
            assert got is pp.groups[e.group_ids[0]].part  # the identity entry


# -- failure domains and the fingerprint ---------------------------------------


@pytest.mark.parametrize("k,n", [(8, 8), (16, 8), (8, 2), (4, 1)])
def test_failure_domains_over_a_mesh_match_twin(k, n):
    pm, jm = _port_mesh(n), _twin_mesh(n)
    for gran in ("process", "device"):
        assert (domains.FailureDomainMap.from_mesh(k, pm, gran).summary()
                == jdomains.FailureDomainMap.from_mesh(k, jm, gran).summary())
    assert (domains.FailureDomainMap.derive(k, pm).summary()
            == jdomains.FailureDomainMap.derive(k, jm).summary())
    with pytest.raises(ValueError):
        domains.FailureDomainMap.from_mesh(k, pm, "host")


@pytest.mark.parametrize("d,frac", [(8, 0.5), (2, 0.25), (1, 0.25)])
def test_failure_domains_over_a_plan_match_twin(d, frac):
    pp, jp = _tiny_padded("port"), _tiny_padded("twin")
    ks = [len(g.subset_ids) for g in pp.groups]
    plan = buckets.plan_ragged_mesh(list(pp.buckets), ks, d, fuse_max_rows_frac=frac)
    jplan = jbuckets.plan_ragged_mesh(list(jp.buckets), ks, d, fuse_max_rows_frac=frac)
    got = domains.FailureDomainMap.derive_ragged(plan, pp, _port_mesh(8))
    want = jdomains.FailureDomainMap.derive_ragged(jplan, jp, _twin_mesh(8))
    assert got.summary() == want.summary()
    assert (domains.FailureDomainMap.from_ragged_plan(plan, pp, _port_mesh(8), "device")
            .summary() == jdomains.FailureDomainMap.from_ragged_plan(
                jplan, jp, _twin_mesh(8), "device").summary())


def test_topology_fingerprint_matches_twin_and_keys_a_new_bucket():
    for n in (1, 2, 8):
        assert programs.topology_fingerprint(_port_mesh(n)) == \
            jprograms.topology_fingerprint(_twin_mesh(n))
    assert programs.topology_fingerprint(None) is None
    model = tp.SpatialGPSampler(SMKConfig(n_subsets=8, n_samples=12))
    dims = (8, None, 25, 1, 2, 6, 2)
    plain = programs.chunk_bucket_key(model, "burn", 4, *dims)
    meshed = programs.chunk_bucket_key(model, "burn", 4, *dims, mesh=_port_mesh(8))
    assert meshed[:-1] == plain and meshed[-1] == programs.topology_fingerprint(_port_mesh(8))
    assert (programs.aux_bucket_key(model, "stats", 8, mesh=_port_mesh(2))[-1]
            == programs.topology_fingerprint(_port_mesh(2)))


def test_mesh_from_spec_matches_twin():
    got = warmup.mesh_from_spec((8,), "cpu", device="cpu")
    want = jwarmup.mesh_from_spec((8,), "cpu")
    assert programs.topology_fingerprint(got) == jprograms.topology_fingerprint(want)
    assert warmup.mesh_from_spec((3,), None, device="cpu").size == 3
    for spec in (((2, 4), "cpu"), ((8,), "NVIDIA H100 80GB HBM3")):
        with pytest.raises(jwarmup.MeshSpecError):
            jwarmup.mesh_from_spec(*spec)
        with pytest.raises(warmup.MeshSpecError):
            warmup.mesh_from_spec(*spec, device="cpu")
    with pytest.raises(warmup.MeshSpecError, match="abstract-topology"):
        warmup.mesh_from_spec((8,), "cpu", allow_topology=True, device="cpu")


# -- fits --------------------------------------------------------------------

N, Q, P, T, KSUB, NS = 200, 1, 2, 6, 8, 8


def _problem():
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = np.concatenate([np.ones((N, Q, 1)), rng.normal(size=(N, Q, P - 1))],
                       -1).astype(np.float32)
    y = (rng.uniform(size=(N, Q)) < 0.5).astype(np.float32)
    return y, x, coords, rng.uniform(size=(T, 2)).astype(np.float32), np.ones((T, Q, P),
                                                                            np.float32)


@pytest.fixture(scope="module")
def meshed():
    data = _problem()
    kw = dict(n_subsets=KSUB, n_samples=NS)
    key = jax.random.key(7)
    ref = jax_fit(key, *data, config=JaxConfig(**kw), n_devices=8)
    port = fit_meta_kriging(*data, config=SMKConfig(**kw), randomness=JaxRandomness(key),
                            device="cpu", n_devices=8)
    return {"ref": ref, "port": port, "data": data, "kw": kw}


@pytest.mark.parametrize("field", RESULT_FIELDS)
def test_meshed_fit_matches_twin_draw_for_draw(meshed, field):
    np.testing.assert_allclose(getattr(meshed["port"], field).numpy(),
                               np.asarray(getattr(meshed["ref"], field)), **TOL)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_meshed_fit_against_the_unmeshed_fit(meshed, n):
    cfg = SMKConfig(**meshed["kw"])
    plain = fit_meta_kriging(*meshed["data"], config=cfg, seed=5, device="cpu")
    got = fit_meta_kriging(*meshed["data"], config=cfg, seed=5, device="cpu", n_devices=n)
    for f in RESULT_FIELDS + ("subset_results",):
        a, b = getattr(got, f), getattr(plain, f)
        for u, v in (zip(a, b) if f == "subset_results" else [(a, b)]):
            if n < 8:  # blocks of two or more subsets: bitwise
                assert _same(u, v), f
            else:  # one subset a block: the batch-of-one GEMV order
                np.testing.assert_allclose(u.numpy(), v.numpy(), equal_nan=True, **TOL)


def test_meshed_fit_refuses_mesh_and_n_devices_together(meshed):
    with pytest.raises(ValueError, match="not both"):
        fit_meta_kriging(*meshed["data"], config=SMKConfig(**meshed["kw"]), device="cpu",
                         mesh=_port_mesh(2), n_devices=2)


def test_sharded_fan_out_rows_are_the_unmeshed_rows(meshed):
    y, x, coords, ct, xt = map(torch.as_tensor, meshed["data"])
    part = partition.random_partition(torch.randperm(N, generator=torch.Generator()
                                                     .manual_seed(1)), y, x, coords, KSUB)
    model = tp.SpatialGPSampler(SMKConfig(**dict(meshed["kw"], phi_sampler="collapsed",
                                                  phi_update_every=2)))
    plain = executor.fit_subsets_vmap(model, part, ct, xt)
    guard = model.guard_rejects
    got = executor.fit_subsets_sharded(model, part, ct, xt, mesh=_port_mesh(2), chunk_size=4)
    for a, b in zip(got, plain):
        assert _same(a, b)
    assert torch.equal(model.guard_rejects, guard)
    with pytest.raises(executor.SubsetLayoutError):
        executor.fit_subsets_sharded(model, part, ct, xt, mesh=_port_mesh(3))


@pytest.fixture(scope="module")
def ragged_meshed():
    data = _clustered()
    kw = dict(n_subsets=4, n_samples=16, partition_method="coherent", fault_policy="quarantine")
    key = jax.random.key(3)
    ref = jax_fit(key, *data, config=JaxConfig(**kw), chunk_iters=4, n_devices=4)
    stats = ChunkPipelineStats()
    port = fit_meta_kriging(*data, config=SMKConfig(**kw), randomness=ChunkedJaxRandomness(key),
                            device="cpu", chunk_iters=4, n_devices=4, pipeline_stats=stats)
    return {"ref": ref, "port": port, "stats": stats, "data": data, "kw": kw}


@pytest.mark.parametrize("field", ["param_grid", "w_grid", "p_quant", "sample_par",
                                   "phi_accept_rate"])
def test_coherent_mesh_fit_matches_twin(ragged_meshed, field):
    np.testing.assert_allclose(getattr(ragged_meshed["port"], field).numpy(),
                               np.asarray(getattr(ragged_meshed["ref"], field)), **TOL)


def test_coherent_mesh_fit_plan_and_ledger_match_twin(ragged_meshed):
    port, ref = ragged_meshed["port"], ragged_meshed["ref"]
    assert port.pad_waste_frac == ref.pad_waste_frac > 0.0
    assert port.domains_dropped == ref.domains_dropped
    assert port.subsets_dropped == ref.subsets_dropped
    plan = ragged_meshed["stats"].ragged_mesh_plan
    assert plan["n_devices"] == 4 and plan["entries"][0]["fused"]
    assert plan["pad_waste_frac"] == port.pad_waste_frac


def test_one_entry_coherent_mesh_fit_is_bitwise_the_host_fit(ragged_meshed):
    cfg = SMKConfig(**ragged_meshed["kw"])
    host = fit_meta_kriging(*ragged_meshed["data"], config=cfg, seed=2, device="cpu",
                            chunk_iters=4)
    one = fit_meta_kriging(*ragged_meshed["data"], config=cfg, seed=2, device="cpu",
                           chunk_iters=4, n_devices=1)
    for f in RESULT_FIELDS:
        assert _same(getattr(one, f), getattr(host, f)), f
    assert one.pad_waste_frac == host.pad_waste_frac == 0.0


def _chunked_problem(seed=4):
    y, x, coords, ct, xt = map(torch.as_tensor, _problem())
    part = partition.random_partition(torch.randperm(N, generator=torch.Generator()
                                                     .manual_seed(seed)), y, x, coords, KSUB)
    return part, ct, xt


def _chunked(mesh, part, ct, xt, **kw):
    cfg = SMKConfig(n_subsets=KSUB, n_samples=16, fault_policy="quarantine", **kw)
    model = tp.SpatialGPSampler(cfg)
    shapes = tp.sweep_shapes(cfg, KSUB, part.subset_size, Q, P, T)
    noise = tp.GeneratorNoise(tp.subset_generators(9, shapes.k, "cpu"), shapes)
    stats = ChunkPipelineStats()
    with inject_subset_nan(3, at_iteration=6):
        res = recovery.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=4,
                                           mesh=mesh, pipeline_stats=stats)
    return res, stats


@pytest.mark.parametrize("n,chunk_size", [(2, 4), (4, None), (1, None)])
def test_meshed_chunked_executor_is_bitwise_the_unmeshed_one(n, chunk_size):
    part, ct, xt = _chunked_problem()
    plain, pst = _chunked(None, part, ct, xt)
    got, mst = _chunked(_port_mesh(n), part, ct, xt)
    for a, b in zip(got, plain):
        assert _same(a, b)
    assert mst.fault_events == pst.fault_events and pst.fault_events
    keys = [p["key"] for p in mst.programs]
    fp = str(programs.topology_fingerprint(_port_mesh(n)))
    assert keys and all(k[-1] == fp for k in keys)
    if chunk_size:
        got_cs = recovery.fit_subsets_chunked(
            tp.SpatialGPSampler(SMKConfig(n_subsets=KSUB, n_samples=16)), part, ct, xt,
            chunk_iters=4, mesh=_port_mesh(n), chunk_size=chunk_size)
        ref_cs = recovery.fit_subsets_chunked(
            tp.SpatialGPSampler(SMKConfig(n_subsets=KSUB, n_samples=16)), part, ct, xt,
            chunk_iters=4)
        for a, b in zip(got_cs, ref_cs):
            assert _same(a, b)


def test_meshed_chunked_layout_checks_and_refusals():
    part, ct, xt = _chunked_problem()
    model = tp.SpatialGPSampler(SMKConfig(n_subsets=KSUB, n_samples=8))
    with pytest.raises(executor.SubsetLayoutError):
        recovery.fit_subsets_chunked(model, part, ct, xt, chunk_iters=4, mesh=_port_mesh(3))
    with pytest.raises(executor.SubsetLayoutError, match="chunk_size"):
        recovery.fit_subsets_chunked(model, part, ct, xt, chunk_iters=4, mesh=_port_mesh(4),
                                     chunk_size=2)
    # the adaptive schedule runs over a mesh of more than one entry now
    # (A9c); its refusal of chunk_size stays, on a mesh as off one
    adaptive = tp.SpatialGPSampler(SMKConfig(n_subsets=KSUB, n_samples=8,
                                             live_diagnostics=True, adaptive_schedule="on"))
    res = recovery.fit_subsets_chunked(adaptive, part, ct, xt, chunk_iters=4,
                                       mesh=_port_mesh(2))
    assert torch.isfinite(res.param_grid).all()
    with pytest.raises(ValueError, match="incompatible with chunk_size"):
        recovery.fit_subsets_chunked(adaptive, part, ct, xt, chunk_iters=4, mesh=_port_mesh(2),
                                     chunk_size=4)


def test_adaptive_with_the_distributed_checkpoint_is_refused_like_twin(tmp_path):
    """The adaptive schedule runs over a multi-process mesh now (A9d),
    but not with the distributed checkpoint (format 8): the scheduler
    sidecar and the full-K state merge are single-process operations,
    in both packages, which refuse it before any chunk runs."""
    from smk_tpu.parallel import checkpoint as jdck
    from smk_tpu.parallel import recovery as jrec
    from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
    from smk_torch.parallel import checkpoint as tdck

    part, ct, xt = _chunked_problem()
    kw = dict(n_subsets=KSUB, n_samples=8, live_diagnostics=True, adaptive_schedule="on")
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.integers(0, 2, (N, Q)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(N, Q, P)), jnp.float32)
    coords = jnp.asarray(rng.uniform(size=(N, 2)), jnp.float32)
    jp = jpart.random_partition(jax.random.key(0), y, x, coords, KSUB)
    jct = jnp.asarray(rng.uniform(size=(T, 2)), jnp.float32)
    jxt = jnp.asarray(rng.normal(size=(T, Q, P)), jnp.float32)
    messages = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdck, "FORCE_DISTRIBUTED_FOR_TESTING", True)
        mp.setattr(jdck, "FORCE_DISTRIBUTED_FOR_TESTING", True)
        with pytest.raises(NotImplementedError) as port:
            recovery.fit_subsets_chunked(tp.SpatialGPSampler(SMKConfig(**kw)), part, ct, xt,
                                         chunk_iters=4, checkpoint_path=str(tmp_path / "p.npz"))
        with pytest.raises(NotImplementedError) as twin:
            jrec.fit_subsets_chunked(JaxSampler(JaxConfig(**kw)), jp, jct, jxt,
                                     jax.random.key(1), chunk_iters=4,
                                     checkpoint_path=str(tmp_path / "j.npz"))
        messages = [str(port.value), str(twin.value)]
    for msg in messages:
        assert "adaptive_schedule='on' is not supported with the" in msg
        assert "distributed checkpoint" in msg
        assert "the scheduler sidecar and the full-K state merge are" in msg
    assert not os.listdir(tmp_path)


@pytest.fixture()
def one_torch_thread():
    """The adaptive fits below are many small products a sweep: one
    thread runs them as fast, and does not contend with the suite's
    other workers (with every core each, they ran ~100x slower there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_adaptive_gathers_each_boundary_on_a_gloo_world_of_one(one_torch_thread):
    """Inside a process group (gloo, a world of one) the adaptive fit
    gathers each sampling boundary's statistics over the group and folds
    the gathered vectors: its result, decisions and replan events are
    bitwise the fit outside any group, one gather a sampling boundary,
    each carrying this process's verdict, finite flags and (K,) R-hat and
    ESS as the run log's live_diagnostics events record them."""
    import socket
    import tempfile

    from smk_torch.obs.reporter import read_jsonl
    from smk_torch.parallel import distributed as tdist
    from smk_torch.testing import dcn_worker

    def fit(log_dir):
        return dcn_worker.adaptive_fit(executor.make_mesh(device="cpu"), log_dir)

    with tempfile.TemporaryDirectory() as d:
        plain_res, plain_stats, plain_replans = fit(d)
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    payloads = []
    real = tdist.allgather_bytes

    def recording(tag, payload, **kw):
        out = real(tag, payload, **kw)
        payloads.append((tag, np.frombuffer(out[0], np.float64)))
        return out

    tdist._reset_state_for_testing()
    tdist.init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0, device="cpu",
                           timeout_s=30.0)
    try:
        with pytest.MonkeyPatch.context() as mp, tempfile.TemporaryDirectory() as d:
            mp.setattr(tdist, "allgather_bytes", recording)
            res, stats, replans = fit(d)
            live = [r["attrs"] for r in read_jsonl(res.run_log_path)
                    if r.get("kind") == "event" and r.get("name") == "live_diagnostics"]
    finally:
        tdist.destroy_distributed()
    for f in RESULT_FIELDS:
        assert _same(getattr(res, f), getattr(plain_res, f)), f
    for a, b in zip(res.subset_results, plain_res.subset_results):
        assert _same(a, b)
    assert (res.frozen_at, res.chunks_saved_frac) == (plain_res.frozen_at,
                                                      plain_res.chunks_saved_frac)
    assert replans == plain_replans
    assert {key: stats.adaptive[key] for key in plain_stats.adaptive if key != "regroup_s"} == \
        {key: plain_stats.adaptive[key] for key in plain_stats.adaptive if key != "regroup_s"}
    assert "decision_gather_s" not in plain_stats.adaptive
    n_consults = sum(1 for ch in stats.chunks if ch["phase"] in ("sample", "extra"))
    assert len(stats.adaptive["decision_gather_s"]) == len(payloads) == n_consults == len(live)
    k = dcn_worker.K
    for (tag, got), ev in zip(payloads, live):
        assert tag == "adaptive_boundary" and got[0] == 0.0 and (got[1:1 + k] == 1.0).all()
        np.testing.assert_array_equal(got[1 + k:1 + 2 * k], np.asarray(ev["rhat_max"], float))
        np.testing.assert_array_equal(got[1 + 2 * k:], np.asarray(ev["ess_min"], float))


# -- the adaptive schedule over a mesh (A9c) ----------------------------------
def _replans(path, name="adaptive_mesh_replan"):
    from smk_torch.obs.reporter import read_jsonl

    return [r["attrs"] for r in read_jsonl(path)
            if r.get("kind") == "event" and r.get("name") == name]


def _log_path(log_dir):
    (name,) = os.listdir(log_dir)
    return os.path.join(log_dir, name)


@pytest.fixture(scope="module")
def adaptive_meshed(tmp_path_factory):
    """The twin's adaptive integration problem (n = 64, K = 4, m = 16,
    two chains, 80 sweeps in chunks of 10) on a 2-entry mesh: one twin
    fit on its forced CPU mesh, the port's on two virtual CPU entries fed
    the replayed JAX keys, and the port's unmeshed fit."""
    from test_torch_adaptive import ADAPT, _port_fit, _twin_fit, _twin_problem

    prob = _twin_problem(64, 4)
    jdir, pdir = tmp_path_factory.mktemp("jlog"), tmp_path_factory.mktemp("plog")
    twin = _twin_fit(prob, dict(ADAPT, run_log_dir=str(jdir)), mesh=_twin_mesh(2))
    port = _port_fit(prob, dict(ADAPT, run_log_dir=str(pdir)), mesh=_port_mesh(2))
    plain = _port_fit(prob, ADAPT)
    return {"twin": twin, "port": port, "plain": plain,
            "twin_log": _log_path(str(jdir)), "port_log": _log_path(str(pdir))}


def test_adaptive_fit_on_two_entries_matches_twin(adaptive_meshed):
    from test_torch_adaptive import FIELDS

    (twin_res, twin_stats), (port_res, port_stats) = adaptive_meshed["twin"], \
        adaptive_meshed["port"]
    ja, pa = twin_stats.adaptive, port_stats.adaptive
    for key in ("frozen_at", "kept_counts", "subset_chunks_dispatched",
                "subset_chunks_baseline", "chunks_saved_frac", "extra_granted", "n_frozen"):
        assert pa[key] == ja[key], key
    # every rung a device multiple: the dispatch groups are even
    assert {ch["kc"] for ch in port_stats.chunks if "kc" in ch} <= {0, 2, 4}
    for f in FIELDS:
        got = getattr(port_res, f).numpy()
        want = np.asarray(getattr(twin_res, f))
        np.testing.assert_allclose(got, want.reshape(got.shape), equal_nan=True, err_msg=f,
                                   **TOL)
    # the replan events, with the twin's keys and values
    assert _replans(adaptive_meshed["port_log"]) == _replans(adaptive_meshed["twin_log"])


def test_adaptive_rungs_on_two_entries_differ_from_the_unmeshed_ladder(adaptive_meshed):
    """On one entry the ladder compacts 4 -> 3 -> ...; on two every rung
    is even, so the meshed schedule is its own (the twin's) and not the
    unmeshed one's."""
    port_stats, plain_stats = adaptive_meshed["port"][1], adaptive_meshed["plain"][1]
    meshed_rungs = {ch["kc"] for ch in port_stats.chunks if "kc" in ch}
    plain_rungs = {ch["kc"] for ch in plain_stats.chunks if "kc" in ch}
    assert all(r % 2 == 0 for r in meshed_rungs)
    assert meshed_rungs != plain_rungs


def _recording(base, script, log):
    """The scheduler with the live R-hat replaced by ``script`` (the
    twin's budget-freeze-and-reopen scenario); every observe (its
    arguments and decision) and mark_stopped call is logged in order."""
    class Recording(base):
        def observe(self, **kw):
            step = getattr(self, "_step", 0)
            self._step = step + 1
            kw["rhat_max"] = np.asarray(script[step], np.float64)
            kw["ess_min"] = np.full(8, 99.0)
            log.append(("observe", dict(kw)))
            dec = super().observe(**kw)
            log.append(("decision", dec))
            return dec

        def mark_stopped(self, ids, it):
            log.append(("mark_stopped", (list(ids), it)))
            return super().mark_stopped(ids, it)
    return Recording


def test_adaptive_on_four_entries_replays_in_the_twins_scheduler(tmp_path, one_torch_thread):
    """K = 8 on a 4-entry mesh, the scheduler scripted (the port's own
    noise; no twin fit): the boundaries the executor consulted, replayed
    on the host in the twin's AdaptiveScheduler(n_devices=4), give the
    same decisions and summary; each compaction of a live group is one
    replan event whose kc is the twin's rung and whose plan is the
    twin's planner's (one full-mesh entry)."""
    from smk_tpu.config import SMKConfig as JaxConfig
    from smk_tpu.parallel import schedule as jsched
    from smk_torch.parallel import schedule as tsched
    from test_torch_adaptive import BAD, CHUNK, GOOD, REOPEN, _dec

    # five subsets converge at the first boundary (8 -> 3 live: the
    # rung 4 on four entries), two more at the second, the last one
    # needs an extra chunk
    script = [[GOOD] * 5 + [BAD] * 3, [1] * 5 + [GOOD, GOOD, BAD]] + [[1] * 7 + [BAD]] * 2 + [
        [1] * 7 + [GOOD]] * 4

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
    part = partition.random_partition(partition.random_permutation(g, n, "cpu"), y, x,
                                      coords, 8)
    cfg = SMKConfig(**dict(REOPEN, run_log_dir=str(tmp_path)))
    model = tp.SpatialGPSampler(cfg)
    noise = model.default_noise(recovery.stacked_subset_data(part, ct, xt), seed=5)
    log, stats = [], ChunkPipelineStats()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(recovery, "AdaptiveScheduler",
                   _recording(tsched.AdaptiveScheduler, script, log))
        res = recovery.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=CHUNK,
                                           pipeline_stats=stats, mesh=_port_mesh(4))
    assert torch.isfinite(res.param_grid).all()
    twin = jsched.AdaptiveScheduler(JaxConfig(**REOPEN), k=8, n_kept=40, chunk_iters=CHUNK,
                                    n_devices=4)
    n_obs = 0
    for i, (kind, val) in enumerate(log):
        if kind == "observe":
            got = _dec(twin.observe(**val))
            assert got == _dec(log[i + 1][1]), i
            n_obs += 1
        elif kind == "mark_stopped":
            twin.mark_stopped(*val)
    assert 3 <= n_obs < len(script)
    summary = twin.summary()
    assert {key: stats.adaptive[key] for key in summary} == summary
    path = _log_path(str(tmp_path))
    comps = [e for e in _replans(path, "adaptive_compaction") if e["n_active"] > 0]
    replans = _replans(path)
    assert len(comps) >= 1 and len(replans) == len(comps)
    for comp, ev in zip(comps, replans):
        kc, n_active = ev["kc"], ev["n_active"]
        assert (kc, n_active) == (comp["kc"], comp["n_active"])
        assert kc == twin.rung(n_active) and kc % 4 == 0
        assert ev["entries"] == len(jbuckets.plan_ragged_mesh([8], [kc], 4).entries) == 1
        assert ev["rung_pad_waste_frac"] == (kc - n_active) / kc


def test_precompile_on_a_mesh_leaves_the_fit_nothing_to_acquire():
    part, ct, xt = _chunked_problem()
    model = tp.SpatialGPSampler(SMKConfig(n_subsets=KSUB, n_samples=12))
    mesh = _port_mesh(2)
    report = warmup.precompile(model, part, ct, xt, chunk_iters=4, mesh=mesh)
    assert report["topology"] == programs.topology_fingerprint(mesh)
    assert report["n_programs"] >= 3
    stats = ChunkPipelineStats()
    recovery.fit_subsets_chunked(model, part, ct, xt, chunk_iters=4, mesh=mesh,
                                 pipeline_stats=stats)
    assert stats.programs and {p["source"] for p in stats.programs} == {"l1"}
    spec = warmup.precompile(model, part, ct, xt, chunk_iters=4, mesh_spec=((2,), "cpu"))
    assert spec["topology"] == report["topology"]


def test_meshed_fit_writes_a_gather_span(tmp_path):
    y, x, coords, ct, xt = _problem()
    res = fit_meta_kriging(y, x, coords, ct, xt, config=SMKConfig(
        n_subsets=KSUB, n_samples=8, run_log_dir=str(tmp_path)), device="cpu", n_devices=2)
    names = [json.loads(line).get("name") for line in open(res.run_log_path)]
    assert "gather" in names


# -- the sharded Cholesky ------------------------------------------------------


def _spd(m, seed=0):
    a = np.random.default_rng(seed).normal(size=(m, m)).astype(np.float32)
    return (a @ a.T / m + np.eye(m, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("m,b", [(96, 16), (40, 8)])
def test_sharded_cholesky_matches_twin_and_blocked(m, b):
    s = _spd(m)
    got = sharded_chol.sharded_cholesky(torch.as_tensor(s), _port_mesh(8), jitter=1e-4,
                                        block_size=b)
    assert len(got.blocks) == 8
    full = got.gather().numpy()
    want = np.asarray(jsc.sharded_cholesky(jnp.asarray(s), _twin_mesh(8), jitter=1e-4,
                                           block_size=b))
    np.testing.assert_allclose(full, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(full, np.asarray(jax_blocked_cholesky(jnp.asarray(s), 1e-4, b)),
                               atol=2e-5, rtol=2e-5)
    assert torch.equal(torch.as_tensor(full),
                       blocked_cholesky(torch.as_tensor(s), 1e-4, b))
    v = np.random.default_rng(1).normal(size=(m,)).astype(np.float32)
    mv = sharded_chol.sharded_matvec(torch.as_tensor(s), torch.as_tensor(v), _port_mesh(8))
    jmv = jsc.sharded_matvec(jnp.asarray(s), jnp.asarray(v), _twin_mesh(8))
    np.testing.assert_allclose(mv.gather().numpy(), np.asarray(jmv), atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        sharded_chol.row_sharding(_FakeMultiMesh())


class _FakeMultiMesh:
    multi_process = True


# -- the kernel wrapper's device -------------------------------------------------


def test_the_kernel_launches_on_its_output_device(monkeypatch):
    """The launch enters ``torch.cuda.device(out.device)`` around the
    ctypes call, so a thread whose current device is another card
    launches on the output's (and the launcher sizes its grid for it)."""
    entered, calls = [], []

    @contextlib.contextmanager
    def fake_device(dev):
        entered.append(dev)
        yield
        entered.append("exit")

    class Stream:
        cuda_stream = 7

    def fake_kernel(dtype):
        def call(*args):
            calls.append((dtype, args[-1], list(entered)))
            return 0
        return call

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: Stream())
    monkeypatch.setattr(fused_build, "_kernel", fake_kernel)
    ca = torch.zeros(1, 5, 2)
    # an output on the second card (the pointers are not dereferenced)
    out = types.SimpleNamespace(shape=(1, 1, 5, 5), dtype=torch.float32,
                                device=torch.device("cuda", 1), data_ptr=lambda: 0)
    fused_build._launch(ca, ca, torch.ones(1, 1), None, None, "exponential", True, out,
                        fused_build.NARROW)
    assert calls == [(torch.float32, 7, [out.device])]
    assert entered == [out.device, "exit"]
