"""The port's chunked, checkpointed executor (smk_torch/parallel/recovery.py,
smk_torch/utils/checkpoint.py, smk_torch/utils/tracing.ChunkPipelineStats)
against the JAX package's.

The JAX executor carries its PRNG key in the chain state; the port draws
from a noise source that the executor snapshots, restores and forks.
``ChunkedJaxReplay`` below is that source for the tests: it replays the
JAX key schedule of every (subset, chain) row (JaxSweepReplay's draws,
tests/test_torch_sampler.py), and holds the rows' keys in one store so
that a source of some rows (``rows``) draws, snapshots, restores and
forks exactly those keys — its ``fork`` is the twin's
``fold_in(held_key, attempt)``, on the key held at chunk start. Both
executors then consume the same numbers, chunk for chunk.

Sizes: K = 4 subsets of m = 24, q = 1, p = 2, t = 5, 16 sweeps (12
burn-in) in chunks of 4, and a two-chain, K-chunked (chunk_size = 2),
phi-every-2nd-sweep variant. The JAX reference fits run once each in a
module fixture. Tolerance: the sweep tolerance of
tests/test_torch_sampler.py (5e-5 absolute + 5e-5 relative); the port
against itself (kill and resume) is held bitwise.
"""

# smklint: test-budget=two JAX chunked reference fits (K=4, m=24, 16 sweeps in chunks of 4), one JAX rerun and the C5 pair (float32 and float64, 24 sweeps) in module fixtures; every test runs the port at that size on the CPU
import ast
import os
import pathlib
import warnings
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.models.probit_gp import SubsetResult as JaxResult
from smk_tpu.parallel import partition as jpart
from smk_tpu.parallel import recovery as jrec
from smk_tpu.utils.tracing import ChunkPipelineStats as JaxStats
from smk_torch import convert
from smk_torch.config import SMKConfig
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import recovery as rec
from smk_torch.testing.faults import corrupt_segment, inject_subset_nan
from smk_torch.utils import checkpoint as ckpt
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_sampler import jax_sweep_noise, to_sweep_noise

K, N, Q, P, T = 4, 96, 1, 2, 5
CHUNK = 4
TOL = dict(atol=5e-5, rtol=5e-5)
BASE = dict(n_subsets=K, n_samples=16, burn_in_frac=0.75)
VARIANTS = {
    "base": (BASE, None),
    "chains2-chunked-every2": (dict(BASE, n_chains=2, phi_update_every=2), 2),
}
# the kill-and-resume legs (port against port): three burn-in and three
# sampling chunks, so kills land before and after the first segments
KILL = dict(BASE, n_samples=24, burn_in_frac=0.5)
REPO = pathlib.Path(__file__).resolve().parents[1]
RESULT_FIELDS = ("param_grid", "w_grid", "phi_accept_rate", "param_samples", "w_samples")


class ChunkedJaxReplay:
    """A noise source replaying the JAX key schedule of its rows, with
    the executor's operations (models/probit_gp.NoiseSource): ``rows``
    shares the rows' keys with this source, ``snapshot``/``restore``
    are the keys (and sweep counters) at a boundary, ``fork`` folds the
    attempt into the held keys of the masked rows, ``identity`` names
    the initial keys."""

    def __init__(self, keys, shapes: tp.SweepShapes, *, collapsed=False, dtype=jnp.float32,
                 _store=None, _ids=None):
        if _store is None:
            data = np.asarray(jax.random.key_data(keys))
            _store = {"keys": data.copy(), "initial": data.copy(),
                      "next": np.zeros(data.shape[0], np.int64)}
        self.store = _store
        self.ids = np.arange(shapes.k) if _ids is None else np.asarray(_ids, np.int64)
        self.shapes = shapes
        self.collapsed = collapsed
        self.dtype = dtype
        self._draw = _draw_fn(shapes._replace(k=0), collapsed, dtype)

    def __call__(self, it, collect):
        assert (self.store["next"][self.ids] == it).all(), "sweeps replay in order"
        new, arrays = self._draw(self.store["keys"][self.ids])
        self.store["keys"][self.ids] = np.asarray(jax.random.key_data(new))
        self.store["next"][self.ids] += 1
        return to_sweep_noise(arrays, collect)

    def rows(self, ids, *, m=None):
        ids = self.ids[np.asarray(list(ids), np.int64)]
        shapes = self.shapes._replace(k=len(ids), m=self.shapes.m if m is None else m)
        return ChunkedJaxReplay(None, shapes, collapsed=self.collapsed, dtype=self.dtype,
                                _store=self.store, _ids=ids)

    def snapshot(self):
        return {"keys": self.store["keys"][self.ids].copy(),
                "next": self.store["next"][self.ids].copy()}

    def restore(self, snap):
        self.store["keys"][self.ids] = np.asarray(snap["keys"])
        self.store["next"][self.ids] = np.asarray(snap["next"])

    def fork(self, mask, attempts):
        for r in np.flatnonzero(np.asarray(mask, bool)):
            i = self.ids[r]
            key = jax.random.wrap_key_data(jnp.asarray(self.store["keys"][i]))
            folded = jax.random.fold_in(key, jnp.int32(attempts[r]))
            self.store["keys"][i] = np.asarray(jax.random.key_data(folded))

    def identity(self):
        return self.store["initial"][self.ids].tobytes()


_DRAWS = {}


def _draw_fn(shapes, collapsed, dtype=jnp.float32):
    """One jitted, vmapped sweep draw per row shape and dtype (shared by
    every source of those shapes, so the tests compile it once)."""
    key = (shapes, collapsed, jnp.dtype(dtype).name)
    if key not in _DRAWS:
        _DRAWS[key] = jax.jit(jax.vmap(lambda kk: jax_sweep_noise(
            jax.random.wrap_key_data(kk), shapes.m, shapes.q, shapes.p, shapes.t,
            shapes.weight, collapsed=collapsed, link=shapes.link, n_terms=shapes.pg_n_terms,
            proposals=shapes.proposals, family=shapes.family, dtype=dtype,
        )))
    return _DRAWS[key]


def replay(key, cfg, k, m, q=Q, p=P, t=T):
    """The port's noise for a JAX fit of ``k`` subsets with fan-out
    ``key`` (the twin's subset_chain_keys: split(key, k * n_chains)), in
    the fit's dtype (a float64 fit under jax.enable_x64 draws float64)."""
    shapes = tp.sweep_shapes(cfg, k, m, q, p, t)
    return ChunkedJaxReplay(jax.random.split(key, shapes.k), shapes,
                            collapsed=cfg.phi_sampler == "collapsed",
                            dtype=jnp.dtype(cfg.dtype))


def _problem(seed=7, t=T):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = np.concatenate([np.ones((N, Q, 1)), rng.normal(size=(N, Q, P - 1))],
                       -1).astype(np.float32)
    y = rng.integers(0, 2, size=(N, Q)).astype(np.float32)
    ct = rng.uniform(size=(t, 2)).astype(np.float32)
    xt = rng.normal(size=(t, Q, P)).astype(np.float32)
    jp = jpart.random_partition(jax.random.key(0), *map(jnp.asarray, (y, x, coords)), K)
    return jp, jnp.asarray(ct), jnp.asarray(xt), jax.random.key(1)


@pytest.fixture(scope="module")
def problem():
    jp, ct, xt, key = _problem()
    return {"jpart": jp, "ct": ct, "xt": xt, "key": key,
            "part": convert.partition_from_numpy(jp, device="cpu"),
            "ct_t": torch.as_tensor(np.array(ct)), "xt_t": torch.as_tensor(np.array(xt))}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def reference(request, problem):
    """The JAX chunked fit of a variant, with its progress calls and its
    pipeline statistics."""
    kw, chunk_size = VARIANTS[request.param]
    calls, stats = [], JaxStats()
    res = jrec.fit_subsets_chunked(
        JaxSampler(JaxConfig(**kw)), problem["jpart"], problem["ct"], problem["xt"],
        problem["key"], chunk_iters=CHUNK, chunk_size=chunk_size, progress=calls.append,
        pipeline_stats=stats,
    )
    port_calls, port_stats = [], ChunkPipelineStats()
    port = port_fit(problem, kw, chunk_size=chunk_size, progress=port_calls.append,
                    pipeline_stats=port_stats)
    return {"kw": kw, "chunk_size": chunk_size, "res": res, "calls": calls, "stats": stats,
            "port": port, "port_calls": port_calls, "port_stats": port_stats}


def port_fit(problem, kw, *, key=None, part=None, **opts):
    cfg = SMKConfig(**kw)
    part = problem["part"] if part is None else part
    noise = replay(problem["key"] if key is None else key, cfg, K, part.subset_size)
    return rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), part, problem["ct_t"],
                                   problem["xt_t"], noise, chunk_iters=CHUNK, **opts)


@pytest.mark.parametrize("field", RESULT_FIELDS)
def test_chunked_fit_matches_twin_draw_for_draw(reference, field):
    want = np.asarray(getattr(reference["res"], field))
    np.testing.assert_allclose(getattr(reference["port"], field).numpy(), want, **TOL)


def test_progress_matches_twin_call_for_call(reference):
    calls, want = reference["port_calls"], reference["calls"]
    assert [(c["phase"], c["iteration"], c["n_samples"]) for c in calls] == [
        (c["phase"], c["iteration"], c["n_samples"]) for c in want]
    assert sorted(calls[0]) == sorted(want[0])
    np.testing.assert_allclose([c["phi_accept_rate"] for c in calls],
                               [c["phi_accept_rate"] for c in want], atol=1e-6)


def test_pipeline_stats_aggregate_has_the_twins_keys(reference):
    stats = reference["port_stats"]
    got, want = stats.aggregate(), reference["stats"].aggregate()
    assert sorted(got) == sorted(want)
    for key in ("mode", "n_chunks", "ckpt_bytes", "ckpt_generations", "fault",
                "live_rhat_final", "ess_per_second", "adaptive", "ragged_groups"):
        assert got[key] == want[key], key
    assert [c["iteration"] for c in stats.chunks] == [
        c["iteration"] for c in reference["stats"].chunks]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_kill_and_resume_is_exact(problem, variant, tmp_path):
    """Killed in the burn-in, killed again after one sampling segment
    (the second resume compacts two segments into one), resumed:
    bitwise the uninterrupted run."""
    kw, chunk_size = VARIANTS[variant]
    kw = dict(kw, **KILL)
    path = str(tmp_path / "kill.npz")
    full = port_fit(problem, kw, chunk_size=chunk_size)
    assert port_fit(problem, kw, chunk_size=chunk_size, checkpoint_path=path,
                    stop_after_chunks=2) is None
    assert os.path.exists(path)
    assert port_fit(problem, kw, chunk_size=chunk_size, checkpoint_path=path,
                    stop_after_chunks=2) is None
    assert os.path.exists(ckpt.segment_path(path, 0))
    assert port_fit(problem, kw, chunk_size=chunk_size, checkpoint_path=path,
                    stop_after_chunks=1) is None
    resumed = port_fit(problem, kw, chunk_size=chunk_size, checkpoint_path=path)
    assert os.path.exists(ckpt.segment_path(path, 2))  # the compacted segment
    assert not os.path.exists(ckpt.segment_path(path, 0))
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_overlap_kill_and_resume_is_exact(problem, variant, tmp_path):
    """The overlap pipeline (K pieces and two chains included): killed
    after one sampling segment and resumed, bitwise the uninterrupted sync
    run."""
    kw, chunk_size = VARIANTS[variant]
    kw = dict(kw, **KILL)
    ov = dict(kw, chunk_pipeline="overlap")
    path = str(tmp_path / "kill.npz")
    full = port_fit(problem, kw, chunk_size=chunk_size)
    assert port_fit(problem, ov, chunk_size=chunk_size, checkpoint_path=path,
                    stop_after_chunks=4) is None
    assert os.path.exists(ckpt.segment_path(path, 0))
    resumed = port_fit(problem, ov, chunk_size=chunk_size, checkpoint_path=path)
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(full, f), getattr(resumed, f)), f


def test_resume_restores_the_carried_layout(problem, tmp_path, monkeypatch):
    """The sampler's factor is column-major; a resumed chain gets its
    leaves back with the strides the uninterrupted run carried into the
    same chunk (on the card a solve against a contiguous copy rounds
    differently), by the manifest's layout."""
    seen = {}
    real = rec._run_chunk

    def spy(model, kind, pieces, state, start, n):
        seen.setdefault(start, []).append([tuple(t.stride()) for t in state])
        return real(model, kind, pieces, state, start, n)

    monkeypatch.setattr(rec, "_run_chunk", spy)
    path = str(tmp_path / "l.npz")
    port_fit(problem, KILL)
    assert port_fit(problem, KILL, checkpoint_path=path, stop_after_chunks=4) is None
    port_fit(problem, KILL, checkpoint_path=path)
    cols = seen[16][0][-1]
    assert cols[-2] == 1  # chol_r column-major in the chain itself
    for start in (16, 20):
        assert seen[start][0] == seen[start][1], start


def test_resume_of_a_finished_run_returns_it(problem, tmp_path):
    path = str(tmp_path / "done.npz")
    first = port_fit(problem, BASE, checkpoint_path=path)
    again = port_fit(problem, BASE, checkpoint_path=path)
    assert torch.equal(first.param_samples, again.param_samples)


def test_checkpointed_fit_matches_the_unchunked_port_fit(problem):
    """Chunking and the cache rebuilt at each boundary change nothing on
    the CPU: the chunked draws are bitwise the one-pass run's."""
    cfg = SMKConfig(**BASE)
    model = tp.SpatialGPSampler(cfg)
    part = problem["part"]
    data = tp.SubsetData(part.coords, part.x, part.y, part.mask, problem["ct_t"],
                         problem["xt_t"])
    one_pass = model.run(data, model.init_state(data), replay(problem["key"], cfg, K,
                                                              part.subset_size))
    chunked = port_fit(problem, BASE)
    assert torch.equal(one_pass.param_samples, chunked.param_samples)


@pytest.fixture
def checkpointed(problem, tmp_path):
    path = str(tmp_path / "c.npz")
    port_fit(problem, BASE, checkpoint_path=path, stop_after_chunks=1)
    return path


def test_mismatched_config_rejected(problem, checkpointed):
    with pytest.raises(ValueError, match="different run"):
        port_fit(problem, dict(BASE, n_samples=20), checkpoint_path=checkpointed)


def test_same_shapes_different_chain_rejected(problem, checkpointed):
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        port_fit(problem, BASE, key=jax.random.key(99), checkpoint_path=checkpointed)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        port_fit(problem, dict(BASE, cov_model="matern32"), checkpoint_path=checkpointed)


def test_single_data_change_rejected(problem, checkpointed):
    part = problem["part"]
    coords = part.coords.clone()
    coords[1, 3, 0] += 1e-3
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        port_fit(problem, BASE, part=part._replace(coords=coords),
                 checkpoint_path=checkpointed)


def test_fault_knobs_stay_resume_legal(problem, checkpointed):
    """As in the twin, the fault policy is not part of the run identity:
    an abort checkpoint resumes under quarantine."""
    res = port_fit(problem, dict(BASE, fault_policy="quarantine", fault_max_retries=1),
                   checkpoint_path=checkpointed)
    assert torch.isfinite(res.param_samples).all()


def test_bad_chunk_iters_rejected(problem):
    with pytest.raises(ValueError, match="chunk_iters"):
        rec.fit_subsets_chunked(tp.SpatialGPSampler(SMKConfig(**BASE)), problem["part"],
                                problem["ct_t"], problem["xt_t"], chunk_iters=0)


def test_nan_guard_names_the_subset_before_the_first_save(problem, tmp_path):
    path = str(tmp_path / "nan.npz")
    with inject_subset_nan(2, 1):
        with pytest.raises(rec.SubsetNaNError) as ei:
            port_fit(problem, BASE, nan_guard=True, checkpoint_path=path)
    assert ei.value.subset_ids == [2] and ei.value.iteration == CHUNK
    assert not os.path.exists(path)


def test_nan_guard_keeps_the_last_finite_checkpoint(problem, tmp_path):
    path = str(tmp_path / "nan2.npz")
    with inject_subset_nan(1, 9):
        with pytest.raises(rec.SubsetNaNError, match=r"subsets \[1\] at iteration 12"):
            port_fit(problem, BASE, nan_guard=True, checkpoint_path=path)
    state = np.load(path)
    leaves = [state[f] for f in state.files if f.startswith("leaf_")]
    assert all(np.isfinite(a).all() for a in leaves if a.dtype.kind == "f")


def test_progress_abort_stops_and_other_errors_warn_once(problem):
    class Stop(rec.ProgressAbort):
        pass

    def stop(info):
        if info["iteration"] >= 8:
            raise Stop()

    with pytest.raises(Stop):
        port_fit(problem, BASE, progress=stop)

    def broken(info):
        raise KeyError("logging hook")

    with pytest.warns(RuntimeWarning, match="progress callback raised") as rec_w:
        res = port_fit(problem, BASE, progress=broken)
    assert len([w for w in rec_w if "progress callback" in str(w.message)]) == 1
    assert torch.isfinite(res.param_samples).all()


def test_pytree_round_trip(tmp_path):
    tree = {"state": tp.SamplerState(*(torch.arange(6.0).reshape(2, 3) + i
                                       for i in range(7))),
            "noise": {"keys": np.arange(4, dtype=np.uint32), "next": np.zeros(2)},
            "it": np.asarray([3])}
    path = str(tmp_path / "t.npz")
    assert ckpt.save_pytree(path, tree) == os.path.getsize(path)
    got = ckpt.load_pytree(path, tree)
    assert isinstance(got["state"], tp.SamplerState)
    for a, b in zip(got["state"], tree["state"]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(got["noise"]["keys"], tree["noise"]["keys"])
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.load_pytree(path, {**tree, "it": [np.zeros(1)]})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_pytree(path, {"it": np.zeros(1)})


def test_segment_checksum_and_truncation_are_caught(tmp_path):
    path = str(tmp_path / "s.npz")
    rng = np.random.default_rng(0)
    param, w = rng.normal(size=(4, 3, 5)), rng.normal(size=(4, 3, 2))
    ckpt.save_segment(path, 0, param, w, 0, 3)
    seg = ckpt.load_segment(path, 0)
    np.testing.assert_array_equal(seg["param"], param)
    assert (seg["start"], seg["stop"]) == (0, 3)
    corrupt_segment(path, 0, "bitflip")
    with pytest.raises(ValueError, match="checksum"):
        ckpt.load_segment(path, 0)
    ckpt.save_segment(path, 1, param, w, 0, 3)
    corrupt_segment(path, 1, "truncate")
    with pytest.raises((ValueError, OSError, zipfile.BadZipFile)):
        ckpt.load_segment(path, 1)
    # the twin's checksum over the same payload
    from smk_tpu.utils.checkpoint import segment_checksum

    assert ckpt.segment_checksum(param, w, 0, 3) == segment_checksum(param, w, 0, 3)


def test_writes_go_to_a_temp_file_then_os_replace(tmp_path, monkeypatch):
    seen = []
    real = os.replace

    def spy(src, dst):
        seen.append((src, dst, os.path.exists(dst)))
        real(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    path = str(tmp_path / "m.npz")
    ckpt.save_pytree(path, {"a": np.zeros(3)})
    ckpt.save_segment(path, 0, np.zeros((1, 1, 1)), np.zeros((1, 1, 1)), 0, 1)
    ckpt.save_sidecar(path, "sched", {"b": np.ones(2)})
    assert [(s, d) for s, d, _ in seen] == [
        (path + ".tmp", path),
        (ckpt.segment_path(path, 0) + ".tmp", ckpt.segment_path(path, 0)),
        (ckpt.sidecar_path(path, "sched") + ".tmp", ckpt.sidecar_path(path, "sched")),
    ]
    assert not any(existed for _, _, existed in seen)
    assert ckpt.load_sidecar(path, "sched")["b"].tolist() == [1.0, 1.0]


def _truncating_writes(tree):
    """(function, line) of each truncating write in a module: open() in
    a "w" mode, np.save/np.savez/torch.save — in a function that does
    not also call os.replace."""
    out = []

    def is_write(call):
        f = call.func
        name = getattr(f, "attr", getattr(f, "id", ""))
        owner = getattr(getattr(f, "value", None), "id", "")
        if name in ("save", "savez", "savez_compressed") and owner in ("np", "numpy", "torch"):
            return True
        if name == "open" and len(call.args) > 1:
            mode = call.args[1]
            return isinstance(mode, ast.Constant) and "w" in str(mode.value)
        return False

    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        replaces = any(getattr(c.func, "attr", "") == "replace"
                       and getattr(c.func.value, "id", "") == "os" for c in calls)
        out += [(fn.name, c.lineno) for c in calls if is_write(c) and not replaces]
    return out


def test_durable_modules_hold_the_atomic_write_discipline():
    for rel in ("smk_torch/utils/checkpoint.py", "smk_torch/parallel/recovery.py"):
        tree = ast.parse((REPO / rel).read_text())
        assert _truncating_writes(tree) == [], rel


@pytest.fixture(scope="module")
def reruns(problem):
    """A port fit with subset 1's grid poisoned, and the twin's
    find_failed_subsets and rerun_subsets of it (the twin compiles its
    whole-run program here, once)."""
    port_res = port_fit(problem, BASE)
    port_bad = port_res._replace(param_grid=port_res.param_grid.clone())
    port_bad.param_grid[1, 3, 0] = float("nan")
    bad = JaxResult(*(jnp.asarray(f.numpy()) for f in port_bad))
    failed = jrec.find_failed_subsets(bad)
    want = jrec.rerun_subsets(JaxSampler(JaxConfig(**BASE)), problem["jpart"], problem["ct"],
                              problem["xt"], problem["key"], bad, [1])
    return port_bad, failed, want


def test_find_failed_subsets_and_rerun_match_twin(problem, reruns):
    port_bad, failed, want = reruns
    np.testing.assert_array_equal(failed, [1])
    np.testing.assert_array_equal(rec.find_failed_subsets(port_bad), [1])
    cfg = SMKConfig(**BASE)
    got = rec.rerun_subsets(tp.SpatialGPSampler(cfg), problem["part"], problem["ct_t"],
                            problem["xt_t"], replay(problem["key"], cfg, K,
                                                    problem["part"].subset_size),
                            port_bad, [1])
    for f in ("param_grid", "param_samples", "w_grid"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   **TOL)
    assert torch.isfinite(got.param_grid).all()


def test_generator_noise_rows_snapshot_restore_and_fork():
    gens = tp.subset_generators(3, 4, "cpu")
    shapes = tp.SweepShapes(k=4, m=6, q=1, p=2, t=3)
    noise = tp.GeneratorNoise(gens, shapes)
    snap = noise.snapshot()
    first = noise(0, True)
    noise.restore(snap)
    assert torch.equal(noise(0, True).ku_prior, first.ku_prior)
    noise.restore(snap)
    sub = noise.rows([2, 0], m=5)
    assert sub.shapes.k == 2 and sub.shapes.m == 5
    part = sub(0, False)
    assert part.ku_prior.shape == (2, 1, 5)
    noise.restore(snap)
    noise.fork(np.array([False, True, False, False]), np.array([0, 1, 0, 0]))
    forked = noise(0, True)
    assert torch.equal(forked.ku_prior[[0, 2, 3]], first.ku_prior[[0, 2, 3]])
    assert not torch.equal(forked.ku_prior[1], first.ku_prior[1])
    again = tp.GeneratorNoise(tp.subset_generators(3, 4, "cpu"), shapes)
    again.fork(np.array([False, True, False, False]), np.array([0, 1, 0, 0]))
    assert torch.equal(again(0, True).ku_prior[1], forked.ku_prior[1])  # deterministic
    assert noise.identity() == again.identity() != tp.GeneratorNoise(
        tp.subset_generators(4, 4, "cpu"), shapes).identity()


def test_default_noise_checkpointed_fit_resumes_exactly(problem, tmp_path):
    """The port's own generators (GeneratorNoise, as fit_meta_kriging
    draws them) resume bitwise across a fresh model and a fresh source."""
    cfg = SMKConfig(**dict(BASE, n_chains=2))
    part = problem["part"]

    def run(**kw):
        model = tp.SpatialGPSampler(cfg)
        data = tp.SubsetData(part.coords, part.x, part.y, part.mask, problem["ct_t"],
                             problem["xt_t"])
        return rec.fit_subsets_chunked(model, part, problem["ct_t"], problem["xt_t"],
                                       model.default_noise(data, seed=11), chunk_iters=CHUNK,
                                       **kw)

    path = str(tmp_path / "g.npz")
    full = run()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert run(checkpoint_path=path, stop_after_chunks=3) is None
        resumed = run(checkpoint_path=path)
    assert torch.equal(full.w_samples, resumed.w_samples)


# the production sampler (collapsed phi on a sparse schedule, a Nystrom-CG
# u-draw: the CG operators rebuilt at every chunk entry) and the default
# sampler (the Cholesky u-draw), both on the fused build
BUILD_VARIANTS = {
    "default": dict(fused_build="pallas"),
    "production": dict(fused_build="pallas", phi_sampler="collapsed", phi_update_every=3,
                       u_solver="cg", cg_precond="nystrom", cg_precond_rank=8, cg_iters=8,
                       cg_matvec_dtype="bfloat16", trisolve_block_size=16),
}


@pytest.mark.parametrize("variant", sorted(BUILD_VARIANTS))
@pytest.mark.parametrize("chunk_iters", [3, 4, 16])
def test_build_calls_count_the_chunk_entries(problem, variant, chunk_iters):
    """Each chunk rebuilds the solve cache from the state at its start, so
    a chunked fit calls the builds build_calls(chunk_iters=) counts (on
    the CPU the plain version runs and is counted per entry point, as
    chip_smoke.py counts the kernels' launches on the card)."""
    from smk_torch.ops import fused_build as tfb

    kw = dict(BASE, **BUILD_VARIANTS[variant])
    cfg = SMKConfig(**kw)
    tfb.reset_counts()
    rec.fit_subsets_chunked(tp.SpatialGPSampler(cfg), problem["part"], problem["ct_t"],
                            problem["xt_t"], replay(problem["key"], cfg, K,
                                                    problem["part"].subset_size),
                            chunk_iters=chunk_iters)
    want = tp.build_calls(cfg, Q, cfg.n_samples, cfg.n_burn_in, chunk_iters=chunk_iters)
    assert dict(tfb.PLAIN_CALLS) == want
    if chunk_iters >= cfg.n_samples:
        assert want == tp.build_calls(cfg, Q, cfg.n_samples, cfg.n_burn_in)


def test_guard_counts_stay_per_row_across_k_pieces(problem):
    """chunk_size sweeps the subsets in pieces; the collapsed move's
    finite-factor guard counts (instrumentation) come back per row, as
    the unchunked run's."""
    cfg = SMKConfig(**dict(BASE, phi_sampler="collapsed", phi_update_every=2))
    guards = []
    for chunk_size in (None, 2):
        model = tp.SpatialGPSampler(cfg)
        rec.fit_subsets_chunked(model, problem["part"], problem["ct_t"], problem["xt_t"],
                                replay(problem["key"], cfg, K, problem["part"].subset_size),
                                chunk_iters=CHUNK, chunk_size=chunk_size)
        guards.append(model.guard_rejects)
    assert guards[0].shape == (K,) and torch.equal(guards[0], guards[1])


# -- the kriging roundoff of the rng(11) problem (ROADMAP C5) ---------------
#
# On tests/test_torch_chunk_pipeline.py's configuration over an rng(11),
# t = 3 problem, the port's w_samples differ from the twin's by up to
# 1.1e-4 (at a |w| of ~2), the parameter draws by 1.1e-5. Run in float64,
# the two packages agree to 1e-14 on their float64 keys, so they compute
# the same function; and each float32 run sits ~1.2e-4 from the float64 run
# on its own noise (the port's float32 numbers upcast). The miss is float32
# roundoff that both packages carry: the m = 24 solves give W = R~^-1 R_c
# and chol(R_t - R_c^T W + jitter) ~2e-5 of error, the kept draws scale
# that by a|u|, and the two packages round in different orders.
C5 = dict(n_subsets=K, n_samples=24, burn_in_frac=0.5, phi_update_every=2,
          fault_policy="quarantine")
C5_T = 3


class _Float64Noise:
    """A noise source's numbers upcast to float64 (the float64 answer for
    the float32 run's draws)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, it, collect):
        return tp.SweepNoise(*(None if a is None else a.double() for a in self.inner(it, collect)))

    def rows(self, ids, **kw):
        return _Float64Noise(self.inner.rows(ids, **kw))

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _c5_fits(jp, ct, xt, key, dtype):
    """The twin's chunked fit in ``dtype`` and the port's on the twin's
    keys, as (twin, port) numpy dicts of RESULT_FIELDS."""
    np_dt = np.float64 if dtype == "float64" else np.float32
    kw = dict(C5, dtype=dtype)
    twin = jrec.fit_subsets_chunked(JaxSampler(JaxConfig(**kw)), jp, ct, xt, key,
                                    chunk_iters=CHUNK)
    part = convert.partition_from_numpy(jp, device="cpu")
    cfg = SMKConfig(**kw)
    port = rec.fit_subsets_chunked(
        tp.SpatialGPSampler(cfg), part, torch.as_tensor(np.asarray(ct, np_dt)),
        torch.as_tensor(np.asarray(xt, np_dt)), replay(key, cfg, K, part.subset_size, t=C5_T),
        chunk_iters=CHUNK)
    fields = ("param_samples", "w_samples")
    return ({f: np.asarray(getattr(twin, f), np.float64) for f in fields},
            {f: getattr(port, f).double().numpy() for f in fields})


@pytest.fixture(scope="module")
def c5():
    jp, ct, xt, key = _problem(seed=11, t=C5_T)
    twin32, port32 = _c5_fits(jp, ct, xt, key, "float32")
    part = convert.partition_from_numpy(jp, device="cpu")
    part64 = part._replace(**{f: getattr(part, f).double() for f in ("coords", "x", "y", "mask")})
    cfg = SMKConfig(**C5, dtype="float64")
    exact = rec.fit_subsets_chunked(
        tp.SpatialGPSampler(cfg), part64, torch.as_tensor(np.asarray(ct, np.float64)),
        torch.as_tensor(np.asarray(xt, np.float64)),
        _Float64Noise(replay(key, SMKConfig(**C5), K, part.subset_size, t=C5_T)),
        chunk_iters=CHUNK)
    with jax.enable_x64(True):
        cast = (jnp.asarray(np.asarray(a, np.float64)) for a in (jp.coords, jp.x, jp.y, jp.mask))
        jp64 = jp._replace(**dict(zip(("coords", "x", "y", "mask"), cast)))
        twin64, port64 = _c5_fits(jp64, jnp.asarray(np.asarray(ct, np.float64)),
                                  jnp.asarray(np.asarray(xt, np.float64)), key, "float64")
    return {"twin32": twin32, "port32": port32, "twin64": twin64, "port64": port64,
            "exact": {f: getattr(exact, f).numpy() for f in twin32}}


def test_c5_miss_reproduces_inside_the_sweep_tolerance(c5):
    """The miss is there (over 5e-5 absolute on w) and the port meets the
    sweep tolerance, 5e-5 + 5e-5 |x|, on every draw."""
    diff = np.abs(c5["port32"]["w_samples"] - c5["twin32"]["w_samples"])
    assert diff.max() > 5e-5
    for f in ("param_samples", "w_samples"):
        np.testing.assert_allclose(c5["port32"][f], c5["twin32"][f], **TOL)


def test_c5_float64_runs_of_both_packages_agree(c5):
    for f in ("param_samples", "w_samples"):
        np.testing.assert_allclose(c5["port64"][f], c5["twin64"][f], atol=1e-10, rtol=1e-10)


def test_c5_both_float32_runs_sit_as_far_from_float64(c5):
    """Each package's float32 w draws against the float64 run on the same
    numbers: the two distances are within a factor of two of each other
    (~1.2e-4 each), and the port-twin gap is no wider than their sum. (The
    parameter draws sit 1.7e-5 and 7.7e-6 from it, inside the tolerance.)"""
    exact = c5["exact"]["w_samples"]
    e_port = np.abs(c5["port32"]["w_samples"] - exact).max()
    e_twin = np.abs(c5["twin32"]["w_samples"] - exact).max()
    assert 0.5 <= e_port / e_twin <= 2.0, (e_port, e_twin)
    gap = np.abs(c5["port32"]["w_samples"] - c5["twin32"]["w_samples"]).max()
    assert gap <= e_port + e_twin
