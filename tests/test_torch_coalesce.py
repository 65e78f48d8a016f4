"""Cross-request coalescing in the port (smk_torch/serve/coalesce.py, the
engine's row-seed path in serve/engine.py, obs/summarize.serve_block)
against the JAX package's, on the CPU.

The artifact is made, not fitted: 40 draws at t = 6 anchors, q = 1,
p = 2, written by the port's save_artifact and read by both packages, so
no fit runs here. The twin's window-armed engine is built without a
program store (its own ``TestCoalescing`` fixture loads AOT programs from
the store, which depends on the compiling machine's CPU features).

- **The row noise law**: the port's row-seed program handed a
  ``row_noise`` that draws ``jax.random.normal(fold_in(key(seed), row),
  (S, q))`` per row receives, for a packed and padded slice, exactly the
  twin's numbers called directly, and serves what the twin's row-seed
  program serves at 5e-5 + 5e-5 |x| (the port composes in float64, the
  twin in float32).
- **Coalescing**: concurrent requests on a window-armed port engine go
  out in fewer dispatches than requests, each response bitwise the same
  request served alone; deadline-critical requests are never held;
  ``held_s`` stays within the deadline; a NaN row degrades only the
  request that owns it; ``serve_block`` of the port's run log is the
  twin's.
- **The default row noise** (``hash_row_noise``): N(0, 1) moments at
  1e5 draws, and each row's draws independent of its packing.
"""

# smklint: test-budget=no fit: a made artifact; one twin window-armed engine (two buckets, ~3 s of compiles) in a module fixture; each coalescing test holds a few requests for a 0.4 s window
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu import serve as jserve
from smk_tpu.obs import summarize as jsummarize
from smk_torch.config import SMKConfig
from smk_torch.obs import summarize as tsummarize
from smk_torch.serve import DeadlineBudget, PredictionEngine, hash_row_noise, save_artifact
from smk_torch.testing.faults import inject_predict_nan

S, T, Q, P = 40, 6, 1, 2
BUCKETS = (4, 8)
WINDOW_MS = 400.0
TOL = dict(atol=5e-5, rtol=5e-5)


def _queries(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, Q, P)).astype(np.float32))


@pytest.fixture(scope="module")
def artifact_path(tmp_path_factory):
    """A made fit: sorted quantile grids (betas, the K entry, phi in
    [3, 8]) and draws, saved by the port (its anchor factor built here)."""
    rng = np.random.default_rng(17)
    n_q, n_par = 21, Q * P + Q * (Q + 1) // 2 + Q
    grid = np.sort(rng.normal(size=(n_q, n_par)), axis=0)
    grid[:, Q * P] = np.linspace(0.5, 1.5, n_q)
    grid[:, -Q:] = np.linspace(3.0, 8.0, n_q)[:, None]
    fit = types.SimpleNamespace(
        sample_par=grid[rng.integers(0, n_q, S)].astype(np.float32),
        sample_w=rng.normal(size=(S, T * Q)).astype(np.float32),
        param_grid=grid.astype(np.float32),
        w_grid=np.sort(rng.normal(size=(n_q, T * Q)), axis=0).astype(np.float32),
    )
    ct = rng.uniform(size=(T, 2)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("co") / "art.npz")
    return save_artifact(path, fit, ct, config=SMKConfig(n_quantiles=n_q))


_ROW_EPS = {}


def twin_row_eps(rs, ri, shape):
    """The twin's row-seed noise (serve/engine.py's ``row_eps``), called
    directly: (S, u, q) from uint32 seeds and int32 row indices."""
    if shape not in _ROW_EPS:
        def row(seed, idx):
            return jax.random.normal(jax.random.fold_in(jax.random.key(seed), idx), shape,
                                     jnp.float32)
        _ROW_EPS[shape] = jax.jit(jax.vmap(row, out_axes=1))
    return np.array(_ROW_EPS[shape](jnp.asarray(rs, jnp.uint32), jnp.asarray(ri, jnp.int32)))


class RecordingJaxRowNoise:
    """A ``row_noise`` that draws the twin's numbers and records what it
    was asked for."""

    def __init__(self):
        self.calls = []

    def __call__(self, seeds, idx, shape, dtype, device):
        rs, ri = seeds.cpu().numpy(), idx.cpu().numpy()
        eps = twin_row_eps(rs, ri, shape)
        self.calls.append((rs, ri, eps))
        return torch.as_tensor(eps, dtype=dtype, device=device)


@pytest.fixture(scope="module")
def twin_engine(artifact_path):
    eng = jserve.PredictionEngine(artifact_path, buckets=BUCKETS, coalesce_window_ms=1.0)
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def ceng(artifact_path):
    """The port's window-armed engine with its default row noise."""
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu", max_queue=32,
                           coalesce_window_ms=WINDOW_MS)
    yield eng
    eng.close()


def _race(eng, reqs, seeds, **kw):
    """``reqs`` sent at once from one thread each; their responses."""
    results, errs = [None] * len(reqs), []
    gate = threading.Barrier(len(reqs))

    def worker(i):
        try:
            gate.wait(timeout=10.0)
            results[i] = eng.predict(*reqs[i], seed=seeds[i], **kw)
        except Exception as e:  # recorded and failed below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads) and not errs, errs
    return results


# -- the row noise law --------------------------------------------------------


def test_row_program_receives_the_twins_fold_in_normals(artifact_path):
    """A packed, padded slice: rows of two requests (seeds 5 and 9) and
    three pad rows repeating the first entry; then a request seed past
    2**32, which the coalescer wraps to its low 32 bits."""
    noise = RecordingJaxRowNoise()
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu", row_noise=noise,
                           coalesce_window_ms=1.0, warm=False)
    (ca, xa), (cb, xb) = _queries(3, 1), _queries(2, 2)
    rs = np.array([5] * 3 + [9] * 2, np.int64)
    ri = np.array([0, 1, 2, 0, 1], np.int64)
    eng._dispatch_slice_rows(np.concatenate([ca, cb]), np.concatenate([xa, xb]), rs, ri, 8,
                             "test", DeadlineBudget(30.0))
    got_rs, got_ri, eps = noise.calls[-1]
    np.testing.assert_array_equal(got_rs, [5, 5, 5, 9, 9, 5, 5, 5])
    np.testing.assert_array_equal(got_ri, [0, 1, 2, 0, 1, 0, 0, 0])
    for r in range(8):
        want = np.array(jax.random.normal(
            jax.random.fold_in(jax.random.key(np.uint32(got_rs[r])), int(got_ri[r])), (S, Q),
            jnp.float32))
        np.testing.assert_array_equal(eps[:, r], want)
    # the coalescer wraps a seed to its low 32 bits, as the twin's
    eng2 = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu", row_noise=noise,
                            coalesce_window_ms=1.0, warm=False)
    eng2.predict(cb, xb, seed=2**32 + 9)
    np.testing.assert_array_equal(noise.calls[-1][0][:2], [9, 9])


@pytest.mark.parametrize("u", BUCKETS)
def test_row_program_matches_the_twins(artifact_path, twin_engine, u):
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu",
                           row_noise=RecordingJaxRowNoise(), coalesce_window_ms=1.0, warm=False)
    cq, xq = _queries(u, 3)
    rs = np.array([7, 7, 11, 11, 11, 3, 3, 3][:u], np.uint32)
    ri = np.array([0, 1, 0, 1, 2, 0, 1, 2][:u], np.int32)
    pred, _ = eng._programs_rows(u)
    ps, pq = pred(*eng._gen.const, torch.as_tensor(cq, dtype=torch.float32),
                  torch.as_tensor(xq, dtype=torch.float32), torch.as_tensor(rs.astype(np.int64)),
                  torch.as_tensor(ri.astype(np.int64)))
    jpred, _ = twin_engine._programs_rows(u)
    jps, jpq = jpred(*twin_engine._const, cq, xq, rs, ri)
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), **TOL)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jpq), **TOL)


@pytest.mark.parametrize("n, seed", [(3, 0), (11, 4)])
def test_window_armed_engine_matches_the_twins(artifact_path, twin_engine, n, seed):
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu",
                           row_noise=RecordingJaxRowNoise(), coalesce_window_ms=1.0)
    cq, xq = _queries(n, 10 + n)
    got, want = eng.predict(cq, xq, seed=seed), twin_engine.predict(cq, xq, seed=seed)
    assert got.buckets == want.buckets and got.held_s > 0.0
    np.testing.assert_allclose(got.p_quant, np.asarray(want.p_quant), **TOL)
    assert not got.degraded
    assert sorted(eng.health()["coalesce"]) == sorted(twin_engine.health()["coalesce"])
    eng.close()


# -- coalescing ---------------------------------------------------------------


def test_window_zero_keeps_the_per_request_path(artifact_path):
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu")
    r = eng.predict(*_queries(3, 41))
    assert r.held_s == 0.0 and eng._coalescer is None
    assert not any(p["key"][0] == "serve_predict_rs" for p in eng.pstats.programs)
    h = eng.health()
    assert h["coalesce_window_ms"] == 0.0 and "coalesce" not in h
    eng.close()


def test_coalesced_bitwise_solo_and_fewer_dispatches(ceng):
    """Three requests (3, 2 and 11 rows: the batch spans two slices) at
    once: strictly fewer dispatches than requests, each response bitwise
    the same request served alone."""
    reqs = [_queries(3, 1), _queries(2, 2), _queries(11, 3)]
    seeds = [0, 1, 2]
    solo = [ceng.predict(c, x, seed=s) for (c, x), s in zip(reqs, seeds)]
    d0 = ceng.health()["dispatches"]
    results = _race(ceng, reqs, seeds)
    batched = ceng.health()["dispatches"] - d0
    assert batched < sum(len(r.buckets) for r in solo)
    for got, want in zip(results, solo):
        np.testing.assert_array_equal(got.p_quant, want.p_quant)
        np.testing.assert_array_equal(got.rows_degraded, want.rows_degraded)
    co = ceng.health()["coalesce"]
    assert co["max_batch_requests"] >= 2 and co["window_ms"] == WINDOW_MS


def test_held_s_is_within_the_deadline(ceng):
    deadline = 10.0
    r = ceng.predict(*_queries(3, 5), deadline_s=deadline)
    # a lone leader holds for the whole window, and its latency counts it
    assert r.held_s >= 0.5 * WINDOW_MS / 1000.0
    assert r.held_s <= r.latency_s <= deadline


def test_deadline_critical_request_is_never_held(ceng):
    co = ceng._coalescer
    crit0 = co.stats_snapshot()["critical_flushes"]
    # a planted dispatch wall makes the headroom (remaining - 2 x
    # estimate) negative for this deadline
    co._walls.append(5.0)
    try:
        r = ceng.predict(*_queries(3, 6), deadline_s=8.0)
    finally:
        co._walls.clear()
    assert r.held_s < 0.05
    assert co.stats_snapshot()["critical_flushes"] == crit0 + 1
    again = ceng.predict(*_queries(3, 6), deadline_s=8.0)
    np.testing.assert_array_equal(again.p_quant, r.p_quant)


def test_quarantine_scatter_back_is_isolated(ceng):
    """One NaN row of a coalesced dispatch degrades the request that owns
    it; its batch-mates come back bitwise their solo responses."""
    reqs = [_queries(3, 21), _queries(2, 22), _queries(3, 23)]
    seeds = [50, 51, 52]
    solo = [ceng.predict(c, x, seed=s) for (c, x), s in zip(reqs, seeds)]
    d0 = ceng.health()["dispatches"]
    # row 1 of the one dispatch is local row 1 of the first-arrived member
    with inject_predict_nan(rows=[1], max_fires=1) as inj:
        results = _race(ceng, reqs, seeds)
    assert inj.fires == 1 and ceng.health()["dispatches"] - d0 == 1
    hurt = [i for i, r in enumerate(results) if r.degraded]
    assert len(hurt) == 1
    r = results[hurt[0]]
    assert r.rows_degraded[1] and int(r.rows_degraded.sum()) == 1
    np.testing.assert_array_equal(r.p_quant[:, ~r.rows_degraded],
                                  solo[hurt[0]].p_quant[:, ~r.rows_degraded])
    for i, got in enumerate(results):
        if i != hurt[0]:
            assert not got.degraded
            np.testing.assert_array_equal(got.p_quant, solo[i].p_quant)
    assert not ceng.predict(*reqs[0], seed=50).degraded


def test_swap_to_a_new_config_warms_the_row_programs_too(artifact_path):
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu", coalesce_window_ms=1.0)
    fresh = eng.program_summary()["program_sources"]["fresh"]
    assert fresh == 3 * len(BUCKETS)  # predict, row-seed predict, guard
    art = eng.artifact
    eng.swap_artifact(art._replace(link="logit"))
    assert eng.program_summary()["program_sources"]["fresh"] == 2 * fresh
    eng.swap_artifact(art, generation=5)  # back to the built keys
    assert eng.program_summary()["program_sources"]["fresh"] == 2 * fresh
    assert eng.generation == 5 and not eng.predict(*_queries(3, 8)).degraded
    eng.close()


def test_serve_block_of_the_ports_run_log_is_the_twins(artifact_path, tmp_path):
    eng = PredictionEngine(artifact_path, buckets=BUCKETS, device="cpu",
                           coalesce_window_ms=WINDOW_MS, run_log_dir=str(tmp_path))
    _race(eng, [_queries(3, 31), _queries(2, 32), _queries(3, 33)], [1, 2, 3])
    eng.predict(*_queries(2, 34), seed=4)
    eng.close()
    path = str(next(tmp_path.glob("*.jsonl")))
    mine = tsummarize.serve_block(tsummarize.load_run(path))
    assert mine == jsummarize.serve_block(jsummarize.load_run(path))
    co = mine["coalesce"]
    assert co["requests"] == 4 and co["rows"] == 10 and co["n_batches"] < 4
    assert sum(mine["held_s_hist"].values()) == 4 and mine["n_request_spans"] == 4
    assert mine["sheds"]["requests_served"] == 4
    assert mine["sheds"]["dispatches"] == co["n_batches"]
    assert tsummarize.summarize(path)["serve"] == mine
    assert tsummarize.main([path]) == 0


# -- the default row noise ------------------------------------------------------


def test_default_row_noise_is_standard_normal():
    """1e5 draws: 100 rows of one request, 1000 draws each."""
    z = hash_row_noise(torch.full((100,), 12345), torch.arange(100), (1000, 1),
                       torch.float64, torch.device("cpu")).numpy().ravel()
    n = z.size
    assert n == 100_000 and np.isfinite(z).all()
    assert abs(z.mean()) < 4.0 / np.sqrt(n)
    assert abs(z.var() - 1.0) < 4.0 * np.sqrt(2.0 / n)
    assert abs(np.mean(z ** 3)) < 4.0 * np.sqrt(15.0 / n)
    assert abs(np.mean(z ** 4) - 3.0) < 4.0 * np.sqrt(96.0 / n)
    assert abs(np.mean(np.abs(z) < 1.959964) - 0.95) < 4.0 * np.sqrt(0.95 * 0.05 / n)


def test_default_row_noise_is_invariant_to_packing():
    cpu = torch.device("cpu")
    seeds = torch.tensor([3, 3, 3, 8, 8, 2**32 - 1])
    idx = torch.tensor([0, 1, 2, 0, 1, 0])
    full = hash_row_noise(seeds, idx, (7, 3), torch.float32, cpu)
    assert full.shape == (7, 6, 3) and full.dtype == torch.float32
    perm = torch.tensor([5, 3, 0, 4, 2, 1])
    moved = hash_row_noise(seeds[perm], idx[perm], (7, 3), torch.float32, cpu)
    assert torch.equal(moved, full[:, perm])
    alone = hash_row_noise(seeds[4:5], idx[4:5], (7, 3), torch.float32, cpu)
    assert torch.equal(alone[:, 0], full[:, 4])
    # (seed, row) pairs differ: so do their draws; an odd s * q is cut
    assert not torch.equal(full[:, 0], full[:, 1]) and not torch.equal(full[:, 0], full[:, 3])
    odd = hash_row_noise(seeds, idx, (7, 1), torch.float64, cpu)
    assert odd.shape == (7, 6, 1) and torch.isfinite(odd).all()
