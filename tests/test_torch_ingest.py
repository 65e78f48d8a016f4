"""The port's live loop (smk_torch/serve/ingest.py, the generation
publication of serve/artifact.py, ``swap_artifact`` in serve/engine.py and
serve/fleet.py, the ingest ledger and obs/summarize.ingest_block) against
the JAX package's, on the CPU.

One module fixture runs the twin's own problem (tests/test_ingest.py:
K = 4, n = 64, q = 1, p = 2, t = 6, 16 sweeps, coherent) through both
packages: fit, one ingest of six copies of subset 0's own rows, one
dirty-only refit. The port replays the twin's key schedule
(serve/ingest.py's ``fit``: ``split(key)``, the sweeps from the first
half, the resample from ``fold_in(second, 0x1E57)``; ``refit``: the sweeps
from ``fold_in(key, len(target))``, the resample from
``fold_in(fold_in(key, 0xF17), 0x1E57)``) through a randomness object, as
``fit_meta_kriging``'s tests do.

Tolerance: 5e-5 + 5e-5 |x|, the other whole-fit comparisons', on the
combined grids and draws and on every subset leaf (observed at most 0.82
of it, on ``param_rhat``). Routes, dirty sets and the untouched subsets
are held exactly; manifests field by field, except the wall-clock
``published_at`` and the measured ``wall_s``.
"""

# smklint: test-budget=one twin LiveFit fit + ingest + refit (~30 s of compiles) and the port's (~3 s) in a module fixture; the restart drill runs three port fits (~3 s each); every other test reads the fixture or serves in milliseconds
import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from smk_tpu.obs import summarize as jsummarize
from smk_tpu.serve import IngestError as JaxIngestError
from smk_tpu.serve import LiveFit as JaxLiveFit
from smk_tpu.serve import artifact as jart
from smk_tpu.config import SMKConfig as JaxConfig
from smk_torch.config import SMKConfig
from smk_torch.obs import summarize as tsummarize
from smk_torch.serve import (
    GENERATION_MANIFEST,
    ArtifactSwapError,
    GenerationError,
    IngestError,
    LiveFit,
    PredictionEngine,
    ReplicaFleet,
    commit_generation,
    current_generation,
    generation_artifact_name,
    land_generation,
    load_artifact,
    load_current_generation,
    orphan_generations,
    publish_generation,
)
from smk_torch.utils.checkpoint import _atomic_savez
from test_torch_recovery import ChunkedJaxReplay

K, N, Q, P, T = 4, 64, 1, 2, 6
KW = dict(n_subsets=K, n_samples=16, burn_in_frac=0.5, n_quantiles=21, resample_size=40,
          partition_method="coherent")
TOL = dict(atol=5e-5, rtol=5e-5)
COMBINED = ("param_grid", "w_grid", "sample_par", "sample_w")
LEAVES = ("param_grid", "w_grid", "phi_accept_rate", "param_samples", "w_samples",
          "param_ess", "param_rhat", "w_ess", "w_rhat")


def _problem():
    """tests/test_ingest.py's problem."""
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(N, 2))
    x = rng.normal(size=(N, Q, P))
    y = rng.integers(0, 2, size=(N, Q)).astype(np.float64)
    ct = rng.uniform(size=(T, 2))
    xt = rng.normal(size=(T, Q, P))
    return y, x, coords, ct, xt


def _batch_for_subset(live, j, b=6, seed=3):
    """tests/test_ingest.py's batch: exact copies of subset ``j``'s own
    coordinates (same Morton codes, so the route is exact), fresh y and x."""
    rng = np.random.default_rng(seed)
    c = live._coords[np.asarray(live._assignments[j][:b])] + 0.0
    yb = rng.integers(0, 2, size=(c.shape[0], Q)).astype(np.float64)
    xb = rng.normal(size=(c.shape[0], Q, P))
    return yb, xb, c


class LiveJaxRandomness:
    """One LiveFit call's random numbers from the twin's keys: the sweeps
    from ``k_sweep`` (split over the call's subsets and chains, replayed
    by ChunkedJaxReplay), the resample indices from ``k_res``."""

    def __init__(self, k_sweep, k_res):
        self.k_sweep, self.k_res = k_sweep, k_res

    def sweep_noise(self, shapes):
        return ChunkedJaxReplay(jax.random.split(self.k_sweep, shapes.k), shapes)

    def resample_index(self, n_draws, n_grid):
        return torch.as_tensor(np.array(jax.random.randint(self.k_res, (n_draws,), 0, n_grid)))

    @classmethod
    def for_fit(cls, key):
        k_fit, k_pub = jax.random.split(key)
        return cls(k_fit, jax.random.fold_in(k_pub, 0x1E57))

    @classmethod
    def for_refit(cls, key, n_target):
        return cls(jax.random.fold_in(key, n_target),
                   jax.random.fold_in(jax.random.fold_in(key, 0xF17), 0x1E57))


def _host_copy(results):
    return type(results)(*(np.array(a, copy=True) for a in results))


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """The twin's loop and the port's on the same problem and keys."""
    root = tmp_path_factory.mktemp("live")
    y, x, coords, ct, xt = _problem()
    out = {"root": root, "ct": ct, "xt": xt}
    for side in ("twin", "port"):
        logs = str(root / side / "logs")
        if side == "twin":
            live = JaxLiveFit(str(root / side / "gens"), coords_test=ct, x_test=xt,
                              config=JaxConfig(**dict(KW, run_log_dir=logs)))
            manifest0 = live.fit(jax.random.key(0), y, x, coords)
        else:
            live = LiveFit(str(root / side / "gens"), coords_test=ct, x_test=xt,
                           config=SMKConfig(**dict(KW, run_log_dir=logs)), device="cpu")
            manifest0 = live.fit(0, y, x, coords,
                                 randomness=LiveJaxRandomness.for_fit(jax.random.key(0)))
        combined0 = live._last_combined
        receipt = live.ingest(*_batch_for_subset(live, 0))
        pre = _host_copy(live._subset_results)
        if side == "twin":
            report = live.refit(jax.random.key(1))
        else:
            report = live.refit(1, randomness=LiveJaxRandomness.for_refit(jax.random.key(1), 1))
        live.close()
        out[side] = {"live": live, "manifest0": manifest0, "combined0": combined0,
                     "receipt": receipt, "pre": pre, "report": report, "logs": logs,
                     "manifest1": current_generation(live.gen_dir)}
    return out


# -- routing and dirty sets --------------------------------------------------


def test_router_matches_twin(loops):
    mine, twin = loops["port"]["live"]._router, loops["twin"]["live"]._router
    for f in ("lo", "span", "boundaries"):
        np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(twin, f)))
    assert (mine.bits, mine.n_subsets) == (twin.bits, twin.n_subsets)
    pts = np.random.default_rng(5).uniform(-0.5, 1.5, size=(256, 2))  # half out of frame
    np.testing.assert_array_equal(mine.route(pts), twin.route(pts))
    assert ((mine.route(pts) >= 0) & (mine.route(pts) < K)).all()


def test_router_routes_the_fits_rows_into_their_own_subsets(loops):
    live = loops["port"]["live"]
    for j in range(K):
        own = [i for i in live._assignments[j] if i < N]
        assert (live._router.route(live._coords[np.asarray(own)]) == j).all()
    with pytest.raises(IngestError):
        live._router.route(np.zeros((4, 3)))


def test_routes_and_dirty_sets_match_twin(loops):
    mine, twin = loops["port"]["receipt"], loops["twin"]["receipt"]
    assert tuple(mine) == tuple(twin)
    assert set(mine.routed_subsets) == {0} and mine.dirty_subsets == (0,)
    assert mine.generation == 0  # an ingest publishes nothing
    r_mine, r_twin = loops["port"]["report"], loops["twin"]["report"]
    assert (r_mine.refit_subsets, r_mine.reused_subsets, r_mine.generation) == (
        r_twin.refit_subsets, r_twin.reused_subsets, r_twin.generation) == ((0,), (1, 2, 3), 1)
    assert r_mine.dirty_group_frac == r_twin.dirty_group_frac
    for live in (loops["port"]["live"], loops["twin"]["live"]):
        assert live.dirty_subsets == () and live.n_rows == N + 6
    mine_a, twin_a = loops["port"]["live"]._assignments, loops["twin"]["live"]._assignments
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(mine_a, twin_a))


# -- the fits, draw for draw ------------------------------------------------


@pytest.mark.parametrize("stage", ["fit", "refit"])
@pytest.mark.parametrize("field", COMBINED)
def test_combined_fit_matches_twin(loops, stage, field):
    if stage == "fit":
        got, want = loops["port"]["combined0"], loops["twin"]["combined0"]
    else:
        got, want = loops["port"]["live"]._last_combined, loops["twin"]["live"]._last_combined
    got, want = getattr(got, field), np.asarray(getattr(want, field))
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("field", LEAVES)
def test_subset_leaves_match_twin_after_the_refit(loops, field):
    got = getattr(loops["port"]["live"]._subset_results, field)
    want = np.asarray(getattr(loops["twin"]["live"]._subset_results, field))
    # carried state lives on the host
    assert isinstance(got, np.ndarray) and got.shape == want.shape and got.shape[0] == K
    np.testing.assert_allclose(got, want, **TOL)


def test_untouched_subsets_bitwise_and_the_refit_one_fresh(loops):
    pre, post = loops["port"]["pre"], loops["port"]["live"]._subset_results
    reused = np.asarray(loops["port"]["report"].reused_subsets)
    for a, b in zip(pre, post):
        assert np.array_equal(a[reused], b[reused])
    assert not np.array_equal(pre.w_samples[0], post.w_samples[0])


def test_refit_report_fields(loops):
    rep = loops["port"]["report"]
    assert rep.refit_wall_s > 0 and rep.full_fit_wall_s > 0
    assert rep.refit_speedup == pytest.approx(rep.full_fit_wall_s / rep.refit_wall_s)
    assert rep.param_rhat_max is not None and not rep.skipped


@pytest.mark.parametrize("which", ["manifest0", "manifest1"])
def test_manifests_match_twin(loops, which):
    mine, twin = dict(loops["port"][which]), dict(loops["twin"][which])
    for m in (mine, twin):
        m.pop("published_at")
        m.pop("wall_s", None)  # a measured wall time
    assert mine == twin
    assert mine["generation"] == (0 if which == "manifest0" else 1)


# -- generation directories ---------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_generation_dirs_cross_load(loops, writer):
    gen_dir = loops[writer]["live"].gen_dir
    mine, m_mine = load_current_generation(gen_dir)
    twin, m_twin = jart.load_current_generation(gen_dir)
    assert m_mine == m_twin and m_mine["generation"] == 1
    assert current_generation(gen_dir) == jart.current_generation(gen_dir)
    assert orphan_generations(gen_dir) == jart.orphan_generations(gen_dir) == ()
    for f in mine._fields:
        a, b = getattr(mine, f), getattr(twin, f)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
    assert mine.serve_digest() == twin.serve_digest()
    old = load_artifact(os.path.join(gen_dir, generation_artifact_name(0)))
    assert old.n_anchor == T and not np.array_equal(old.sample_w, mine.sample_w)


def test_torn_publish_keeps_the_committed_generation(loops, tmp_path):
    """Land without commit (a crash between the phases): the committed
    manifest, and so every load, stays; the orphan is visible and the
    retry overwrites it at its name. In a copy of the port's directory."""
    live = loops["port"]["live"]
    gen_dir = str(tmp_path / "gens")
    shutil.copytree(live.gen_dir, gen_dir)
    before = current_generation(gen_dir)
    gen, path = land_generation(gen_dir, live._last_combined, live.coords_test, config=live.cfg)
    assert gen == before["generation"] + 1 and os.path.exists(path)
    assert current_generation(gen_dir) == before
    assert orphan_generations(gen_dir) == jart.orphan_generations(gen_dir) == (gen,)
    art, manifest = load_current_generation(gen_dir)
    assert manifest == before and jart.load_current_generation(gen_dir)[1] == before
    again = publish_generation(gen_dir, live._last_combined, live.coords_test, config=live.cfg)
    assert again["generation"] == gen and again["artifact"] == generation_artifact_name(gen)
    assert orphan_generations(gen_dir) == ()


def test_generation_names_and_manifest_format_are_the_twins(tmp_path):
    assert generation_artifact_name(12) == jart.generation_artifact_name(12)
    assert GENERATION_MANIFEST == jart.GENERATION_MANIFEST
    with pytest.raises(ValueError):
        generation_artifact_name(-1)
    assert current_generation(str(tmp_path)) is None
    assert orphan_generations(str(tmp_path / "missing")) == ()
    with pytest.raises(GenerationError, match="no generation committed"):
        load_current_generation(str(tmp_path))


def test_commit_refuses_an_unlanded_generation(tmp_path):
    with pytest.raises(GenerationError, match="not landed"):
        commit_generation(str(tmp_path), 0)


@pytest.mark.parametrize("text", ["{not json", '{"generation": 0}', "[1, 2]"])
def test_corrupt_manifest_is_typed(tmp_path, text):
    (tmp_path / GENERATION_MANIFEST).write_text(text)
    with pytest.raises(GenerationError):
        current_generation(str(tmp_path))
    with pytest.raises(jart.GenerationError):
        jart.current_generation(str(tmp_path))


# -- typed rejections ---------------------------------------------------------


def _fresh(tmp_path, **kw):
    cfg = SMKConfig(**dict(KW, **kw))
    return LiveFit(str(tmp_path / "g"), config=cfg, coords_test=np.zeros((T, 2)),
                   x_test=np.zeros((T, Q, P)), device="cpu")


def test_requires_a_coherent_partition(tmp_path):
    with pytest.raises(IngestError, match="coherent"):
        _fresh(tmp_path, partition_method="random")


def test_ingest_and_refit_before_the_fit_are_typed(tmp_path):
    live = _fresh(tmp_path)
    with pytest.raises(IngestError, match="before the initial fit"):
        live.ingest(np.zeros((2, Q)), np.zeros((2, Q, P)), np.zeros((2, 2)))
    with pytest.raises(IngestError, match="before the initial fit"):
        live.refit(0)


def test_live_fit_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveFit(str(tmp_path), config=SMKConfig(**KW), coords_test=np.zeros((T, 2)),
                x_test=np.zeros((T, Q, P)))


def _bad_batches():
    nan_c = np.zeros((2, 2))
    nan_c[0, 0] = np.nan
    return {
        "y width": (np.zeros((2, Q + 1)), np.zeros((2, Q, P)), np.zeros((2, 2))),
        "coords rows": (np.zeros((2, Q)), np.zeros((2, Q, P)), np.zeros((3, 2))),
        "nan coords": (np.zeros((2, Q)), np.zeros((2, Q, P)), nan_c),
        "x None with covariates": (np.zeros((2, Q)), None, np.zeros((2, 2))),
        "x shape": (np.zeros((2, Q)), np.zeros((2, Q, P + 1)), np.zeros((2, 2))),
        "no coords": (np.zeros((2, Q)), np.zeros((2, Q, P)), None),
    }


@pytest.mark.parametrize("case", sorted(_bad_batches()))
def test_bad_batch_is_typed_before_any_change(loops, case):
    live, twin = loops["port"]["live"], loops["twin"]["live"]
    before = (live.n_rows, live.dirty_subsets, live._pending_seq)
    with pytest.raises(IngestError):
        live.ingest(*_bad_batches()[case])
    with pytest.raises(JaxIngestError):
        twin.ingest(*_bad_batches()[case])
    assert (live.n_rows, live.dirty_subsets, live._pending_seq) == before


def test_subsets_out_of_bounds_typed(loops):
    with pytest.raises(IngestError, match="subsets must lie"):
        loops["port"]["live"].refit(0, subsets=[K + 3])


def test_empty_refit_is_skipped(loops):
    live = loops["port"]["live"]
    gen = live.generation
    rep = live.refit(9)
    assert rep.skipped and rep.refit_subsets == () and rep.reused_subsets == tuple(range(K))
    assert rep.generation == gen == live.generation


# -- the durable append log ---------------------------------------------------


def test_append_log_persisted_then_consumed(loops):
    """The fixture's ingest persisted one batch file; its refit consumed
    it, stamped the watermark into the committed manifest, then deleted
    the file."""
    live = loops["port"]["live"]
    assert os.listdir(os.path.join(live.gen_dir, "pending")) == []
    led = live.pstats.ingest
    assert (led["pending_persisted"], led["ingest_watermark"], led["replayed_batches"]) == (1, 0, 0)
    assert current_generation(live.gen_dir)["ingest_watermark"] == 0 and live._pending == []


def test_restart_replays_unrefit_rows_and_drops_committed_ones(tmp_path):
    """Rows ingested but never re-fit survive a restart: a new LiveFit on
    the directory replays the batch file after its base fit; a stale file
    at the committed watermark (a crash between commit and delete) is
    dropped, never applied twice."""
    gd = str(tmp_path / "gens")
    y, x, coords, ct, xt = _problem()

    def life(seed):
        live = LiveFit(gd, config=SMKConfig(**KW), coords_test=ct, x_test=xt, device="cpu")
        live.fit(seed, y, x, coords)
        return live

    live = life(0)
    batch = _batch_for_subset(live, 1)
    live.ingest(*batch)
    pend = os.path.join(gd, "pending")
    assert os.listdir(pend) == ["batch.00000000.npz"]
    live.close()

    live2 = life(1)
    led = live2.pstats.ingest
    assert (led["replayed_batches"], led["replayed_rows"]) == (1, 6)
    assert live2.n_rows == N + 6 and live2.dirty_subsets == (1,)
    rep = live2.refit(2)
    assert rep.refit_subsets == (1,)
    assert current_generation(gd)["ingest_watermark"] == 0 and os.listdir(pend) == []
    live2.close()

    _atomic_savez(os.path.join(pend, "batch.00000000.npz"),
                  {"y": batch[0], "x": batch[1], "coords": batch[2]})
    live3 = life(3)
    assert live3.pstats.ingest["replayed_batches"] == 0 and live3.n_rows == N
    assert os.listdir(pend) == [] and live3.generation == 3
    live3.close()


# -- hot swaps ----------------------------------------------------------------


def _arts(loops):
    gen_dir = loops["port"]["live"].gen_dir
    art0 = load_artifact(os.path.join(gen_dir, generation_artifact_name(0)))
    return art0, load_current_generation(gen_dir)[0]


def _fresh_programs(eng):
    return eng.program_summary()["program_sources"].get("fresh", 0)


def test_engine_swap_and_health(loops):
    live = loops["port"]["live"]
    art0, _ = _arts(loops)
    ct, xt = loops["ct"], loops["xt"]
    eng = PredictionEngine(art0, device="cpu")
    assert eng.health()["generation"] == 0
    r0 = eng.predict(ct[:2], xt[:2], seed=7)
    built = _fresh_programs(eng)
    out = live.swap_into(eng)
    assert out["generation"] == live.generation == eng.generation == 1
    h = eng.health()
    assert h["generation"] == 1 and h["generation_swaps"] == 1 and h["state"] == "ready"
    # a re-fit of the same config: the same program keys, nothing built
    assert _fresh_programs(eng) == built
    r1 = eng.predict(ct[:2], xt[:2], seed=7)
    assert not np.array_equal(r0.p_quant, r1.p_quant)  # subset 0 saw new data
    eng.close()


def test_swap_of_another_geometry_is_typed(loops):
    art0, _ = _arts(loops)
    eng = PredictionEngine(art0, device="cpu", warm=False)
    with pytest.raises(ArtifactSwapError, match="geometry"):
        eng.swap_artifact(art0._replace(coords_test=art0.coords_test[:-1]))
    with pytest.raises(TypeError):
        eng.swap_artifact(object())
    assert eng.generation == 0 and eng.health()["generation_swaps"] == 0


def test_swap_to_a_new_config_warms_its_programs_first(loops):
    art0, art1 = _arts(loops)
    eng = PredictionEngine(art0, device="cpu", buckets=(4, 8))
    built = _fresh_programs(eng)
    other = art1._replace(cov_model="matern32")
    assert other.serve_digest() != art0.serve_digest()
    eng.swap_artifact(other)
    # every bucket's predict and guard of the new digest, before publishing
    assert _fresh_programs(eng) == built + 2 * 2
    r = eng.predict(loops["ct"][:3], loops["xt"][:3], seed=1)
    assert np.isfinite(r.p_quant).all() and _fresh_programs(eng) == built + 4


def test_fleet_swap_moves_every_replica(loops):
    art0, art1 = _arts(loops)
    ct, xt = loops["ct"], loops["xt"]
    with PredictionEngine(art1, device="cpu") as e1:
        want = e1.predict(ct[:3], xt[:3], seed=4).p_quant
    fleet = ReplicaFleet(art0, n_replicas=2, device="cpu")
    out = loops["port"]["live"].swap_into(fleet)
    assert out == {"generation": 1, "replicas": 2}
    assert [e.generation for e in fleet.engines] == [1, 1] and fleet.artifact is not art0
    for _ in range(2):  # both replicas, round-robin
        assert np.array_equal(fleet.predict(ct[:3], xt[:3], seed=4).p_quant, want)
    assert fleet.health()["totals"]["generation_swaps"] == 2
    fleet.close()


def test_serve_during_swap_is_never_torn(loops):
    """4 threads x 20 requests racing six swaps between two generations:
    none dropped, each response bitwise one generation's answer."""
    art0, art1 = _arts(loops)
    cq, xq = loops["ct"][:2], loops["xt"][:2]
    with PredictionEngine(art0, device="cpu") as e0, PredictionEngine(art1, device="cpu") as e1:
        exp0 = e0.predict(cq, xq, seed=21).p_quant
        exp1 = e1.predict(cq, xq, seed=21).p_quant
    assert not np.array_equal(exp0, exp1)
    results, errors = [], []
    with PredictionEngine(art0, device="cpu") as hot:
        built = _fresh_programs(hot)

        def hammer():
            try:
                for _ in range(20):
                    results.append(hot.predict(cq, xq, seed=21).p_quant)
            except Exception as e:  # recorded and failed below
                errors.append(e)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for th in threads:
            th.start()
        for flip in range(6):
            hot.swap_artifact(art1 if flip % 2 == 0 else art0, generation=flip + 1)
        for th in threads:
            th.join(timeout=60.0)
        assert not any(th.is_alive() for th in threads)
        assert _fresh_programs(hot) == built and hot.health()["generation_swaps"] == 6
    assert not errors and len(results) == 80
    assert all(np.array_equal(r, exp0) or np.array_equal(r, exp1) for r in results)


# -- the ledger and the run log -----------------------------------------------

_TIMED = ("last_refit_wall_s", "last_refit_speedup")


def test_ingest_ledger_matches_twin_and_rides_aggregate(loops):
    mine = loops["port"]["live"].pstats
    twin = loops["twin"]["live"].pstats
    led = {k: v for k, v in mine.ingest.items() if k not in _TIMED}
    want = {k: v for k, v in twin.ingest.items() if k not in _TIMED}
    # the empty refit above left the port's ledger as it was
    assert led == want
    assert led["ingest_batches"] == 1 and led["ingested_rows"] == 6 and led["generation"] == 1
    assert (led["refits"], led["refit_subsets_total"], led["reused_subsets_total"]) == (1, 1, 3)
    assert mine.aggregate()["ingest"] is mine.ingest


@pytest.mark.parametrize("writer", ["port", "twin"])
def test_ingest_block_equals_the_twins_on_one_run_log(loops, writer):
    logs = loops[writer]["logs"]
    path = next(os.path.join(logs, f) for f in sorted(os.listdir(logs))
                if "livefit" in f and f.endswith(".jsonl"))
    mine = tsummarize.ingest_block(tsummarize.load_run(path))
    assert mine == jsummarize.ingest_block(jsummarize.load_run(path))
    assert (mine["n_ingest_batches"], mine["rows_ingested"], mine["n_refits"]) == (1, 6, 1)
    assert (mine["n_generations_published"], mine["last_generation"]) == (2, 1)
    # the shared defect (ROADMAP queue C): the totals sum keys that no
    # refit_scheduled event carries, so they read 0 in both packages
    assert mine["refit_subsets_total"] == 0 and mine["reused_subsets_total"] == 0
    summary = tsummarize.summarize(path)
    assert summary["ingest"] == mine and summary["serve"]["n_request_spans"] == 0
    with open(path) as f:
        ends = [json.loads(line) for line in f if '"run_end"' in line]
    assert ends and ends[-1]["attrs"]["ingest"]["refits"] == 1

