"""The port's query path and serving engine (smk_torch/api.predict_at and
its helpers, smk_torch/serve/, the serving injectors of
smk_torch/testing/faults.py) against the JAX package's, on the CPU.

One JAX fit (tests/test_serve.py's problem: K = 4, n = 64, t = 6 anchors,
q = 1, p = 2, 24 sweeps, 40 resampled draws) runs once in a module
fixture; the port serves that same fit (convert.meta_kriging_result_from_numpy)
and the artifact the twin saved. The composition noise is injected: the
port's ``predict_at`` takes the twin's ``jax.random.normal(key)`` draws as
``eps``, and the port's engine a noise callable that draws what the
twin's engine draws for a slice, ``jax.random.normal(key(seed))``.

Tolerances: probabilities and quantiles 5e-5 + 5e-5 |x| (the sweep
tolerance; the port composes in float64, the twin in float32), the anchor
factor 2e-6 + 1e-6 |x| (a float32 factor of a 6 x 6 correlation); the
port against itself is held bitwise, artifacts across the packages too.
"""

# smklint: test-budget=one JAX fit (~14 s), the twin's predict_at and one twin engine (two buckets) in module fixtures; every port test runs in milliseconds on the CPU

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu import api as japi
from smk_tpu import serve as jserve
from smk_tpu.config import SMKConfig as JaxConfig
from smk_torch import api as tapi
from smk_torch import convert
from smk_torch.config import SMKConfig
from smk_torch.ops.quantiles import credible_probs, credible_summary
from smk_torch.serve import (
    ArtifactError,
    DeadlineBudget,
    EngineDrainingError,
    FleetSaturatedError,
    PredictionEngine,
    QueueFullError,
    ReplicaFleet,
    RequestTimeoutError,
    load_artifact,
    run_under_deadline,
    save_artifact,
)
from smk_torch.testing.faults import inject_predict_nan, stall_predict

K, N, Q, P, T = 4, 64, 1, 2, 6
KW = dict(n_subsets=K, n_samples=24, burn_in_frac=0.5, n_quantiles=21, resample_size=40)
CFG = SMKConfig(**KW)
TOL = dict(atol=5e-5, rtol=5e-5)
CHOL_TOL = dict(atol=2e-6, rtol=1e-6)
BUCKETS = (4, 8)


def _problem():
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = rng.normal(size=(N, Q, P)).astype(np.float32)
    y = rng.integers(0, 2, size=(N, Q)).astype(np.float32)
    ct = rng.uniform(size=(T, 2)).astype(np.float32)
    xt = rng.normal(size=(T, Q, P)).astype(np.float32)
    return y, x, coords, ct, xt


def _queries(n, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, 2)).astype(np.float32),
            rng.normal(size=(n, Q, P)).astype(np.float32))


def jax_noise(seed, shape, dtype, device):
    """What the twin's engine draws for a slice of seed ``seed``."""
    eps = jax.random.normal(jax.random.key(np.uint32(seed)), shape, jnp.float32)
    return torch.as_tensor(np.array(eps), dtype=dtype, device=device)


@pytest.fixture(scope="module")
def fit():
    """The twin's fit, and the same fit as the port's MetaKrigingResult."""
    y, x, coords, ct, xt = _problem()
    res = japi.fit_meta_kriging(jax.random.key(0), y, x, coords, ct, xt,
                                config=JaxConfig(**KW))
    return {"twin": res, "port": convert.meta_kriging_result_from_numpy(res), "ct": ct}


@pytest.fixture(scope="module")
def paths(fit, tmp_path_factory):
    """The fit saved by each package: the twin's artifact (its factor built
    by the twin) and the port's (built by the port)."""
    root = tmp_path_factory.mktemp("serve")
    twin = jserve.save_artifact(str(root / "twin.npz"), fit["twin"], fit["ct"],
                                config=JaxConfig(**KW))
    port = save_artifact(str(root / "port.npz"), fit["port"], fit["ct"], config=CFG)
    return {"twin": twin, "port": port}


@pytest.fixture(scope="module")
def engine(paths):
    """The port's engine on the twin's artifact, with the twin's noise."""
    return PredictionEngine(paths["twin"], buckets=BUCKETS, device="cpu", noise=jax_noise)


@pytest.fixture(scope="module")
def twin_engine(paths):
    return jserve.PredictionEngine(paths["twin"], buckets=BUCKETS)


def _engine(paths, **kw):
    kw.setdefault("buckets", BUCKETS)
    return PredictionEngine(paths["twin"], device="cpu", noise=jax_noise, **kw)


# -- predict_at --------------------------------------------------------------


@pytest.fixture(scope="module")
def predicted(fit):
    cq, xq = _queries(5)
    key = jax.random.key(3)
    want, wcache = japi.predict_at(fit["twin"], jnp.asarray(fit["ct"]), cq, xq, key=key,
                                   config=JaxConfig(**KW))
    eps = np.array(jax.random.normal(key, (KW["resample_size"], 5, Q), jnp.float32))
    got, cache = tapi.predict_at(fit["port"], fit["ct"], cq, xq, eps=torch.as_tensor(eps),
                                 config=CFG)
    return {"want": want, "wcache": wcache, "got": got, "cache": cache, "cq": cq, "xq": xq,
            "eps": torch.as_tensor(eps)}


@pytest.mark.parametrize("field", ["p_samples", "p_quant"])
def test_predict_at_matches_twin(predicted, field):
    got = getattr(predicted["got"], field)
    assert got.dtype == torch.float32 and tuple(got.shape) == getattr(predicted["want"], field).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(predicted["want"], field)), **TOL)


def test_prediction_factor_matches_twin(predicted):
    np.testing.assert_allclose(predicted["cache"].krige_chol.numpy(),
                               np.asarray(predicted["wcache"].krige_chol), **CHOL_TOL)


def test_second_predict_zero_factor_rebuilds(fit, predicted):
    """Threading the cache: the second predict factors nothing (n_chol
    stays at q) and returns the same draws bit for bit."""
    cache = predicted["cache"]
    assert cache.n_chol == Q and cache.n_chol_calls == 1
    again, cache2 = tapi.predict_at(fit["port"], fit["ct"], predicted["cq"], predicted["xq"],
                                    eps=predicted["eps"], config=CFG, cache=cache)
    assert cache2.n_chol == Q
    assert torch.equal(again.p_samples, predicted["got"].p_samples)
    assert torch.isfinite(again.p_quant).all() and tuple(again.p_quant.shape) == (3, 5, Q)


def test_predict_at_default_noise_is_seeded(fit):
    """Without eps, a generator seeded with 0 on the result's device: two
    calls agree bit for bit, and a generator of another seed differs."""
    cq, xq = _queries(4)
    a, _ = tapi.predict_at(fit["port"], fit["ct"], cq, xq, config=CFG)
    b, _ = tapi.predict_at(fit["port"], fit["ct"], cq, xq, config=CFG)
    gen = torch.Generator().manual_seed(1)
    c, _ = tapi.predict_at(fit["port"], fit["ct"], cq, xq, config=CFG, generator=gen)
    assert torch.equal(a.p_samples, b.p_samples)
    assert not torch.equal(a.p_samples, c.p_samples)
    with pytest.raises(ValueError, match="eps"):
        tapi.predict_at(fit["port"], fit["ct"], cq, xq, config=CFG, eps=torch.zeros(3, 4, Q))


def test_credible_summary_with_prebuilt_probs_is_bitwise():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(40, 7)).astype(np.float32))
    assert torch.equal(credible_summary(x), credible_summary(x, credible_probs(x.dtype)))


# -- plugin phi --------------------------------------------------------------


def test_median_row_matches_twin():
    for n in (20, 21, 200, 1):
        assert tapi._median_row(n) == japi._median_row(n)


def test_plugin_phi_layout_matches_twin(fit, paths):
    q, p, phi = tapi.plugin_phi_layout(fit["port"], T)
    wq, wp, wphi = japi.plugin_phi_layout(fit["twin"], T)
    assert (q, p) == (wq, wp) == (Q, P)
    np.testing.assert_array_equal(phi, wphi)
    np.testing.assert_array_equal(load_artifact(paths["port"]).phi, phi.astype(np.float32))


@pytest.mark.parametrize("bad_t", [T // 2, T - 1, 3 * T])
def test_plugin_phi_layout_rejects_a_wrong_anchor_grid(fit, bad_t):
    with pytest.raises(tapi.QueryValidationError) as got:
        tapi.plugin_phi_layout(fit["port"], bad_t)
    with pytest.raises(japi.QueryValidationError) as want:
        japi.plugin_phi_layout(fit["twin"], bad_t)
    assert str(got.value) == str(want.value)


# -- the artifact ------------------------------------------------------------


def test_artifact_round_trip(fit, paths):
    res, art = fit["port"], load_artifact(paths["port"])
    assert (art.q, art.p, art.n_anchor, art.coord_dim) == (Q, P, T, 2)
    for f in ("sample_w", "sample_par", "param_grid", "w_grid"):
        np.testing.assert_array_equal(getattr(art, f), getattr(res, f).numpy())
    np.testing.assert_array_equal(art.coords_test, fit["ct"])
    mid = tapi._median_row(res.param_grid.shape[0])
    np.testing.assert_array_equal(art.phi, res.param_grid[mid, -Q:].numpy())
    assert np.isfinite(art.chol_tt).all()
    assert (art.cov_model, art.link) == (CFG.cov_model, CFG.link)
    assert art.config_digest == tapi_digest(CFG)


def tapi_digest(cfg):
    from smk_torch.compile.programs import config_digest

    return config_digest(cfg)


@pytest.mark.parametrize("src,reader", [("twin", "port"), ("port", "twin")])
def test_artifacts_cross_load_bitwise(paths, src, reader):
    """One format: each package reads the other's artifact, every array
    and field equal to what the writer's own package reads."""
    load = {"twin": jserve.load_artifact, "port": load_artifact}
    got, want = load[reader](paths[src]), load[src](paths[src])
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f
    assert got.serve_digest() == want.serve_digest()


def test_serve_digest_and_anchor_factor_agree_across_packages(paths):
    twin, port = load_artifact(paths["twin"]), load_artifact(paths["port"])
    assert twin.serve_digest() == port.serve_digest()
    assert twin.var_floor() == port.var_floor()
    np.testing.assert_allclose(port.chol_tt, twin.chol_tt, **CHOL_TOL)


def _flip_payload(raw):
    raw[len(raw) // 2] ^= 0xFF
    return raw


@pytest.mark.parametrize("damage,match", [
    ("missing", "no serving artifact"),
    ("truncate", "unreadable"),
    ("bitflip", None),
    ("meta", "checksum"),
    ("other", "missing fields"),
])
def test_damaged_artifact_is_a_typed_error(paths, tmp_path, damage, match):
    bad = str(tmp_path / f"{damage}.npz")
    raw = bytearray(open(paths["port"], "rb").read())
    if damage == "truncate":
        open(bad, "wb").write(bytes(raw[: len(raw) // 2]))
    elif damage == "bitflip":
        open(bad, "wb").write(bytes(_flip_payload(raw)))
    elif damage == "meta":
        # a perturbed jitter re-saved with the stale checksum
        with np.load(paths["port"]) as d:
            arrays = {k: np.asarray(d[k]) for k in d.files}
        arrays["jitter"] = arrays["jitter"] * 2.0
        np.savez(bad, **arrays)
    elif damage == "other":
        np.savez(bad, a=np.zeros(3))
    with pytest.raises(ArtifactError, match=match):
        load_artifact(bad)
    if damage != "missing":
        with pytest.raises(jserve.ArtifactError):
            jserve.load_artifact(bad)


# -- the engine against the twin's -------------------------------------------


@pytest.mark.parametrize("n,seed", [(3, 0), (5, 4), (9, 7)])
def test_engine_matches_twin_engine(engine, twin_engine, n, seed):
    cq, xq = _queries(n, seed=20 + n)
    got = engine.predict(cq, xq, seed=seed)
    want = twin_engine.predict(cq, xq, seed=seed)
    assert got.buckets == want.buckets
    np.testing.assert_array_equal(got.rows_degraded, want.rows_degraded)
    np.testing.assert_allclose(got.p_quant, want.p_quant, **TOL)


def test_micro_batch_plan(engine):
    cq3, xq3 = _queries(3)
    r = engine.predict(cq3, xq3)
    assert r.buckets == (4,) and r.p_quant.shape == (3, 3, Q)
    assert engine.predict(*_queries(5)).buckets == (8,)
    r9 = engine.predict(*_queries(9))
    assert r9.buckets == (8, 4) and r9.p_quant.shape == (3, 9, Q)
    assert not r9.rows_degraded.any()


def test_engine_samples_match_predict_at_on_the_same_noise(paths, fit):
    """include_samples: the engine's draws are predict_at's on the twin's
    artifact with the slice's noise (the same core), bit for bit."""
    eng = _engine(paths, include_samples=True, buckets=(4,))
    cq, xq = _queries(4)
    r = eng.predict(cq, xq, seed=6)
    art = load_artifact(paths["twin"])
    res = fit["port"]._replace(sample_par=torch.as_tensor(art.sample_par),
                               sample_w=torch.as_tensor(art.sample_w))
    cache = tapi.FactorCache(None, None, None, krige_chol=torch.as_tensor(art.chol_tt))
    want, _ = tapi.predict_at(res, art.coords_test, cq, xq, config=CFG, cache=cache,
                              eps=jax_noise(6, (40, 4, Q), torch.float32, "cpu"))
    np.testing.assert_array_equal(r.p_samples, want.p_samples.numpy())
    np.testing.assert_array_equal(r.p_quant, want.p_quant.numpy())


def test_query_rejections_before_any_dispatch(engine):
    served = engine.health()["requests_served"]
    dispatches = engine.health()["dispatches"]
    cq, xq = _queries(3)
    bad_c = cq.copy()
    bad_c[1, 0] = np.nan
    with pytest.raises(tapi.QueryValidationError, match="rows \\[1\\]"):
        engine.predict(bad_c, xq)
    bad_x = xq.copy()
    bad_x[2] = np.inf
    with pytest.raises(tapi.QueryValidationError, match="x_query"):
        engine.predict(cq, bad_x)
    with pytest.raises(tapi.QueryValidationError, match="empty"):
        engine.predict(cq[:0], xq[:0])
    with pytest.raises(tapi.QueryValidationError, match="d=2"):
        engine.predict(cq[:, :1], xq)
    with pytest.raises(tapi.QueryValidationError, match="x_query"):
        engine.predict(cq, xq[:2])
    h = engine.health()
    assert (h["requests_served"], h["dispatches"]) == (served, dispatches)


def test_validation_messages_match_twin():
    cq, xq = _queries(3)
    cq[2, 1] = np.inf
    for fn, err in ((tapi.validate_query_batch, tapi.QueryValidationError),
                    (japi.validate_query_batch, japi.QueryValidationError)):
        with pytest.raises(err) as ei:
            fn(cq, xq, d=2, q=Q, p=P)
        assert "rows [2]" in str(ei.value)


def test_pad_row_identity(engine):
    """Two batches sharing their first 3 queries, padded into the same
    bucket with other tail rows: the shared rows are bitwise equal."""
    cq, xq = _queries(4, seed=21)
    cq_alt, xq_alt = _queries(4, seed=22)
    cq_alt[:3], xq_alt[:3] = cq[:3], xq[:3]
    r1 = engine.predict(cq, xq, seed=5)
    r2 = engine.predict(cq_alt, xq_alt, seed=5)
    np.testing.assert_array_equal(r1.p_quant[:, :3], r2.p_quant[:, :3])
    assert not (r1.p_quant[:, 3] == r2.p_quant[:, 3]).all()


def test_deterministic_and_seed_sensitive(engine):
    cq, xq = _queries(4)
    a = engine.predict(cq, xq, seed=9)
    b = engine.predict(cq, xq, seed=9)
    np.testing.assert_array_equal(a.p_quant, b.p_quant)
    c = engine.predict(cq, xq, seed=10)
    assert not (a.p_quant == c.p_quant).all()


def test_programs_fresh_once_then_reused(paths):
    eng = _engine(paths, warm=False)
    assert eng.program_summary()["program_sources"] == {}
    eng.predict(*_queries(3))
    eng.predict(*_queries(3))
    assert eng.program_summary()["program_sources"] == {"fresh": 2}
    eng.warm()
    assert eng.program_summary()["program_sources"] == {"fresh": 4}
    assert eng.health()["warm"]


def test_concurrent_requests_are_bitwise_serial(paths):
    """Eight threads, two requests each, two in flight: every response is
    the serial one bit for bit, and the counters add up."""
    eng = _engine(paths, max_queue=64, max_in_flight=2)
    reqs = [_queries(3 + i % 4, seed=40 + i) for i in range(4)]
    serial = [eng.predict(c, x, seed=i) for i, (c, x) in enumerate(reqs)]
    out, errs = [], []

    def worker(j):
        try:
            for k in range(2):
                i = (j + k) % len(reqs)
                out.append((i, eng.predict(*reqs[i], seed=i)))
        except Exception as e:  # noqa: BLE001 - recorded
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(j,)) for j in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert not any(th.is_alive() for th in threads)
    assert not errs and len(out) == 16
    for i, r in out:
        np.testing.assert_array_equal(r.p_quant, serial[i].p_quant)
    assert eng.health()["requests_served"] == 4 + 16


# -- deadlines and admission ------------------------------------------------


def test_budget_math():
    b = DeadlineBudget(10.0)
    assert not b.expired() and 0 < b.remaining() <= 10.0
    with pytest.raises(ValueError):
        DeadlineBudget(0.0)
    tiny = DeadlineBudget(1e-9)
    time.sleep(0.002)
    assert tiny.expired()
    assert tiny.remaining() == DeadlineBudget.MIN_WAIT_S == jserve.DeadlineBudget.MIN_WAIT_S


def test_run_under_deadline_result_exc_timeout():
    b = DeadlineBudget(5.0)
    assert run_under_deadline(lambda: 42, b, label="ok") == 42
    with pytest.raises(KeyError):
        run_under_deadline(lambda: (_ for _ in ()).throw(KeyError("x")), b, label="exc")
    short = DeadlineBudget(0.05)
    with pytest.raises(RequestTimeoutError) as ei:
        run_under_deadline(lambda: time.sleep(1.0), short, label="batch7", phase="dispatch")
    assert (ei.value.label, ei.value.phase, ei.value.deadline_s) == ("batch7", "dispatch", 0.05)


def test_run_under_deadline_keeps_the_callers_grad_mode():
    with torch.no_grad():
        assert run_under_deadline(torch.is_grad_enabled, DeadlineBudget(5.0), label="g") is False
    assert run_under_deadline(torch.is_grad_enabled, DeadlineBudget(5.0), label="g") is True


def test_stalled_dispatch_typed_and_engine_keeps_serving(engine):
    cq, xq = _queries(3)
    timed = engine.health()["requests_timed_out"]
    with stall_predict(max_fires=1, max_stall_s=10.0) as inj:
        t0 = time.monotonic()
        with pytest.raises(RequestTimeoutError) as ei:
            engine.predict(cq, xq, deadline_s=0.3)
        wall = time.monotonic() - t0
    assert inj.fires == 1
    assert "bucket4" in ei.value.label and ei.value.phase == "dispatch"
    assert wall < 5.0
    assert engine.health()["requests_timed_out"] == timed + 1
    assert np.isfinite(engine.predict(cq, xq).p_quant).all()
    assert engine.health()["state"] == "ready"


def test_expired_budget_sheds_before_dispatch(engine, monkeypatch):
    import smk_torch.serve.engine as eng_mod

    calls = []
    real = eng_mod._invoke_program
    monkeypatch.setattr(eng_mod, "_invoke_program",
                        lambda prog, key, *a: calls.append(key[0]) or real(prog, key, *a))
    budget = DeadlineBudget(1e-9)
    time.sleep(0.002)
    cq, xq = _queries(3)
    with pytest.raises(RequestTimeoutError) as ei:
        engine._serve(cq, xq, "rz", 0, budget)
    assert ei.value.phase == "dispatch"
    assert calls == []


def test_queue_flood_sheds_typed(paths):
    """The one in-flight slot stalled and a waiting room of one: the
    first follow-up waits, the next is shed at once, typed, and the two
    admitted requests complete when the stall ends."""
    eng = _engine(paths, max_queue=1, max_in_flight=1)
    cq, xq = _queries(3)
    results, errors = {}, {}

    def call(name, **kw):
        try:
            results[name] = eng.predict(cq, xq, **kw)
        except Exception as e:  # noqa: BLE001 - recorded
            errors[name] = e

    with stall_predict(max_fires=1, max_stall_s=10.0) as inj:
        a = threading.Thread(target=call, args=("a",))
        a.start()
        for _ in range(200):
            if inj.fires:
                break
            time.sleep(0.01)
        assert inj.fires == 1
        b = threading.Thread(target=call, args=("b",), kwargs={"deadline_s": 10.0})
        b.start()
        for _ in range(200):
            if eng._queue_sem._value == 0:
                break
            time.sleep(0.01)
        t0 = time.monotonic()
        call("c")
        shed_wall = time.monotonic() - t0
    a.join(timeout=10.0)
    b.join(timeout=10.0)
    assert not a.is_alive() and not b.is_alive()
    assert isinstance(errors["c"], QueueFullError)
    assert shed_wall < 1.0
    assert {"a", "b"} <= set(results)
    assert eng.health()["requests_shed"] == 1
    assert eng.health()["requests_served"] == 2


# -- degradation, health and spans -------------------------------------------


def test_partial_response_healthy_rows_bitwise(engine):
    cq, xq = _queries(4, seed=33)
    clean = engine.predict(cq, xq, seed=2)
    assert not clean.rows_degraded.any()
    with inject_predict_nan(rows=[1], max_fires=1) as inj:
        hurt = engine.predict(cq, xq, seed=2)
    assert inj.fires == 1
    np.testing.assert_array_equal(hurt.rows_degraded, [False, True, False, False])
    assert hurt.degraded
    np.testing.assert_array_equal(hurt.p_quant[:, [0, 2, 3]], clean.p_quant[:, [0, 2, 3]])
    again = engine.predict(cq, xq, seed=2)
    assert not again.rows_degraded.any()
    np.testing.assert_array_equal(again.p_quant, clean.p_quant)


def test_injectors_leave_the_seam_as_they_found_it():
    import smk_torch.serve.engine as eng_mod

    real = eng_mod._invoke_program
    with inject_predict_nan(rows=[0]), stall_predict(max_fires=0):
        assert eng_mod._invoke_program is not real
    assert eng_mod._invoke_program is real


def test_health_state_transitions(paths):
    eng = _engine(paths, degraded_threshold=2)
    cq, xq = _queries(3)
    assert eng.health()["state"] == "ready"
    with inject_predict_nan(rows=[0], max_fires=2):
        assert eng.predict(cq, xq).degraded
        assert eng.health()["state"] == "ready"
        assert eng.predict(cq, xq).degraded
    h = eng.health()
    assert h["state"] == "degraded" and not h["ready"]
    assert h["consecutive_guard_trips"] == 2 and h["rows_degraded"] == 2
    assert not eng.predict(cq, xq).degraded
    assert eng.health()["state"] == "ready"
    eng.drain()
    assert eng.health()["state"] == "draining"
    with pytest.raises(EngineDrainingError):
        eng.predict(cq, xq)
    assert eng.health()["requests_rejected"] == 1


def test_health_keys_match_twin(engine, twin_engine):
    assert sorted(engine.health()) == sorted(twin_engine.health())


def test_request_span_tree(paths, tmp_path):
    from smk_torch.obs.reporter import read_jsonl

    eng = _engine(paths, run_log_dir=str(tmp_path / "rlog"))
    eng.predict(*_queries(3), request_id="req-test")
    path = eng.run_log.path
    eng.close()
    recs = read_jsonl(path)
    spans = [r for r in recs if r.get("kind") == "span"]
    req = [s for s in spans if s["name"] == "request" and s["attrs"].get("id") == "req-test"]
    assert len(req) == 1
    buckets = [s for s in spans if s["name"] == "bucket" and s["parent"] == req[0]["span_id"]]
    assert len(buckets) == 1
    assert {s["name"] for s in spans if s["parent"] == buckets[0]["span_id"]} == {
        "dispatch", "guard"}
    end = [r for r in recs if r.get("kind") == "run_end"]
    assert end and end[0]["attrs"]["serve"]["state"] == "draining"


# -- the fleet ---------------------------------------------------------------


def test_fleet_round_robin(paths):
    fleet = ReplicaFleet(paths["twin"], n_replicas=2, buckets=BUCKETS, device="cpu",
                         noise=jax_noise)
    try:
        cq, xq = _queries(3, seed=61)
        r1 = fleet.predict(cq, xq, seed=1)
        r2 = fleet.predict(cq, xq, seed=1)
        np.testing.assert_array_equal(r1.p_quant, r2.p_quant)
        h = fleet.health()
        assert h["state"] == "ready" and h["n_replicas"] == 2
        assert h["requests_routed"] == 2 and h["totals"]["requests_served"] == 2
        assert [rep["requests_served"] for rep in h["replicas"]] == [1, 1]
    finally:
        fleet.close()


def test_fleet_all_shed_raises_typed_saturation(paths):
    fleet = ReplicaFleet(paths["twin"], n_replicas=2, buckets=BUCKETS, device="cpu",
                         warm=False)
    try:
        def shed(*a, **k):
            raise QueueFullError(1)

        for eng in fleet.engines:
            eng.predict = shed
        with pytest.raises(FleetSaturatedError) as ei:
            fleet.predict(*_queries(3, seed=62))
        assert isinstance(ei.value, QueueFullError) and ei.value.n_replicas == 2
        h = fleet.health()
        assert h["requests_shed_fleet"] == 1 and h["replica_fallthroughs"] == 2
    finally:
        fleet.close()


def test_fleet_drain_typed(paths):
    fleet = ReplicaFleet(paths["twin"], n_replicas=2, buckets=BUCKETS, device="cpu",
                         warm=False)
    try:
        fleet.drain()
        assert fleet.health()["state"] == "draining"
        with pytest.raises(EngineDrainingError):
            fleet.predict(*_queries(3, seed=63))
    finally:
        fleet.close()


# -- the knobs that wait for later slices -----------------------------------


@pytest.mark.parametrize("knob,item", [
    (dict(compile_store_dir="store"), "A10"),
    (dict(coalesce_window_ms=5.0), "A11d"),
])
def test_unported_engine_knobs_raise_naming_their_item(paths, knob, item):
    with pytest.raises(NotImplementedError, match=item):
        PredictionEngine(paths["twin"], device="cpu", **knob)


def test_negative_coalesce_window_rejected(paths):
    with pytest.raises(ValueError, match="coalesce_window_ms"):
        PredictionEngine(paths["twin"], device="cpu", coalesce_window_ms=-1.0)


def test_engine_needs_a_card_unless_asked_for_the_cpu(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionEngine(paths["twin"])
