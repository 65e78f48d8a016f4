"""The four-entry mesh of the port on the CPU, and the pieces of the
four-card job that a CPU shows (smk_torch/parallel/executor.py,
parallel/recovery.py, parallel/distributed.py, ops/fused_build.py).

- ``fit_meta_kriging(n_devices=4, device="cpu")`` against the twin's
  fit on its 4-device CPU mesh, draw for draw through the key replay of
  tests/test_torch_api.py, at the twin's own mesh tolerance
  (``rtol=2e-4, atol=2e-4``, tests/test_mesh_store.py:456-461).
- A meshed state keeps an unmeshed run's memory layout after every
  chunk (recovery._cat_rows).
- The block decomposition: every entry's rows of a 4-entry fit, through
  the sharded fan-out and through the chunked executor, are bitwise the
  same block fitted alone (fit_subsets_vmap / fit_subsets_chunked on
  its rows with its noise rows): each entry runs its block from its own
  initial state. chip_smoke.one_card_mesh(4) (the four blocks on one
  device, the probe's one-card reference) is bitwise the 4-entry mesh.
- The per-card launch expectation (probit_gp.dispatched_build_calls):
  the plain builds of 4-entry chunked runs, fixed and adaptive, equal the
  sum over the chunk records' pieces and the entries' initial states;
  on a mesh of one, today's ``build_calls``.
- The K = 8 adaptive case of scripts/torch_mesh_probe.py: the 4-entry
  mesh logs the unmeshed run's statistics bitwise and freezes otherwise;
  cross replays of each run's boundaries in the other's scheduler
  (chip_smoke.replay_schedule) show the rung alone parts them.
- Exact counters under threads: N threads x M plain builds count N x M;
  a thread that diverts its counts (a CUDA graph's capture) takes
  nothing from the others.
- The rank -> card binding of an ``env://`` job: four local ranks get
  four cards; two ranks on one card of a host raise
  DistributedConfigError before any collective.
"""

# smklint: test-budget=one JAX fit on the twin's 4-device CPU mesh (n=200, 8 sweeps, ~10 s) in a module fixture; port fits at n <= 200 (about a second each); two adaptive fits at K = 8, m = 200 (~15 s together on one thread); thread and stub tests in milliseconds
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from smk_tpu.api import fit_meta_kriging as jax_fit
from smk_tpu.config import SMKConfig as JaxConfig
from smk_torch import SMKConfig, fit_meta_kriging
from smk_torch.models import probit_gp as tp
from smk_torch.ops import fused_build
from smk_torch.parallel import distributed as dist
from smk_torch.parallel import executor, partition, recovery
from smk_torch.testing.faults import flaky_coordinator
from smk_torch.utils.tracing import ChunkPipelineStats
from test_torch_api import JaxRandomness

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, P, T, K, NS = 200, 1, 2, 6, 8, 8
TWIN_MESH_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_mesh_store.py:456-461
FIELDS = ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "p_quant",
          "param_quant", "w_quant", "phi_accept_rate")


def _same(a, b) -> bool:
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _problem():
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(N, 2)).astype(np.float32)
    x = np.concatenate([np.ones((N, Q, 1)), rng.normal(size=(N, Q, P - 1))],
                       -1).astype(np.float32)
    y = (rng.uniform(size=(N, Q)) < 0.5).astype(np.float32)
    return y, x, coords, rng.uniform(size=(T, 2)).astype(np.float32), np.ones((T, Q, P),
                                                                            np.float32)


def _mesh4():
    return executor.make_mesh(4, device="cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: under the full suite every xdist worker's
    CPU fits would otherwise contend with all cores each (the port's
    adaptive fit on four entries took 2 s alone and over 60 s there)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def four():
    data = _problem()
    kw = dict(n_subsets=K, n_samples=NS)
    key = jax.random.key(11)
    ref = jax_fit(key, *data, config=JaxConfig(**kw), n_devices=4)
    port = fit_meta_kriging(*data, config=SMKConfig(**kw), randomness=JaxRandomness(key),
                            device="cpu", n_devices=4)
    return {"ref": ref, "port": port, "data": data, "kw": kw}


@pytest.mark.parametrize("field", FIELDS)
def test_four_entry_fit_matches_the_twins_four_device_fit(four, field):
    np.testing.assert_allclose(getattr(four["port"], field).numpy(),
                               np.asarray(getattr(four["ref"], field)), **TWIN_MESH_TOL)


def _part():
    y, x, coords, ct, xt = map(torch.as_tensor, _problem())
    part = partition.random_partition(torch.randperm(N, generator=torch.Generator()
                                                     .manual_seed(2)), y, x, coords, K)
    return part, ct, xt


def _noise(model, part, ct, xt):
    return model.default_noise(recovery.stacked_subset_data(part, ct, xt), seed=5)


def _block(part, lo, hi):
    return partition.Partition(*(None if t is None else t[lo:hi] for t in part))


@pytest.mark.parametrize("path", ["sharded", "chunked", "chunk_size"])
def test_each_entry_is_its_block_fitted_alone(path):
    """Every entry of a 4-entry mesh (blocks of two subsets) runs its
    block from its own initial state with its noise rows: its rows are
    bitwise the block fitted alone, on both mesh paths. With a
    ``chunk_size`` (a 2-entry mesh, two pieces of two subsets an entry)
    each entry's block is the block fitted alone in pieces of two."""
    part, ct, xt = _part()
    cfg = SMKConfig(n_subsets=K, n_samples=12, phi_sampler="collapsed", phi_update_every=2)
    model = tp.SpatialGPSampler(cfg)
    noise = _noise(model, part, ct, xt)
    entries = 2 if path == "chunk_size" else 4
    per = K // entries
    if path == "sharded":
        got = executor.fit_subsets_sharded(model, part, ct, xt, noise, mesh=_mesh4())
    else:
        got = recovery.fit_subsets_chunked(
            model, part, ct, xt, noise, chunk_iters=4,
            mesh=executor.make_mesh(entries, device="cpu"),
            chunk_size=4 if path == "chunk_size" else None)
    for i in range(entries):
        lo, hi = i * per, (i + 1) * per
        alone_model = tp.SpatialGPSampler(cfg)
        fresh = _noise(alone_model, part, ct, xt)  # the same seeds, not yet drawn from
        if path == "sharded":
            alone = executor.fit_subsets_vmap(alone_model, _block(part, lo, hi), ct, xt,
                                              executor._chunk_noise(fresh, lo, hi))
        else:
            alone = recovery.fit_subsets_chunked(
                alone_model, _block(part, lo, hi), ct, xt, fresh.rows(range(lo, hi)),
                chunk_iters=4, chunk_size=2 if path == "chunk_size" else None)
        for f, u, v in zip(got._fields, got, alone):
            assert _same(u[lo:hi], v), (i, f)


def test_a_meshed_state_keeps_the_unmeshed_layout(monkeypatch):
    """The chunked executor gathers its pieces' state in their memory
    order: after every chunk each leaf of a 4-entry run has the strides
    of a one-piece run (the factors stay column-major as the Cholesky
    returns them; a batched product's bits on the card follow its
    operands' strides, so a row-major gather changed a meshed fit's
    draws)."""
    part, ct, xt = _part()
    cfg = SMKConfig(n_subsets=K, n_samples=16, fused_build="pallas")
    seen = {}
    real = recovery._run_chunk

    def spy(model, kind, pieces, state, start, n):
        st, dr = real(model, kind, pieces, state, start, n)
        seen.setdefault(len(pieces), []).append([t.stride() for t in st])
        return st, dr

    monkeypatch.setattr(recovery, "_run_chunk", spy)
    for entries in (1, 4):
        model = tp.SpatialGPSampler(cfg)
        recovery.fit_subsets_chunked(model, part, ct, xt, _noise(model, part, ct, xt),
                                     chunk_iters=4, mesh=executor.make_mesh(entries, device="cpu"))
    assert seen[1] == seen[4] and len(seen[1]) == 4
    stacked = [torch.randn(3, 1, 5, 5).mT.contiguous().mT for _ in range(2)]
    whole = recovery._cat_rows(stacked, "cpu")
    assert whole.stride() == stacked[0].stride() and torch.equal(whole, torch.cat(stacked))


def test_one_card_blocks_are_the_four_entry_mesh():
    """chip_smoke.one_card_mesh(4): four entries on one device, each
    block run as its entry runs it, one after another: bitwise the
    4-entry mesh, field for field."""
    data = _problem()
    cfg = SMKConfig(n_subsets=K, n_samples=12, fault_policy="quarantine")
    a = fit_meta_kriging(*data, config=cfg, seed=3, device="cpu", mesh=_mesh4(), chunk_iters=4)
    b = fit_meta_kriging(*data, config=cfg, seed=3, device="cpu",
                         mesh=chip_smoke.one_card_mesh(4, torch.device("cpu")), chunk_iters=4)
    assert all(chip_smoke.every_field_bitwise(a, b).values())
    gaps = chip_smoke.field_gaps(a, b)
    assert set(gaps.values()) == {0.0}
    assert chip_smoke.phi_decisions_differ(a, b, Q) == 0


# -- the per-card launch expectation (R3) ---------------------------------------


ADAPT = dict(n_samples=60, burn_in_frac=0.5, n_chains=2, live_diagnostics=True,
             adaptive_schedule="on", target_rhat=1.5, target_ess=6.0, adapt_patience=1,
             min_samples_before_stop=8, adapt_max_extra_frac=0.5)


@pytest.mark.parametrize("entries,adaptive,chunk_size", [
    (1, False, None), (4, False, None), (1, True, None), (4, True, None), (2, False, 4)])
def test_builds_equal_the_per_card_expectation_of_the_chunk_records(entries, adaptive,
                                                                   chunk_size):
    """Each entry starts its block once (whole, also where ``chunk_size``
    splits it into pieces) and each piece runs every chunk it is given."""
    part, ct, xt = _part()
    cfg = SMKConfig(n_subsets=K, fused_build="pallas",
                    **(ADAPT if adaptive else dict(n_samples=16)))
    model = tp.SpatialGPSampler(cfg)
    stats = ChunkPipelineStats()
    mesh = executor.make_mesh(entries, device="cpu")
    # this thread's builds alone (the CPU entries run inline): a thread
    # another test left running cannot add to them
    with fused_build.diverted_counts() as sink:
        recovery.fit_subsets_chunked(model, part, ct, xt, _noise(model, part, ct, xt),
                                     chunk_iters=4, mesh=mesh, pipeline_stats=stats,
                                     chunk_size=chunk_size)
    calls = {e: sink[2].get(e, 0) for e in fused_build.ENTRY_POINTS}
    want = tp.dispatched_build_calls(cfg, Q, stats.chunks, entries=entries)
    assert calls == want and sum(calls.values()) > 0
    pieces = entries if chunk_size is None else K * entries // chunk_size
    assert {ch["pieces"] for ch in stats.chunks if ch["phase"] != "drain"} - {0} == {pieces}
    one = tp.build_calls(cfg, Q, cfg.n_samples, cfg.n_burn_in, chunk_iters=4)
    if chunk_size is not None:
        start = {e: 0 for e in one}
        start["fused_masked_correlation_stack"] = 1
        assert want == {e: entries * start[e] + pieces * (v - start[e]) for e, v in one.items()}
    elif not adaptive:
        assert want == {e: entries * v for e, v in one.items()}
    # the one-card expectation of the chunk records, as chip_smoke had it
    one_card = tp.dispatched_build_calls(cfg, Q, [{k: v for k, v in ch.items() if k != "pieces"}
                                                  for ch in stats.chunks])
    assert (want == one_card) == (entries == 1)


# -- the K = 8 adaptive case: what the four-entry rung changes -------------------


def _adaptive_small(mesh, log_dir):
    """The probe's K = 8, m = 200 adaptive case on the CPU: (stats, the
    run's live_diagnostics events by iteration, config)."""
    import glob

    from smk_torch.obs.reporter import read_jsonl

    knobs = dict(n_samples=80, burn_in_frac=0.5, live_diagnostics=True, adaptive_schedule="on",
                 target_rhat=1.5, target_ess=8.0, adapt_patience=1, min_samples_before_stop=8,
                 adapt_max_extra_frac=0.5, n_chains=2, fused_build="pallas")
    cfg = SMKConfig(n_subsets=8, run_log_dir=str(log_dir), **knobs)
    part, ct, xt = chip_smoke._small_problem(1600, 8, torch.device("cpu"))
    model = tp.SpatialGPSampler(cfg)
    stats = ChunkPipelineStats()
    noise = model.default_noise(recovery.stacked_subset_data(part, ct, xt), seed=chip_smoke.SEED)
    recovery.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=chip_smoke.ADAPT_CHUNK,
                                 pipeline_stats=stats, mesh=mesh)
    (log,) = glob.glob(os.path.join(str(log_dir), "*.jsonl"))
    events = {r["attrs"]["iteration"]: r["attrs"] for r in read_jsonl(log)
              if r.get("kind") == "event" and r.get("name") == "live_diagnostics"}
    return stats, events, cfg


def _replayed(cfg, events, stats, n_devices):
    rungs = []
    sched = chip_smoke.replay_schedule(cfg, 8, list(events.values()), stats.chunks,
                                       n_devices=n_devices, rungs=rungs)
    return sched.summary(), rungs


def test_the_four_entry_rung_alone_changes_the_adaptive_freezes(tmp_path):
    """On the CPU a 4-entry mesh (blocks of two subsets) draws bitwise the
    unmeshed run's draws, so the two runs log the same statistics at
    every boundary both reach, and yet they freeze differently: only the
    rung can part them. The unmeshed run's boundaries replayed on four
    entries give the meshed run's schedule; the meshed run's replayed on
    one entry give the unmeshed run's freezes as far as its boundaries
    reach (a later freeze stays open there)."""
    um, ev_u, cfg = _adaptive_small(None, tmp_path / "unmeshed")
    m4, ev_m, _ = _adaptive_small(executor.make_mesh(4, device="cpu"), tmp_path / "mesh4")
    common = sorted(set(ev_u) & set(ev_m))
    assert common and all(ev_u[i]["rhat_max"] == ev_m[i]["rhat_max"]
                          and ev_u[i]["ess_min"] == ev_m[i]["ess_min"] for i in common)
    fz_u, fz_m = um.adaptive["frozen_at"], m4.adaptive["frozen_at"]
    assert fz_u != fz_m
    kc_m = [ch["kc"] for ch in m4.chunks if ch["phase"] in ("sample", "extra")]
    summ, rungs = _replayed(cfg, ev_u, um, 4)
    assert (summ["frozen_at"], summ["extra_granted"], rungs) == (
        fz_m, m4.adaptive["extra_granted"], kc_m)
    last = max(ch["iteration"] for ch in m4.chunks if ch["phase"] in ("sample", "extra"))
    summ, _ = _replayed(cfg, ev_m, m4, 1)
    assert summ["frozen_at"] == [f if 0 <= f <= last else -1 for f in fz_u]


# -- exact counters under threads (R2) -----------------------------------------


COUNT_STRESS = """
import sys, threading
import torch
from smk_torch.ops import fused_build
n_threads, m_calls = 8, 40
coords = torch.rand((5, 2), generator=torch.Generator().manual_seed(0))
phis = torch.tensor([3.0])
start = threading.Barrier(n_threads)

def worker():
    start.wait(timeout=30)
    for _ in range(m_calls):
        fused_build.fused_correlation_stack(coords, phis, "exponential")

sys.setswitchinterval(1e-6)
threads = [threading.Thread(target=worker) for _ in range(n_threads)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=60)
assert not any(t.is_alive() for t in threads)
print(fused_build.PLAIN_CALLS["fused_correlation_stack"], sum(fused_build.LAUNCHES.values()),
      fused_build.DEVICE_LAUNCHES)
"""


def test_counts_are_exact_under_threads():
    """8 threads x 40 plain builds at once, the interpreter switching
    threads every microsecond: exactly 320 counted. In a process of its
    own, so no thread of another test adds to the count."""
    out = subprocess.run([sys.executable, "-c", COUNT_STRESS], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["320", "0", "{}"]


DIVERT = """
import threading
import torch
from smk_torch.ops import fused_build
coords = torch.rand((5, 2), generator=torch.Generator().manual_seed(0))
phis = torch.tensor([3.0])
inside, release, sink = threading.Event(), threading.Event(), {}

def capturer():
    with fused_build.diverted_counts() as got:
        fused_build.fused_correlation_stack(coords, phis, "exponential")
        inside.set()
        release.wait(timeout=30)
        fused_build.fused_correlation_stack(coords, phis, "exponential")
    sink["got"] = got

t = threading.Thread(target=capturer)
t.start()
assert inside.wait(timeout=30)
for _ in range(3):  # this thread counts as usual meanwhile
    fused_build.fused_correlation_stack(coords, phis, "exponential")
release.set()
t.join(timeout=30)
assert not t.is_alive()
before = fused_build.PLAIN_CALLS["fused_correlation_stack"]
fused_build.add_counts(sink["got"])  # a replay adds the diverted counts
print(before, sink["got"][2], fused_build.PLAIN_CALLS["fused_correlation_stack"])
"""


def test_a_diverting_thread_takes_nothing_from_the_others():
    """A thread inside ``diverted_counts`` (a graph's capture) counts its
    2 builds into its sink while the main thread's 3 count as usual;
    adding the sink (a replay) then counts them. In a process of its own."""
    out = subprocess.run([sys.executable, "-c", DIVERT], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "3 {'fused_correlation_stack': 2} 5"


# -- the rank -> card binding of an env:// job (R1) -----------------------------


@pytest.mark.parametrize("pid,ids,env,n_visible,want", [
    (None, None, {"LOCAL_RANK": "0", "RANK": "4"}, 4, 0),
    (None, None, {"LOCAL_RANK": "3", "RANK": "7"}, 4, 3),
    (None, None, {"RANK": "6"}, 4, 2),
    (None, None, {}, 4, 0),
    (5, None, {"LOCAL_RANK": "0"}, 4, 1),
    (None, [2], {"LOCAL_RANK": "0"}, 4, 2),
    # one card visible to each process (a per-process CUDA_VISIBLE_DEVICES)
    (None, None, {"LOCAL_RANK": "3", "RANK": "3"}, 1, 0),
    (None, None, {"RANK": "2"}, 1, 0),
])
def test_local_card(pid, ids, env, n_visible, want):
    assert dist.local_card(pid, ids, n_visible, env) == want


def _entry(index, host, uuid):
    return ["NVIDIA H100 80GB HBM3", "cuda", [index], host, uuid]


def test_distinct_cards_per_host():
    # one card on two hosts is two cards
    dist.check_distinct_cards([_entry(i % 2, f"host{i // 2}", f"GPU-{i % 2}") for i in range(4)])
    dist.check_distinct_cards([["cpu", "cpu", [None], "h", None]] * 4)
    # each rank sees only its own card: all cuda:0, four cards
    dist.check_distinct_cards([_entry(0, "h", f"GPU-{i}") for i in range(4)])
    with pytest.raises(dist.DistributedConfigError, match="ranks 0 and 2 both drive card GPU-1"):
        dist.check_distinct_cards([_entry(1, "h", "GPU-1"), _entry(0, "h", "GPU-0"),
                                   _entry(1, "h", "GPU-1"), _entry(3, "h", "GPU-3")])
    # the same card under two ordinals (two visibility masks) is one card
    with pytest.raises(dist.DistributedConfigError, match="ranks 1 and 3 both drive card GPU-2"):
        dist.check_distinct_cards([_entry(0, "h", "GPU-0"), _entry(2, "h", "GPU-2"),
                                   _entry(0, "h", "GPU-1"), _entry(0, "h", "GPU-2")])


class _Props:
    def __init__(self, uuid):
        self.uuid = uuid


@pytest.fixture()
def fake_cards(monkeypatch):
    """Cards as far as init_distributed can tell: the device queries
    stubbed, set_device recorded. ``state["uuids"]`` are the UUIDs of the
    cards this process sees (four unless a test narrows it)."""
    state = {"current": 0, "set": [], "uuids": [f"GPU-{i}" for i in range(4)]}

    def set_device(i):
        state["set"].append(int(i))
        state["current"] = int(i)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(state["uuids"]))
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: _Props(state["uuids"][int(i)]))
    for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    dist._reset_state_for_testing()
    yield state
    dist._reset_state_for_testing()


def _gathered(entries):
    """An allgather_bytes stand-in that answers with ``entries``, four
    ranks' ``(index, uuid)`` on one host. It holds this rank's own entry
    to what init_distributed gathered."""
    def gather(tag, payload, *, timeout_s):
        mine = json.loads(payload)
        index, uuid = entries[int(os.environ["RANK"])]
        assert (mine[2], mine[4]) == ([index], uuid)
        return [json.dumps(_entry(i, "host", u)).encode() for i, u in entries]
    return gather


def _start_ranks(fake_cards, monkeypatch, entries, uuids_of_rank):
    """init_distributed as each of four env:// ranks of one host: rank r
    sees the cards ``uuids_of_rank(r)``."""
    monkeypatch.setattr(dist, "allgather_bytes", _gathered(entries))
    for r in range(4):
        fake_cards["uuids"] = uuids_of_rank(r)
        fake_cards["current"] = 0
        monkeypatch.setenv("LOCAL_RANK", str(r))
        monkeypatch.setenv("RANK", str(r))
        with flaky_coordinator(0):
            topo = dist.init_distributed(num_processes=4, device="cuda")
        assert topo.global_device_count == 4
        dist._reset_state_for_testing()


def test_env_job_binds_each_local_rank_its_card(fake_cards, monkeypatch):
    all_four = [f"GPU-{i}" for i in range(4)]
    _start_ranks(fake_cards, monkeypatch, [(i, f"GPU-{i}") for i in range(4)],
                 lambda r: all_four)
    assert fake_cards["set"] == [0, 1, 2, 3]


def test_env_job_with_one_visible_card_a_rank(fake_cards, monkeypatch):
    """Each rank sees only its own card (``--gpus-per-task=1``): every rank
    binds its cuda:0, and four distinct UUIDs make four cards."""
    _start_ranks(fake_cards, monkeypatch, [(0, f"GPU-{i}") for i in range(4)],
                 lambda r: [f"GPU-{r}"])
    assert fake_cards["set"] == [0, 0, 0, 0]


@pytest.mark.parametrize("entries,ranks", [
    ([(0, "GPU-0"), (1, "GPU-1"), (1, "GPU-1"), (3, "GPU-3")], "ranks 1 and 2"),
    ([(0, "GPU-0"), (0, "GPU-1"), (0, "GPU-1"), (0, "GPU-3")], "ranks 1 and 2"),
])
def test_two_ranks_on_one_card_raise_before_any_collective(fake_cards, monkeypatch, entries,
                                                           ranks):
    """A duplicated card, under one ordinal or (one visible card a rank)
    under cuda:0 everywhere, raises before NCCL starts."""
    monkeypatch.setattr(dist, "allgather_bytes", _gathered(entries))
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("RANK", "1")
    if entries[1][0] == 0:  # one visible card a rank
        fake_cards["uuids"] = [entries[1][1]]
    with flaky_coordinator(0):
        with pytest.raises(dist.DistributedConfigError, match=ranks):
            dist.init_distributed(num_processes=4, device="cuda")
    assert dist.rank_entries() is None  # nothing established
