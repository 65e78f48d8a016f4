"""The port's runtime sanitizers (smk_torch/analysis/sanitizers.py)
against the JAX package's (smk_tpu/analysis/sanitizers.py).

- The transfer ledger on the twin's sanitizer problem (n = 64, K = 4,
  m = 16, 12 sweeps in chunks of 6, chunk_pipeline="overlap", a
  checkpoint, nan_guard): one twin fit under the twin's
  ``transfer_guard_strict`` in a module fixture, and the port's fit of
  the same partition under the port's; the d2h tag sets and the counts
  per tag are equal, the guard fetch's bytes the port's shape ((K + 1)
  floats a boundary where the twin fetches K + 4 bytes), and the
  guarded draws bitwise an unguarded run's.
- The compile guard's CPU half: a same-bucket refit on one model counts
  0 events, a perturbed bucket (m 16 -> 12) raises RecompileError.
- The ledger's thread safety and nesting (the twin's cases), and, with
  a stand-in for torch's sync debug mode, the arming, the restore after
  an exception and the count of open sanctioned scopes across threads.
- ``utils/tracing.device_sync``: a no-op for host tensors; on the card
  a sanctioned wait (``gpu``-marked).
- On the card (``gpu``-marked, skipped here): an ``.item()`` raises in
  the armed region, and a capture counts one compile event.
"""

# smklint: test-budget=one JAX chunked fit at m=16 (the twin's sanitizer problem, ~10 s of compiles) in a module fixture; port fits at that size take under a second each; the rest is host bookkeeping
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.analysis import sanitizers as jsan
from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.models.probit_gp import SpatialProbitGP as JaxSampler
from smk_tpu.parallel import recovery as jrec
from smk_tpu.parallel.partition import random_partition as jax_random_partition
from smk_torch import convert
from smk_torch.analysis import sanitizers as san
from smk_torch.config import SMKConfig
from smk_torch.models import probit_gp as tp
from smk_torch.parallel import recovery as rec

KNOBS = dict(n_subsets=4, n_samples=12, burn_in_frac=0.5, phi_update_every=2,
             chunk_pipeline="overlap")
K, N_CHUNKS = 4, 2  # 12 sweeps in chunks of 6: one burn-in and one sampling boundary


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    q, p, t = 1, 2, 3
    coords = jnp.asarray(rng.uniform(size=(n, 2)), jnp.float32)
    x = jnp.asarray(rng.normal(size=(n, q, p)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 2, size=(n, q)), jnp.float32)
    ct = jnp.asarray(rng.uniform(size=(t, 2)), jnp.float32)
    xt = jnp.asarray(rng.normal(size=(t, q, p)), jnp.float32)
    jp = jax_random_partition(jax.random.key(0), y, x, coords, K)
    return {"jpart": jp, "ct": ct, "xt": xt, "part": convert.partition_from_numpy(jp),
            "ct_t": torch.as_tensor(np.array(ct)), "xt_t": torch.as_tensor(np.array(xt))}


@pytest.fixture(scope="module")
def problem():
    return _problem(64, 7)


@pytest.fixture(scope="module")
def twin_ledger(problem, tmp_path_factory):
    """The twin's ledger of its overlap test's fit (the one JAX fit)."""
    path = str(tmp_path_factory.mktemp("twin") / "ck.npz")
    with jsan.transfer_guard_strict(h2d="allow") as ledger:
        jrec.fit_subsets_chunked(JaxSampler(JaxConfig(**KNOBS), weight=1), problem["jpart"],
                                 problem["ct"], problem["xt"], jax.random.key(1), chunk_iters=6,
                                 checkpoint_path=path, nan_guard=True)
    return ledger


@pytest.fixture(scope="module")
def model():
    """One port model for the module: its L1 program table makes every
    fit after the first compile-free."""
    return tp.SpatialGPSampler(SMKConfig(**KNOBS))


def _fit(model, prob, path=None, **kw):
    data = rec.stacked_subset_data(prob["part"], prob["ct_t"], prob["xt_t"])
    return rec.fit_subsets_chunked(model, prob["part"], prob["ct_t"], prob["xt_t"],
                                   model.default_noise(data, seed=1), chunk_iters=6,
                                   checkpoint_path=path, **kw)


def test_overlap_ledger_matches_the_twins(model, problem, twin_ledger, tmp_path):
    ref = _fit(model, problem)
    with san.transfer_guard_strict() as ledger:
        res = _fit(model, problem, path=str(tmp_path / "ck.npz"), nan_guard=True)
    assert twin_ledger.tags == {"host_snapshot", "chunk_stats", "run_identity"}
    assert ledger.tags == twin_ledger.tags
    for tag in twin_ledger.tags:
        assert ledger.count(tag) == twin_ledger.count(tag), tag
        assert {d for (t, _), d in zip(ledger.entries, ledger.directions)
                if t == tag} == {"d2h"}, tag
    assert twin_ledger.bytes_for("chunk_stats") == N_CHUNKS * (K + 4)
    assert ledger.bytes_for("chunk_stats") == N_CHUNKS * (K + 1) * 4
    assert ledger.bytes_for("host_snapshot") > 0
    for f, a, b in zip(ref._fields, ref, res):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)), f


def test_streaming_stats_ride_the_boundary_fetch(model, problem, tmp_path):
    """live_diagnostics adds exactly the twin's one tag: two (K,) floats
    a sampling boundary, in the same pinned copy as the guard's."""
    armed = tp.SpatialGPSampler(SMKConfig(**dict(KNOBS, live_diagnostics=True)))
    with san.transfer_guard_strict() as ledger:
        _fit(armed, problem, path=str(tmp_path / "ck.npz"), nan_guard=True)
    assert ledger.tags == {"host_snapshot", "chunk_stats", "run_identity", "streaming_stats"}
    assert ledger.count("streaming_stats") == 1
    assert ledger.bytes_for("streaming_stats") == 2 * K * 4


def test_same_bucket_refit_compiles_nothing(model, problem):
    _fit(model, problem)  # warm (a no-op when an earlier test warmed)
    before = san.compile_count()
    with san.recompile_guard(label="same-bucket refit") as guard:
        assert _fit(model, problem) is not None
    assert guard.compiles == 0
    assert san.compile_count() == before


def test_shape_perturbed_call_is_caught(model, problem):
    small = _problem(48, 3)  # m 16 -> 12: a new bucket
    with pytest.raises(san.RecompileError) as ei:
        with san.recompile_guard(label="perturbed bucket") as guard:
            _fit(model, small, stop_after_chunks=1)
    assert ei.value.compiles > 0 and "perturbed bucket" in str(ei.value)
    assert guard.compiles == ei.value.compiles  # CPU: the L1 builds


def test_budget_and_check(model, problem):
    _fit(model, problem)
    with san.recompile_guard(max_compiles=2, label="budgeted") as g:
        _fit(model, problem)
        assert g.check() == 0
    with pytest.raises(san.RecompileError):
        with san.recompile_guard(max_compiles=0, label="strict"):
            san.note_compile()


# -- the ledger -------------------------------------------------------------
def test_ledger_units_match_the_twins():
    for mod in (jsan, san):
        led = mod.TransferLedger()
        led.record("a", 10)
        led.record("a", -1)  # unknown size: counted, not summed
        led.record("b", 5)
        assert led.tags == {"a", "b"}
        assert (led.count("a"), led.bytes_for("a"), led.bytes_for("b")) == (2, 10, 5)


def test_explicit_scopes_ledger_only_when_strict():
    with san.explicit_d2h("outside", nbytes=12):
        pass
    with san.transfer_guard_strict() as ledger:
        with san.explicit_d2h("inside", nbytes=12), san.explicit_h2d("up", nbytes=4):
            with san.explicit_wait("wait"):
                pass
    assert ledger.entries == [("inside", 12), ("up", 4), ("wait", -1)]
    assert ledger.directions == ["d2h", "h2d", "wait"]
    assert ledger.count("outside") == 0
    # a nested region ledgers apart and hands the outer one back
    with san.transfer_guard_strict() as outer:
        with san.transfer_guard_strict() as inner:
            with san.explicit_d2h("x"):
                pass
        with san.explicit_d2h("y"):
            pass
    assert inner.tags == {"x"} and outer.tags == {"y"}
    with pytest.raises(ValueError):
        with san.transfer_guard_strict(d2h="sometimes"):
            pass


def test_ledger_and_scope_count_are_thread_safe(fake_mode):
    """More threads than cores open and close sanctioned scopes with a
    short switch interval: no ledger entry is lost, and the shared count
    of open scopes ends at 0 with the region's mode re-armed (a lost
    update would leave the mode lifted or the count off)."""
    n_threads = min(64, (os.cpu_count() or 4) + 4)
    n_each = 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with san.transfer_guard_strict() as ledger:
            def work(i):
                for _ in range(n_each):
                    with san.explicit_d2h(f"t{i % 2}", nbytes=1):
                        pass

            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            assert san._open_scopes == 0 and fake_mode["mode"] == 2
    finally:
        sys.setswitchinterval(old)
    assert len(ledger.entries) == n_threads * n_each == len(ledger.directions)
    assert ledger.bytes_for("t0") + ledger.bytes_for("t1") == n_threads * n_each


@pytest.fixture
def fake_mode(monkeypatch):
    """torch's process-wide sync debug mode, stood in for on the CPU."""
    state = {"mode": 0, "sets": []}

    def set_mode(m):
        m = {"default": 0, "warn": 1, "error": 2}.get(m, m)
        state["mode"] = m
        state["sets"].append(m)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    return state


def test_strict_region_arms_and_restores_the_mode(fake_mode):
    fake_mode["mode"] = 1  # a mode the caller had set
    with san.transfer_guard_strict():
        assert fake_mode["mode"] == 2
        with san.explicit_d2h("a"):
            assert fake_mode["mode"] == 0
        assert fake_mode["mode"] == 2
    assert fake_mode["mode"] == 1
    with san.transfer_guard_strict(d2h="log", h2d="allow"):
        assert fake_mode["mode"] == 1  # "log" is "warn"
    with pytest.raises(RuntimeError, match="boom"):
        with san.transfer_guard_strict():
            raise RuntimeError("boom")
    assert fake_mode["mode"] == 1
    fake_mode["sets"].clear()
    with san.transfer_guard_strict(d2h="allow", h2d="allow"):
        pass
    assert fake_mode["sets"] == []  # nothing to arm


def test_open_scopes_on_two_threads_share_one_mode(fake_mode):
    """The mode is process-wide: while a background writer's scope is
    open the main thread's scope neither re-arms nor disarms it, and the
    last scope to close puts the region's mode back."""
    opened, release = threading.Event(), threading.Event()

    def writer():
        with san.explicit_d2h("host_snapshot"):
            opened.set()
            release.wait(timeout=30)

    with san.transfer_guard_strict():
        t = threading.Thread(target=writer)
        t.start()
        assert opened.wait(timeout=30)
        assert fake_mode["mode"] == 0
        with san.explicit_d2h("chunk_stats"):
            assert fake_mode["mode"] == 0
        assert fake_mode["mode"] == 0  # the writer's scope is still open
        release.set()
        t.join(timeout=30)
        assert fake_mode["mode"] == 2
    assert fake_mode["mode"] == 0


def test_arming_failure_raises(monkeypatch, fake_mode):
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda m: None)
    with pytest.raises(RuntimeError, match="could not arm"):
        with san.transfer_guard_strict():
            pass


def test_device_sync_waits_only_on_cards():
    """utils/tracing.device_sync: host tensors need no wait (nothing is
    ledgered), and it takes any tree of tensors."""
    from smk_torch.utils.tracing import device_sync

    with san.transfer_guard_strict() as ledger:
        device_sync({"a": torch.ones(2), "b": (torch.zeros(1), 3)})
    assert ledger.entries == []


# -- on the card --------------------------------------------------------------
@pytest.mark.gpu
def test_armed_mode_raises_on_an_item():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch's sync debug mode watches CUDA calls only")
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError, match="synchronizing"):
        with san.transfer_guard_strict():
            x.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    with san.transfer_guard_strict() as ledger:
        with san.explicit_d2h("probe", nbytes=4):
            assert x.sum().item() == 4.0
    assert ledger.count("probe") == 1


@pytest.mark.gpu
def test_device_sync_is_a_sanctioned_wait_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the armed sync debug mode watches CUDA calls only")
    from smk_torch.utils.tracing import device_sync

    with san.transfer_guard_strict() as ledger:
        device_sync((torch.ones(4, device="cuda"), torch.ones(2)))
    assert ledger.entries == [("device_sync", -1)] and ledger.directions == ["wait"]


@pytest.mark.gpu
def test_a_capture_counts_one_compile_event():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph capture has no CPU mode")
    from smk_torch.compile.programs import GraphProgram

    prog = GraphProgram(lambda a: a * 2.0, ("probe",), "cuda")
    x = torch.arange(8.0, device="cuda")
    with san.recompile_guard(max_compiles=1) as guard:
        prog(x)
        prog(x)
    assert guard.compiles == 1  # the one capture
