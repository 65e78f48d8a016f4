"""The port's program store (smk_torch/compile/, ops/cuda_build.py) on
the CPU: L2 (``ProgramStore``, the built kernel libraries on disk under
the twin's integrity contract), L3 (the armed build directory) and the
acquisition through ``get_program`` with its four sources.

There is no nvcc here: the library build is monkeypatched to a command
that writes fake bytes, and nothing is loaded with ctypes. Every test
that arms L3 or touches cuda_build's per-process records puts them back
(monkeypatch), since they are process-wide.

- **The store**: a round trip; a stale fingerprint is a warned miss; a
  corrupt artifact (truncated, garbage, wrong format, bad checksum) is a
  warned miss, one parametrised case each; an artifact under another
  key's name is refused (the key-collision guard); writes are atomic; an
  uncreatable directory warns and serves nothing.
- **L3**: the armed directory is the one cuda_build builds into.
- **Libraries through the store**: nvcc ("fresh") saves to the store; a
  fresh process with a warm store runs no build and reports "l2"; a
  tampered fingerprint warns and rebuilds.
- **get_program**: sources l1 / l2 / l3 / fresh, the L2 backfill of an
  L1-warm owner, FIFO eviction at ``L1_CACHE_MAX``.
- **A fit**: a chunked fit with ``compile_store_dir`` set draws exactly
  what it draws with it off.
"""

# smklint: test-budget=no JAX fit; fake libraries and store files in tmp dirs, one small chunked port fit (K = 2, m = 20, 16 sweeps) twice, each test well under a second or two
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from smk_torch import SMKConfig
from smk_torch.compile import store as store_mod, xla_cache
from smk_torch.compile.programs import L1_CACHE_MAX, get_program
from smk_torch.compile.store import STORE_FORMAT, ProgramStore, env_fingerprint
from smk_torch.ops import cuda_build

KEY = ("cuda_library", "fused_corr", "0123456789abcdef")


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """cuda_build with a fresh build directory (armed L3 under tmp),
    empty per-process records, and a compile command that writes the
    library's name as its bytes."""
    monkeypatch.setattr(xla_cache, "_ARMED", None)
    monkeypatch.setattr(cuda_build, "ORIGIN", {})
    monkeypatch.setattr(cuda_build, "NVCC_RUNS", {})
    runs = []

    def cmd(name, out):
        runs.append(name)
        return [sys.executable, "-c",
                f"open({str(out)!r}, 'wb').write(b'lib:{name}')"]

    monkeypatch.setattr(cuda_build, "_compile_cmd", cmd)
    xla_cache.enable_persistent_cache(str(tmp_path / "build"))
    return runs


def _fresh_process(monkeypatch, tmp_path, name):
    """What a new process sees: no library records, an empty build
    directory armed as L3."""
    monkeypatch.setattr(cuda_build, "ORIGIN", {})
    monkeypatch.setattr(cuda_build, "NVCC_RUNS", {})
    xla_cache.enable_persistent_cache(str(tmp_path / name))


# -- the store ---------------------------------------------------------------


def test_store_round_trip(tmp_path):
    st = ProgramStore(str(tmp_path / "s"))
    assert st.load(KEY) is None and not st.has(KEY)
    path = st.save(KEY, b"\x00machine code\xff")
    assert path == st.path_for(KEY) and os.path.exists(path) and st.has(KEY)
    assert st.load(KEY) == b"\x00machine code\xff"
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["format"] == STORE_FORMAT and blob["key"] == repr(KEY)
    assert blob["fingerprint"] == env_fingerprint()


def test_stale_fingerprint_is_a_warned_miss(tmp_path, monkeypatch):
    st = ProgramStore(str(tmp_path / "s"))
    st.save(KEY, b"lib")
    fp = dict(env_fingerprint(), torch="0.0.0")
    monkeypatch.setattr(store_mod, "env_fingerprint", lambda: fp)
    with pytest.warns(RuntimeWarning, match="different environment"):
        assert st.load(KEY) is None


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])


def _garbage(path):
    open(path, "wb").write(b"not a pickle at all")


def _rewrite(path, **changes):
    blob = pickle.load(open(path, "rb"))
    blob.update(changes)
    pickle.dump(blob, open(path, "wb"))


@pytest.mark.parametrize("corrupt", [
    _truncate,
    _garbage,
    lambda p: _rewrite(p, format=STORE_FORMAT + 1),
    lambda p: _rewrite(p, payload=b"flipped bits"),
    lambda p: pickle.dump(["a", "list"], open(p, "wb")),
], ids=["truncated", "garbage", "format", "checksum", "not-a-dict"])
def test_corrupt_artifact_is_a_warned_miss(tmp_path, corrupt):
    st = ProgramStore(str(tmp_path / "s"))
    path = st.save(KEY, b"lib")
    corrupt(path)
    with pytest.warns(RuntimeWarning, match="corrupt or unreadable"):
        assert st.load(KEY) is None
    st.save(KEY, b"lib2")  # the stale file is overwritten
    assert st.load(KEY) == b"lib2"


def test_key_collision_guard(tmp_path):
    """An artifact moved under another key's file name is refused: the
    key inside the artifact is compared on load."""
    st = ProgramStore(str(tmp_path / "s"))
    other = KEY[:2] + ("fedcba9876543210",)
    os.replace(st.save(other, b"other lib"), st.path_for(KEY))
    with pytest.warns(RuntimeWarning, match="corrupt or unreadable"):
        assert st.load(KEY) is None


def test_atomic_write(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the published artifact as it was
    and strands at worst its temporary file; a clean save leaves none."""
    st = ProgramStore(str(tmp_path / "s"))
    st.save(KEY, b"v1")

    def dying_dump(obj, f, protocol=None):
        f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(store_mod.pickle, "dump", dying_dump)
    with pytest.warns(RuntimeWarning, match="could not persist"):
        assert st.save(KEY, b"v2") is None
    monkeypatch.undo()
    assert st.load(KEY) == b"v1"
    for f in os.listdir(st.root):
        os.remove(os.path.join(st.root, f))
    st.save(KEY, b"v3")
    assert os.listdir(st.root) == [os.path.basename(st.path_for(KEY))]


def test_uncreatable_directory_warns_and_misses(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with pytest.warns(RuntimeWarning, match="could not create"):
        st = ProgramStore(str(blocker / "store"))
    assert st.load(KEY) is None
    with pytest.warns(RuntimeWarning, match="could not persist"):
        assert st.save(KEY, b"lib") is None


# -- L3 and the libraries ------------------------------------------------------


def test_armed_directory_is_cuda_builds(tmp_path, monkeypatch):
    monkeypatch.setattr(xla_cache, "_ARMED", None)
    monkeypatch.setenv("SMK_TORCH_BUILD_DIR", str(tmp_path / "env"))
    assert not xla_cache.persistent_cache_enabled()
    assert cuda_build.build_dir() == tmp_path / "env"  # unarmed: today's resolution
    assert xla_cache.maybe_enable_from_config(SMKConfig()) is None
    d = xla_cache.maybe_enable_from_config(SMKConfig(xla_cache_dir=str(tmp_path / "l3")))
    assert d == str(tmp_path / "l3") and xla_cache.persistent_cache_enabled()
    assert cuda_build.build_dir() == tmp_path / "l3"
    assert cuda_build.library_path("fused_corr").parent == tmp_path / "l3"
    # an uncreatable directory leaves the process as it was
    (tmp_path / "blocker").write_text("x")
    assert xla_cache.enable_persistent_cache(str(tmp_path / "blocker" / "d")) is None
    assert xla_cache.armed_dir() == str(tmp_path / "l3")


def test_libraries_through_the_store(fake_build, tmp_path, monkeypatch):
    st = ProgramStore(str(tmp_path / "store"))
    names = ["fused_corr", "fused_corr_f64"]
    assert cuda_build.ensure(names, st) == dict.fromkeys(names, "fresh")
    assert sorted(fake_build) == sorted(names) and cuda_build.NVCC_RUNS == dict.fromkeys(names, 1)
    assert all(st.load(cuda_build.store_key(n)) == f"lib:{n}".encode() for n in names)
    # a new process, an empty build directory, the warm store: no build
    _fresh_process(monkeypatch, tmp_path, "build2")
    assert cuda_build.ensure(names, st) == dict.fromkeys(names, "l2")
    assert len(fake_build) == 2 and cuda_build.NVCC_RUNS == {}
    assert cuda_build.library_path("fused_corr").read_bytes() == b"lib:fused_corr"
    # the library on disk in the build directory, no store: "l3"
    monkeypatch.setattr(cuda_build, "ORIGIN", {})
    assert cuda_build.ensure(["fused_corr"]) == {"fused_corr": "l3"}
    # a tampered fingerprint: a warned miss, then the rebuild, saved again
    _fresh_process(monkeypatch, tmp_path, "build3")
    _rewrite(st.path_for(cuda_build.store_key("fused_corr")),
             fingerprint=dict(env_fingerprint(), device_name="another card"))
    with pytest.warns(RuntimeWarning, match="different environment"):
        assert cuda_build.ensure(["fused_corr"], st) == {"fused_corr": "fresh"}
    assert cuda_build.NVCC_RUNS == {"fused_corr": 1}
    assert st.load(cuda_build.store_key("fused_corr")) == b"lib:fused_corr"


# -- get_program ---------------------------------------------------------------


class _Owner:
    pass


def test_get_program_sources(fake_build, tmp_path, monkeypatch):
    from smk_torch.utils.tracing import ChunkPipelineStats

    st = ProgramStore(str(tmp_path / "store"))
    libs = ("fused_corr",)

    def acquire(owner, key, store=None, libraries=libs):
        stats = ChunkPipelineStats()
        get_program(owner, key, lambda: (lambda: key), store=store, stats=stats,
                    libraries=libraries)
        return stats.programs[0]["source"]

    a = _Owner()
    assert acquire(a, ("k", 1), st) == "fresh"          # nvcc ran in this process
    assert acquire(a, ("k", 1), st) == "l1"             # in memory
    _fresh_process(monkeypatch, tmp_path, "b2")
    assert acquire(_Owner(), ("k", 1), st) == "l2"      # libraries out of the store
    monkeypatch.setattr(cuda_build, "ORIGIN", {})
    assert acquire(_Owner(), ("k", 1)) == "l3"          # found in the build directory
    # a program with no kernel library: "l3" armed, "fresh" unarmed
    assert acquire(_Owner(), ("serve", 8), libraries=()) == "l3"
    monkeypatch.setattr(xla_cache, "_ARMED", None)
    assert acquire(_Owner(), ("serve", 8), libraries=()) == "fresh"


def test_l1_backfill_fills_a_new_store(fake_build, tmp_path):
    """An owner warm in L1 and handed a store for the first time fills it
    with the libraries its programs launch, without building again."""
    owner = _Owner()
    get_program(owner, ("k",), lambda: (lambda: 0), libraries=("fused_corr",))
    st = ProgramStore(str(tmp_path / "late"))
    assert not st.has(cuda_build.store_key("fused_corr"))
    get_program(owner, ("k",), lambda: pytest.fail("rebuilt"), store=st,
                libraries=("fused_corr",))
    assert st.load(cuda_build.store_key("fused_corr")) == b"lib:fused_corr"
    assert fake_build == ["fused_corr"]


def test_l1_fifo_eviction():
    owner = _Owner()
    built = []

    def acquire(i):
        return get_program(owner, ("k", i), lambda: built.append(i) or (lambda: i))

    for i in range(L1_CACHE_MAX + 3):
        acquire(i)
    table = owner.__dict__["_program_l1"]
    assert len(table) == L1_CACHE_MAX
    assert [key for _, key in table][:2] == [("k", 3), ("k", 4)]  # the oldest went first
    acquire(L1_CACHE_MAX + 2)  # still held: no build
    assert len(built) == L1_CACHE_MAX + 3
    acquire(0)  # evicted: built again
    assert len(built) == L1_CACHE_MAX + 4


# -- a fit ---------------------------------------------------------------------


def test_chunked_fit_with_the_store_draws_what_it_draws_without(tmp_path, monkeypatch):
    from smk_torch.parallel.partition import random_partition
    from smk_torch.parallel.recovery import fit_subsets_chunked
    from smk_torch.models.probit_gp import SpatialGPSampler
    from smk_torch.utils.tracing import ChunkPipelineStats

    monkeypatch.setattr(xla_cache, "_ARMED", None)
    rng = np.random.default_rng(0)
    n, q, p, t = 40, 1, 2, 4
    y = torch.as_tensor((rng.uniform(size=(n, q)) < 0.5).astype(np.float32))
    x = torch.as_tensor(np.concatenate([np.ones((n, q, 1)), rng.normal(size=(n, q, p - 1))],
                                       -1).astype(np.float32))
    coords = torch.as_tensor(rng.uniform(size=(n, 2)).astype(np.float32))
    ct = torch.as_tensor(rng.uniform(size=(t, 2)).astype(np.float32))
    xt = torch.ones((t, q, p))

    def fit(**kw):
        cfg = SMKConfig(n_subsets=2, n_samples=16, phi_update_every=2, **kw)
        part = random_partition(torch.randperm(n, generator=torch.Generator().manual_seed(0)),
                                y, x, coords, 2)
        stats = ChunkPipelineStats()
        res = fit_subsets_chunked(SpatialGPSampler(cfg), part, ct, xt, chunk_iters=3,
                                  pipeline_stats=stats)
        return res, stats

    on, s_on = fit(compile_store_dir=str(tmp_path / "store"))
    off, s_off = fit()
    for a, b in zip(on, off):
        assert torch.equal(a, b)
    assert [p["key"] for p in s_on.programs] == [p["key"] for p in s_off.programs]
    assert any(p["key"][0] == "burn" for p in s_on.programs)
