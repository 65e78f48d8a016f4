"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its own file of check limits, the
readers of its per-layer metrics, and the pieces of its check that a
configuration file may name (its reference, its noise layout, its
inputs) with the arguments of its fits. A cell, configuration, traffic
mix or metric is added by adding files and entries, never by editing
one."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent  # benchmark/
ROOT = BENCH.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` needs: ``workload`` (its
    BENCHMARK.json entry), ``config`` (the configuration file),
    ``traffic`` (traffic/<traffic>.json), ``checks`` (the limits in
    workloads/<cell>.json), ``end_to_end`` and ``per_layer`` (the
    BENCHMARK.json metrics the cell reports)."""
    b = benchmark(root)
    bench = Path(root) / "benchmark"
    wl = {w["name"]: w for w in b["workloads"]}
    if name not in wl:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(wl)})")
    w = wl[name]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    e2e = [m for m in b["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per = [m for m in b["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {
        "workload": w,
        "config": load_json(Path(root) / conf["file"]),
        "traffic": load_json(bench / "traffic" / f"{w['traffic']}.json"),
        "checks": load_json(bench / "workloads" / f"{name}.json"),
        "end_to_end": e2e,
        "per_layer": per,
    }


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` function of metrics/<name>.py."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))  # the readers' shared _common.py
    return load_module(path, f"bench_metric_{name.replace('.', '_')}").read


def load_module(path: Path, name: str):
    """The module of file ``path``, imported under ``name``."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def kernel_list(name: str, root: Path = ROOT) -> Path:
    """The kernel-name pattern list of metric ``name``."""
    return Path(root) / "benchmark" / "metrics" / f"{name}.txt"


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


# ----------------------------------------------------------------------
# the pieces of a configuration's check, and the arguments of its fits
# ----------------------------------------------------------------------
# What a configuration file that names none of them is checked with: the
# reference and noise layout of the dense, exponential, collapsed,
# single-try, CG-at-float32 path that config5 and config4 run.
DEFAULT_PIECES = {"reference": "harness.reference", "noise": "harness.noise"}
# The keywords of ``smk_torch.fit_meta_kriging`` a cell may set.
FIT_ARGS = ("chunk_size", "chunk_iters", "checkpoint_path", "checkpoint_every", "n_devices",
            "sharded")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark_file(rel: str, key: str, root: Path = ROOT) -> Path:
    """benchmark/<rel> of the checkout at ``root``: a relative path that
    stays inside benchmark/ and names a file, else a ValueError naming
    ``key``."""
    bench = (Path(root) / "benchmark").resolve()
    path = (bench / str(rel)).resolve()
    if Path(str(rel)).is_absolute() or bench not in path.parents or not path.is_file():
        raise ValueError(f"{key}: {rel!r} is no file under benchmark/")
    return path


def piece(cfg: dict, key: str, root: Path = ROOT):
    """The module that configuration ``cfg`` names under ``key``
    ("reference" or "noise"): a .py file under benchmark/, or where the
    key is absent the harness's own."""
    rel = cfg.get(key)
    if rel is None:
        return importlib.import_module(DEFAULT_PIECES[key])
    if not str(rel).endswith(".py"):
        raise ValueError(f"{key}: {rel!r} is no .py file")
    path = benchmark_file(rel, key, root)
    stem = re.sub(r"[^A-Za-z0-9_]", "_", str(Path(rel).with_suffix("")))
    return load_module(path, f"bench_{key}_{stem}")


def generator(cfg: dict, root: Path = ROOT):
    """``make(n, q, p, t, seed)`` of configuration ``cfg``'s inputs: the
    generator of harness/data.py its ``data`` names, else the ``make`` of
    benchmark/inputs/<data>.py."""
    from harness import data

    name = cfg["data"]
    if name in data.GENERATORS:
        return data.GENERATORS[name]
    if not NAME.match(str(name)):
        raise ValueError(f"data: {name!r} is not a name")
    path = benchmark_file(f"inputs/{name}.py", "data", root)
    return load_module(path, f"bench_inputs_{name.replace('.', '_')}").make


def pieces(cfg: dict, root: Path = ROOT) -> SimpleNamespace:
    """The check's pieces of configuration ``cfg``: ``reference`` (a
    module with ``knobs(cfg)`` and ``fit(cfg, inputs, perm,
    resample_idx, noise, device, subset_grids=None)``), ``noise`` (a
    module with ``fit_seed``, ``child_seed``, ``permutation``,
    ``resample_index`` and ``streams(fit_seed, cfg, device)``) and
    ``inputs(seed)``, the configuration's inputs ``(y, x, coords,
    coords_test, x_test)`` as numpy arrays."""
    make = generator(cfg, root)
    return SimpleNamespace(
        reference=piece(cfg, "reference", root), noise=piece(cfg, "noise", root),
        inputs=lambda seed: make(cfg["n"], cfg["q"], cfg["p"], cfg["t"], seed))


def fit_args(cfg: dict, traffic: dict) -> dict:
    """The keywords the cell's fits pass to ``fit_meta_kriging``: the
    ``fit_args`` of the configuration file, then of the traffic file,
    whose value wins a clash; a key outside ``FIT_ARGS`` is a
    ValueError."""
    args = {**cfg.get("fit_args", {}), **traffic.get("fit_args", {})}
    bad = sorted(set(args) - set(FIT_ARGS))
    if bad:
        raise ValueError(f"fit_args: {bad} are not among {list(FIT_ARGS)}")
    return args


def fit_files(root: Path = ROOT) -> Path:
    """The directory a fit's ``checkpoint_path`` is taken relative to;
    harness/port.py empties it before each fit."""
    return Path(root) / "benchmark" / "_build" / "fit_files"
