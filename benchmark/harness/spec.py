"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file, its own file of check limits, and
the readers of its per-layer metrics. A cell, configuration, traffic mix
or metric is added by adding files and entries, never by editing one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

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
    import sys

    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))  # the readers' shared _common.py
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_list(name: str, root: Path = ROOT) -> Path:
    """The kernel-name pattern list of metric ``name``."""
    return Path(root) / "benchmark" / "metrics" / f"{name}.txt"


def peaks() -> dict:
    return load_json(HERE / "peaks.json")
