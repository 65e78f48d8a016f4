"""A cell, a configuration or a per-layer metric is added by adding
files and BENCHMARK.json entries: the harness finds them by name."""

# smklint: test-budget=a copy of the benchmark's files and JSON lookups, under a second

import json
import shutil

from harness import spec


def copy_tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_config_traffic_and_metric_are_found(tmp_path):
    root = copy_tree(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "benchmark/configs/config5.json").read_text())
    conf.update(name="config5_deep", n_samples=512)
    (root / "benchmark/configs/config5_deep.json").write_text(json.dumps(conf))
    b["configs"].append({"name": "config5_deep", "source": conf["source"],
                         "file": "benchmark/configs/config5_deep.json",
                         "reduced": ["n", "n_subsets", "n_samples"], "why": "deeper fits"})
    (root / "benchmark/traffic/fit_pair.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "warmup_samples": 8}))
    b["workloads"].append({"name": "config5_deep.fit_pair", "config": "config5_deep",
                           "traffic": "fit_pair", "chips": 1, "why": "a new cell"})
    (root / "benchmark/workloads/config5_deep.fit_pair.json").write_text(json.dumps(
        {"limits": {"p_gap": 0.5, "combine_gap": 1.0}}))
    (root / "benchmark/metrics/fits_seen.py").write_text(
        "def read(ctx):\n    return len(ctx['fits']) or None\n")
    b["per_layer"].append({"name": "fits_seen", "unit": "fits", "better": "higher",
                           "source": "host_clock", "layer": "window", "moves": "sweep_ms",
                           "workloads": ["config5_deep.fit_pair"]})
    for m in b["end_to_end"]:
        if m["name"] == "sweep_ms":  # the new cell reports this end-to-end metric too
            m["workloads"].append("config5_deep.fit_pair")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    c = spec.cell("config5_deep.fit_pair", root)
    assert c["config"]["n_samples"] == 512 and c["traffic"]["warmup_samples"] == 8
    assert c["checks"]["limits"]["p_gap"] == 0.5
    assert [m["name"] for m in c["per_layer"]] == ["fits_seen"]
    assert {m["name"] for m in c["end_to_end"]} >= {"sweep_ms", "setup_s"}
    read = spec.metric_reader("fits_seen", root)
    assert read({"fits": [1, 2, 3]}) == 3 and read({"fits": []}) is None
    # the cells already there are unchanged by the addition
    assert spec.cell("config5.fit", root)["per_layer"] == spec.cell("config5.fit")["per_layer"]


def test_metric_without_workloads_goes_to_every_cell_of_its_end_to_end(tmp_path):
    root = copy_tree(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "everywhere", "unit": "x", "better": "higher",
                           "source": "host_clock", "layer": "window", "moves": "sweep_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    # config5.fit reports sweep_ms; config4.fit reports sweep_ms.config4
    assert "everywhere" in [m["name"] for m in spec.cell("config5.fit", root)["per_layer"]]
    assert "everywhere" not in [m["name"] for m in spec.cell("config4.fit", root)["per_layer"]]
