"""BENCHMARK.json against the benchmark's contract, and the run's last
line: its keys, their order and the metrics a cell reports."""

# smklint: test-budget=two whole runs at the small CPU shapes (about 2 s each), the rest JSON checks

import json
import re

import pytest

from harness import spec
from _tiny import run_cpu

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")
B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]


def line_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["command"] == ["python3", "benchmark/run.py"]
    assert B["paths"] == ["benchmark"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell) fits in 12 hours
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(B)) <= 64 * 1024


def test_configs():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and line_ok(c["source"]) and line_ok(c["why"])
        conf = spec.load_json(spec.ROOT / c["file"])
        assert conf["name"] == c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key)
            assert key in conf["source_values"] and conf[key] != conf["source_values"][key]


def test_workloads():
    names = {c["name"] for c in B["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in B["workloads"]}
    assert len(pairs) == len(B["workloads"]) == len(set(CELLS))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        c = spec.cell(w["name"])
        assert set(c["checks"]["limits"]) == {"p_gap", "combine_gap"}
    four = sum(1 for w in B["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(B["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in B["end_to_end"]}
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").exists()
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in B["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and line_ok(m["layer"]) and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (spec.BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and spec.kernel_list(m["name"]).exists()
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:
        c = spec.cell(cell)
        got = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and c["per_layer"]
        for m in c["per_layer"]:
            assert m["moves"] in got


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(trace, capsys):
    import run

    res, lines = run_cpu("config5.fit", trace=trace)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == bool(trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    if trace:  # the traced fit runs after the window: the device block has its seconds
        assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] >= 0
    c = spec.cell("config5.fit")
    want = {m["name"] for m in (c["per_layer"] if trace else c["end_to_end"])}
    assert set(res["metrics"]) <= want
    if not trace:
        assert {"sweep_ms", "setup_s"} <= set(res["metrics"])
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    for name, chk in res["checks"].items():
        assert set(chk) == {"value", "limit"}
    assert lines[-len(res["checks"]):] == [
        f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in res["checks"].items()]
    json.dumps(res)


def test_no_card_no_result(monkeypatch, capsys):
    import run
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "config5.fit", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
