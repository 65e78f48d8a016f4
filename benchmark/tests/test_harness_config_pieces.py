"""A configuration brings the pieces of its check as added files: its
reference, its noise layout, its inputs and the arguments of its fits
(harness/spec.pieces, spec.fit_args). The cells that name none are
checked by the harness's own, and those refuse, at set-up, a
configuration outside what they compute."""

# smklint: test-budget=JSON lookups, set-up refusals before any fit, and two runs at the small CPU shapes on one thread (about 1 s each)

import json
import shutil

import pytest

from harness import data, noise, reference, spec
from _tiny import TINY, run_cpu
from test_harness_discovery import copy_tree

CELLS = {"config5.fit": "binary_field", "config4.fit": "ebird_proxy"}
OUTSIDE = [("cov_model", "matern32"), ("phi_proposals", 4), ("subset_engine", "vecchia"),
           ("dtype", "float64")]


@pytest.fixture
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_resolve_to_the_harness_pieces(cell):
    c = spec.cell(cell)
    p = spec.pieces(c["config"])
    assert p.reference is reference and p.noise is noise
    assert spec.generator(c["config"]) is data.GENERATORS[CELLS[cell]]
    assert spec.fit_args(c["config"], c["traffic"]) == {}


@pytest.mark.parametrize("key,value", OUTSIDE, ids=[k for k, _ in OUTSIDE])
def test_harness_reference_refuses_what_it_does_not_compute(key, value):
    cfg = json.loads(json.dumps(spec.cell("config5.fit")["config"]))
    cfg["sampler"][key] = value
    with pytest.raises(ValueError, match=key):
        reference.knobs(cfg)


@pytest.mark.parametrize("key,value", OUTSIDE, ids=[k for k, _ in OUTSIDE])
def test_a_cell_outside_the_path_gives_no_result(key, value):
    """Set-up refuses it by name, before any fit: a RunError, which
    run.main turns into exit code 2 and no result line."""
    import run

    with pytest.raises(run.RunError, match=key):
        run_cpu("config5.fit", overrides={**TINY, "sampler": {**TINY["sampler"], key: value}})


@pytest.mark.parametrize("key,value", [("phi_proposals", 4), ("phi_proposal_family", "student_t"),
                                       ("subset_engine", "vecchia"), ("dtype", "float64")])
def test_harness_noise_refuses_a_layout_it_does_not_draw(key, value):
    cfg = json.loads(json.dumps(spec.cell("config4.fit")["config"]))
    cfg["sampler"][key] = value
    with pytest.raises(ValueError, match=key):
        noise.streams(1, cfg, "cpu")


def test_the_conditional_sampler_draws_one_gaussian_proposal():
    cfg = json.loads(json.dumps(spec.cell("config4.fit")["config"]))
    cfg["sampler"].update(phi_sampler="conditional", phi_proposals=4,
                          phi_proposal_family="student_t")
    noise.check_layout(cfg)


def test_fit_args_from_configuration_and_traffic():
    assert spec.fit_args({"fit_args": {"chunk_size": 4, "chunk_iters": 8}},
                         {"fit_args": {"chunk_iters": 16}}) == {"chunk_size": 4,
                                                                "chunk_iters": 16}
    with pytest.raises(ValueError, match="weight"):
        spec.fit_args({"fit_args": {"weight": 2}}, {})


@pytest.mark.parametrize("rel", ["../BENCHMARK.json", "/etc/hostname", "harness/nothing.py",
                                 "configs/config5.json"])
def test_a_piece_outside_benchmark_is_refused(rel):
    with pytest.raises(ValueError, match="reference"):
        spec.piece({"reference": rel}, "reference")


def add_own_configuration(root):
    """config5 at the small shapes as an added configuration with its own
    reference (a copy of harness/reference.py), inputs file and fit
    arguments, its cell, limits and sweep metric all added files and
    entries."""
    bench = root / "benchmark"
    (bench / "references").mkdir()
    shutil.copy(bench / "harness" / "reference.py", bench / "references" / "own.py")
    src = (bench / "harness" / "reference.py").read_text()
    line = "    cp = np.array([0.5, 0.025, 0.975])\n"
    assert src.count(line) == 1
    (bench / "references" / "planted.py").write_text(
        src.replace(line, "    p_s = p_s * 0.999\n" + line))
    (bench / "inputs").mkdir()
    (bench / "inputs" / "own_field.py").write_text(
        "from harness import data\n\n\n"
        "def make(n, q, p, t, seed):\n"
        "    return data.binary_field(n, q, p, t, seed, phi=9.0)\n")
    conf = json.loads((bench / "configs" / "config5.json").read_text())
    conf.update(name="config5_own", reference="references/own.py", data="own_field",
                fit_args={"chunk_size": TINY["n_subsets"] // 2, "chunk_iters": 8,
                          "checkpoint_path": "ckpt"})
    (bench / "configs" / "config5_own.json").write_text(json.dumps(conf))
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "config5_own", "source": conf["source"],
                         "file": "benchmark/configs/config5_own.json",
                         "reduced": ["n", "n_subsets", "n_samples"], "why": "its own pieces"})
    b["workloads"].append({"name": "config5_own.fit", "config": "config5_own",
                           "traffic": "fit", "chips": 1, "why": "checkpointed chunks"})
    limits = json.loads((bench / "workloads" / "config5.fit.json").read_text())["limits"]
    (bench / "workloads" / "config5_own.fit.json").write_text(json.dumps({"limits": limits}))
    (bench / "metrics" / "sweep_ms.config5_own.py").write_text(
        "from harness import spec\n\nread = spec.metric_reader('sweep_ms')\n")
    b["end_to_end"].append({"name": "sweep_ms.config5_own", "unit": "ms", "better": "lower",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["config5_own.fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return bench / "configs" / "config5_own.json"


def files_outside_build(root):
    return {p for p in root.rglob("*")
            if p.is_file() and "_build" not in p.parts and "__pycache__" not in p.parts}


def test_an_added_configuration_brings_its_pieces(tmp_path, monkeypatch, one_thread):
    import smk_torch

    root = copy_tree(tmp_path)
    conf_file = add_own_configuration(root)
    calls = []
    fit = smk_torch.fit_meta_kriging

    def seen(*a, **kw):
        calls.append(kw)
        return fit(*a, **kw)

    monkeypatch.setattr(smk_torch, "fit_meta_kriging", seen)
    before = files_outside_build(root)
    res, lines = run_cpu("config5_own.fit", root=root)
    # chunked draws are bitwise the unchunked ones: the frozen noise holds
    assert res["correct"] is True, lines
    assert {"sweep_ms.config5_own", "setup_s"} <= set(res["metrics"])
    files = spec.fit_files(root)
    assert len(calls) == 1 + res["attempted"]  # the warm fit and the window's
    for kw in calls:
        assert (kw["chunk_size"], kw["chunk_iters"]) == (2, 8)
        assert kw["checkpoint_path"] == str(files / "ckpt")
    assert [p.name for p in files.iterdir() if p.name.startswith("ckpt")]
    assert files_outside_build(root) == before

    conf = json.loads(conf_file.read_text())
    conf["reference"] = "references/planted.py"
    conf_file.write_text(json.dumps(conf))
    res, lines = run_cpu("config5_own.fit", root=root)
    assert res["correct"] is False, lines
    assert res["checks"]["combine_gap"]["value"] > res["checks"]["combine_gap"]["limit"]

