"""The program's spans laid on a profiler trace (harness/spans.py): the
Unix-clock mapping, device time by the span that launched it, card 0's
idle time by the span open over it, the gaps named by span; the span
readers' None where no span was recorded; and, on the card, a span
around one launch holding that launch's runtime call, and the factor
counter at each cell's shapes. The card's tests run with

    python -m pytest benchmark/tests/test_harness_spans.py -m gpu
"""

# smklint: test-budget=hand-made events in milliseconds; one small CPU run a cell, about 3 s; on the card a launch and a 16-sweep fit a cell

import json
import sys

import pytest

from harness import span_fits, spans, spec, trace, work
from _tiny import run_cpu

BASE = 1_700_000_000_000_000_000  # baseTimeNanoseconds of the hand-made trace


def ev(cat, name, ts, dur, corr=None, device=None):
    args = {}
    if corr is not None:
        args["correlation"] = corr
    if device is not None:
        args["device"] = device
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def rec(sid, parent, name, a_us, b_us, **attrs):
    """A span as the port exports it: Unix ns bounds."""
    return {"name": name, "span_id": sid, "parent": parent, "t0": BASE + int(a_us * 1e3),
            "t1": BASE + int(b_us * 1e3), "attrs": attrs}


# a fit (0..1000 us): a sweep (100..900) with a noise draw before it
# (20..100), stages latent (100..300) and u_draw (300..900) holding a
# factor of the subset size (400..600) and a small one (700..800)
SPANS = [
    rec(0, None, "fit_meta_kriging", 0, 1000),
    rec(1, 0, "subset_fits", 10, 990),
    rec(2, 1, "smk.noise", 20, 100, rows=4),
    rec(3, 1, "smk.sweep", 100, 900, it=0),
    rec(4, 3, "smk.latent", 100, 300),
    rec(5, 3, "smk.u_draw", 300, 900),
    rec(6, 5, "smk.factor", 400, 600, m=64, batch=4),
    rec(7, 5, "smk.factor", 700, 800, m=3, batch=4),
]
EVENTS = [
    ev("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
    ev("kernel", "normal", 40, 10, corr=1, device=0),           # noise: busy 40-50
    ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=2),
    ev("kernel", "elementwise", 160, 40, corr=2, device=0),     # latent: busy 160-200
    ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=3),
    ev("kernel", "potrf", 420, 100, corr=3, device=0),          # factor m=64: 420-520
    ev("cuda_runtime", "cudaLaunchKernel", 530, 5, corr=4),
    ev("gpu_memcpy", "Memcpy DtoD", 540, 20, corr=4, device=0),  # factor m=64: 540-560
    ev("cuda_runtime", "cudaLaunchKernel", 710, 5, corr=5),
    ev("kernel", "potrf", 720, 30, corr=5, device=0),           # factor m=3: 720-750
    ev("cuda_runtime", "cudaStreamSynchronize", 950, 49),
    ev("kernel", "tail", 990, 10, corr=99, device=0),            # launched outside the trace
]


def write(tmp_path, events=EVENTS):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE, "traceEvents": events}))
    return path


def test_spans_map_onto_the_trace_and_own_their_launches(tmp_path):
    tr = spans.load(write(tmp_path))
    assert tr["base_ns"] == BASE and tr["window"] == (30.0, 1000.0)
    assert tr["launch"] == {1: 30.0, 2: 150.0, 3: 410.0, 4: 530.0, 5: 710.0}
    sp = spans.Spans(SPANS, tr["base_ns"])
    assert sp.by_id[3]["a"] == pytest.approx(100.0) and sp.by_id[3]["b"] == pytest.approx(900.0)
    assert sp.at(450)["span_id"] == 6 and sp.at(650)["span_id"] == 5 and sp.at(50)["span_id"] == 2
    assert sp.at(950)["name"] == "subset_fits" and sp.at(995)["name"] == "fit_meta_kriging"
    assert sp.at(1000) is None
    assert [s["span_id"] for s in sp.lineage(sp.by_id[6])] == [6, 5, 3, 1, 0]
    dev = spans.device_by_span(tr, sp)
    assert dev["by_name"] == pytest.approx({"smk.noise": 10e-6, "smk.latent": 40e-6,
                                            "smk.factor": 150e-6, None: 10e-6})
    # the factor of the subset size: its potrf and its copy, not the 3 x 3 factor
    assert spans.factor_seconds(tr, sp, 64) == pytest.approx(120e-6)
    assert spans.factor_seconds(tr, sp, 64, trace.patterns(
        spec.kernel_list("factor_roofline"))) == pytest.approx(120e-6)
    assert spans.factor_seconds(tr, sp, 3) == pytest.approx(30e-6)


def test_idle_time_by_the_span_open_over_it(tmp_path):
    tr = spans.load(write(tmp_path))
    sp = spans.Spans(SPANS, tr["base_ns"])
    gaps = spans.card_gaps(tr)
    assert gaps == [(30.0, 40.0), (50.0, 160.0), (200.0, 420.0), (520.0, 540.0),
                    (560.0, 720.0), (750.0, 990.0)]
    idle = spans.idle_by_span(tr, sp)
    assert idle["by_name"] == pytest.approx({
        "smk.noise": 60e-6,  # 30-40, 50-100
        "smk.latent": 160e-6,  # 100-160, 200-300
        "smk.u_draw": 300e-6,  # 300-400, 600-700, 800-900
        "smk.factor": 150e-6,  # 400-420, 520-540, 560-600 (m = 64); 700-720, 750-800
        "subset_fits": 90e-6,  # 900-990
    })
    assert sum(idle["by_name"].values()) == pytest.approx(sum(b - a for a, b in gaps) * 1e-6)
    assert idle["by_id"][6] == pytest.approx(80e-6) and idle["by_id"][7] == pytest.approx(70e-6)
    # every idle stretch lies inside subset_fits; all but 900-990 under a stage
    assert idle["subset_fits_s"] == pytest.approx(760e-6)
    assert idle["stage_share_pct"] == pytest.approx(100 * 670 / 760)


def test_gap_names_with_and_without_spans(tmp_path):
    tr = spans.load(write(tmp_path))
    plain = trace.summarize([d[:4] for d in tr["dev"]], tr["host"], tr["window"])["idle_gaps"]
    assert spans.named_gaps(tr, spans.Spans([], tr["base_ns"])) == plain
    named = spans.named_gaps(tr, spans.Spans(SPANS, tr["base_ns"]))
    assert named == [
        ["smk.u_draw|launching tail", pytest.approx(240e-6)],
        ["smk.u_draw|launching potrf", pytest.approx(220e-6)],
        ["smk.u_draw|launching potrf", pytest.approx(160e-6)],
        ["smk.latent|launching elementwise", pytest.approx(110e-6)],
        ["smk.factor|cudaLaunchKernel", pytest.approx(20e-6)],
        ["smk.noise|cudaLaunchKernel", pytest.approx(10e-6)],
    ]
    assert [n.split("|")[1] for n, _ in named] == [n for n, _ in plain]


def test_span_readers_read_nothing_without_spans(monkeypatch):
    """Without the run's seed on the command line, or with a port that
    has no recorder, every span reading is None and nothing is run."""
    cell = spec.cell("config5.fit")
    ctx = {"cell": cell, "config": cell["config"], "fits": [], "work": work}
    monkeypatch.setattr(sys, "argv", ["pytest"])
    for name in ("noise_ms", "noise_idle_pct", "factor_roofline"):
        assert spec.metric_reader(name)(dict(ctx)) is None
        assert spec.metric_reader(name + ".config4")(dict(ctx)) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "config5.fit", "--seed", "7"])
    assert span_fits.run_seed("config5.fit") == 7 and span_fits.run_seed("config4.fit") is None
    from harness import port_spans

    def no_fit(*a, **kw):
        raise AssertionError("a span fit ran for a port with no recorder")

    monkeypatch.setattr(port_spans, "available", lambda: False)
    monkeypatch.setattr(span_fits.subprocess, "run", no_fit)
    for name in ("noise_ms", "noise_idle_pct", "factor_roofline"):
        assert spec.metric_reader(name)(dict(ctx)) is None


@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
def test_a_traced_cpu_run_reads_the_noise_spans(cell, monkeypatch, capsys):
    """On the CPU: noise_ms from the host fit, no device reading,
    the factor counter equal to harness/work.py's count."""
    argv = ["--workload", cell, "--seed", "123456789012", "--seconds", "0.5", "--trace", "1"]
    monkeypatch.setattr(sys, "argv", ["benchmark/run.py"] + argv)
    res, lines = run_cpu(cell, trace=1)
    sfx = "" if cell == "config5.fit" else ".config4"
    assert res["correct"] is True and res["metrics"]["noise_ms" + sfx]["value"] > 0
    assert "noise_idle_pct" + sfx not in res["metrics"]
    assert "factor_roofline" + sfx not in res["metrics"]
    err = capsys.readouterr().err
    from _tiny import TINY

    cfg = dict(spec.cell(cell)["config"], **{k: v for k, v in TINY.items() if k != "sampler"})
    want = work.factorizations(cfg)
    assert (f"span fits: the host fit of {cfg['n_samples']} sweeps" in err
            and f"factor_mm {want}, harness/work.factorizations {want}\n" in err)


@pytest.mark.gpu
def test_a_span_holds_its_launch_on_the_card(card, tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smk_torch.obs import record_spans
    from smk_torch.utils.tracing import span

    x = torch.randn(1 << 20, device=card)
    torch.exp(x)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with record_spans() as r:
            with span("probe"):
                torch.exp(x)
            torch.cuda.synchronize(card)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    tr = spans.load(tmp_path / "t.json")
    (probe,) = [s for s in spans.on_trace(r.export(), tr["base_ns"]) if s["name"] == "probe"]
    kern = [d for d in tr["dev"] if "exp" in d[0].lower()]
    assert len(kern) == 1, [d[0] for d in tr["dev"]]
    t = tr["launch"][kern[0][4]]
    call = [h for h in tr["host"] if h[1] == t]
    assert call and call[0][0] in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    print("span", probe["a"], probe["b"], "launch", call[0][1], call[0][2])
    assert probe["a"] - 20 <= call[0][1] and call[0][2] <= probe["b"] + 20


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
def test_factor_count_at_the_cells_shapes(card, cell):
    """A 16-sweep fit at each cell's shapes: the recorder's factor_mm
    is harness/work.py's count of m x m factorizations."""
    import torch

    from harness import data, port, port_spans

    cfg = dict(spec.cell(cell)["config"], n_samples=16)
    inputs = tuple(torch.as_tensor(a, device=card) for a in data.make_inputs(cfg, 2147483711))
    _res, rec = port_spans.recorded(
        lambda: port.fit_once(cfg, inputs, 2147483711, 0, device=card))
    print(cell, rec.counters, work.factorizations(cfg))
    assert rec.counters["factor_mm"] == work.factorizations(cfg)
    assert sum(s["name"] == "smk.sweep" for s in rec.spans) == 16
