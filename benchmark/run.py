"""The benchmark of the PyTorch port (``smk_torch``): one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, builds (or finds) the
port's kernels in benchmark/_build/, and runs one short warm fit at the
cell's shapes. The window then calls ``smk_torch.fit_meta_kriging``
fit after fit, each whole at the cell's depth, until ``--seconds`` have
passed; the fit under way then is finished and counted. After the window
one fit, drawn from the seed, is checked against the plain reference
(harness/reference.py). The last line of standard output is the result
as one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` one more fit runs after the window, under torch.profiler,
and the line carries the cell's per-layer metrics (host-clock ones from
the window's fits), the device's busy and window seconds and the
trace's breakdown. Each metric is read by
metrics/<name>.py.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BUILD = BENCH / "_build"
# every build and kernel cache at a fixed path inside the checkout
os.environ["SMK_TORCH_BUILD_DIR"] = str(BUILD / "kernels")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from harness import data, judge, noise, reference, spec, trace, work  # noqa: E402
from harness.window import run_window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "smk_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (exit code 2)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _sync(devs):
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def fit_outputs(res) -> dict:
    """What the check reads of one fit, copied to the host (so the
    window's device peak holds no kept outputs)."""
    sr = res.subset_results
    return to_host({"p_quant": res.p_quant, "p_samples": res.p_samples,
                    "param_quant": res.param_quant, "subset_param_grid": sr.param_grid,
                    "subset_w_grid": sr.w_grid, "phase_seconds": dict(res.phase_seconds)})


def to_host(out: dict) -> dict:
    return {k: (v.detach().double().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def reference_check(cell: dict, inputs, seed: int, fit: int, port_out: dict, home) -> dict:
    """The numbers compared for fit ``fit`` of the window."""
    cfg = cell["config"]
    s = reference.knobs(cfg)
    n_grid = int(round((1.0 - 1.0 / s["n_quantiles"]) / s["interp_grid_step"])) + 1
    fs = noise.fit_seed(seed, fit)
    perm = noise.permutation(fs, cfg["n"], home)
    idx = noise.resample_index(fs, s["resample_size"], n_grid, home)
    streams = noise.SweepStreams(fs, s["n_subsets"] * s["n_chains"], home, m=s["m"],
                                 q=cfg["q"], p=cfg["p"], t=cfg["t"], link=s["link"],
                                 pg_n_terms=s["pg_n_terms"])
    ref = reference.fit(cfg, inputs, perm, idx, streams, home)
    ref_of_port = reference.fit(cfg, inputs, perm, idx, None, home,
                                subset_grids=(port_out["subset_param_grid"],
                                              port_out["subset_w_grid"]))
    return judge.numbers(port_out, ref, ref_of_port)


def run(argv=None, *, device=None, overrides=None, control=None) -> tuple:
    """One run; returns (result dict, checks lines). ``device``: "cpu"
    runs the cell on the CPU (the tests' rehearsal; no card is looked
    for); ``overrides``: configuration keys to replace (the tests' small
    shapes); ``control``: "tf32" runs the port with its TF32 path on
    (the control of the check, never in a benchmark run)."""
    args = parse(argv)
    cell = spec.cell(args.workload)
    cfg = json.loads(json.dumps(cell["config"]))
    if overrides:
        for k, v in overrides.items():
            if k == "sampler":
                cfg["sampler"].update(v)
            else:
                cfg[k] = v
    if control == "tf32":
        cfg["sampler"]["matmul_precision"] = "high"
    cell["config"] = cfg
    chips = int(cell["workload"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device is visible")
        if torch.cuda.device_count() < chips:
            raise RunError(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")
        devs = [torch.device("cuda", i) for i in range(chips)]
    else:
        devs = [torch.device(device)] * chips
    from harness import port

    home = devs[0]
    traffic = cell["traffic"]
    seed = int(args.seed)
    inputs = data.make_inputs(cfg, seed)
    dev_inputs = tuple(torch.as_tensor(a, device=home) for a in inputs)

    def one_fit(i, n_samples=None):
        return port.fit_once(cfg, dev_inputs, seed, i, device=home, n_samples=n_samples)

    # set-up: one short fit at the cell's shapes builds and warms every kernel
    warm = one_fit(-1, n_samples=int(traffic["warmup_samples"]))
    del warm
    _sync(devs)
    for d in devs:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.monotonic() - T_START

    kept = {}
    window = run_window(one_fit, args.seconds, int(cfg["n_samples"]), sync=lambda: _sync(devs),
                        on_fit=lambda i, r: kept.__setitem__(i, fit_outputs(r)))
    peak = max((torch.cuda.max_memory_allocated(d) for d in devs if d.type == "cuda"),
               default=0)
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules of JAX or the JAX package are loaded: {bad}")

    ok_fits = sorted(kept)
    ctx = {"cell": cell, "config": cfg, "window": window, "peaks": spec.peaks(),
           "setup_s": setup_s, "peak_bytes": peak,
           "fits": [dict(f, phase_seconds=kept[f["index"]]["phase_seconds"])
                    for f in window.fits if f["index"] in kept],
           "chips": chips, "work": work}
    summary = None
    if args.trace:
        # one more fit of the timed path, after the window: a card's
        # profiler leaves launches slower after it stops, so the window's
        # fits, which the host-clock metrics read, run untraced
        t0 = time.monotonic()
        summary = trace_summary(traced_fit(lambda: one_fit(window.attempted), devs))
        trace_s = time.monotonic() - t0
        ctx["trace"] = summary
    metrics = {}
    for m in cell["per_layer"] if args.trace else cell["end_to_end"]:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: one fit of the window drawn from the seed, after the
    # program's state is freed and the peak is read
    correct, checks = False, {}
    if ok_fits:
        pick = ok_fits[noise.child_seed(seed, 0x5EED) % len(ok_fits)]
        port_out = kept[pick]
        kept.clear()
        if home.type == "cuda":
            torch.cuda.empty_cache()
        values = reference_check(cell, inputs, seed, pick, port_out, home)
        correct, checks = judge.verdict(values, cell["checks"]["limits"])
    correct = bool(correct and window.failed == 0)
    kind = torch.cuda.get_device_name(home) if home.type == "cuda" else "cpu"
    dev_block = {"platform": "gpu" if home.type == "cuda" else "cpu", "kind": kind,
                 "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
              "metrics": metrics, "device": dev_block}
    if summary is not None:
        dev_block["busy_s"] = summary["busy_s"]
        dev_block["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    bad = forbidden_modules()
    if bad:
        raise RunError(f"modules of JAX or the JAX package are loaded: {bad}")
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    if summary is not None:
        lines.insert(0, f"traced fit and its reading {trace_s:.1f} s; busy by card "
                        + json.dumps(summary["busy_by_card"]))
    lines.insert(0, "fits: " + " ".join(f"{f['wall_s']:.3f}" for f in window.fits)
                 + f" s; window {window.wall_s:.3f} s; set-up {setup_s:.3f} s")
    errors = [f["error"] for f in window.fits if f["error"] is not None]
    if errors:
        lines.insert(0, f"failed fits: {len(errors)}; first: {errors[0]}")
    return result, lines


TRACE = BUILD / "trace" / "fit.json"


def traced_fit(call, devs) -> Path:
    """``call()`` under torch.profiler, its trace saved to a fixed file in
    the checkout, whose path is returned. On a card the profiler records
    the device's activity alone (kernels, copies, sets and the runtime
    calls that launch them): recording every host operator as well
    stretches a fit whose host launches many small operations, so its
    idle share would read high. On the CPU it records the operators."""
    from torch.profiler import ProfilerActivity, profile

    cuda = devs[0].type == "cuda"
    prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
    with prof:
        res = call()
        _sync(devs)
    del res
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    return TRACE


def trace_summary(path) -> dict:
    """The traced fit's numbers (harness/trace.summarize), from the trace
    file, which is removed once read."""
    try:
        dev, host, window_us = trace.read_chrome_trace(path)
    finally:
        Path(path).unlink(missing_ok=True)
    return trace.summarize(dev, host, window_us or (0.0, 0.0))


def main(argv=None) -> int:
    try:
        result, lines = run(argv)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
