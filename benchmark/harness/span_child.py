"""The span fits of a ``--trace 1`` run (harness/span_fits.py), in a
process of their own: a process in which torch.profiler has run launches
more slowly after it stops, so the run's own process, which traced a fit
before, cannot time the host.

    python3 benchmark/harness/span_child.py < request.json

The request (standard input, JSON): ``config`` (the cell's configuration
as run), ``fit_args`` (its fits' arguments, harness/spec.fit_args),
``root`` (the checkout), ``seed``, ``fit`` (the first fit's index: fit
i's seed is the configuration's ``noise.fit_seed(seed, i)``), ``device``
("cuda" or "cpu"), ``warmup_samples`` and ``sweeps``. The inputs are
made from the seed, as the run made them (harness/spec.pieces), and a
short fit at the cell's shapes warms every kernel. Then, at ``sweeps``
sweeps (the schedule's burn-in share and phi updates kept), with the
program's spans armed (harness/port_spans.py):

1. the host fit, with no profiler: the host-clock readings;
2. the profiled fit, under torch.profiler recording the card's activity
   alone, as benchmark/run.py's traced fit does: the device's time and
   idle time by span (harness/spans.py). On the CPU no device reading.

Its ``span fits:`` lines go to standard error; the last line of standard
output is the readings as JSON."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TRACE = BENCH / "_build" / "trace" / "spans.json"


def _rounded(d: dict, scale: float = 1.0) -> dict:
    items = sorted(d.items(), key=lambda kv: -kv[1])
    return {("(no span)" if k is None else k): round(v * scale, 4) for k, v in items}


def say(line: str) -> None:
    print("span fits: " + line, file=sys.stderr, flush=True)


def main() -> int:
    t_start = time.perf_counter()
    steps = {}

    def step(name):
        steps[name] = round(time.perf_counter() - t_start, 3)

    import torch

    from harness import port, port_spans, spans, spec, trace, work

    req = json.loads(sys.stdin.read())
    cfg, seed, first = req["config"], int(req["seed"]), int(req["fit"])
    root = Path(req["root"])
    pcfg = dict(cfg, n_samples=min(int(req["sweeps"]), int(cfg["n_samples"])))
    dev = torch.device("cuda", 0) if req["device"] == "cuda" else torch.device("cpu")
    pieces = spec.pieces(cfg, root)
    inputs = tuple(torch.as_tensor(a, device=dev) for a in pieces.inputs(seed))
    files = spec.fit_files(root)
    step("inputs")

    def fit(i, n_samples=None):
        res = port.fit_once(pcfg, inputs, seed, i, device=dev, n_samples=n_samples,
                            fit_args=req["fit_args"], files=files, noise=pieces.noise)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return res

    warm = fit(-1, n_samples=int(req["warmup_samples"]))
    del warm
    step("warm")
    t0 = time.perf_counter()
    got = port_spans.recorded(lambda: fit(first))
    wall = time.perf_counter() - t0
    if got is None:
        raise SystemExit("the port has no span recorder")
    host = got[1]
    del got
    step("host")
    sweeps = int(pcfg["n_samples"])
    totals = host.totals()["spans"]
    noise = totals.get("smk.noise")
    out = {"sweeps": sweeps, "noise_ms": 1e3 * noise["total_s"] / sweeps if noise else None,
           "factor_mm": host.counters.get("factor_mm")}
    say(f"the host fit of {sweeps} sweeps {wall:.3f} s; factor_mm {out['factor_mm']}, "
        f"harness/work.factorizations {work.factorizations(pcfg)}")
    say("host ms a sweep by span (self) " + json.dumps(
        _rounded({k: v["self_s"] for k, v in totals.items()}, 1e3 / sweeps)))

    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if dev.type == "cuda"
                               else ProfilerActivity.CPU])
    with prof:
        got = port_spans.recorded(lambda: fit(first + 1))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    rec = got[1]
    del got, inputs
    step("profiled")
    TRACE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE))
    del prof
    step("written")
    try:
        tr = spans.load(TRACE)
    finally:
        TRACE.unlink(missing_ok=True)
    step("read")
    if tr["window"] is not None and any(d[1] == 0 for d in tr["dev"]):
        sp = spans.Spans(rec.export(), tr["base_ns"])
        lo, hi = tr["window"]
        window_s = (hi - lo) * 1e-6
        m = work.shape(cfg)["m"]
        pats = trace.patterns(spec.kernel_list("factor_roofline"))
        by_dev = spans.device_by_span(tr, sp)
        factor_s = spans.factor_seconds(tr, sp, m, pats)
        factor_all = sum(v for k, v in by_dev["by_id"].items()
                         if sp.within(sp.by_id[k], ("smk.factor",)))
        idle = spans.idle_by_span(tr, sp)
        noise_idle = sum(v for k, v in idle["by_id"].items()
                         if sp.within(sp.by_id[k], ("smk.noise",)))
        idle_s = sum(idle["by_name"].values())
        share = idle["stage_share_pct"]
        out.update(window_s=window_s, noise_idle_pct=100.0 * noise_idle / window_s,
                   factor_s=factor_s if factor_s > 0 else None, stage_share_pct=share)
        say(f"the profiled fit: device s by span {json.dumps(_rounded(by_dev['by_name']))}; "
            f"smk.factor at m = {m}: {factor_s:.4f} s of {factor_all:.4f} s in every "
            f"smk.factor")
        say(f"card 0 idle s by span {json.dumps(_rounded(idle['by_name']))}; idle "
            f"{idle_s:.4f} s of a {window_s:.4f} s window; in subset_fits "
            f"{idle['subset_fits_s']:.4f} s, under the sweep's stages "
            f"{'n/a' if share is None else f'{share:.2f} %'}")
        say("idle gaps " + json.dumps([[n, round(s, 6)] for n, s in spans.named_gaps(tr, sp)]))
    step("read out")
    say("seconds since the start, by step " + json.dumps(steps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
