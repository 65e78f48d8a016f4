"""The span readings of a ``--trace 1`` run: the first reader of a span
metric (metrics/noise_ms.py, noise_idle_pct.py, factor_roofline.py)
runs the span fits, after the untraced window and the harness's traced
fit, and keeps their readings in ``ctx["span_fits"]`` for the others.

The fits run in a process of their own (harness/span_child.py): a host
fit for the host clock and a profiled fit for the device, both at
``SWEEPS`` sweeps of the cell's shapes, on the window's inputs made
again from the run's seed, each with a seed of its own after the traced
fit's and the window's fit arguments. Their ``span fits:`` lines are
passed on to standard error. ``SWEEPS`` keeps the traced run inside its
time: on an H100 the profiler's start, stop, trace writing and reading
took about 11 s and a third of a second a sweep, and the readings at 32
sweeps were those at 64 (PERF.md).

The seed is read from the command line as the benchmark is run
(``--workload <cell> --seed <n>``): the readers are handed no seed.
Where the command line does not name this cell and a seed, or the port
has no span recorder, every reading is None and no fit runs."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

from harness import port_spans

SWEEPS = 32
TIMEOUT_S = 300


def run_seed(cell: str):
    """The ``--seed`` of the command line if it also names ``cell`` as
    its ``--workload``, else None."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed")
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload != cell or args.seed is None:
        return None
    try:
        return int(args.seed)
    except ValueError:
        return None


def measure(ctx: dict):
    """The span fits' readings of this run (run once, kept in ``ctx``):
    ``sweeps``, ``noise_ms``, ``factor_mm`` and, where a card ran,
    ``window_s``, ``noise_idle_pct``, ``factor_s`` and
    ``stage_share_pct``; None where no span fit could run."""
    if "span_fits" not in ctx:
        ctx["span_fits"] = _measure(ctx)
    return ctx["span_fits"]


def _measure(ctx: dict):
    seed = run_seed(ctx["cell"]["workload"]["name"])
    if seed is None or not port_spans.available():
        return None
    root = Path(ctx["root"])
    req = {"config": ctx["config"], "fit_args": ctx["fit_args"], "root": str(root),
           "seed": seed,
           "fit": ctx["window"].attempted + 1,  # the harness's traced fit is `attempted`
           "device": "cuda" if torch.cuda.is_available() else "cpu",
           "warmup_samples": int(ctx["cell"]["traffic"]["warmup_samples"]),
           "sweeps": SWEEPS}
    try:
        out = subprocess.run([sys.executable, str(root / "benchmark/harness/span_child.py")],
                             input=json.dumps(req), capture_output=True, text=True,
                             timeout=TIMEOUT_S, cwd=str(root))
    except subprocess.TimeoutExpired:
        print(f"span fits: ran past {TIMEOUT_S} s", file=sys.stderr)
        return None
    for line in out.stderr.splitlines():
        if line.startswith("span fits: "):
            print(line, file=sys.stderr)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        print(f"span fits: failed ({out.returncode}): {out.stderr[-2000:]}", file=sys.stderr)
        return None
    return json.loads(lines[-1])
