"""The reading of a torch.profiler trace: the device's busy time and
idle share per card, device time by kernel name, the longest idle gaps
with what the host was doing, and the time in the kernels whose names
match a pattern list (a roofline's kernels).

``summarize`` reduces the profiler's events to plain numbers once, so the
per-layer metric readers need no profiler objects."""

from __future__ import annotations

import re
from pathlib import Path


def _intervals(events):
    """Merged (start, end) microsecond intervals of ``events``."""
    spans = sorted((e[0], e[1]) for e in events)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _gaps(merged, lo, hi):
    """Idle (start, end) intervals of [lo, hi) between merged busy ones."""
    gaps, cur = [], lo
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def read_chrome_trace(path):
    """(device events, host events, window) of a profiler's Chrome trace
    file: device events (name, card, start_us, end_us) of the kernels,
    copies and sets; host events (name, start_us, end_us) of the
    operators and runtime calls; the window (start_us, end_us) from the
    first event to the last end (the traced fit's first launch to its
    closing synchronisation)."""
    import json

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, a = e.get("cat", ""), float(e["ts"])
        b = a + float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((e["name"], int(e.get("args", {}).get("device", 0)), a, b))
        elif cat in HOST_CATS:
            host.append((e["name"], a, b))
    spans = [(a, b) for _, _, a, b in dev] + [(a, b) for _, a, b in host]
    window = (min(a for a, _ in spans), max(b for _, b in spans)) if spans else None
    return dev, host, window


def summarize(dev_events, host, window_us, n_top: int = 10) -> dict:
    """The trace's numbers over the window ``window_us`` = (start, end):

    - ``window_s``; per card ``busy_s`` (the union of its device events);
    - ``busy_s`` their mean over the cards that ran anything;
    - ``by_name``: device seconds by event name (all cards);
    - ``device_ops``: the ``n_top`` names with the most device seconds;
    - ``idle_gaps``: the ``n_top`` longest gaps of card 0, each named by
      the innermost host event that spans the gap's midpoint, else by
      the device operation the host launched to end it ("launching
      <name>"; "no host operator" at the window's end)."""
    lo, hi = window_us
    per_card, by_name = {}, {}
    for name, dev, a, b in dev_events:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        per_card.setdefault(dev, []).append((a, b))
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    busy = {d: sum(b - a for a, b in _intervals(ev)) * 1e-6 for d, ev in per_card.items()}
    first = min(per_card) if per_card else None
    gaps = []
    if first is not None:
        starts = {}
        for name, dev, a, _ in dev_events:
            if dev == first:
                starts.setdefault(a, name)
        raw = sorted(_gaps(_intervals(per_card[first]), lo, hi), key=lambda g: g[0] - g[1])
        for a, b in raw[:n_top]:
            mid = 0.5 * (a + b)
            inner = [h for h in host if h[1] <= mid <= h[2]]
            if inner:
                name = min(inner, key=lambda h: h[2] - h[1])[0]
            else:
                name = f"launching {starts[b]}" if b in starts else "no host operator"
            gaps.append([name, (b - a) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_by_card": {str(d): v for d, v in sorted(busy.items())},
        "busy_s": (sum(busy.values()) / len(busy)) if busy else 0.0,
        "by_name": by_name,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": gaps,
    }


def patterns(path: Path) -> list:
    """The regular expressions of a kernel-name list: one a line, blank
    lines and lines starting with # left out."""
    lines = Path(path).read_text().splitlines()
    return [re.compile(s.strip()) for s in lines if s.strip() and not s.lstrip().startswith("#")]


def seconds_matching(summary: dict, pats: list) -> float:
    """Device seconds of the events whose names match any pattern."""
    return sum(s for name, s in summary["by_name"].items() if any(p.search(name) for p in pats))
