"""The program's spans laid on a torch.profiler trace (written here
without the port: the spans come in as plain records).

A span record is ``name``, ``span_id``, ``parent``, ``t0``/``t1`` in
Unix nanoseconds and ``attrs``, as the port's span recorder exports them
(``smk_torch.obs.record_spans``; harness/port_spans.py). A Chrome trace
is on the same clock: an event at ``ts`` (us) happened at
``baseTimeNanoseconds + 1000 ts``. So the spans map onto the trace with
no host operator recorded, and:

- each device event belongs to the innermost span that holds the
  runtime call that launched it (matched through ``correlation``);
- each idle stretch of card 0 belongs to the innermost span open on
  the host over it;
- a long idle gap is named ``<innermost span>|<what the host was
  doing>`` (the second part as harness/trace.summarize names it), the
  span first because names are cut at 64 characters.

Spans of one thread nest; the cells' fits run on one host thread."""

from __future__ import annotations

import bisect
import json

from harness.trace import DEVICE_CATS, HOST_CATS, _gaps, _intervals

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# the sweep's stage spans (models/probit_gp.py) and its noise draw
STAGES = ("smk.noise", "smk.latent", "smk.beta", "smk.phi", "smk.u_draw", "smk.a",
          "smk.krige")


def load(path) -> dict:
    """The trace file's events: ``base_ns``; ``dev``, device events
    (name, card, start_us, end_us, correlation); ``host``, host events
    (name, start_us, end_us) as harness/trace.read_chrome_trace gives
    them; ``launch``, correlation -> start_us of the runtime call; and
    ``window``, the first event's start to the last end."""
    with open(path) as f:
        doc = json.load(f)
    dev, host, launch = [], [], {}
    for e in doc["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, a = e.get("cat", ""), float(e["ts"])
        b = a + float(e["dur"])
        args = e.get("args", {})
        if cat in DEVICE_CATS:
            dev.append((e["name"], int(args.get("device", 0)), a, b, args.get("correlation")))
        elif cat in HOST_CATS:
            host.append((e["name"], a, b))
            if cat in RUNTIME_CATS and args.get("correlation") is not None:
                launch[args["correlation"]] = a
    ends = [(d[2], d[3]) for d in dev] + [(h[1], h[2]) for h in host]
    window = (min(a for a, _ in ends), max(b for _, b in ends)) if ends else None
    return {"base_ns": int(doc.get("baseTimeNanoseconds", 0)), "dev": dev, "host": host,
            "launch": launch, "window": window}


def on_trace(spans, base_ns: int) -> list:
    """The spans with ``a``/``b``, their bounds in the trace's us."""
    return [dict(s, a=(s["t0"] - base_ns) / 1e3, b=(s["t1"] - base_ns) / 1e3) for s in spans]


def timeline(spans) -> list:
    """(start, end, span) pieces, in order, each held by the innermost
    span open over it (spans of one thread, from :func:`on_trace`)."""
    pieces, stack, cur = [], [], None

    def upto(t):
        nonlocal cur
        if stack and cur is not None and t > cur:
            pieces.append((cur, t, stack[-1]))
        cur = t if cur is None else max(cur, t)

    for s in sorted(spans, key=lambda s: (s["a"], -s["b"])):
        while stack and stack[-1]["b"] <= s["a"]:
            upto(stack[-1]["b"])
            stack.pop()
        upto(s["a"])
        stack.append(s)
    while stack:
        upto(stack[-1]["b"])
        stack.pop()
    return pieces


class Spans:
    """The spans of one traced fit on the trace's clock: the innermost
    span at an instant, a span's ancestors."""

    def __init__(self, spans, base_ns: int):
        self.spans = on_trace(spans, base_ns)
        self.by_id = {s["span_id"]: s for s in self.spans}
        self.pieces = timeline(self.spans)
        self._starts = [p[0] for p in self.pieces]

    def at(self, t: float):
        """The innermost span open at ``t`` (us), or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.pieces[i][0] <= t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None

    def lineage(self, s) -> list:
        """``s`` and its ancestors, innermost first."""
        out = []
        while s is not None:
            out.append(s)
            s = self.by_id.get(s["parent"])
        return out

    def within(self, s, names) -> bool:
        """Whether ``s`` or an ancestor is named in ``names``."""
        return s is not None and any(x["name"] in names for x in self.lineage(s))


def device_by_span(tr: dict, sp: Spans) -> dict:
    """Device seconds (all cards) by the innermost span that launched
    each event, and per span id; events whose launch is in no span, or
    not in the trace, under ``None``."""
    by_name, by_id = {}, {}
    for name, _card, a, b, corr in tr["dev"]:
        t = tr["launch"].get(corr)
        s = sp.at(t) if t is not None else None
        key = s["name"] if s is not None else None
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
        if s is not None:
            by_id[s["span_id"]] = by_id.get(s["span_id"], 0.0) + (b - a) * 1e-6
    return {"by_name": by_name, "by_id": by_id}


def factor_seconds(tr: dict, sp: Spans, m: int, pats=()) -> float:
    """Device seconds of the events launched inside an ``smk.factor``
    span (innermost, or an ancestor) whose matrices are m x m, their
    names matching one of ``pats`` (every event where none is given)."""
    secs = 0.0
    for name, _card, a, b, corr in tr["dev"]:
        t = tr["launch"].get(corr)
        s = sp.at(t) if t is not None else None
        if s is None or (pats and not any(p.search(name) for p in pats)):
            continue
        if any(x["name"] == "smk.factor" and x["attrs"].get("m") == m for x in sp.lineage(s)):
            secs += (b - a) * 1e-6
    return secs


def card_gaps(tr: dict, card: int = 0) -> list:
    """Card ``card``'s idle (start, end) intervals over the window."""
    lo, hi = tr["window"]
    busy = [(max(a, lo), min(b, hi)) for _n, c, a, b, _k in tr["dev"] if c == card]
    return _gaps(_intervals([iv for iv in busy if iv[1] > iv[0]]), lo, hi)


def idle_by_span(tr: dict, sp: Spans, card: int = 0) -> dict:
    """Card ``card``'s idle seconds by the innermost span open over them
    (``None``: no span), with ``stage_share_pct``, the share of the idle
    seconds inside ``subset_fits`` that fall under a stage span of the
    sweep or its children (:data:`STAGES`)."""
    by_name, by_id = {}, {}
    fits = staged = 0.0
    pieces = sp.pieces
    j = 0
    for a, b in card_gaps(tr, card):
        free = b - a
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                s = pieces[k][2]
                secs = (hi - lo) * 1e-6
                free -= hi - lo
                by_name[s["name"]] = by_name.get(s["name"], 0.0) + secs
                by_id[s["span_id"]] = by_id.get(s["span_id"], 0.0) + secs
                if sp.within(s, ("subset_fits",)):
                    fits += secs
                    if sp.within(s, STAGES):
                        staged += secs
            k += 1
        if free > 1e-6:  # us: more than rounding
            by_name[None] = by_name.get(None, 0.0) + free * 1e-6
    return {"by_name": by_name, "by_id": by_id, "subset_fits_s": fits,
            "stage_share_pct": 100.0 * staged / fits if fits > 0 else None}


def named_gaps(tr: dict, sp: Spans, n_top: int = 10, card: int = 0) -> list:
    """The ``n_top`` longest idle gaps of card ``card``, each [name,
    seconds]: the innermost span over the gap's midpoint, ``|``, then
    what harness/trace.summarize calls it (the innermost host event over
    the midpoint, else "launching <the event that ends it>", else "no
    host operator"); the second part alone where no span is open."""
    starts = {}
    for name, c, a, _b, _k in tr["dev"]:
        if c == card:
            starts.setdefault(a, name)
    out = []
    for a, b in sorted(card_gaps(tr, card), key=lambda g: g[0] - g[1])[:n_top]:
        mid = 0.5 * (a + b)
        inner = [h for h in tr["host"] if h[1] <= mid <= h[2]]
        if inner:
            what = min(inner, key=lambda h: h[2] - h[1])[0]
        else:
            what = f"launching {starts[b]}" if b in starts else "no host operator"
        s = sp.at(mid)
        out.append([f"{s['name']}|{what}" if s is not None else what, (b - a) * 1e-6])
    return out
