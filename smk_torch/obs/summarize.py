"""Run-log summarizer — twin of ``smk_tpu/obs/summarize.py`` (without the
mesh and program-store blocks): ``python -m smk_torch.obs summarize
<run.jsonl> [--json]``.

Rebuilds the timeline a fit wrote (obs/events.py) into:

- the span tree, every span under its parent with its wall bounds, and
  its health: orphan spans (a parent id with no record: a corrupt or
  edited log) and the root's coverage (the share of the outermost span
  its direct children account for; untimed gaps hide uninstrumented
  work);
- the chunk breakdown: dispatch, host-work and host-stall seconds,
  device-to-host bytes and the peak device memory, re-aggregated from
  the ``chunk`` events;
- the checkpoint writes, the faults, the watchdog's events, the live
  diagnostics' trajectory, the adaptive schedule's compactions and the
  profiler's windows;
- the serving view (:func:`serve_block`: coalesced batches, the held-time
  histogram, the admission counters) and the live-fit view
  (:func:`ingest_block`: ingested batches, refits, published generations
  and swaps), each the twin's, so both packages read one log to the same
  blocks.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from smk_torch.obs.reporter import read_jsonl


def load_run(path: str) -> Dict[str, Any]:
    """Partition a run log's records by kind. Tolerates a truncated
    (killed-run) log: ``run_end`` may be absent."""
    records = read_jsonl(path)
    if not records or records[0].get("kind") != "run_start":
        raise ValueError(
            f"{path} is not a run log (first record must be "
            "run_start; got "
            f"{records[0].get('kind') if records else 'empty file'})"
        )
    out: Dict[str, Any] = {
        "start": records[0],
        "spans": [],
        "events": [],
        "counters": [],
        "end": None,
    }
    for r in records[1:]:
        kind = r.get("kind")
        if kind == "span":
            out["spans"].append(r)
        elif kind == "event":
            out["events"].append(r)
        elif kind == "counter":
            out["counters"].append(r)
        elif kind == "run_end":
            out["end"] = r
    return out


def build_tree(
    spans: List[dict],
) -> Tuple[List[dict], Dict[int, List[dict]], List[dict]]:
    """(roots, children-by-parent-id, orphans). An orphan is a span
    whose recorded parent id has no span record — structurally
    impossible in a log this package wrote to completion, so any
    orphan means truncation or tampering."""
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[int, List[dict]] = {}
    roots: List[dict] = []
    orphans: List[dict] = []
    for s in spans:
        parent = s.get("parent")
        if parent is None:
            roots.append(s)
        elif parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            orphans.append(s)
    for lst in children.values():
        lst.sort(key=lambda s: s["t0"])
    roots.sort(key=lambda s: s["t0"])
    return roots, children, orphans


def _interval_union(ivals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [a, b) intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(ivals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def coverage(
    root: dict, children: Dict[int, List[dict]]
) -> Optional[float]:
    """Fraction of ``root``'s wall covered by the union of its direct
    children (clipped to the root's bounds). None for a zero-length
    root."""
    dur = root["t1"] - root["t0"]
    if dur <= 0:
        return None
    ivals = [
        (max(c["t0"], root["t0"]), min(c["t1"], root["t1"]))
        for c in children.get(root["span_id"], ())
        if c["t1"] > c["t0"]
    ]
    return _interval_union([iv for iv in ivals if iv[1] > iv[0]]) / dur


def _events_named(run: Dict[str, Any], name: str) -> List[dict]:
    return [e for e in run["events"] if e.get("name") == name]


def chunk_breakdown(run: Dict[str, Any]) -> Dict[str, Any]:
    """Re-aggregate the per-chunk events into the stall/overlap
    summary (the live ChunkPipelineStats.aggregate() shape, minus the
    fields only the live object holds)."""
    chunks = [e["attrs"] for e in _events_named(run, "chunk")]
    stall = sum(float(c.get("host_stall_s", 0.0)) for c in chunks)
    work = sum(float(c.get("host_work_s", 0.0)) for c in chunks)
    disp = sum(float(c.get("dispatch_s", 0.0)) for c in chunks)
    d2h = sum(int(c.get("d2h_bytes", 0)) for c in chunks)
    hbm = [
        int(c["hbm_peak_bytes"])
        for c in chunks
        if c.get("hbm_peak_bytes") is not None
    ]
    return {
        "n_chunks": len(chunks),
        "dispatch_s": round(disp, 4),
        "host_work_s": round(work, 4),
        "host_stall_s": round(stall, 4),
        "d2h_bytes": d2h,
        "hbm_peak_bytes": max(hbm) if hbm else None,
    }


# held-time histogram edges (ms) of the serve block: fixed bins, so two
# logs' histograms line up whatever their windows
_HELD_EDGES_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0)


def _held_histogram(held_s: List[float]) -> Dict[str, int]:
    hist: Dict[str, int] = {}
    for h in held_s:
        ms = float(h) * 1000.0
        for edge in _HELD_EDGES_MS:
            if ms < edge:
                label = f"<{edge:g}ms"
                break
        else:
            label = f">={_HELD_EDGES_MS[-1]:g}ms"
        hist[label] = hist.get(label, 0) + 1
    return hist


def serve_block(run: Dict[str, Any]) -> Dict[str, Any]:
    """The serving view of a run log: coalesced-batch occupancy from the
    ``coalesce`` spans, the held-time histogram from their per-request
    ``held_s``, and the admission counters the engine (or fleet) wrote
    into ``run_end``. Zeros and empties on a fit's log."""
    req_spans = [s for s in run["spans"] if s["name"] == "request"]
    co_spans = [s for s in run["spans"] if s["name"] == "coalesce"]
    end_attrs = (run["end"] or {}).get("attrs", {})
    stats = end_attrs.get("serve") or end_attrs.get("fleet") or {}
    held = [float(h) for s in co_spans for h in (s["attrs"].get("held_s") or [])]
    n_req = [int(s["attrs"].get("n_requests", 0)) for s in co_spans]
    n_rows = [int(s["attrs"].get("rows", 0)) for s in co_spans]
    shed_keys = (
        "requests_served", "requests_shed", "requests_timed_out",
        "requests_rejected", "dispatches", "requests_shed_fleet",
        "replica_fallthroughs",
    )
    return {
        "n_request_spans": len(req_spans),
        "coalesce": {
            "n_batches": len(co_spans),
            "requests": sum(n_req),
            "rows": sum(n_rows),
            "mean_requests_per_batch": (round(sum(n_req) / len(co_spans), 2)
                                        if co_spans else None),
            "max_requests_per_batch": max(n_req, default=None),
            "mean_rows_per_batch": (round(sum(n_rows) / len(co_spans), 2)
                                    if co_spans else None),
        },
        "held_s_hist": _held_histogram(held),
        "held_s_max": round(max(held), 6) if held else None,
        "sheds": {k: stats[k] for k in shed_keys if k in stats},
    }


def ingest_block(run: Dict[str, Any]) -> Dict[str, Any]:
    """The live-fit view of a run log: ingest routing, refit scheduling
    and the generations published and swapped, from the
    ``ingest_routed`` / ``refit_scheduled`` / ``generation_published`` /
    ``generation_swap`` events. Zeros and None on a plain fit or serve
    log.

    As the twin has it: the refit totals sum ``n_refit`` / ``n_reused``,
    which no ``refit_scheduled`` event carries (LiveFit writes
    ``refit_subsets``, a list, and ``reused_subsets``, a count), so both
    totals read 0 in either package (ROADMAP queue C)."""
    routed = [e["attrs"] for e in _events_named(run, "ingest_routed")]
    refits = [e["attrs"] for e in _events_named(run, "refit_scheduled")]
    published = [e["attrs"] for e in _events_named(run, "generation_published")]
    swaps = [e["attrs"] for e in _events_named(run, "generation_swap")]
    return {
        "n_ingest_batches": len(routed),
        "rows_ingested": sum(int(r.get("n_rows", 0)) for r in routed),
        "n_refits": len(refits),
        "refit_subsets_total": sum(int(r.get("n_refit", 0)) for r in refits),
        "reused_subsets_total": sum(int(r.get("n_reused", 0)) for r in refits),
        "n_generations_published": len(published),
        "last_generation": published[-1].get("generation") if published else None,
        "n_generation_swaps": len(swaps),
        "last_swap": swaps[-1] if swaps else None,
    }


def summarize(path: str) -> Dict[str, Any]:
    """The full machine-readable summary of one run log."""
    run = load_run(path)
    roots, children, orphans = build_tree(run["spans"])
    root = max(
        roots, key=lambda s: s["t1"] - s["t0"], default=None
    )
    cov = coverage(root, children) if root is not None else None
    faults = [e["attrs"] for e in _events_named(run, "fault")]
    watchdog = [e["attrs"] for e in _events_named(run, "watchdog")]
    live = [e["attrs"] for e in _events_named(run, "live_diagnostics")]
    compactions = [
        e["attrs"] for e in _events_named(run, "adaptive_compaction")
    ]
    ckpt = [e["attrs"] for e in _events_named(run, "ckpt_write")]
    commits = [e["attrs"] for e in _events_named(run, "ckpt_commit")]
    breakdown = chunk_breakdown(run)
    span_walls: Dict[str, float] = {}
    for s in run["spans"]:
        span_walls[s["name"]] = span_walls.get(s["name"], 0.0) + (
            s["t1"] - s["t0"]
        )

    def _span_wall(name: str) -> Optional[float]:
        w = span_walls.get(name)
        return None if w is None else round(w, 4)
    wall = root["t1"] - root["t0"] if root is not None else None
    if wall and wall > 0:
        breakdown["host_stall_frac"] = round(
            breakdown["host_stall_s"] / wall, 4
        )
        breakdown["overlap_efficiency"] = round(
            1.0 - breakdown["host_stall_s"] / wall, 4
        )
    return {
        "path": path,
        "trace_id": run["start"].get("trace_id"),
        "name": run["start"].get("name"),
        "meta": run["start"].get("meta", {}),
        "truncated": run["end"] is None,
        "n_spans": len(run["spans"]),
        "n_events": len(run["events"]),
        "n_orphan_spans": len(orphans),
        "root_span": None if root is None else {
            "name": root["name"],
            "wall_s": round(root["t1"] - root["t0"], 4),
        },
        "root_coverage": None if cov is None else round(cov, 4),
        "chunks": breakdown,
        "ckpt_writes": {
            "n": len(ckpt),
            "seconds": round(
                sum(float(c.get("seconds", 0.0)) for c in ckpt), 4
            ),
            "bytes": sum(int(c.get("nbytes", 0)) for c in ckpt),
        },
        # the distributed checkpoint's commits: one ckpt_commit event a
        # published generation (its barriers' and publish's seconds), and
        # the "ckpt_commit" spans' wall under the sync pipeline (the
        # overlap pipeline commits on the writer thread, events only);
        # empty under format 7
        "ckpt_commit": {
            "n_generations": len(commits),
            "seconds": round(sum(float(c.get("seconds", 0.0)) for c in commits), 4),
            "span_s": _span_wall("ckpt_commit"),
            "last_generation": commits[-1].get("generation") if commits else None,
            "n_processes": commits[-1].get("n_processes") if commits else None,
        },
        # the post-sampling phases of fit_meta_kriging
        "combine": {
            "combine_s": _span_wall("combine"),
            "resample_predict_s": _span_wall("resample_predict"),
        },
        "faults": faults,
        # the chunk watchdog: one "armed" record when the first
        # deadline exists, one "fired" per hang it converted
        "watchdog": {
            "n_events": len(watchdog),
            "fired": [
                w for w in watchdog if w.get("action") == "fired"
            ],
        },
        "live_diagnostics": {
            "n_boundaries": len(live),
            "final": live[-1] if live else None,
        },
        # the adaptive schedule: one "adaptive_compaction" event per
        # re-formed dispatch group (freeze, reopen, rung change); empty
        # on a fixed schedule
        "adaptive": {
            "n_compactions": len(compactions),
            "compactions": compactions,
        },
        "profile": [e["attrs"] for e in run["events"]
                    if e.get("name") in ("profile_start", "profile_stop")],
        "serve": serve_block(run),
        "ingest": ingest_block(run),
        "counters": (run["end"] or {}).get("counters", {}),
    }


def render_tree(
    roots: List[dict], children: Dict[int, List[dict]]
) -> List[str]:
    """Indented text rendering of the span tree."""
    lines: List[str] = []

    def walk(span: dict, depth: int) -> None:
        dur = span["t1"] - span["t0"]
        lines.append(
            f"{'  ' * depth}{span['name']}  "
            f"[{span['t0']:.3f}s → {span['t1']:.3f}s]  "
            f"({dur:.3f}s)"
        )
        for c in children.get(span["span_id"], ()):
            walk(c, depth + 1)

    for r in roots:
        walk(r, 0)
    return lines


def main(argv: List[str]) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m smk_torch.obs summarize <run.jsonl> "
            "[--json]\n"
            "  reconstructs the span tree, wall coverage, "
            "stall/overlap breakdown\n"
            "  and fault/live-diagnostics/serve/ingest history of one "
            "run log"
        )
        return 0 if argv else 2
    path = argv[0]
    as_json = "--json" in argv[1:]
    summary = summarize(path)
    if as_json:
        print(json.dumps(summary, indent=2))
        return 0
    run = load_run(path)
    roots, children, _ = build_tree(run["spans"])
    print(f"run log  {path}")
    print(
        f"trace {summary['trace_id']}  name={summary['name']}  "
        + ("TRUNCATED (no run_end)" if summary["truncated"] else
           "complete")
    )
    print(
        f"spans={summary['n_spans']} events={summary['n_events']} "
        f"orphans={summary['n_orphan_spans']}  "
        f"root_coverage={summary['root_coverage']}"
    )
    print("\nspan tree:")
    for line in render_tree(roots, children):
        print("  " + line)
    ch = summary["chunks"]
    if ch["n_chunks"]:
        print(
            f"\nchunks: n={ch['n_chunks']} dispatch={ch['dispatch_s']}s"
            f" host_work={ch['host_work_s']}s "
            f"host_stall={ch['host_stall_s']}s "
            f"overlap_efficiency={ch.get('overlap_efficiency')}"
        )
        if ch.get("hbm_peak_bytes") is not None:
            print(f"hbm_peak_bytes: {ch['hbm_peak_bytes']}")
    cb = summary["combine"]
    if cb["combine_s"] is not None:
        print(f"\ncombine: {cb['combine_s']}s  resample_predict: "
              f"{cb['resample_predict_s']}s")
    cc = summary["ckpt_commit"]
    if cc["n_generations"]:
        print(f"\nckpt commits: {cc['n_generations']} generation(s), {cc['seconds']}s "
              f"coordination (last generation {cc['last_generation']}, "
              f"{cc['n_processes']} process(es))")
    if summary["watchdog"]["fired"]:
        print(
            f"\nwatchdog fired {len(summary['watchdog']['fired'])} "
            "time(s):"
        )
        for w in summary["watchdog"]["fired"]:
            print(
                f"  chunk {w.get('chunk')} deadline "
                f"{w.get('deadline_s')}s domains {w.get('domains')}"
            )
    if summary["faults"]:
        print(f"\nfaults ({len(summary['faults'])}):")
        for f in summary["faults"]:
            print(f"  {f}")
    live = summary["live_diagnostics"]
    if live["n_boundaries"]:
        print(
            f"\nlive diagnostics: {live['n_boundaries']} boundaries, "
            f"final {live['final']}"
        )
    sv = summary["serve"]
    co = sv["coalesce"]
    if sv["n_request_spans"] or co["n_batches"] or sv["sheds"]:
        print(
            f"\nserve: {sv['n_request_spans']} request span(s), "
            f"{co['n_batches']} coalesced batch(es)"
            + (f" (occupancy {co['mean_requests_per_batch']} req/batch, max "
               f"{co['max_requests_per_batch']}; {co['mean_rows_per_batch']} rows/batch)"
               if co["n_batches"] else "")
        )
        if sv["held_s_hist"]:
            print(f"  held-time histogram: {sv['held_s_hist']} (max {sv['held_s_max']}s)")
        if sv["sheds"]:
            print(f"  admission counters: {sv['sheds']}")
    ig = summary["ingest"]
    if ig["n_ingest_batches"] or ig["n_generations_published"] or ig["n_generation_swaps"]:
        print(
            f"\ningest: {ig['n_ingest_batches']} batch(es), "
            f"{ig['rows_ingested']} row(s); {ig['n_refits']} refit(s) "
            f"({ig['refit_subsets_total']} refit / "
            f"{ig['reused_subsets_total']} reused subsets); "
            f"{ig['n_generations_published']} generation(s) published "
            f"(last {ig['last_generation']}), "
            f"{ig['n_generation_swaps']} swap(s)"
        )
    return 0
