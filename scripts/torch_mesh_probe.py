"""The four-card job of the port on four H100s: the counterpart of the
twin's scripts/mesh_probe.py.

    python3 scripts/torch_mesh_probe.py [--legs a,b,...] [--out FILE] [--rehearse]

Needs four visible cards (no fall-back to fewer). Builds the kernels
from this checkout, then runs each leg and prints one JSON line a leg
(also appended to ``--out``), the cards' nvidia-smi lines, and a last
line ``{"ok": ..., "legs": {...}}``; exits 1 when any check of any leg
failed. Every leg holds the four cards against the same blocks run one
after another on cuda:0 (chip_smoke.one_card_mesh(4): each entry's job
as its card runs it), in the same call:

- ``c7_config5``: config5 production (K = 32, m = 3906, n = 124,992,
  quarantine), 32 sweeps in chunks of 16, on make_mesh(4), 8 subsets a
  card, through ``n_devices=4``: (a) every card's rows, and every result
  field, bitwise the one-card blocks, and the overlap pipeline
  (``chunk_pipeline="overlap"``) bitwise the sync one; (b) against the unmeshed one-card fit, each field's
  largest difference and the phi decisions that differ (the batch-size
  roundoff: 8 rows a call against 32), also with the CG operator in fp32
  (the one-card blocks against the unmeshed fit); (c) launches == the per-card
  expectation of the chunk records, the same count on each card.
- ``mesh4_northstar``: the four-card share of the north-star job (K =
  128, m = 3906, n = 499,968, production, 32 sweeps in chunks of 16), 32
  subsets a card: every card's rows and the combined posterior bitwise
  the one-card blocks; wall, ms/sweep, each card's chunk calls and their
  spans (CUDA events around each call, a first call's warm-up, capture
  and capture-lock wait included: not busy time), the peak per card,
  captures per card and their waits, the ``gather`` span. At 32 sweeps
  in chunks of 16 each chunk program is called once a card, so every
  call captures and none replays: the cards' steady-state overlap is
  not measured here.
- ``adaptive_mesh4``: chip_smoke's adaptive run (c) (config5, two
  chains, 160 sweeps in chunks of 10) on make_mesh(4): ``frozen_at``,
  the rungs and the grants equal chip_smoke.replay_schedule's
  AdaptiveScheduler(n_devices=4) over the run's logged boundaries, every
  replan a rung on four entries planned as the twin's planner plans it,
  launches per card, rows bitwise the one-card blocks; then the K = 8,
  m = 200 case unmeshed, on make_mesh(4) and on the one-card blocks:
  for every subset whose freeze differs between the two runs, the
  unmeshed run's boundaries replayed on four entries give the four-entry
  run's freeze, and the four-entry run's boundaries replayed on one
  entry do not (the rung parts them, not the batch's roundoff).
- ``nccl_world4``: four processes, one card each, launched with
  torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
  MASTER_PORT) into smk_torch.testing.dcn_worker's card mode (NCCL,
  parallel/distributed.local_card): (a) ``mesh4_northstar``'s fit under
  the distributed checkpoint (format 8), each rank's rows and the result
  bitwise the one-process make_mesh(4) fit; each generation's commit and
  landing seconds, shard bytes per rank, the ``gather`` over NCCL; (b)
  the adaptive run (c) over the world, bitwise ``adaptive_mesh4``'s,
  one decision gather per sampling boundary; (c) rank 0 killed at
  generation 2 (testing/faults.kill_process_at_generation): the peers'
  commits abort typed, and a relaunch of four resumes from generation 1
  bitwise (a).
- ``sharded_chol4``: a 3906 × 3906 factor's row blocks on the four
  cards (parallel/sharded_chol) against ops/chol.blocked_cholesky on
  one card: both residuals, both times.

``--rehearse`` runs every leg on the CPU at small sizes (four virtual
CPU entries, gloo workers, the plain builds counted in place of
launches; no device time): the control flow and every comparison, no
number of a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from smk_torch.models.probit_gp import dispatched_build_calls  # noqa: E402

# the legs' sizes on the cards, and in a CPU rehearsal
SIZES = {
    "card": dict(m=3906, t=64, c7_k=32, north_k=128, adapt_k=32, small_n=1600, rank=256,
                 block=512, chol_m=3906, samples=32, chunk=16),
    "rehearse": dict(m=40, t=8, c7_k=8, north_k=16, adapt_k=8, small_n=320, rank=16,
                     block=16, chol_m=256, samples=32, chunk=16),
}
LEGS = ("c7_config5", "mesh4_northstar", "adaptive_mesh4", "nccl_world4", "sharded_chol4")
N_CARDS = 4
KILL_GEN = 2
WORKER_TIMEOUT_S = 420
# no leg starts after this many seconds of the run (it is recorded as failed)
DEADLINE_S = 1300.0


class Leg:
    """One leg's record and its failed checks."""

    def __init__(self, name):
        self.rec = {"leg": name}
        self.failed = []

    def check(self, cond, what):
        if not cond:
            self.failed.append(what)
        return bool(cond)


class Probe:
    """The run's devices, sizes and shared references."""

    def __init__(self, rehearse: bool, tmp: str):
        import torch

        self.rehearse = rehearse
        self.s = SIZES["rehearse" if rehearse else "card"]
        self.dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
        self.tmp = tmp
        self.refs = {}

    # -- devices -----------------------------------------------------------
    def mesh4(self):
        from smk_torch.parallel.executor import make_mesh

        return make_mesh(N_CARDS, device="cpu") if self.rehearse else make_mesh(N_CARDS)

    def one_card(self):
        return cs.one_card_mesh(N_CARDS, self.dev)

    def sync(self):
        import torch

        if not self.rehearse:
            for i in range(N_CARDS):
                torch.cuda.synchronize(i)

    def free(self):
        import torch

        gc.collect()
        if not self.rehearse:
            torch.cuda.empty_cache()

    def counts(self):
        """Builds per entry point: kernel launches on the cards, the plain
        version's calls in a rehearsal (the same calls)."""
        from smk_torch.ops import fused_build as fb

        return dict(fb.PLAIN_CALLS if self.rehearse else fb.LAUNCHES)

    def data(self, k):
        s = self.s
        return cs.binary_field(k * s["m"], 1, 2, s["t"], cs.SEED + k * s["m"])

    def production(self, k, **kw):
        return cs.production_config(k=k, n_samples=self.s["samples"], phi_every=16,
                                    rank=self.s["rank"], block=self.s["block"], **kw)

    def adaptive(self, k, log_dir):
        return cs.adaptive_config(k=k, n_samples=cs.ADAPT_SAMPLES, n_chains=2, adaptive=True,
                                  live=True, run_log_dir=log_dir, rank=self.s["rank"],
                                  block=self.s["block"])

    # -- one fit -------------------------------------------------------------
    def fit(self, data, cfg, mesh, chunk_iters, *, spans=False):
        """fit_meta_kriging on ``mesh`` (None: unmeshed; an int: that
        ``n_devices``) from a clean count:
        (result, stats, record). ``spans``: each card's CUDA-event
        seconds around its chunk program calls (:func:`chunk_spans`)."""
        import torch
        from smk_torch import fit_meta_kriging
        from smk_torch.ops import fused_build as fb
        from smk_torch.utils.tracing import ChunkPipelineStats

        stats = ChunkPipelineStats()
        self.sync()
        if not self.rehearse:
            for i in range(N_CARDS):
                torch.cuda.reset_peak_memory_stats(i)
        fb.reset_counts()
        events = {}
        timer = chunk_spans(events) if spans and not self.rehearse else contextlib.nullcontext()
        t0 = time.perf_counter()
        where = ({} if mesh is None else {"n_devices": mesh} if isinstance(mesh, int)
                 else {"mesh": mesh})
        with timer:
            res = fit_meta_kriging(*data, config=cfg, seed=cs.SEED, device=self.dev,
                                   chunk_iters=chunk_iters, pipeline_stats=stats, **where)
            self.sync()
        rec = {"wall_s": time.perf_counter() - t0, "phase_seconds": res.phase_seconds,
               "ms_per_sweep": res.phase_seconds["subset_fits"] / cfg.n_samples * 1e3,
               "launches": self.counts(), "launches_by_card": dict(fb.DEVICE_LAUNCHES)}
        if not self.rehearse:
            rec["peak_bytes_by_card"] = {i: torch.cuda.max_memory_allocated(i)
                                         for i in range(N_CARDS)}
        if spans:
            rec["chunk_span_s_by_card"] = ({d: sum(a.elapsed_time(b) for a, b in ev) / 1e3
                                            for d, ev in events.items()}
                                           if not self.rehearse else "not measured")
            rec["chunk_calls_by_card"] = {d: len(ev) for d, ev in events.items()}
        caps = {}
        for c in stats.captures:
            e = caps.setdefault(c["device"], {"captures": 0, "capture_s": 0.0, "wait_s": 0.0})
            e["captures"] += 1
            e["capture_s"] += c["capture_s"]
            e["wait_s"] += c["wait_s"]
        rec["captures_by_card"] = caps
        return res, stats, rec


@contextlib.contextmanager
def chunk_spans(events):
    """Record a CUDA event pair around every chunk program call of a piece
    (parallel/recovery._run_piece), on the piece's device and the stream
    it runs on; ``events[device]`` gets the pairs. A pair spans the call
    whole: a replay, or at a program's first call its warm-up, its
    capture and the wait for the process's one capture at a time, during
    which the card may idle. It is a span, not the card's busy time."""
    import torch
    from smk_torch.parallel import recovery

    real = recovery._run_piece

    def timed(model, kind, pc, *args, **kw):
        dev = pc.data.x.device
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(torch.cuda.current_stream(dev))
        out = real(model, kind, pc, *args, **kw)
        b.record(torch.cuda.current_stream(dev))
        events.setdefault(str(dev), []).append((a, b))
        return out

    recovery._run_piece = timed
    try:
        yield
    finally:
        recovery._run_piece = real


def per_card_expected(cfg, chunks):
    """One card's builds of a chunked run on the four cards: the initial
    state's stack and each dispatched chunk's calls once."""
    one = [{**ch, "pieces": 1 if ch.get("pieces", 1) else 0} for ch in chunks]
    return sum(dispatched_build_calls(cfg, 1, one, entries=1).values())


def rows_bitwise(a, b, n_blocks):
    """Per block of rows, whether every subset_results field of the two
    fits is bitwise equal there."""
    per = a.subset_results.param_grid.shape[0] // n_blocks
    return [all(cs.same_bits(u[i * per:(i + 1) * per], v[i * per:(i + 1) * per])
                for u, v in zip(a.subset_results, b.subset_results))
            for i in range(n_blocks)]


def card_launch_checks(leg, pr, rec, cfg, stats, total):
    """Launches == the chunk records' per-card expectation, and on the
    cards the same count on each of the four."""
    want = dispatched_build_calls(cfg, 1, stats.chunks, entries=N_CARDS)
    rec["launches_expected"] = want
    leg.check(rec["launches"] == want, f"launches {rec['launches']} != {want}")
    if not pr.rehearse:
        per = per_card_expected(cfg, stats.chunks)
        rec["launches_per_card_expected"] = per
        leg.check(rec["launches_by_card"] == dict.fromkeys(range(N_CARDS), per),
                  f"launches by card {rec['launches_by_card']} != {per} on each")
        leg.check(sum(rec["launches_by_card"].values()) == total, "card counts do not sum")


def span_seconds(res, name):
    return cs.span_seconds(res.run_log_path, name)[0] if res.run_log_path else None


# ----------------------------------------------------------------------
# the legs
# ----------------------------------------------------------------------
def c7_config5(pr, leg):
    s = pr.s
    k = s["c7_k"]
    data = pr.data(k)
    cfg = pr.production(k, fault_policy="quarantine")
    fits = {}
    for name, mesh in (("mesh4", N_CARDS), ("one_card", pr.one_card()), ("unmeshed", None)):
        fits[name] = pr.fit(data, cfg, mesh, s["chunk"])
        pr.free()
    # the same on the four cards under the overlap pipeline
    fits["mesh4_overlap"] = pr.fit(data, dataclasses.replace(cfg, chunk_pipeline="overlap"),
                                   pr.mesh4(), s["chunk"])
    pr.free()
    (a, sa, ra), (b, _, rb), (u, _, ru) = fits["mesh4"], fits["one_card"], fits["unmeshed"]
    o, _, ro = fits["mesh4_overlap"]
    overlap_same = cs.every_field_bitwise(o, a)
    leg.check(all(overlap_same.values()), f"the overlap pipeline not bitwise sync {overlap_same}")
    # (b') the same two one-card runs with the CG operator in fp32: how much
    # of the gap the bf16 operator's rounding carries
    f32 = dataclasses.replace(cfg, cg_matvec_dtype="float32")
    b32, _, _ = pr.fit(data, f32, pr.one_card(), s["chunk"])
    pr.free()
    u32, _, _ = pr.fit(data, f32, None, s["chunk"])
    pr.free()
    leg.rec["fp32_operator"] = {"max_abs_diff_unmeshed": cs.field_gaps(b32, u32),
                                "phi_decisions_differ": cs.phi_decisions_differ(b32, u32, 1)}
    del b32, u32
    rows = rows_bitwise(a, b, N_CARDS)
    fields = cs.every_field_bitwise(a, b)
    leg.check(all(rows), f"(a) rows by card not bitwise the one-card blocks {rows}")
    leg.check(all(fields.values()), f"(a) result fields not bitwise {fields}")
    card_launch_checks(leg, pr, ra, cfg, sa, sum(ra["launches"].values()))
    leg.check(rb["launches"] == ra["launches"], "the one-card blocks launched otherwise")
    leg.rec.update(K=k, m=s["m"], n=k * s["m"], n_samples=cfg.n_samples, chunk_iters=s["chunk"],
                   rows_bitwise_one_card=rows, fields_bitwise_one_card=fields,
                   bitwise_unmeshed=cs.every_field_bitwise(a, u),
                   max_abs_diff_unmeshed=cs.field_gaps(a, u),
                   phi_decisions_differ=cs.phi_decisions_differ(a, u, 1), phi_decisions_of=k,
                   overlap_bitwise_sync=overlap_same, mesh4=ra, mesh4_overlap=ro, one_card=rb,
                   unmeshed=ru)


def mesh4_northstar(pr, leg):
    s = pr.s
    k = s["north_k"]
    data = pr.data(k)
    fits = {}
    for name, mesh in (("mesh4", pr.mesh4()), ("one_card", pr.one_card())):
        cfg = pr.production(k, run_log_dir=os.path.join(pr.tmp, f"north_{name}"))
        fits[name] = pr.fit(data, cfg, mesh, s["chunk"], spans=True)
        fits[name][2]["gather_s"] = span_seconds(fits[name][0], "gather")
        pr.free()
    (a, sa, ra), (b, _, rb) = fits["mesh4"], fits["one_card"]
    rows = rows_bitwise(a, b, N_CARDS)
    fields = cs.every_field_bitwise(a, b)
    leg.check(all(rows), f"rows by card not bitwise the one-card blocks {rows}")
    leg.check(all(fields.values()), f"the combined posterior not bitwise {fields}")
    card_launch_checks(leg, pr, ra, cfg, sa, sum(ra["launches"].values()))
    if not pr.rehearse:
        # the chunk calls' spans over the four cards' sweeps (not an
        # overlap: a span holds a first call's capture and its waits)
        span = sum(ra["chunk_span_s_by_card"].values())
        ra["span_share"] = span / (N_CARDS * ra["phase_seconds"]["subset_fits"])
    leg.rec.update(K=k, m=s["m"], n=k * s["m"], n_samples=cfg.n_samples, chunk_iters=s["chunk"],
                   rows_bitwise_one_card=rows, fields_bitwise_one_card=fields,
                   mesh4=ra, one_card=rb)
    from smk_torch.testing import dcn_worker as w

    pr.refs["northstar"] = {"rows": w.rows_digests(a.subset_results, N_CARDS),
                            **{f: w.digest(getattr(a, f)) for f in w.E2E_FIELDS}}


def _events(path, name):
    from smk_torch.obs.reporter import read_jsonl

    return [r["attrs"] for r in read_jsonl(path)
            if r.get("kind") == "event" and r.get("name") == name]


def _replay_checks(leg, tag, cfg, k, res, stats, n_devices):
    """The run's frozen_at, summary and rungs against the scheduler
    replayed over its logged boundaries on ``n_devices`` entries."""
    rungs = []
    rep = cs.replay_schedule(cfg, k, _events(res.run_log_path, "live_diagnostics"),
                             stats.chunks, n_devices=n_devices, rungs=rungs)
    summ = rep.summary()
    got = {key: stats.adaptive[key] for key in summ}
    run_rungs = [ch["kc"] for ch in stats.chunks if ch["phase"] in ("sample", "extra")]
    leg.check(got == summ, f"{tag}: the run's schedule {got} != the replay's {summ}")
    leg.check(run_rungs == rungs, f"{tag}: rungs {run_rungs} != the replay's {rungs}")
    return {"frozen_at": got["frozen_at"], "extra_granted": stats.adaptive["extra_granted"],
            "chunks_saved_frac": stats.adaptive["chunks_saved_frac"], "rungs": run_rungs,
            "replay_equal": got == summ and run_rungs == rungs}


def _cross_replay(cfg, log, stats, n_devices):
    """The frozen_at of the scheduler on ``n_devices`` entries replayed
    over another run's logged boundaries (as far as they go)."""
    return cs.replay_schedule(cfg, 8, _events(log, "live_diagnostics"), stats.chunks,
                              n_devices=n_devices).summary()["frozen_at"]


def _replan_checks(leg, tag, res, m):
    from smk_torch.compile.buckets import plan_ragged_mesh

    replans = _events(res.run_log_path, "adaptive_mesh_replan")
    comps = [e for e in _events(res.run_log_path, "adaptive_compaction") if e["n_active"] > 0]
    leg.check(len(replans) == len(comps), f"{tag}: {len(replans)} replans, {len(comps)} compactions")
    for e in replans:
        plan = plan_ragged_mesh([m], [e["kc"]], N_CARDS)
        leg.check(e["kc"] % N_CARDS == 0 and e["entries"] == len(plan.entries)
                  and all(u.n_devices == N_CARDS for u in plan.entries),
                  f"{tag}: replan {e} is not a rung over the four entries")
    return replans


def adaptive_mesh4(pr, leg):
    import glob

    import torch
    from smk_torch import SMKConfig
    from smk_torch.models import probit_gp as tp
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import recovery as rec_
    from smk_torch.utils.tracing import ChunkPipelineStats

    s = pr.s
    k = s["adapt_k"]
    data = pr.data(k)
    fits = {}
    for name, mesh in (("mesh4", pr.mesh4()), ("one_card", pr.one_card())):
        cfg = pr.adaptive(k, os.path.join(pr.tmp, f"adapt_{name}"))
        fits[name] = pr.fit(data, cfg, mesh, cs.ADAPT_CHUNK)
        pr.free()
    (a, sa, ra), (b, _, rb) = fits["mesh4"], fits["one_card"]
    rows = rows_bitwise(a, b, N_CARDS)
    leg.check(all(rows), f"(c) rows by card not bitwise the one-card blocks {rows}")
    card_launch_checks(leg, pr, ra, cfg, sa, sum(ra["launches"].values()))
    ra["schedule"] = _replay_checks(leg, "(c)", cfg, k, a, sa, N_CARDS)
    ra["replans"] = _replan_checks(leg, "(c)", a, s["m"])
    leg.rec.update(K=k, m=s["m"], n_samples=cfg.n_samples, chunk_iters=cs.ADAPT_CHUNK,
                   rows_bitwise_one_card=rows, c_mesh4=ra, c_one_card=rb)
    from smk_torch.testing import dcn_worker as w

    pr.refs["adaptive"] = {"rows": w.rows_digests(a.subset_results, N_CARDS),
                           "frozen_at": list(a.frozen_at),
                           "chunks_saved_frac": a.chunks_saved_frac,
                           "extra_granted": sa.adaptive["extra_granted"],
                           **{f: w.digest(getattr(a, f)) for f in w.E2E_FIELDS}}
    del a, b, fits
    pr.free()
    # the K = 8, m = 200 case: where the four-entry rungs change the freezes
    knobs = dict(n_samples=80, burn_in_frac=0.5, live_diagnostics=True, adaptive_schedule="on",
                 target_rhat=1.5, target_ess=8.0, adapt_patience=1, min_samples_before_stop=8,
                 adapt_max_extra_frac=0.5, n_chains=2, fused_build="pallas")
    part, ct, xt = cs._small_problem(s["small_n"], 8, pr.dev)
    small = {}
    for name, mesh in (("unmeshed", None), ("mesh4", pr.mesh4()), ("one_card", pr.one_card())):
        cfg_s = SMKConfig(n_subsets=8, run_log_dir=os.path.join(pr.tmp, f"small_{name}"), **knobs)
        model = tp.SpatialGPSampler(cfg_s)
        st = ChunkPipelineStats()
        noise = model.default_noise(rec_.stacked_subset_data(part, ct, xt), seed=cs.SEED)
        fb.reset_counts()
        r = rec_.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=cs.ADAPT_CHUNK,
                                     pipeline_stats=st, mesh=mesh)
        pr.sync()
        (log,) = glob.glob(os.path.join(cfg_s.run_log_dir, "*.jsonl"))
        small[name] = (r, st, log, pr.counts(), cfg_s)
    (ru, su, lu, _, cu), (rm, sm, lm, cm, cfg_m) = small["unmeshed"], small["mesh4"]
    ro = small["one_card"][0]
    same = all(cs.same_bits(u, v) for u, v in zip(rm, ro) if u is not None)
    leg.check(same, "small: the four-entry run is not bitwise its one-card blocks")

    class _Logged:  # the executor's result handle the replay reads
        def __init__(self, path):
            self.run_log_path = path

    rep_m = _replay_checks(leg, "small mesh4", cfg_m, 8, _Logged(lm), sm, N_CARDS)
    rep_u = _replay_checks(leg, "small unmeshed", cu, 8, _Logged(lu), su, 1)
    want = dispatched_build_calls(cfg_m, 1, sm.chunks, entries=N_CARDS)
    leg.check(cm == want, f"small: launches {cm} != {want}")
    fz_m, fz_u = sm.adaptive["frozen_at"], su.adaptive["frozen_at"]
    extra = [j for j in range(8) if fz_m[j] != fz_u[j]]
    # each run's boundaries in the other's scheduler: the rung alone
    u_on4 = _cross_replay(cu, lu, su, N_CARDS)
    m_on1 = _cross_replay(cfg_m, lm, sm, 1)
    by_rung = all(u_on4[j] == fz_m[j] and m_on1[j] != fz_m[j] for j in extra)
    leg.check(by_rung, f"small: the freezes {extra} that differ are not the rung's "
                       f"(unmeshed on 4 entries {u_on4}, four-entry on 1 {m_on1})")
    leg.rec["small"] = {"K": 8, "m": s["small_n"] // 8, "frozen_at_mesh4": fz_m,
                        "frozen_at_unmeshed": fz_u, "differ": extra,
                        "unmeshed_replayed_on_4": u_on4, "mesh4_replayed_on_1": m_on1,
                        "explained_by_rung": by_rung,
                        "bitwise_one_card": same, "mesh4": rep_m, "unmeshed": rep_u,
                        "replans": _replan_checks(leg, "small", _Logged(lm), s["small_n"] // 8),
                        "launches": cm, "launches_expected": want}
    del small, part, ct, xt
    if not pr.rehearse:
        torch.cuda.empty_cache()


def _free_port():
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        return so.getsockname()[1]


TAGS = {"ckpt": "DCN_CKPT", "adaptive": "DCN_ADAPTIVE"}


def run_world(pr, mode, extra_env):
    """One job of four worker processes, launched as torchrun launches
    them; each one's tagged line (None where it printed none) and its
    exit code."""
    port = str(_free_port())
    procs = []
    for r in range(N_CARDS):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(N_CARDS), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   **extra_env)
        if pr.rehearse:
            env.pop("SMK_DCN_DEVICE", None)
            env["OMP_NUM_THREADS"] = "1"
        else:
            env["SMK_DCN_DEVICE"] = "cuda"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "smk_torch.testing.dcn_worker", mode], cwd=str(REPO),
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WORKER_TIMEOUT_S)
            lines = [ln for ln in stdout.splitlines() if ln.startswith(TAGS[mode] + " ")]
            outs.append({"rc": p.returncode, "line": (json.loads(lines[0][len(TAGS[mode]) + 1:])
                                                      if lines else None),
                         "stderr_tail": stderr[-1500:] if p.returncode or not lines else ""})
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _world_ok(leg, tag, outs):
    ok = all(o["rc"] == 0 and o["line"] is not None for o in outs)
    leg.check(ok, f"{tag}: a worker failed {[(o['rc'], o['stderr_tail']) for o in outs]}")
    return ok


def nccl_world4(pr, leg):
    from smk_torch.testing import dcn_worker as w

    s = pr.s
    pr.free()
    if "northstar" not in pr.refs or "adaptive" not in pr.refs:
        leg.check(False, "needs mesh4_northstar and adaptive_mesh4 in the same run")
        return
    k = s["north_k"]
    north_job = os.path.join(pr.tmp, "northstar.job")
    w.write_job(north_job, pr.data(k), pr.production(k), cs.SEED, s["chunk"])
    k_a = s["adapt_k"]
    adapt_job = os.path.join(pr.tmp, "adaptive.job")
    w.write_job(adapt_job, pr.data(k_a), pr.adaptive(k_a, None), cs.SEED, cs.ADAPT_CHUNK)
    ref = pr.refs["northstar"]
    # (a) the north-star share under format 8
    path_a = os.path.join(pr.tmp, "ckpt_a", "run.ckpt")
    os.makedirs(os.path.dirname(path_a))
    outs = run_world(pr, "ckpt", {"SMK_DCN_JOB": north_job, "SMK_DCN_CKPT_PATH": path_a,
                                  "SMK_DCN_CKPT_TIMEOUT": "60"})
    a = {"ranks": [o["line"] for o in outs]}
    if _world_ok(leg, "(a)", outs):
        lines = a["ranks"]
        leg.check([ln["outcome"] for ln in lines] == ["completed"] * N_CARDS, "(a) not completed")
        leg.check([ln["local_sha"] for ln in lines] == ref["rows"],
                  "(a) rows not bitwise the one-process make_mesh(4) fit")
        for f in w.E2E_FIELDS:
            leg.check(all(ln[f] == ref[f] for ln in lines), f"(a) {f} not bitwise")
        if not pr.rehearse:
            leg.check(sorted(ln["card"] for ln in lines) == list(range(N_CARDS)),
                      f"(a) cards {[ln['card'] for ln in lines]}")
        a["shard_bytes_by_rank"] = [sum(b["ckpt_bytes"] or 0 for b in ln["boundaries"])
                                    for ln in lines]
        a["files"] = sorted(os.listdir(os.path.dirname(path_a)))
    shutil.rmtree(os.path.dirname(path_a), ignore_errors=True)
    leg.rec["a_ckpt"] = a
    # (b) the adaptive run (c) over the world
    outs = run_world(pr, "adaptive", {"SMK_DCN_JOB": adapt_job})
    b = {"ranks": [o["line"] for o in outs]}
    if _world_ok(leg, "(b)", outs):
        aref = pr.refs["adaptive"]
        lines = b["ranks"]
        leg.check([ln["rows"] for ln in lines] == aref["rows"], "(b) rows not bitwise adaptive_mesh4")
        for key in w.E2E_FIELDS + ("frozen_at", "chunks_saved_frac", "extra_granted"):
            leg.check(all(ln[key] == aref[key] for ln in lines), f"(b) {key} differs")
        # one gather a sampling boundary: every chunk but the burn-in's
        n_burn = pr.adaptive(k_a, None).n_burn_in
        consults = len(lines[0]["kc"]) - -(-n_burn // cs.ADAPT_CHUNK)
        leg.check(all(ln["gathers"] == consults for ln in lines),
                  f"(b) gathers {[ln['gathers'] for ln in lines]} != {consults} boundaries")
    leg.rec["b_adaptive"] = b
    # (c) rank 0 killed at generation KILL_GEN, then a relaunch of four
    path_c = os.path.join(pr.tmp, "ckpt_c", "run.ckpt")
    os.makedirs(os.path.dirname(path_c))
    env_c = {"SMK_DCN_JOB": north_job, "SMK_DCN_CKPT_PATH": path_c, "SMK_DCN_CKPT_TIMEOUT": "30"}
    killed = run_world(pr, "ckpt", dict(env_c, SMK_DCN_CKPT_KILL_GEN=str(KILL_GEN)))
    relaunch = run_world(pr, "ckpt", env_c)
    c = {"killed": [o["line"] for o in killed], "relaunch": [o["line"] for o in relaunch]}
    if _world_ok(leg, "(c) kill", killed) and _world_ok(leg, "(c) relaunch", relaunch):
        kl, rl = c["killed"], c["relaunch"]
        leg.check(kl[0]["outcome"] == "killed"
                  and all(ln["outcome"] == "commit_abort" for ln in kl[1:]),
                  f"(c) outcomes {[ln['outcome'] for ln in kl]}")
        leg.check(all(ln["final_generation"] == KILL_GEN - 1 for ln in kl), "(c) generation")
        leg.check(all(ln["outcome"] == "completed" and ln["resume_from_generation"] == KILL_GEN - 1
                      for ln in rl), "(c) the relaunch did not resume from generation 1")
        leg.check([ln["local_sha"] for ln in rl] == ref["rows"], "(c) resume not bitwise (a)")
    leg.rec["c_kill_resume"] = c
    shutil.rmtree(os.path.dirname(path_c), ignore_errors=True)


def sharded_chol4(pr, leg):
    import torch
    from smk_torch.ops.chol import blocked_cholesky
    from smk_torch.parallel.sharded_chol import sharded_cholesky

    m = pr.s["chol_m"]
    block = pr.s["block"]
    g = torch.Generator(device="cpu").manual_seed(cs.SEED)
    coords = torch.rand((m, 2), generator=g).to(pr.dev)
    a = torch.exp(-6.0 * torch.cdist(coords, coords)) + 1e-3 * torch.eye(m, device=pr.dev)
    mesh = pr.mesh4()

    def resid(lf):
        return float(torch.linalg.norm(lf @ lf.T - a) / torch.linalg.norm(a))

    def wall_ms(fn, reps=5):
        fn()
        pr.sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            pr.sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    got = sharded_cholesky(a, mesh, block_size=block)
    devices = sorted({str(b.device) for b in got.blocks}) if hasattr(got, "blocks") else None
    l_sh = got.gather()
    l_bl = blocked_cholesky(a, 0.0, block)
    r_sh, r_bl = resid(l_sh), resid(l_bl)
    leg.check(bool(torch.isfinite(l_sh).all()) and r_sh <= 2.0 * r_bl,
              f"residual {r_sh} beyond twice blocked_cholesky's {r_bl}")
    leg.rec.update(m=m, block=block, mesh=repr(mesh), block_devices=devices,
                   residual_sharded=r_sh, residual_blocked=r_bl,
                   bitwise_blocked=bool(torch.equal(l_sh, l_bl)),
                   max_abs_diff=float((l_sh - l_bl).abs().max()),
                   sharded_wall_ms=wall_ms(lambda: sharded_cholesky(a, mesh, block_size=block)),
                   blocked_wall_ms=wall_ms(lambda: blocked_cholesky(a, 0.0, block)))
    if not pr.rehearse:
        leg.rec["blocked_device_ms"] = cs.ms_median(lambda: blocked_cholesky(a, 0.0, block),
                                                    reps=5, warmup=1, device_only=True)


def smi_lines():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", default=",".join(LEGS))
    ap.add_argument("--out", default=None, help="also append each leg's line to this file")
    ap.add_argument("--rehearse", action="store_true",
                    help="every leg on the CPU at small sizes (no card, no device time)")
    args = ap.parse_args()
    asked = {x for x in args.legs.split(",") if x}
    if asked - set(LEGS):
        ap.error(f"unknown legs {sorted(asked - set(LEGS))}")
    legs = [x for x in LEGS if x in asked]  # nccl_world4 reads the two legs before it
    start = time.perf_counter()
    import torch

    if args.rehearse:
        # the CPU's products sum in an order that follows the thread count:
        # one thread here, as in the gloo workers
        torch.set_num_threads(1)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < N_CARDS:
            print(f"torch_mesh_probe: needs {N_CARDS} CUDA cards, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from smk_torch.ops import cuda_build

        t0 = time.perf_counter()
        cuda_build.build()
        print(json.dumps({"leg": "build", "wall_s": time.perf_counter() - t0,
                          "cards": [torch.cuda.get_device_name(i) for i in range(N_CARDS)]}),
              flush=True)
    smi = smi_lines() if not args.rehearse else ["not measured (CPU rehearsal)"]
    tmp = tempfile.mkdtemp(prefix="smk_mesh_probe_")
    pr = Probe(args.rehearse, tmp)
    verdicts = {}
    try:
        for name in legs:
            leg = Leg(name)
            t0 = time.perf_counter()
            if t0 - start > DEADLINE_S:
                leg.failed.append(f"not run: past the {DEADLINE_S:.0f} s deadline")
            else:
                try:
                    globals()[name](pr, leg)
                except Exception:  # a leg that raises is a failed leg; the next runs
                    leg.failed.append(traceback.format_exc()[-3000:])
            pr.free()
            leg.rec.update(ok=not leg.failed, failed=leg.failed,
                           leg_wall_s=time.perf_counter() - t0, nvidia_smi=smi,
                           device="cpu (rehearsal)" if args.rehearse else
                           torch.cuda.get_device_name(0))
            verdicts[name] = not leg.failed
            line = json.dumps(leg.rec, default=str)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for ln in smi:
        print(ln, flush=True)
    print(json.dumps({"ok": all(verdicts.values()), "legs": verdicts}), flush=True)
    return 0 if all(verdicts.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
