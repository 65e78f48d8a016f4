"""One process of a multi-process job, on the CPU (gloo) or one card a
process (NCCL): the port's counterpart of the twin's
``scripts/_dcn_worker.py``.

Every process builds the same small problem from fixed seeds (K = 4
subsets of m = 24 rows, data/synthetic.tiny_binary_problem), joins the process group
(parallel/distributed.init_distributed), lays the subsets over the job's
mesh (one virtual CPU entry a process), fits the rows it owns, and
gathers the grids over the group for the combine. It prints one line of
JSON, prefixed by its mode's tag, for the caller to compare with a
one-process fit of the same seeds (:func:`reference`).

Usage::

    python -m smk_torch.testing.dcn_worker <rank> <world> <port> [mode]
    SMK_DCN_DEVICE=cuda python -m smk_torch.testing.dcn_worker [mode]

The second form is the card mode: the process joins an NCCL group
through the ``env://`` rendezvous, launched as torchrun launches its
workers (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``), drives the card its local rank names
(parallel/distributed.local_card) and fits on it. The environment form
runs on the CPU too (gloo), with ``SMK_DCN_DEVICE`` unset.

``SMK_DCN_JOB`` names a job file (:func:`write_job`: the data, the
config, the fit's seed and chunk length) that replaces the tiny problem
and its config, seed and chunk length in every mode: the tiny problem at
another K (:func:`tiny_problem`; two or more subsets a process keep the
fits bitwise on the CPU), or a problem at full size, such as the
four-card share of the north-star job (K = 128, m = 3906,
scripts/torch_mesh_probe.py). The modes' own knobs (fault policy, commit
timeout, the run log) are applied to its config.

``mode`` (default ``normal``):

- ``normal``: ``fit_subsets_sharded`` over the job's mesh, then
  ``gather_grids`` and the combine; prints ``DCN_RESULT``;
- ``e2e``: the whole ``fit_meta_kriging`` over the job's mesh through the
  chunked executor (chunks of 10 sweeps, quarantine); prints
  ``DCN_E2E`` with the result's digests and the topology fingerprint;
- ``die_mid``: leaves right after joining the group (a host that dies
  mid-run); prints ``DCN_DYING``;
- ``guard``: the ``normal`` fit and gather under a ChunkWatchdog deadline
  of ``SMK_DCN_DEADLINE_S`` seconds (default 20): with a dead peer the
  gather's barrier waits, and the watchdog's ChunkTimeoutError, naming
  the process domains, is printed as ``DCN_TIMEOUT``;
- ``ckpt``: ``fit_meta_kriging`` over the job's mesh with a
  ``checkpoint_path``, the distributed checkpoint (format 8: per-process
  shard files, a two-phase-committed generation a chunk boundary). The
  environment drives it:

  - ``SMK_DCN_CKPT_PATH``: the shared checkpoint path (required);
  - ``SMK_DCN_CKPT_STOP``: stop after that many committed generations
    (a progress callback raising a ProgressAbort at the next boundary);
  - ``SMK_DCN_CKPT_KILL_GEN``: on process 0, testing/faults
    .kill_process_at_generation of that generation (a SimulatedKill
    between shard-land and manifest-publish; the peer's commit aborts
    with a typed CkptCommitError within the commit deadline);
  - ``SMK_DCN_CKPT_POLICY``: ``fault_policy`` (default ``abort``);
  - ``SMK_DCN_CKPT_TIMEOUT``: ``ckpt_commit_timeout_s`` (default 60);
  - ``SMK_DCN_CKPT_CHUNK``: ``chunk_iters`` (default 5).

  Prints one ``DCN_CKPT`` line: ``outcome`` (``completed``, ``stopped``,
  ``killed`` or ``commit_abort``), ``local_sha`` (this process's rows of
  the draws), ``global_sha`` (all K rows, through
  checkpoint.fetch_global), ``final_generation`` and
  ``resume_from_generation`` (the manifest's after and before the run),
  ``generations`` and ``ckpt_commit_s`` (the run's commits),
  ``warnings`` (``elastic``, ``orphan``, ``other``), and after a resume
  ``committed_rows_sha``: the digest of the kept draws that were
  committed before it. A one-process job (world 1) on a checkpoint that
  two processes wrote resumes elastically.
- ``adaptive``: ``fit_meta_kriging`` over the job's mesh under the
  adaptive schedule (two chains, 120 sweeps in chunks of 10, seed
  ``ADAPT_SEED``: both subsets of process 0 freeze at iteration 80, so
  process 1 samples on alone, then a third subset freezes and the last
  is granted three extra chunks). Every process holds the one scheduler
  over all K, fed each boundary's statistics gathered over the group.
  Prints ``DCN_ADAPTIVE`` with the digests of its rows and of the
  result, ``frozen_at``, ``chunks_saved_frac``, ``extra_granted``, the
  ``adaptive_mesh_replan`` events, each chunk's rung and this process's
  share of it, and the number of boundary gathers.
  ``SMK_DCN_ADAPT_NAN=<subset>:<iteration>`` runs it under
  ``fault_policy="quarantine"`` with that subset's state poisoned once in
  the chunk covering that burn-in iteration (testing/faults
  .inject_subset_nan, on the process that owns the subset): the owner
  rewinds and retries it, every other process replays the chunk as it
  ran.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import pickle
import shutil
import sys

import numpy as np
import torch

K, M, Q, P, T = 4, 24, 1, 2, 6
SEED = 3


def write_job(path, data, config, seed: int, chunk_iters: int) -> None:
    """Write the job file ``SMK_DCN_JOB`` reads: the five data arrays
    (numpy, the same on every process), the SMKConfig, the fit's seed and
    chunk length (pickled)."""
    with open(path, "wb") as f:
        pickle.dump({"data": tuple(np.asarray(a) for a in data), "config": config,
                     "seed": int(seed), "chunk_iters": int(chunk_iters)}, f)


def job():
    """The job of ``SMK_DCN_JOB`` (a file :func:`write_job` wrote), or
    None for the tiny problem."""
    path = os.environ.get("SMK_DCN_JOB")
    return _read_job(path) if path else None


@functools.lru_cache(maxsize=1)
def _read_job(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def n_subsets() -> int:
    """The job's K: the job file's, else the tiny problem's."""
    spec = job()
    return spec["config"].n_subsets if spec else K


def device() -> str:
    """``SMK_DCN_DEVICE``: "cpu" (default) or "cuda", this process's card."""
    return os.environ.get("SMK_DCN_DEVICE", "cpu")


def problem():
    """The job's data, the same on every process: (y, x, coords,
    coords_test, x_test) as float32 numpy arrays."""
    spec = job()
    return spec["data"] if spec else tiny_problem(K)


def tiny_problem(k: int):
    """The tiny problem at ``k`` subsets of m = 24 rows (numpy arrays)."""
    from smk_torch.data.synthetic import tiny_binary_problem

    return tiny_binary_problem(seed=11, n=k * M, q=Q, p=P, t=T)


def config(**kw):
    """The job file's config with ``kw``, else the tiny problem's."""
    from smk_torch.config import SMKConfig

    spec = job()
    if spec:
        return dataclasses.replace(spec["config"], **kw)
    return SMKConfig(**{**dict(n_subsets=K, n_samples=40, u_solver="cg", cg_iters=16,
                               phi_update_every=2, n_quantiles=20), **kw})


def seed_and_chunk(seed: int, chunk_iters: int) -> tuple:
    """The fit's seed and chunk length: the job file's, else the mode's."""
    spec = job()
    return (spec["seed"], spec["chunk_iters"]) if spec else (seed, chunk_iters)


ADAPT_SEED = 4
# the adaptive mode's knobs on the tiny problem
ADAPT_KNOBS = dict(n_samples=120, burn_in_frac=0.5, n_chains=2, live_diagnostics=True,
                   adaptive_schedule="on", target_rhat=1.5, target_ess=6.0, adapt_patience=1,
                   min_samples_before_stop=8, adapt_max_extra_frac=0.5)
# the poisoned subset and burn-in iteration of the quarantined adaptive
# leg (SMK_DCN_ADAPT_NAN): subset 3, process 1's second row
ADAPT_NAN = (3, 15)


def adaptive_fit(mesh, log_dir, nan=None):
    """The ``adaptive`` mode's fit over ``mesh`` (the job's, or a
    one-process mesh of the world's entries for the reference), its run
    log in ``log_dir``; ``nan``: (subset, iteration) of a poisoned burn-in
    chunk under quarantine. Returns (result, ChunkPipelineStats, replan
    events)."""
    import contextlib

    from smk_torch.api import fit_meta_kriging
    from smk_torch.obs.reporter import read_jsonl
    from smk_torch.parallel.executor import process_row_range
    from smk_torch.testing.faults import inject_subset_nan
    from smk_torch.utils.tracing import ChunkPipelineStats

    policy = "abort" if nan is None else "quarantine"
    knobs = {} if job() else ADAPT_KNOBS
    cfg = config(**knobs, run_log_dir=log_dir, fault_policy=policy)
    seed, chunk = seed_and_chunk(ADAPT_SEED, 10)
    poison = contextlib.nullcontext()
    if nan is not None:
        lo, hi = process_row_range(n_subsets(), mesh)
        if lo <= nan[0] < hi:  # a row of this process's chunk state
            poison = inject_subset_nan(nan[0] - lo, at_iteration=nan[1])
    stats = ChunkPipelineStats()
    with poison:
        res = fit_meta_kriging(*problem(), config=cfg, seed=seed, device=device(),
                               mesh=mesh, chunk_iters=chunk, pipeline_stats=stats)
    replans = [r["attrs"] for r in read_jsonl(res.run_log_path)
               if r.get("kind") == "event" and r.get("name") == "adaptive_mesh_replan"]
    return res, stats, replans


def adaptive_summary(res, stats, replans) -> dict:
    """What the ``adaptive`` mode reports of one fit (the rows' digests
    are the caller's)."""
    ad = stats.adaptive
    gathers = ad.get("decision_gather_s", ())
    return {**{f: digest(getattr(res, f)) for f in E2E_FIELDS},
            "frozen_at": list(res.frozen_at), "chunks_saved_frac": res.chunks_saved_frac,
            "extra_granted": ad["extra_granted"], "replans": replans,
            "kc": [ch["kc"] for ch in stats.chunks if "kc" in ch],
            "local_kc": [ch["local_kc"] for ch in stats.chunks if "local_kc" in ch],
            "gathers": len(gathers), "gather_ms": [g * 1e3 for g in gathers],
            # this process's quarantine events: (iteration, its retried
            # rows, its dropped rows)
            "faults": [[e["iteration"], e["retried"], e["dropped"]]
                       for e in stats.fault_events]}


def adaptive_nan() -> tuple:
    """``SMK_DCN_ADAPT_NAN`` as (subset, iteration), or None."""
    spec = os.environ.get("SMK_DCN_ADAPT_NAN")
    return None if not spec else tuple(int(v) for v in spec.split(":"))


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


def sharded_fit(mesh=None):
    """The ``normal`` fit: the subsets over ``mesh`` (None: unmeshed),
    seeded generators from 0. Returns (SubsetResult of this process's
    rows, the combined parameter grid, the combined latent grid)."""
    from smk_torch.models.probit_gp import SpatialGPSampler
    from smk_torch.parallel.combine import combine_quantile_grids, gather_grids
    from smk_torch.parallel.executor import fit_subsets_sharded, fit_subsets_vmap
    from smk_torch.parallel.partition import random_partition

    k = n_subsets()
    y, x, coords, ct, xt = (torch.as_tensor(a) for a in problem())
    cfg = config()
    perm = torch.randperm(k * M, generator=torch.Generator().manual_seed(SEED))
    part = random_partition(perm, y, x, coords, k)
    model = SpatialGPSampler(cfg)
    if mesh is None:
        res = fit_subsets_vmap(model, part, ct, xt)
        gp, gw = res.param_grid, res.w_grid
    else:
        res = fit_subsets_sharded(model, part, ct, xt, mesh=mesh)
        gp, gw = gather_grids(res.param_grid, mesh), gather_grids(res.w_grid, mesh)
    return res, combine_quantile_grids(gp, cfg.combiner), combine_quantile_grids(gw, cfg.combiner)


def e2e_fit(mesh=None):
    """The ``e2e`` fit: ``fit_meta_kriging`` on the CPU (over ``mesh``
    when given), chunked, quarantine on."""
    from smk_torch.api import fit_meta_kriging

    seed, chunk = seed_and_chunk(SEED, 10)
    return fit_meta_kriging(*problem(), config=config(fault_policy="quarantine"), seed=seed,
                            device="cpu", mesh=mesh, chunk_iters=chunk)


def samples_digest(res, upto=None) -> str:
    """The digest of a SubsetResult's kept draws (param and latent), of
    the first ``upto`` of them when given."""
    cut = (lambda t: t) if upto is None else (lambda t: t[:, :upto])
    return digest(cut(res.param_samples), cut(res.w_samples))


def rows_digests(res, world: int) -> list:
    """The digest of each of ``world`` processes' contiguous rows of a
    SubsetResult's kept draws."""
    per = res.param_samples.shape[0] // world
    return [digest(res.param_samples[lo:lo + per], res.w_samples[lo:lo + per])
            for lo in range(0, per * world, per)]


def ckpt_config(run_log_dir=None):
    """The ``ckpt`` mode's config (the job file's, or the tiny problem's)
    with its environment knobs."""
    return config(fault_policy=os.environ.get("SMK_DCN_CKPT_POLICY", "abort"),
                  ckpt_commit_timeout_s=float(os.environ.get("SMK_DCN_CKPT_TIMEOUT", "60")),
                  run_log_dir=run_log_dir)


def ckpt_fit(mesh=None, **kw):
    """The ``ckpt`` mode's fit (over ``mesh`` when given), on the CPU or
    the card, in chunks of ``SMK_DCN_CKPT_CHUNK`` sweeps (default: the
    job file's, else 5); ``run_log_dir`` among ``kw`` goes to the
    config."""
    from smk_torch.api import fit_meta_kriging

    cfg = ckpt_config(kw.pop("run_log_dir", None))
    seed, chunk = seed_and_chunk(SEED, 5)
    chunk = os.environ.get("SMK_DCN_CKPT_CHUNK", chunk)
    return fit_meta_kriging(*problem(), config=cfg, seed=seed, device=device(), mesh=mesh,
                            chunk_iters=int(chunk), **kw)


def _manifest_field(path, name):
    from smk_torch.parallel import checkpoint as dck
    from smk_torch.utils.checkpoint import load_pytree

    if not (os.path.exists(path) and dck.is_distributed_manifest(path)):
        return None
    return int(np.asarray(load_pytree(path, dck._manifest_like())[name])[0])


def cfg_samples() -> int:
    """The sweeps of the ``ckpt`` mode's fit."""
    return ckpt_config().n_samples


def _span_seconds(path, name) -> list:
    """The seconds of each span ``name`` of a run log."""
    from smk_torch.obs.reporter import read_jsonl

    return [r["t1"] - r["t0"] for r in read_jsonl(path)
            if r.get("kind") == "span" and r.get("name") == name]


def _ckpt_mode(mesh, out) -> bool:
    """The ``ckpt`` mode (module docstring); fills ``out`` and returns
    whether the process must leave without the group's goodbye (a
    killed process, or a peer of one)."""
    import contextlib
    import glob
    import tempfile
    import warnings

    from smk_torch.parallel.checkpoint import CkptCommitError, ShardLayout, fetch_global
    from smk_torch.parallel.recovery import ProgressAbort
    from smk_torch.testing.faults import SimulatedKill, kill_process_at_generation
    from smk_torch.utils.tracing import ChunkPipelineStats, monotonic

    class Stop(ProgressAbort):
        pass

    path = os.environ["SMK_DCN_CKPT_PATH"]
    stop = os.environ.get("SMK_DCN_CKPT_STOP")
    kill_gen = os.environ.get("SMK_DCN_CKPT_KILL_GEN")
    filled_at_start = _manifest_field(path, "filled")
    out.update(resume_from_generation=_manifest_field(path, "generation"),
               filled_at_start=filled_at_start)
    progress = None
    if stop:
        seen = []

        def progress(info):
            seen.append(info)
            if len(seen) > int(stop):
                raise Stop()

    kill = (kill_process_at_generation(int(kill_gen)) if kill_gen and out["process_id"] == 0
            else contextlib.nullcontext())
    on_card, timed = device() == "cuda", job() is not None
    pstats = ChunkPipelineStats()
    log_dir = tempfile.mkdtemp(prefix="smk_dcn_log_") if timed else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = monotonic()
    try:
        with warnings.catch_warnings(record=True) as caught, kill:
            warnings.simplefilter("always")
            try:
                res = ckpt_fit(mesh, checkpoint_path=path, progress=progress,
                               pipeline_stats=pstats, run_log_dir=log_dir)
            finally:
                out["warnings"] = sorted({
                    "elastic" if "elastic resume" in str(w.message)
                    else "orphan" if "orphan shard" in str(w.message) else "other"
                    for w in caught})
        sr = res.subset_results
        layout = ShardLayout.current(n_subsets(), mesh)
        out.update(outcome="completed", local_sha=samples_digest(sr),
                   global_sha=digest(*(torch.as_tensor(fetch_global(t, layout, timeout_s=60.0))
                                       for t in (sr.param_samples, sr.w_samples))))
        out.update({f: digest(getattr(res, f)) for f in E2E_FIELDS})
        if filled_at_start:
            out["committed_rows_sha"] = samples_digest(sr, upto=filled_at_start)
        if timed:
            (log,) = glob.glob(os.path.join(log_dir, "*.jsonl"))
            out.update(ms_per_sweep=res.phase_seconds["subset_fits"] / cfg_samples() * 1e3,
                       phase_seconds=res.phase_seconds, gather_s=_span_seconds(log, "gather"))
        if on_card:
            out["peak_bytes"] = torch.cuda.max_memory_allocated()
    except Stop:
        out["outcome"] = "stopped"
    except SimulatedKill as e:
        out.update(outcome="killed", error=str(e)[:120])
    except CkptCommitError as e:
        out.update(outcome="commit_abort", error=str(e)[:200])
    out.update(elapsed_s=monotonic() - t0, generations=pstats.ckpt_generations,
               ckpt_commit_s=round(pstats.ckpt_commit_s, 4),
               final_generation=_manifest_field(path, "generation"))
    if log_dir is not None:
        shutil.rmtree(log_dir, ignore_errors=True)
    if timed:
        # each generation's commit and landing, and this process's shard bytes
        out["boundaries"] = [{key: ch.get(key) for key in
                              ("iteration", "ckpt_commit_s", "ckpt_write_s", "ckpt_bytes")}
                             for ch in pstats.chunks if "ckpt_commit_s" in ch]
    return out["outcome"] in ("killed", "commit_abort")


E2E_FIELDS = ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "p_quant")


def reference(world: int = 2) -> dict:
    """The one-process fits of the same seeds, digested as ``world``
    workers digest theirs (the ckpt mode's result whole: a test digests
    the rows and the prefix it needs); the adaptive ones on a
    ``world``-entry CPU mesh."""
    res, comb, comb_w = sharded_fit()
    e2e = e2e_fit()
    return {"combined": digest(comb), "combined_w": digest(comb_w),
            "rows": rows_digests(res, world),
            "e2e": {f: digest(getattr(e2e, f)) for f in E2E_FIELDS},
            # the ckpt mode's fit without a checkpoint: its SubsetResult
            "ckpt": ckpt_fit().subset_results,
            "adaptive": adaptive_reference(world=world),
            "adaptive_nan": adaptive_reference(ADAPT_NAN, world=world)}


def adaptive_reference(nan=None, world: int = 2) -> dict:
    """The ``adaptive`` mode's fit in one process on a ``world``-entry CPU
    mesh (``nan``: as ``SMK_DCN_ADAPT_NAN``), summarized as the workers
    summarize theirs, with each process's rows digested."""
    import tempfile

    from smk_torch.parallel.executor import make_mesh

    with tempfile.TemporaryDirectory() as log_dir:
        res, stats, replans = adaptive_fit(make_mesh(world, device="cpu"), log_dir, nan)
    sr = res.subset_results
    return {**adaptive_summary(res, stats, replans), "rows": rows_digests(sr, world)}


def main(argv) -> int:
    from smk_torch.parallel.distributed import destroy_distributed, init_distributed
    from smk_torch.parallel.executor import make_mesh, process_row_range

    if len(argv) > 3:  # the explicit form: rank, world, port on the CPU
        rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
        mode = argv[4] if len(argv) > 4 else "normal"
        topo = init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                                device="cpu", timeout_s=60.0)
    else:  # torchrun's environment: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT
        mode = argv[1] if len(argv) > 1 else "normal"
        topo = init_distributed(device=device(), timeout_s=120.0)
    rank = topo.process_id
    if mode == "die_mid":
        print("DCN_DYING " + json.dumps({"process_id": rank}), flush=True)
        os._exit(0)  # no goodbye to the group: the peer finds a dead process
    mesh = make_mesh(device=device())
    k = n_subsets()
    out = {"process_id": topo.process_id, "num_processes": topo.num_processes,
           "global_devices": topo.global_device_count, "mesh_size": mesh.size}
    if device() == "cuda":
        out.update(card=torch.cuda.current_device(), local_rank=os.environ.get("LOCAL_RANK"),
                   mesh=repr(mesh))
    if mode == "guard":
        from smk_torch.parallel.domains import ChunkTimeoutError, ChunkWatchdog, FailureDomainMap

        deadline = float(os.environ.get("SMK_DCN_DEADLINE_S", "20"))
        wd = ChunkWatchdog(FailureDomainMap.from_mesh(k, mesh), min_deadline_s=deadline)
        try:
            wd.run(lambda: sharded_fit(mesh), chunk=0, iteration=0, deadline_s=deadline)
        except ChunkTimeoutError as e:
            out.update(chunk=e.chunk, deadline_s=e.deadline_s, domains=e.domains,
                       domain_labels=e.domain_labels)
            print("DCN_TIMEOUT " + json.dumps(out), flush=True)
            # the watchdog's worker still waits on the dead peer: leave
            # without joining it
            os._exit(0)
        print("DCN_NO_TIMEOUT " + json.dumps(out), flush=True)
        os._exit(1)
    if mode == "ckpt":
        gone = _ckpt_mode(mesh, out)
        print("DCN_CKPT " + json.dumps(out), flush=True)
        if gone:
            # a killed process, or the peer of one: the group's goodbye
            # would wait on the dead
            os._exit(0)
    elif mode == "adaptive":
        import tempfile

        with tempfile.TemporaryDirectory() as log_dir:
            res, stats, replans = adaptive_fit(mesh, log_dir, adaptive_nan())
        sr = res.subset_results
        out.update(adaptive_summary(res, stats, replans),
                   rows=digest(sr.param_samples, sr.w_samples))
        print("DCN_ADAPTIVE " + json.dumps(out), flush=True)
    elif mode == "e2e":
        from smk_torch.compile.programs import topology_fingerprint

        res = e2e_fit(mesh)
        out.update({f: digest(getattr(res, f)) for f in E2E_FIELDS},
                   topology_fingerprint=list(topology_fingerprint(mesh)),
                   subsets_dropped=list(res.subsets_dropped))
        print("DCN_E2E " + json.dumps(out), flush=True)
    elif mode == "normal":
        res, comb, comb_w = sharded_fit(mesh)
        lo, hi = process_row_range(k, mesh)
        out.update(rows=[lo, hi], combined=digest(comb), combined_w=digest(comb_w),
                   local=digest(res.param_samples, res.w_samples),
                   param_grid_shape=list(res.param_grid.shape))
        print("DCN_RESULT " + json.dumps(out), flush=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
