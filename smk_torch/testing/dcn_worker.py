"""One process of a multi-process job on the CPU (gloo): the port's
counterpart of the twin's ``scripts/_dcn_worker.py``.

Every process builds the same small problem from fixed seeds (K = 4
subsets of m = 24 rows, data/synthetic.tiny_binary_problem), joins the
process group
(parallel/distributed.init_distributed), lays the subsets over the job's
mesh (one virtual CPU entry a process), fits the rows it owns, and
gathers the grids over the group for the combine. It prints one line of
JSON, prefixed by its mode's tag, for the caller to compare with a
one-process fit of the same seeds (:func:`reference`).

Usage::

    python -m smk_torch.testing.dcn_worker <rank> <world> <port> [mode]

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
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

K, M, Q, P, T = 4, 24, 1, 2, 6
SEED = 3


def problem():
    """The job's data, the same on every process: (y, x, coords,
    coords_test, x_test) as float32 numpy arrays, n = K * M."""
    from smk_torch.data.synthetic import tiny_binary_problem

    return tiny_binary_problem(seed=11, n=K * M, q=Q, p=P, t=T)


def config(**kw):
    from smk_torch.config import SMKConfig

    return SMKConfig(n_subsets=K, n_samples=40, u_solver="cg", cg_iters=16,
                     phi_update_every=2, n_quantiles=20, **kw)


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

    y, x, coords, ct, xt = (torch.as_tensor(a) for a in problem())
    cfg = config()
    perm = torch.randperm(K * M, generator=torch.Generator().manual_seed(SEED))
    part = random_partition(perm, y, x, coords, K)
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

    return fit_meta_kriging(*problem(), config=config(fault_policy="quarantine"), seed=SEED,
                            device="cpu", mesh=mesh, chunk_iters=10)


def samples_digest(res, upto=None) -> str:
    """The digest of a SubsetResult's kept draws (param and latent), of
    the first ``upto`` of them when given."""
    cut = (lambda t: t) if upto is None else (lambda t: t[:, :upto])
    return digest(cut(res.param_samples), cut(res.w_samples))


def ckpt_config():
    """The ``ckpt`` mode's config, from its environment knobs."""
    return config(fault_policy=os.environ.get("SMK_DCN_CKPT_POLICY", "abort"),
                  ckpt_commit_timeout_s=float(os.environ.get("SMK_DCN_CKPT_TIMEOUT", "60")))


def ckpt_fit(mesh=None, **kw):
    """The ``ckpt`` mode's fit: ``fit_meta_kriging`` on the CPU (over
    ``mesh`` when given) in chunks of ``SMK_DCN_CKPT_CHUNK`` sweeps."""
    from smk_torch.api import fit_meta_kriging

    return fit_meta_kriging(*problem(), config=ckpt_config(), seed=SEED, device="cpu",
                            mesh=mesh, chunk_iters=int(os.environ.get("SMK_DCN_CKPT_CHUNK", "5")),
                            **kw)


def _manifest_field(path, name):
    from smk_torch.parallel import checkpoint as dck
    from smk_torch.utils.checkpoint import load_pytree

    if not (os.path.exists(path) and dck.is_distributed_manifest(path)):
        return None
    return int(np.asarray(load_pytree(path, dck._manifest_like())[name])[0])


def _ckpt_mode(mesh, out) -> bool:
    """The ``ckpt`` mode (module docstring); fills ``out`` and returns
    whether the process must leave without the group's goodbye (a
    killed process, or a peer of one)."""
    import contextlib
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
    pstats = ChunkPipelineStats()
    t0 = monotonic()
    try:
        with warnings.catch_warnings(record=True) as caught, kill:
            warnings.simplefilter("always")
            try:
                res = ckpt_fit(mesh, checkpoint_path=path, progress=progress,
                               pipeline_stats=pstats)
            finally:
                out["warnings"] = sorted({
                    "elastic" if "elastic resume" in str(w.message)
                    else "orphan" if "orphan shard" in str(w.message) else "other"
                    for w in caught})
        sr = res.subset_results
        layout = ShardLayout.current(K, mesh)
        out.update(outcome="completed", local_sha=samples_digest(sr),
                   global_sha=digest(*(torch.as_tensor(fetch_global(t, layout, timeout_s=60.0))
                                       for t in (sr.param_samples, sr.w_samples))))
        if filled_at_start:
            out["committed_rows_sha"] = samples_digest(sr, upto=filled_at_start)
    except Stop:
        out["outcome"] = "stopped"
    except SimulatedKill as e:
        out.update(outcome="killed", error=str(e)[:120])
    except CkptCommitError as e:
        out.update(outcome="commit_abort", error=str(e)[:200])
    out.update(elapsed_s=monotonic() - t0, generations=pstats.ckpt_generations,
               ckpt_commit_s=round(pstats.ckpt_commit_s, 4),
               final_generation=_manifest_field(path, "generation"))
    return out["outcome"] in ("killed", "commit_abort")


E2E_FIELDS = ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "p_quant")


def reference() -> dict:
    """The one-process fits of the same seeds, digested as the workers
    digest theirs (the ckpt mode's result whole: a test digests the rows
    and the prefix it needs)."""
    res, comb, comb_w = sharded_fit()
    e2e = e2e_fit()
    return {"combined": digest(comb), "combined_w": digest(comb_w),
            "rows": [digest(res.param_samples[lo:lo + K // 2], res.w_samples[lo:lo + K // 2])
                     for lo in range(0, K, K // 2)],
            "e2e": {f: digest(getattr(e2e, f)) for f in E2E_FIELDS},
            # the ckpt mode's fit without a checkpoint: its SubsetResult
            "ckpt": ckpt_fit().subset_results}


def main(argv) -> int:
    rank, world, port = int(argv[1]), int(argv[2]), int(argv[3])
    mode = argv[4] if len(argv) > 4 else "normal"
    from smk_torch.parallel.distributed import destroy_distributed, init_distributed
    from smk_torch.parallel.executor import make_mesh, process_row_range

    topo = init_distributed(f"127.0.0.1:{port}", num_processes=world, process_id=rank,
                            device="cpu", timeout_s=60.0)
    if mode == "die_mid":
        print("DCN_DYING " + json.dumps({"process_id": rank}), flush=True)
        os._exit(0)  # no goodbye to the group: the peer finds a dead process
    mesh = make_mesh(device="cpu")
    out = {"process_id": topo.process_id, "num_processes": topo.num_processes,
           "global_devices": topo.global_device_count, "mesh_size": mesh.size}
    if mode == "guard":
        from smk_torch.parallel.domains import ChunkTimeoutError, ChunkWatchdog, FailureDomainMap

        deadline = float(os.environ.get("SMK_DCN_DEADLINE_S", "20"))
        wd = ChunkWatchdog(FailureDomainMap.from_mesh(K, mesh), min_deadline_s=deadline)
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
    elif mode == "e2e":
        from smk_torch.compile.programs import topology_fingerprint

        res = e2e_fit(mesh)
        out.update({f: digest(getattr(res, f)) for f in E2E_FIELDS},
                   topology_fingerprint=list(topology_fingerprint(mesh)),
                   subsets_dropped=list(res.subsets_dropped))
        print("DCN_E2E " + json.dumps(out), flush=True)
    elif mode == "normal":
        res, comb, comb_w = sharded_fit(mesh)
        lo, hi = process_row_range(K, mesh)
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
