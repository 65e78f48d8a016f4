"""``precompile``: pay the program acquisition at build time, not at the
first chunk (twin of ``smk_tpu/compile/warmup.py``).

A deployment calls :func:`precompile` once per shape bucket with the
model and the run's shapes: every chunk program the chunked executor
will dispatch (full chunks and ragged tails, at each phase of
``phi_update_every`` the plan reaches; the K-ladder rungs of an adaptive
run) is acquired and, on the card, warmed up and captured as a CUDA
graph, with its kernel libraries from the store, the build directory or
nvcc (compile/programs.py). The guard, finalize and refork programs are
acquired too. A following chunked fit of the same model then finds every
program in L1.

Unlike the twin's, the warm-up runs real work: the port precompiles on
the data it is given (a seeded noise source of its own, so the fit's
streams are untouched), not on abstract shapes. Under a mesh (``mesh``,
or ``mesh_spec`` resolved by :func:`mesh_from_spec` against the live
devices) it captures each entry device's programs under the mesh's
topology fingerprint, and a ragged partition's programs per entry of its
RaggedMeshPlan. There is no abstract-topology compile in the port
(``allow_topology`` raises): a CUDA graph is captured on the card it
replays on.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from smk_torch.compile.programs import aux_bucket_key, store_from_config, topology_fingerprint
from smk_torch.compile.store import ProgramStore
from smk_torch.utils.tracing import monotonic


class MeshSpecError(RuntimeError):
    """A ``mesh_spec`` could not be resolved to a mesh on this host:
    carries the mismatch (wrong device kind, too few devices)."""


def mesh_from_spec(mesh_shape, device_kind: Optional[str] = None, *, axis: str = "subsets",
                   allow_topology: bool = False, device=None):
    """Resolve a ``(mesh_shape, device_kind)`` spec to a live mesh
    (parallel/executor.make_mesh): the visible cards (every rank's once a
    process group is up) when there are enough of them and their name
    (``torch.cuda.get_device_name``) is ``device_kind`` (or it is None);
    with ``device="cpu"``, virtual CPU entries of kind ``"cpu"``. Only
    1-D shapes. ``allow_topology=True`` raises: the twin's fallback to an
    abstract TPU topology (``jax.experimental.topologies``) has no
    counterpart, since a CUDA graph is captured on the card that replays
    it."""
    from smk_torch.parallel.distributed import process_count
    from smk_torch.parallel.executor import make_mesh

    if allow_topology:
        raise MeshSpecError(
            "allow_topology=True asks for an abstract-topology compile, which smk_torch "
            "does not have (jax.experimental.topologies is a TPU feature; a CUDA graph "
            "is captured on the card it replays on) — precompile on a host of the target "
            "topology, or pass a live mesh")
    if len(mesh_shape) != 1:
        raise MeshSpecError(
            f"mesh_spec shape {tuple(mesh_shape)!r} is not 1-D — the K-subset fan-out "
            "shards exactly one axis (see executor.make_mesh)")
    n = int(mesh_shape[0])
    if device is not None and torch.device(device).type == "cpu":
        n_live, kind = None, "cpu"
    elif torch.cuda.is_available():
        n_live = (torch.cuda.device_count() if process_count() <= 1
                  else process_count())
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
    else:
        raise MeshSpecError(
            f"mesh_spec ({tuple(mesh_shape)!r}, {device_kind!r}): no CUDA device is "
            "visible to resolve it against; pass device='cpu' for virtual CPU entries")
    if (n_live is None or n_live >= n) and (device_kind is None or str(device_kind) == kind):
        return make_mesh(n, axis=axis, device=device)
    raise MeshSpecError(
        f"mesh_spec ({tuple(mesh_shape)!r}, {device_kind!r}) does not match the live "
        f"devices ({n_live if n_live is not None else 'any number of'} x {kind!r}) — "
        "precompile on a host of the target topology, or pass a live mesh")


class _Recorder:
    """A ``record_program`` sink when the caller passes none."""

    def __init__(self):
        self.programs: List[Dict[str, Any]] = []

    def record_program(self, *, key, source, compile_s, aot):
        self.programs.append({"key": [str(f) for f in key], "source": source,
                              "compile_s": round(float(compile_s), 4), "aot": bool(aot)})


def part_device(part):
    """The device a Partition or PaddedPartition lives on."""
    return (part.groups[0].part if hasattr(part, "groups") else part).x.device


def chunk_plan_lengths(n_burn: int, n_samples: int, chunk_iters: int) -> List[tuple]:
    """The distinct ``(kind, length)`` chunks of the executor's plan for
    this budget: full chunks and ragged tails (the twin's)."""
    out, seen = [], set()
    it = 0
    while it < n_burn:
        n = min(chunk_iters, n_burn - it)
        if ("burn", n) not in seen:
            seen.add(("burn", n))
            out.append(("burn", n))
        it += n
    while it < n_samples:
        n = min(chunk_iters, n_samples - it)
        if ("samp", n) not in seen:
            seen.add(("samp", n))
            out.append(("samp", n))
        it += n
    return out


def chunk_plan_buckets(n_burn: int, n_samples: int, chunk_iters: int,
                       phi_update_every: int) -> List[tuple]:
    """The distinct ``(kind, length, phase, first start)`` chunk programs
    of the plan: :func:`chunk_plan_lengths` with each chunk's first sweep
    modulo ``phi_update_every`` (a key field of the port's chunk
    programs), and the first start at which each occurs."""
    out, seen = [], set()
    it = 0
    for kind, hi in (("burn", n_burn), ("samp", n_samples)):
        while it < hi:
            n = min(chunk_iters, hi - it)
            b = (kind, n, it % phi_update_every)
            if b not in seen:
                seen.add(b)
                out.append(b + (it,))
            it += n
    return out


def precompile(model, part, coords_test, x_test, *, chunk_iters: int = 500,
               chunk_size: Optional[int] = None, store_dir: Optional[str] = None, stats=None,
               mesh=None, mesh_spec=None, allow_topology: bool = False) -> Dict[str, Any]:
    """Acquire (and on the card capture) every hot program a chunked fit
    of these shapes dispatches. ``part`` is a Partition or a
    PaddedPartition (one program set per occupied bucket group, the
    reports merged), on the device the fit will run on. ``store_dir``
    overrides ``model.config.compile_store_dir``. Returns a report: per
    program its source and seconds (``stats`` receives the records when
    given). ``mesh`` (a parallel/executor.Mesh) or ``mesh_spec`` (a
    ``(mesh_shape, device_kind)`` pair for :func:`mesh_from_spec`, with
    ``allow_topology`` passed through) captures the programs a
    ``fit_subsets_chunked(mesh=...)`` run dispatches, keyed under the
    mesh's fingerprint, on each of its entries' devices."""
    from smk_torch.parallel import recovery as rec_mod
    from smk_torch.parallel.executor import stacked_subset_data
    from smk_torch.parallel.partition import PaddedPartition
    from smk_torch.parallel.schedule import AdaptiveScheduler
    from smk_torch.models.probit_gp import SweepNoise, chunk_noise, n_params

    if mesh is None and mesh_spec is not None:
        shape_spec, kind_spec = mesh_spec
        mesh = mesh_from_spec(tuple(shape_spec), kind_spec, axis=model.config.mesh_axis,
                              allow_topology=allow_topology, device=part_device(part))
    if isinstance(part, PaddedPartition):
        t0 = monotonic()
        plan = None
        if mesh is None:
            sub = [precompile(model, g.part, coords_test, x_test, chunk_iters=chunk_iters,
                              chunk_size=chunk_size, store_dir=store_dir, stats=stats)
                   for g in part.groups]
        else:
            from smk_torch.compile.buckets import plan_ragged_mesh
            from smk_torch.parallel.executor import fits_layout, sub_mesh
            from smk_torch.parallel.partition import ragged_mesh_entry_partition

            plan = plan_ragged_mesh([g.bucket for g in part.groups],
                                    [len(g.subset_ids) for g in part.groups], mesh.size)
            sub = []
            for e in plan.entries:
                # the driver's per-entry chunk_size rule
                ecs = chunk_size
                if chunk_size is not None and (e.padded_k % chunk_size
                                               or not fits_layout(chunk_size, e.n_devices)):
                    ecs = None
                sub.append(precompile(model, ragged_mesh_entry_partition(part, e)[0],
                                      coords_test, x_test, chunk_iters=chunk_iters,
                                      chunk_size=ecs, store_dir=store_dir, stats=stats,
                                      mesh=sub_mesh(mesh, e.n_devices)))
        report = {
            "store_dir": sub[0]["store_dir"],
            "n_programs": sum(r["n_programs"] for r in sub),
            "programs": [p for r in sub for p in r["programs"]],
            "compile_s": round(monotonic() - t0, 4),
            "topology": sub[0]["topology"],
            "buckets": [{"bucket": int(g.bucket), "n_subsets": len(g.subset_ids)}
                        for g in part.groups],
        }
        if plan is not None:
            report["ragged_mesh_plan"] = plan.summary()
        return report

    cfg = model.config
    t0 = monotonic()
    rec = stats if stats is not None else _Recorder()
    n_before = len(rec.programs)
    store = ProgramStore(store_dir) if store_dir else store_from_config(cfg)
    k = part.n_subsets
    c = cfg.n_chains
    m, q, p = part.x.shape[1:]
    t = coords_test.shape[0]
    d_par, d_w = n_params(q, p), t * q
    if mesh is not None:
        from smk_torch.parallel.partition import Partition

        from smk_torch.parallel.executor import process_row_range

        home = mesh.home
        lo, hi = process_row_range(part.n_subsets, mesh)  # this process's rows
        part = Partition(*(t[lo:hi].to(home) for t in part))
        coords_test, x_test = coords_test.to(home), x_test.to(home)
    dev = part.x.device
    data = stacked_subset_data(part, coords_test, x_test)
    e = cfg.phi_update_every

    def warm(kk, rows_data, buckets, csize):
        """Acquire and capture the chunk programs ``buckets`` at K = kk,
        then the guard and refork programs of that K."""
        cdata = model.chain_data(rows_data)
        noise = model.default_noise(rows_data, seed=0)  # the precompile's own streams
        ctx = rec_mod._ProgramCtx(store, rec, kk, csize, mesh)
        pieces = rec_mod._pieces(model, cdata, noise, rows_data.x.shape[0], c, csize, ctx)
        firsts: dict = {}  # one capture a device: the pieces of a device share a bucket
        for pc in pieces:
            firsts.setdefault(str(pc.data.x.device), pc)
        for pc in firsts.values():
            pdev = pc.data.x.device
            state = model.init_state(pc.data, consts=pc.consts)
            rows = pc.data.x.shape[0]
            for kind, n, phase, start in buckets:
                collect = kind != "burn"
                prog = rec_mod._chunk_program(model, collect, n, phase, pc)
                guard = (torch.zeros(rows, dtype=torch.int32, device=pdev)
                         if model.chunk_touches_guard(phase, n) else None)
                nz = chunk_noise(pc.noise, start, n, collect)
                if pc.sliced:
                    nz = SweepNoise(*(None if f is None else f[:, pc.lo:pc.hi].to(pdev)
                                      for f in nz))
                prog.capture(pc.data, pc.consts, state, nz,
                             model.chunk_gains(start, n, collect, pc.data.x.dtype, pdev), guard)
        for key, fn in ((rec_mod._stats_key(model, kk, m, q, p, mesh), rec_mod._chunk_stats),
                        (rec_mod._refork_key(model, kk, m, q, p, mesh), rec_mod._refork)):
            rec_mod._cached_program(model, key, lambda fn=fn: fn, store=store, stats=rec,
                                    device=dev)

    plan = chunk_plan_buckets(cfg.n_burn_in, cfg.n_samples, chunk_iters, e)
    warm(k, data, plan, chunk_size)
    rec_mod._cached_program(model, rec_mod._finalize_key(model, k, m, q, cfg.n_kept, d_par, d_w,
                                                         mesh),
                            lambda: model.finalize, store=store, stats=rec, device=dev)
    adaptive = cfg.adaptive_schedule == "on"
    if cfg.live_diagnostics:
        # the streaming monitor's fold-in per sampling length, and its
        # statistics
        from smk_torch.obs.streaming import (make_stream_stats, make_stream_update,
                                             make_stream_update_masked)

        lengths = {b[1] for b in plan if b[0] == "samp"}
        if adaptive:
            lengths.add(min(chunk_iters, cfg.n_kept))  # the extra chunks' length
        make = make_stream_update_masked if adaptive else make_stream_update
        for n in sorted(lengths):
            fn = make(cfg.n_kept // 2, c)
            rec_mod._cached_program(
                model, aux_bucket_key(model, "streamm" if adaptive else "stream", n, k, d_par,
                                      mesh=mesh),
                lambda fn=fn: fn, store=store, stats=rec, device=dev)
        fn = make_stream_stats(c)
        rec_mod._cached_program(model, aux_bucket_key(model, "stream_stats", k, d_par, mesh=mesh),
                                lambda: fn, store=store, stats=rec, device=dev)

    if adaptive:
        # the K-ladder rungs an adaptive run compacts onto: their sampling
        # chunks (the plan's, and the extra chunks' length at every phase
        # a grant can start at), guard and refork, and the masked finalize
        sched = AdaptiveScheduler(cfg, k=k, n_kept=cfg.n_kept, chunk_iters=chunk_iters)
        samp = [b for b in plan if b[0] == "samp"]
        seen = {b[:3] for b in samp}
        for j in range(e):
            start = cfg.n_samples + j * sched.l_extra
            b = ("samp", sched.l_extra, start % e)
            if b not in seen:
                seen.add(b)
                samp.append(b + (start,))
        in_plan = {b[:3] for b in plan}
        for kk in sorted({sched.rung(na) for na in range(1, k + 1)}):
            sel = torch.arange(kk, device=dev)
            rows = data._replace(coords=data.coords[sel], x=data.x[sel], y=data.y[sel],
                                 mask=data.mask[sel])
            warm(kk, rows, samp if kk != k else [b for b in samp if b[:3] not in in_plan], None)
        rec_mod._cached_program(
            model, aux_bucket_key(model, "finadapt", k, m, q, sched.n_cap, d_par, d_w, mesh=mesh),
            lambda: model.finalize_masked, store=store, stats=rec, device=dev)

    programs = rec.programs[n_before:]
    return {
        "store_dir": store.root if store is not None else None,
        "n_programs": len(programs),
        "programs": programs,
        "compile_s": round(monotonic() - t0, 4),
        "topology": topology_fingerprint(mesh),
    }
