"""The K-subset fan-out — twin of ``smk_tpu/parallel/executor.py``. JAX
vmaps the one-subset sampler over K (and over the chains); here the
sampler is already batched over a leading axis of K * n_chains rows,
subset-major, so the fan-out is one run over the stacked subsets, or one
run per chunk of subsets, each row drawing its randomness from its own
generator.

The mesh: a :class:`Mesh` is a 1-D list of entries, each a device of
some process of the job (``make_mesh``: the local cards, plus every
rank's once a process group is up; on the CPU, virtual entries that
share the one CPU device, the analog of the twin's forced host device
count). The K axis is laid out contiguously over the entries (the
layout oracle: ``require_divisible_layout``, ``subset_device_assignment``,
``process_row_range``), and :func:`fit_subsets_sharded` runs each
entry's block of subsets on its device: distinct devices concurrently,
one host thread each; blocks that share a device one after another; a
process only the rows it owns. The fits exchange nothing, so the draws
are the unmeshed run's.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from smk_torch.models.probit_gp import (
    NoiseSource,
    SpatialGPSampler,
    SubsetData,
    SubsetResult,
    subset_generators,
)
from smk_torch.parallel.partition import Partition
from smk_torch.device import in_callers_context
from smk_torch.utils.tracing import span, under_current_span


def stacked_subset_data(
    part: Partition, coords_test: torch.Tensor, x_test: torch.Tensor
) -> SubsetData:
    return SubsetData(
        coords=part.coords, x=part.x, y=part.y, mask=part.mask,
        coords_test=coords_test, x_test=x_test,
    )


def subset_chain_keys(seed: int, k: int, n_chains: int, device) -> List[torch.Generator]:
    """Per-(subset, chain) generators, K * n_chains of them, subset-major
    (row k * n_chains + c): the twin's ``split(key, k * n_chains)``
    reshaped to (k, n_chains), flattened. One per subset at one chain."""
    return subset_generators(seed, k * n_chains, device)


def init_subset_states(model: SpatialGPSampler, data: SubsetData, beta_init, consts=None):
    """Initial states of all K * n_chains rows (one batched call on the
    chain data: a subset's chains share its data and start alike).
    ``consts``: the sampler's geometry of that chain data, if built."""
    return model.init_state(model.chain_data(data), beta_init, consts=consts)


def _run(model: SpatialGPSampler, data: SubsetData, beta_init, noise) -> SubsetResult:
    """Init and run of the stacked subsets ``data`` over one build of the
    sampler's geometry, which init and both scans share."""
    with span("smk.init", rows=data.x.shape[0] * model.config.n_chains):
        consts = model._consts(model.chain_data(data))
        state = init_subset_states(model, data, beta_init, consts)
    return model.run(data, state, noise, consts=consts)


def _chunk_noise(noise, lo: int, hi: int):
    subset = getattr(noise, "subset", None)
    if subset is None:
        raise ValueError(
            "chunk_size needs a noise source with subset(lo, hi) (as "
            "GeneratorNoise has), so that each chunk draws its own rows"
        )
    return subset(lo, hi)


def fit_subsets_vmap(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    chunk_size: Optional[int] = None,
) -> SubsetResult:
    """Run all K subset samplers (each with its n_chains chains) as one
    batched run. ``noise`` defaults to one generator per (subset, chain)
    row (SpatialGPSampler.run). ``chunk_size`` runs the subsets in
    chunks of that many, one after the other, to bound how many are
    resident at once (a multiple-try or multi-chain fit); each chunk
    draws its rows' own noise, so the result is the unchunked run's.
    ``run`` takes both one chain and several (the twin's ``subset_runner``
    picks ``run`` or ``run_chains``)."""
    data = stacked_subset_data(part, coords_test, x_test)
    k = part.n_subsets
    if chunk_size is None or chunk_size >= k:
        return _run(model, data, beta_init, noise)
    if k % chunk_size != 0:
        raise ValueError(f"chunk_size {chunk_size} must divide K={k}")
    c = model.config.n_chains
    if noise is None:
        noise = model.default_noise(data)
    results, guards = [], []
    for lo in range(0, k, chunk_size):
        hi = lo + chunk_size
        d = data._replace(coords=data.coords[lo:hi], x=data.x[lo:hi],
                          y=data.y[lo:hi], mask=data.mask[lo:hi])
        model.guard_rejects = None
        results.append(_run(model, d, beta_init, _chunk_noise(noise, lo * c, hi * c)))
        guards.append(model.guard_rejects)
    model.guard_rejects = None if guards[0] is None else torch.cat(guards)
    return SubsetResult(*(torch.cat(f) for f in zip(*results)))


def count_subset_factorizations(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    n_iters: int,
    start_it: int = 0,
    collect: bool = False,
    with_calls: bool = False,
):
    """The instrumented fan-out (twin of ``count_subset_factorizations``):
    every subset advances ``n_iters`` sweeps from its initial state, and
    the result is ``(phi_accepts, n_chol)``: the (K, q) phi-acceptance
    counts and the (K,) m x m factorizations performed, read from the
    sampler's FactorCache counters (``with_calls``: ``(phi_accepts,
    (n_chol, n_chol_calls))``, the second the batched Cholesky calls).
    ``noise`` defaults to a generator a subset seeded from 0. One chain
    only, as in the twin: chains multiply the counts."""
    if model.config.n_chains != 1:
        raise ValueError(
            "count_subset_factorizations measures single-chain programs; chains scale "
            "counts linearly")
    data = stacked_subset_data(part, coords_test, x_test)
    if noise is None:
        noise = model.default_noise(data)
    consts = model._consts(data)
    state = init_subset_states(model, data, beta_init, consts)
    state, counts = model.count_chunk(data, consts, state, noise, start_it, n_iters,
                                      collect=collect, with_calls=with_calls)
    k, dev = part.n_subsets, part.x.device

    def per_subset(n):
        return torch.full((k,), int(n), dtype=torch.int64, device=dev)

    if with_calls:
        return state.phi_accept, (per_subset(counts[0]), per_subset(counts[1]))
    return state.phi_accept, per_subset(counts)


# ----------------------------------------------------------------------
# the mesh and its layout oracle
# ----------------------------------------------------------------------
class MeshEntry(NamedTuple):
    """One entry of a :class:`Mesh`: ``id`` its place in the mesh,
    ``device`` the torch device it runs on (on its own process),
    ``process_index`` that process's rank and ``device_kind`` the card's
    name ("cpu" for a virtual CPU entry)."""

    id: int
    device: torch.device
    process_index: int
    device_kind: str


class Mesh:
    """A 1-D device mesh (the port's ``jax.sharding.Mesh``): ``devices``
    holds the entries as a numpy object array, read as the twin reads a
    mesh's (``.flat``, ``.size``, ``.shape``), and ``axis_names`` the one
    axis. Build one with :func:`make_mesh` or :func:`sub_mesh`."""

    def __init__(self, entries: Sequence[MeshEntry], axis_names):
        if not entries:
            raise ValueError("a mesh needs at least one entry")
        arr = np.empty(len(entries), dtype=object)
        for i, e in enumerate(entries):
            arr[i] = e
        self.devices = arr
        self.axis_names = tuple(str(a) for a in axis_names)

    @property
    def entries(self) -> tuple:
        return tuple(self.devices.flat)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_kind(self) -> str:
        return "|".join(sorted({e.device_kind for e in self.entries}))

    @property
    def process_indices(self) -> tuple:
        return tuple(sorted({e.process_index for e in self.entries}))

    @property
    def multi_process(self) -> bool:
        return len(self.process_indices) > 1

    def local_entries(self) -> list:
        """The entries this process drives, in mesh order."""
        from smk_torch.parallel.distributed import process_index

        me = process_index()
        return [e for e in self.entries if e.process_index == me]

    def local(self) -> "Mesh":
        """The mesh of this process's entries alone, on the same axis."""
        return Mesh(self.local_entries(), self.axis_names)

    @property
    def home(self) -> torch.device:
        """The device of this process's first entry: where the executor
        keeps the run's state and gathers the subset results."""
        local = self.local_entries()
        if not local:
            raise ValueError("this process owns no entry of the mesh")
        return local[0].device

    def __repr__(self) -> str:
        devs = ", ".join(f"{e.id}:{e.device}@p{e.process_index}" for e in self.entries)
        return f"Mesh({self.axis_names[0]}=[{devs}], kind={self.device_kind!r})"


def make_mesh(n_devices: Optional[int] = None, axis: str = "subsets", *, device=None) -> Mesh:
    """1-D device mesh over the subset axis.

    On the card (the default) the entries are the local CUDA devices —
    in a multi-process job each process's current card — and, once a
    process group is up (parallel/distributed.py), every rank's, in rank
    order. With ``device="cpu"`` they are ``n_devices`` virtual entries
    sharing the CPU (one per process in a multi-process job): the analog
    of the twin's forced host device count, and the only case in which
    entries repeat a device. ``n_devices`` takes a prefix of the job's
    entries; more than exist is an error, never a silent downgrade, and
    no mesh falls back from the card to the CPU."""
    from smk_torch.parallel import distributed as D

    if n_devices is not None and n_devices < 1:
        raise ValueError(f"make_mesh needs n_devices >= 1, got {n_devices}")
    nproc, me = D.process_count(), D.process_index()
    if device is not None and torch.device(device).type == "cpu":
        n_local = 1 if n_devices is None else (n_devices if nproc == 1 else -(-n_devices // nproc))
        local = [torch.device("cpu")] * n_local
        kind = "cpu"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh builds a mesh of CUDA devices and none is visible; pass "
                "device='cpu' for virtual CPU entries")
        if nproc > 1:
            local = [torch.device("cuda", torch.cuda.current_device())]
        else:
            local = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        kind = torch.cuda.get_device_name(local[0])
    info = [kind, local[0].type, [d.index for d in local]]
    if nproc > 1 and local[0].type == "cuda":
        infos = D.rank_entries()  # gathered when the process group started
        if infos is None:
            raise RuntimeError(
                "a process group is up but not through parallel/distributed."
                "init_distributed, so the ranks' devices are unknown")
    else:
        infos = [info] * nproc
    entries: List[MeshEntry] = []
    for r, (kind_r, typ, idx) in enumerate(infos):
        for j, ix in enumerate(idx):
            dev = local[j] if r == me else torch.device(typ, ix) if ix is not None \
                else torch.device(typ)
            entries.append(MeshEntry(len(entries), dev, r, kind_r))
    if n_devices is not None:
        if n_devices > len(entries):
            raise ValueError(
                f"make_mesh(n_devices={n_devices}) but only {len(entries)} device(s) are "
                "visible — start the process group (parallel/distributed.init_distributed) "
                "or pass device='cpu' for virtual CPU entries before building the mesh")
        entries = entries[:n_devices]
    return Mesh(entries, (axis,))


def sub_mesh(mesh: Mesh, n_devices: int) -> Mesh:
    """The prefix sub-mesh of the first ``n_devices`` entries, same axis
    name; the parent itself when the sizes match (so the plan's
    full-mesh entries keep the parent's fingerprint)."""
    if n_devices < 1 or n_devices > mesh.size:
        raise ValueError(
            f"sub_mesh(n_devices={n_devices}) outside the parent mesh's "
            f"1..{mesh.size} device range")
    if n_devices == mesh.size:
        return mesh
    return Mesh(mesh.entries[:n_devices], (mesh.axis_names[0],))


class SubsetLayoutError(ValueError):
    """A subset count K that cannot be laid out contiguously over the
    requested device count. Raised only by
    :func:`require_divisible_layout`."""


def require_divisible_layout(k: int, n_devices: int, *, what: str = "K") -> int:
    """The layout oracle every sharded path consults: the contiguous
    leading-K layout needs ``k % n_devices == 0``. Returns the per-device
    subset count; raises :class:`SubsetLayoutError` naming the ragged-mesh
    planner otherwise."""
    if n_devices < 1:
        raise SubsetLayoutError(f"n_devices must be >= 1, got {n_devices}")
    if k % n_devices != 0:
        raise SubsetLayoutError(
            f"{what}={k} must be divisible by mesh size {n_devices}; for ragged bucket "
            "groups, route the fit through the ragged-mesh planner "
            "(smk_torch.compile.buckets.plan_ragged_mesh), which pads or fuses group Ks "
            "onto sub-meshes so every entry satisfies this layout")
    return k // n_devices


def fits_layout(k: int, n_devices: int) -> bool:
    """Non-raising form of :func:`require_divisible_layout`."""
    return n_devices >= 1 and k % n_devices == 0


def subset_device_assignment(k: int, mesh: Mesh) -> list:
    """The entry of each of the ``k`` subsets under the contiguous layout:
    subset ``i`` on entry ``i // (k / mesh.size)``."""
    devs = mesh.entries
    per = require_divisible_layout(k, len(devs))
    return [devs[i // per] for i in range(k)]


def all_process_row_ranges(k: int, mesh: Mesh) -> list:
    """Contiguous K-row ownership per process, processes by ascending
    index: entry ``p`` is the ``(start, stop)`` rows of the ``p``-th
    process. Raises if a process's rows are not contiguous."""
    devices = subset_device_assignment(k, mesh)
    procs = sorted({int(d.process_index) for d in devices})
    out = []
    for p in procs:
        rows = [i for i, d in enumerate(devices) if int(d.process_index) == p]
        start, stop = rows[0], rows[-1] + 1
        if rows != list(range(start, stop)):
            raise ValueError(
                f"process {p} owns non-contiguous subset rows {rows} — the canonical "
                "contiguous leading-K layout is a prerequisite of per-process shards")
        out.append((start, stop))
    return out


def process_row_range(k: int, mesh: Mesh) -> tuple:
    """THIS process's ``(start, stop)`` contiguous subset rows."""
    from smk_torch.parallel.distributed import process_index

    devices = subset_device_assignment(k, mesh)
    procs = sorted({int(d.process_index) for d in devices})
    me = process_index()
    if me not in procs:
        raise ValueError(
            f"process {me} owns no device of this mesh (processes {procs}) — it cannot "
            "participate in the sharded fit")
    return all_process_row_ranges(k, mesh)[procs.index(me)]


# ----------------------------------------------------------------------
# running per device
# ----------------------------------------------------------------------
def run_per_device(jobs: Sequence[tuple]) -> list:
    """Run ``jobs``, (device, fn) pairs, and return their results in
    order. Jobs that share a device run one after another; when the jobs
    span several devices each device gets a host thread of its own,
    under that device and this thread's current stream on it
    (device.in_callers_context). Every job's exception reaches the
    caller."""
    groups: dict = {}
    for i, (dev, _) in enumerate(jobs):
        groups.setdefault(str(torch.device(dev)), []).append(i)
    out: list = [None] * len(jobs)

    def run(ids):
        for i in ids:
            out[i] = jobs[i][1]()

    if len(groups) <= 1:
        run(range(len(jobs)))
        return out
    with ThreadPoolExecutor(max_workers=len(groups), thread_name_prefix="smk-mesh") as ex:
        futs = [ex.submit(in_callers_context(under_current_span(lambda ids=ids: run(ids)),
                                             torch.device(jobs[ids[0]][0])))
                for ids in groups.values()]
        for f in futs:
            # smklint: disable=SMK111 -- one chunk's dispatch per entry; an armed chunk watchdog bounds the whole call from outside (parallel/domains.ChunkWatchdog)
            f.result()
    return out


def model_on(model: SpatialGPSampler, device, home) -> SpatialGPSampler:
    """The sampler to drive on ``device``: ``model`` itself on ``home``,
    else a shallow copy kept on the model for that device, whose guard
    counts and program tables are its own, so threads on distinct
    devices share no mutable state of the sampler."""
    dev = torch.device(device)
    if dev == torch.device(home):
        return model
    views = model.__dict__.setdefault("_device_views", {})
    view = views.get(str(dev))
    if view is None:
        view = copy.copy(model)
        for attr in ("_program_l1", "_programs_persisted", "_graph_shared", "_device_views"):
            view.__dict__.pop(attr, None)
        view.guard_rejects = None
        views[str(dev)] = view
    return view


def noise_on(noise, device):
    """``noise`` drawing on ``device``: itself where it draws there (or
    has no device of its own), else its ``to(device)``."""
    own = getattr(noise, "device", None)
    dev = torch.device(device)
    if own is None or torch.device(own) == dev:
        return noise
    to = getattr(noise, "to", None)
    if to is None:
        raise ValueError(
            f"a noise source on {own} cannot feed a mesh entry on {dev}: it has no "
            "to(device) (as models/probit_gp.GeneratorNoise has)")
    return to(dev)


def fit_subsets_sharded(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    mesh: Optional[Mesh] = None,
    chunk_size: Optional[int] = None,
) -> SubsetResult:
    """Sharded fan-out: the K axis laid out contiguously over the mesh.

    Entry ``i`` runs subsets ``[i*K/n, (i+1)*K/n)`` through
    :func:`fit_subsets_vmap` on its device, with the rows' own noise
    (``noise.subset``), so every subset draws what the unmeshed run
    draws for it. ``chunk_size`` (divisible by the mesh size) is the
    subsets per step over the whole mesh, as in the twin: each entry
    sweeps ``chunk_size / n`` of its subsets at a time. Under a
    multi-process mesh this process runs the rows it owns
    (:func:`process_row_range`) and returns those rows; the combine
    gathers the grids (combine.gather_grids). The results come back on
    the mesh's first local device (``mesh.home``)."""
    cfg = model.config
    if mesh is None:
        mesh = make_mesh(axis=cfg.mesh_axis, device=part.x.device)
    k = part.n_subsets
    n = mesh.size
    per = require_divisible_layout(k, n)
    inner = None
    if chunk_size is not None and chunk_size < k:
        inner = require_divisible_layout(chunk_size, n, what="chunk_size")
        if per % inner:
            raise ValueError(f"chunk_size {chunk_size} must divide K={k}")
    c = cfg.n_chains
    home = mesh.home
    data = stacked_subset_data(part, coords_test, x_test)
    if noise is None:
        noise = model.default_noise(data)
    from smk_torch.parallel.distributed import process_index

    process_row_range(k, mesh)  # raises for a process that owns no entry
    me = process_index()
    jobs = []
    for i, e in enumerate(mesh.entries):
        if e.process_index != me:
            continue
        lo, hi = i * per, (i + 1) * per
        dev = e.device
        whole = (lo, hi) == (0, k) and torch.device(dev) == part.x.device
        bpart = part if whole else Partition(*(t[lo:hi].to(dev) for t in part))
        bnoise = noise if whole else noise_on(_chunk_noise(noise, lo * c, hi * c), dev)
        bmodel = model_on(model, dev, home)

        def job(bmodel=bmodel, bpart=bpart, bnoise=bnoise, dev=dev):
            bmodel.guard_rejects = None
            res = fit_subsets_vmap(
                bmodel, bpart, coords_test.to(dev), x_test.to(dev), bnoise,
                None if beta_init is None else beta_init.to(dev), chunk_size=inner)
            return res, bmodel.guard_rejects

        jobs.append((dev, job))
    outs = run_per_device(jobs)
    guards = [g for _, g in outs]
    model.guard_rejects = (None if guards[0] is None
                           else torch.cat([g.to(home) for g in guards]))
    if len(outs) == 1 and outs[0][0].param_grid.device == home:
        return outs[0][0]
    return SubsetResult(*(torch.cat([f.to(home) for f in fs])
                          for fs in zip(*(r for r, _ in outs))))
