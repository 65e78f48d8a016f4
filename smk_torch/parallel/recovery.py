"""The chunked, checkpointed, fault-isolating executor — twin of
``smk_tpu/parallel/recovery.py``.

The whole MCMC (burn-in and sampling) runs as a host loop of
``chunk_iters``-sweep chunks, the sampler's ``burn_chunk`` and
``sample_chunk``. Each chunk's boundary copies one small tensor to the
host (the per-subset finite vector and the mean phi acceptance, when a
guard, a report or quarantine asks for it) and, on a checkpointed run,
the carried state, then guards, reports and checkpoints:

- the checkpoint (format 7, the twin's layout in the port's own files)
  is a manifest holding the carried state, the noise source's snapshot,
  the counters, the run identity and the fault ledger, plus one draw
  segment per sampling chunk with its checksum, each file atomic
  (utils/checkpoint.py). An interrupted call resumes bitwise: the chain
  is a function of the carried state and the noise source's state, and
  both are in the manifest;
- ``chunk_pipeline="overlap"`` queues chunk t + 1 before chunk t's
  boundary work and writes the checkpoint on a ``BackgroundWriter``
  thread, from two pinned staging buffers taken in turn; a failed write
  degrades to inline writes after one full rewrite. Both pipelines run
  the same plan, so their draws are bitwise equal;
- ``fault_policy="quarantine"`` holds a clone of the state and the
  noise snapshot at each chunk start; a subset that goes non-finite is
  rewound to them with a forked stream (``noise.fork``) and a halved
  phi step, up to ``fault_max_retries`` times, then dropped (its draws
  stay non-finite and the combine's survival mask removes it). A
  fault-free quarantine run is bitwise the ``"abort"`` run. On resume a
  corrupt, truncated or missing draw segment is a hole, re-sampled by
  extending the chain (lenient resume); ``"abort"`` rejects it;
- ``watchdog=True`` runs each chunk and each boundary under a deadline
  (parallel/domains.ChunkWatchdog): a hang becomes a typed
  ``ChunkTimeoutError``;
- ``live_diagnostics=True`` folds each sampling chunk's kept draws into
  the streaming monitor (obs/streaming.py) on the device; its (K,)
  ``rhat_max`` and ``ess_min`` ride in the boundary's one copy to the
  host and reach the progress callback, the chunk records and the run
  log. A quarantine rewind rewinds the monitor too;
- ``adaptive_schedule="on"`` consults parallel/schedule.AdaptiveScheduler
  at each committed sampling boundary: converged subsets freeze, the
  batch compacts onto a smaller rung of the K ladder, and the saved
  slots buy extra chunks for the stragglers. Its state is the ``sched``
  sidecar, written before each manifest, so a kill resumes the same
  schedule bitwise; the finalize is masked (models/probit_gp
  ``finalize_masked``). Over a multi-process mesh every process holds
  the same scheduler over all K: each boundary's (K,) statistics and
  guard verdicts are gathered over the process group (one
  ``allgather_bytes`` a boundary, a world of one included), every
  process applies the same decision, and each regroups its own
  survivors onto a rung over its own entries;
- ``run_log_dir`` writes the fit's run log (obs/events.py): spans for
  the chunk loop and the finalize, and events for the plan, the chunks,
  the faults, the checkpoint writes, the watchdog, the live diagnostics,
  the compactions and the profiler window;
- ``profile_dir`` / ``profile_chunks`` open one ``torch.profiler``
  window over a chunk range (obs/profiling.py).

The twin carries its PRNG key in the chain state; here randomness
comes from a noise source (models/probit_gp.NoiseSource), which the
executor snapshots, restores and forks. A ``PaddedPartition`` runs
through the ragged fan-out, one ordinary chunked fit per occupied
bucket, or per entry of its RaggedMeshPlan on a mesh. Over a mesh
(parallel/executor.Mesh) each chunk program runs per entry block on the
entry's device; a multi-process mesh runs this process's rows, and its
checkpoint is the distributed format 8 (parallel/checkpoint.py:
per-process shard files, each boundary a two-phase-committed generation,
elastic resume onto another topology), which a single-process run takes
when ``checkpoint_path`` already holds a format-8 manifest.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings
import zlib
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from smk_torch.compile import programs as compile_programs
from smk_torch.compile.programs import GraphProgram
from smk_torch.device import in_callers_context
from smk_torch.models.probit_gp import (
    BuildConsts,
    GeneratorNoise,
    NoiseSource,
    SamplerState,
    SpatialGPSampler,
    SubsetData,
    SubsetResult,
    SweepNoise,
    chunk_noise,
    n_params,
    subset_generators,
    sweep_shapes,
)
from smk_torch.obs.events import open_run_log
from smk_torch.ops import cuda_build
from smk_torch.obs.memory import device_memory_stats
from smk_torch.obs.profiling import ProfilerCapture, chunk_scope
from smk_torch.obs.streaming import (
    init_stream,
    make_stream_stats,
    make_stream_update,
    make_stream_update_masked,
)
from smk_torch.analysis.sanitizers import explicit_d2h, explicit_h2d
from smk_torch.parallel import checkpoint as dist_ckpt
from smk_torch.parallel.checkpoint import identity_config_repr
from smk_torch.parallel.domains import ChunkWatchdog, FailureDomainMap
from smk_torch.compile.buckets import compaction_rung, plan_ragged_mesh
from smk_torch.parallel import distributed
from smk_torch.parallel.executor import (
    all_process_row_ranges,
    fits_layout,
    model_on,
    process_row_range,
    require_divisible_layout,
    run_per_device,
    stacked_subset_data,
    sub_mesh,
)
from smk_torch.parallel.partition import PaddedPartition, Partition, ragged_mesh_entry_partition
from smk_torch.parallel.schedule import AdaptiveScheduler
from smk_torch.utils.checkpoint import (
    BackgroundWriter,
    load_pytree,
    load_segment,
    load_sidecar,
    save_pytree,
    save_segment,
    save_sidecar,
    segment_path,
    sidecar_path,
)
from smk_torch.utils.tracing import ChunkPipelineStats, monotonic

# The port's checkpoint format: the twin's v7 layout (manifest + one
# checksummed draw segment per sampling chunk, the v7 fault-domain
# ledger), with the noise snapshot in place of the PRNG keys.
CKPT_VERSION = 7


class ProgressAbort(Exception):
    """Base class of the exceptions a ``progress`` callback raises to
    abort a chunked run on purpose. Any other exception from the
    callback is warned about once and the run goes on."""


class _QuarantineRewind(Exception):
    """A boundary's guard found non-finite subsets with retry budget
    left; carries the (K,) retry mask. Never escapes the executor."""

    def __init__(self, retry_mask):
        self.retry_mask = retry_mask
        super().__init__("quarantine rewind")


class SubsetNaNError(RuntimeError):
    """In-chain NaN/inf found by ``nan_guard``: which subsets, at which
    global iteration. Raised before the chunk's checkpoint save, so the
    checkpoint still holds the last finite state."""

    def __init__(self, subset_ids, iteration):
        self.subset_ids = list(int(i) for i in subset_ids)
        self.iteration = int(iteration)
        super().__init__(
            f"sampler state non-finite in subsets {self.subset_ids} at iteration "
            f"{self.iteration}; the last checkpoint (if any) precedes the failure — "
            "resume from it or re-run the failed shards (rerun_subsets)"
        )


# ----------------------------------------------------------------------
# device-side boundary statistics
# ----------------------------------------------------------------------
def _finite_subsets(state: SamplerState, n_chains: int) -> torch.Tensor:
    """(K,) bool: every small carried leaf finite, over all of a
    subset's chains. chol_r is left out (the one O(m^2) leaf; a
    non-finite factor reaches u within one sweep)."""
    k = state.beta.shape[0] // n_chains
    oks = [torch.isfinite(leaf).reshape(k, -1).all(dim=1)
           for leaf in (state.beta, state.u, state.a, state.phi)]
    return torch.stack(oks).all(dim=0)


def _chunk_stats(state: SamplerState, n_chains: int) -> torch.Tensor:
    """(K + 1,) on the device: the finite vector as 0/1 and the mean of
    the running phi-acceptance counters — one fetch per boundary."""
    fin = _finite_subsets(state, n_chains).to(state.phi_accept.dtype)
    return torch.cat([fin, torch.mean(state.phi_accept).reshape(1)])


def _refork(held: SamplerState, row_mask: torch.Tensor, half: float) -> SamplerState:
    """A quarantine retry's start state: the held chunk-start state with
    the phi step of the retried rows (``row_mask``, (K*C,) bool) moved
    by ``half`` (log 0.5)."""
    step = held.phi_log_step
    return held._replace(phi_log_step=torch.where(row_mask[:, None], step + half, step))


def _subset_draws_finite(param_draws: torch.Tensor, w_draws: torch.Tensor,
                         n_chains: int) -> np.ndarray:
    """(K,) bool on the host: every recorded draw of each subset finite
    (the terminal boundary's quarantine verdict)."""
    k = param_draws.shape[0] // n_chains
    ok = (torch.isfinite(param_draws).reshape(k, -1).all(dim=1)
          & torch.isfinite(w_draws).reshape(k, -1).all(dim=1))
    return ok.cpu().numpy()


# ----------------------------------------------------------------------
# run identity
# ----------------------------------------------------------------------
def _leaf_fingerprint(leaf: torch.Tensor) -> int:
    """CRC of a tensor's shape, dtype and every byte (the data leaves are
    O(n) in size: one fetch at the start of a checkpointed run)."""
    h = zlib.crc32(repr((tuple(leaf.shape), str(leaf.dtype))).encode())
    with explicit_d2h("run_identity"):
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return zlib.crc32(raw.tobytes(), h)


def _run_identity(cfg, noise, data: SubsetData, beta_init) -> np.ndarray:
    """Fingerprint of everything that determines the chain: the config,
    the noise stream (``noise.identity()``) and the data and warm
    start. A checkpoint of another identity is rejected, not resumed.
    (identity_config_repr is parallel/checkpoint's, re-exported here.)"""
    crcs = [zlib.crc32(identity_config_repr(cfg)), zlib.crc32(noise.identity())]
    crcs += [_leaf_fingerprint(leaf) for leaf in data]
    if beta_init is not None:
        crcs.append(_leaf_fingerprint(beta_init))
    return np.asarray(crcs, np.uint32)


# ----------------------------------------------------------------------
# the checkpoint
# ----------------------------------------------------------------------
class _HostStaging:
    """The host copies a boundary checkpoints (the carried state and a
    sampling chunk's draw segment), copied in without blocking: pinned
    memory on the card, plain host memory on the CPU. A pool of
    ``n_slots`` buffers, each allocated once at the largest boundary's
    size and handed out in turn. A boundary takes the next slot only
    once the writer job that reads it is done (``claim`` names that
    job), so no job reads a buffer a later boundary overwrites. The
    overlap pipeline has two slots: boundary t's job writes from one
    while boundary t + 1 fills the other."""

    def __init__(self, n_slots: int, writer: Optional[BackgroundWriter] = None):
        self.bufs: list = [None] * n_slots
        self.jobs = [0] * n_slots  # the writer job reading each slot (0: none)
        self.writer = writer
        self.next = 0

    @property
    def nbytes(self) -> int:
        return sum(b.numel() for b in self.bufs if b is not None)

    def take(self, tensors: Sequence[torch.Tensor], capacity: int):
        """Copy ``tensors`` into the next slot, waiting first for the job
        that still reads it. Returns (slot, numpy views, seconds waited).
        On the card the copies are queued on the current stream: the
        caller records an event behind them and synchronizes it before
        the views are read."""
        slot = self.next
        self.next = (slot + 1) % len(self.bufs)
        t0 = monotonic()
        if self.jobs[slot] and self.writer is not None:
            self.writer.wait_done(self.jobs[slot])
        self.jobs[slot] = 0
        waited = monotonic() - t0
        offsets, off = [], 0
        for t in tensors:
            offsets.append(off)
            off += -(-t.numel() * t.element_size() // 64) * 64
        buf = self.bufs[slot]
        if buf is None or buf.numel() < off:
            self.bufs[slot] = buf = None  # free the old buffer before pinning its successor
            buf = torch.empty(max(off, capacity), dtype=torch.uint8,
                              pin_memory=tensors[0].device.type == "cuda")
            self.bufs[slot] = buf
        out = []
        for t, o in zip(tensors, offsets):
            n = t.numel() * t.element_size()
            dst = buf[o:o + n].view(t.dtype).view(t.shape)
            dst.copy_(t, non_blocking=True)
            out.append(dst.numpy())
        return slot, out, waited

    def claim(self, slot: int, job: int) -> None:
        """Writer job ``job`` reads ``slot`` until it is done."""
        self.jobs[slot] = job


def _state_nbytes(state: SamplerState) -> int:
    return sum(t.numel() * t.element_size() for t in state)


class _HostState(NamedTuple):
    """The carried state as a manifest holds it: each leaf in its memory
    order (``arrays``) and the permutation that views it back in logical
    order with the device tensor's own strides (``layout``). A resumed
    chain then runs on the layouts the uninterrupted one had: the
    sampler's factor is column-major, and on the card a triangular solve
    against its contiguous copy rounds differently."""

    arrays: SamplerState
    layout: SamplerState


def _memory_order(t: torch.Tensor):
    """(permutation, view): ``t``'s dims by decreasing stride, and ``t``
    permuted so, which is contiguous when ``t`` is a permuted contiguous
    tensor; the identity and ``t`` itself otherwise."""
    perm = sorted(range(t.dim()), key=lambda i: (-t.stride(i), i))
    view = t.permute(perm)
    if view.is_contiguous():
        return np.asarray(perm, np.int64), view
    return np.arange(t.dim(), dtype=np.int64), t


def _state_views(state: SamplerState):
    """(memory-order views of the leaves, their layout)."""
    perms, views = zip(*(_memory_order(t) for t in state))
    return list(views), SamplerState(*perms)


def _host_state(state: SamplerState) -> _HostState:
    """The live state's host copy (a synchronising fetch)."""
    views, layout = _state_views(state)
    return _HostState(SamplerState(*(v.cpu().numpy() for v in views)), layout)


def _snapshot_state(state: SamplerState) -> _HostState:
    """:func:`_host_state` as a sanctioned host snapshot."""
    with explicit_d2h("host_snapshot", nbytes=_state_nbytes(state)):
        return _host_state(state)


def _device_state(host: _HostState, device, tag: str = "checkpoint_restore") -> SamplerState:
    """A manifest's state on ``device``, each leaf with its saved layout
    (a sanctioned upload, ``tag`` in the sanitizers' ledger)."""
    with explicit_h2d(tag, nbytes=sum(np.asarray(a).nbytes for a in host.arrays)):
        return SamplerState(*(
            torch.as_tensor(np.asarray(a), device=device).permute(*np.argsort(p).tolist())
            for a, p in zip(host.arrays, host.layout)))


def _row_axis(perm) -> int:
    """The memory-order axis of a host leaf that holds its batch rows
    (logical dim 0)."""
    return int(np.flatnonzero(np.asarray(perm) == 0)[0])


def _logical(arr: np.ndarray, perm) -> torch.Tensor:
    """A host leaf in memory order as a tensor in logical order."""
    return torch.from_numpy(np.asarray(arr)).permute(*np.argsort(perm).tolist())


def _relayout(arr: np.ndarray, src_perm, dst_perm) -> np.ndarray:
    """A host leaf in memory order ``src_perm`` re-laid in ``dst_perm``."""
    if np.array_equal(src_perm, dst_perm):
        return arr
    return _logical(arr, src_perm).permute(*np.asarray(dst_perm).tolist()).contiguous().numpy()


def _merge_rows(full: _HostState, part: _HostState, rows) -> None:
    """Write the first ``len(rows)`` batch rows of ``part`` (a group's
    host state) into rows ``rows`` of ``full`` (the host mirror), each
    leaf re-laid to the mirror's memory order."""
    rows = np.asarray(rows, np.int64)
    for dst_leaf, src_leaf, fp, pp in zip(full.arrays, part.arrays, full.layout, part.layout):
        src_leaf = _relayout(src_leaf, pp, fp)
        ax = _row_axis(fp)
        dst = [slice(None)] * dst_leaf.ndim
        dst[ax] = rows
        src = [slice(None)] * src_leaf.ndim
        src[ax] = slice(0, len(rows))
        dst_leaf[tuple(dst)] = src_leaf[tuple(src)]


class _PaddedNoise:
    """The noise of an adaptive dispatch group: its members' rows of the
    source (``base``) followed by ``n_pad`` pad rows, each pad of C rows
    fed the first member's numbers (a pad is a clone of that member, as
    the twin's pad carries a clone of its key). Snapshots, restores and
    forks act on the members' rows."""

    def __init__(self, base, n_pad: int, n_chains: int):
        self.base = base
        self.n_pad = int(n_pad)
        self.c = int(n_chains)

    def __call__(self, it: int, collect: bool) -> SweepNoise:
        nz = self.base(it, collect)
        if not self.n_pad:
            return nz
        reps = self.n_pad // self.c
        return SweepNoise(*(
            None if f is None
            else torch.cat([f, f[:self.c].repeat(reps, *([1] * (f.dim() - 1)))])
            for f in nz))

    def snapshot(self):
        return self.base.snapshot()

    def restore(self, snap) -> None:
        self.base.restore(snap)

    def fork(self, mask, attempts) -> None:
        n = len(np.asarray(mask)) - self.n_pad
        self.base.fork(np.asarray(mask)[:n], np.asarray(attempts)[:n])

    def identity(self) -> bytes:
        return self.base.identity() + np.asarray([self.n_pad], np.int64).tobytes()


def _to_host_async(t: torch.Tensor):
    """(host copy, event): on the card the copy into pinned memory is
    queued without blocking and ``event`` marks where the stream stands
    behind it; on the CPU the tensor itself and None."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, _record_event(t.device)


def _record_event(device: torch.device, timing: bool = False):
    """A CUDA event recorded on ``device``'s current stream (None on the
    CPU); ``timing``: one that ``elapsed_time`` can read."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=timing)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _read_segments(path, seg_base, n_segments, filled, dtype):
    """The filled kept-draw region [0, filled) from segments
    seg_base..seg_base+n_segments-1, checking contiguous coverage;
    (None, None) when nothing is filled."""
    if filled <= 0:
        if n_segments != 0:
            raise ValueError(
                f"checkpoint {path} is inconsistent: {n_segments} segments recorded "
                "but no filled draws"
            )
        return None, None
    import zipfile

    parts_p, parts_w = [], []
    cursor = 0
    for i in range(seg_base, seg_base + n_segments):
        try:
            seg = load_segment(path, i)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            raise ValueError(
                f"checkpoint {path} is missing or has a corrupt draw segment "
                f"{segment_path(path, i)} — the manifest records {n_segments} segments "
                f"covering {filled} kept draws; restore the file or delete the "
                "checkpoint and re-run"
            ) from e
        if seg["start"] != cursor or seg["stop"] <= seg["start"]:
            raise ValueError(
                f"checkpoint {path} segments are not contiguous: segment {i} covers "
                f"[{seg['start']}, {seg['stop']}) but {cursor} was expected next"
            )
        if seg["param"].shape[-2] != seg["stop"] - seg["start"]:
            raise ValueError(
                f"checkpoint {path} segment {i} shape {seg['param'].shape} does not "
                f"match its recorded range [{seg['start']}, {seg['stop']})"
            )
        cursor = seg["stop"]
        parts_p.append(np.asarray(seg["param"], dtype))
        parts_w.append(np.asarray(seg["w"], dtype))
    if cursor != filled:
        raise ValueError(
            f"checkpoint {path} segments cover {cursor} kept draws but the manifest "
            f"records {filled}"
        )
    return np.concatenate(parts_p, axis=-2), np.concatenate(parts_w, axis=-2)


def _read_segments_lenient(path, seg_base, n_segments, filled, dtype, lead, d_par, d_w):
    """The lenient read of ``fault_policy="quarantine"`` (the twin's
    ``_read_segments_lenient``): every readable, checksum-clean segment
    whose range and shape agree with the manifest lands at its range;
    a truncated, bit-flipped, missing, overlapping or out-of-range one
    becomes a hole, warned about, that the executor re-samples by
    extending the chain. Returns (param, w, holes): ``lead + (filled,
    d)`` arrays (zeros in the holes) and the sorted disjoint kept ranges
    (a, b) no good segment covers; (None, None, []) when nothing is
    filled."""
    import zipfile

    if filled <= 0:
        return None, None, []
    param = np.zeros(lead + (filled, d_par), dtype)
    w = np.zeros(lead + (filled, d_w), dtype)
    covered = np.zeros(filled, bool)
    for i in range(seg_base, seg_base + n_segments):
        try:
            seg = load_segment(path, i)
        except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
            warnings.warn(
                f"checkpoint {path}: draw segment {segment_path(path, i)} is corrupt or "
                f"unreadable ({e!r}); its iteration range will be re-sampled "
                "(fault_policy='quarantine' lenient resume)",
                RuntimeWarning, stacklevel=3,
            )
            continue
        a, b = seg["start"], seg["stop"]
        if (not 0 <= a < b <= filled
                or seg["param"].shape[-2] != b - a or seg["w"].shape[-2] != b - a
                or seg["param"].shape[:-2] != lead or seg["param"].shape[-1] != d_par
                or seg["w"].shape[-1] != d_w or covered[a:b].any()):
            warnings.warn(
                f"checkpoint {path}: draw segment {segment_path(path, i)} records range "
                f"[{a}, {b}) inconsistent with the manifest (shape/bounds/overlap); "
                "treating it as corrupt — its range will be re-sampled",
                RuntimeWarning, stacklevel=3,
            )
            continue
        param[..., a:b, :] = np.asarray(seg["param"], dtype)
        w[..., a:b, :] = np.asarray(seg["w"], dtype)
        covered[a:b] = True
    holes = []
    pos = 0
    while pos < filled:
        if covered[pos]:
            pos += 1
            continue
        start = pos
        while pos < filled and not covered[pos]:
            pos += 1
        holes.append((start, pos))
    return param, w, holes


class _SegmentedCheckpoint:
    """The manifest and its ordered draw segments (the twin's
    ``_SegmentedCheckpoint``). Each boundary writes its segment, then the
    manifest, each atomic, and no write touches a file the manifest on
    disk references: appends land past the manifest's range, and a full
    rewrite (compaction, the degraded writer's recovery, the lenient
    refill) writes its merged segment at a fresh index before the
    manifest that names it. A kill at any instant leaves the previous
    consistent view or the new one.

    Writes run inline (``chunk_pipeline="sync"``) or as jobs of the one
    :class:`BackgroundWriter` (``"overlap"``). A failed background write
    is warned about once at the next boundary and the checkpoint
    degrades to inline writes, starting with one full rewrite that
    re-establishes the files whatever jobs were lost."""

    def __init__(self, path: str, meta: np.ndarray, ident: np.ndarray, *,
                 writer: Optional[BackgroundWriter] = None,
                 pstats: Optional[ChunkPipelineStats] = None, full_draws=None,
                 fault_src=None):
        self.path = path
        self.meta = meta
        self.ident = ident
        self.version = np.asarray([CKPT_VERSION], np.int64)
        self.writer = writer
        self.pstats = pstats
        self._full_draws = full_draws  # filled -> (param, w) numpy
        self._fault_src = fault_src
        # touched only by the thread that writes (the writer under
        # overlap, the caller inline; degrading flushes the writer first)
        self.seg_base = 0
        self.n_segments = 0
        self.filled = 0
        self.degraded = False
        self._need_full = False

    def _write_manifest(self, state_np, noise_np, it: int, fault=None) -> int:
        if fault is None:
            fault = self._fault_src()
        attempts, dead, dom_map, dom_attempts, dom_dead = fault
        return save_pytree(self.path, {
            "state": state_np.arrays,
            "layout": state_np.layout,
            "noise": noise_np,
            "it": np.asarray([it], np.int64),
            "meta": self.meta,
            "ident": self.ident,
            "version": self.version,
            "seg_base": np.asarray([self.seg_base], np.int64),
            "n_segments": np.asarray([self.n_segments], np.int64),
            "filled": np.asarray([self.filled], np.int64),
            "fault_attempts": np.asarray(attempts, np.int64),
            "fault_dead": np.asarray(dead, np.int64),
            "fault_domain": np.asarray(dom_map, np.int64),
            "fault_domain_attempts": np.asarray(dom_attempts, np.int64),
            "fault_domain_dead": np.asarray(dom_dead, np.int64),
        })

    def _record(self, seconds: float, nbytes: int) -> None:
        if self.pstats is not None:
            self.pstats.add_ckpt_write(seconds, nbytes)

    def _write(self, state_np, noise_np, seg, it: int, fault=None):
        """One boundary's files: the segment ``seg`` = (param, w, start,
        stop) of a sampling chunk (None at a burn-in boundary), then the
        manifest. Returns (seconds, bytes written)."""
        t0 = monotonic()
        nbytes = 0
        if seg is not None:
            param, w, start, stop = seg
            if stop > start:
                nbytes += save_segment(self.path, self.seg_base + self.n_segments,
                                       param, w, start, stop)
                self.n_segments += 1
                self.filled = stop
        nbytes += self._write_manifest(state_np, noise_np, it, fault)
        secs = monotonic() - t0
        self._record(secs, nbytes)
        return secs, nbytes

    def _write_full(self, state_np, noise_np, param, w, it: int, filled: int):
        """One merged segment at the first index past the on-disk range,
        then the manifest, then the superseded files unlinked. Returns
        (seconds, bytes written)."""
        t0 = monotonic()
        old = range(self.seg_base, self.seg_base + self.n_segments)
        self.seg_base += self.n_segments
        self.n_segments = self.filled = 0
        nbytes = 0
        if filled > 0:
            nbytes += save_segment(self.path, self.seg_base, param, w, 0, filled)
            self.n_segments, self.filled = 1, filled
        nbytes += self._write_manifest(state_np, noise_np, it)
        for i in old:
            try:
                os.remove(segment_path(self.path, i))
            except OSError:  # pragma: no cover - cleanup only
                pass
        secs = monotonic() - t0
        self._record(secs, nbytes)
        return secs, nbytes

    def _check_degrade(self) -> None:
        if self.writer is not None and not self.degraded and self.writer.error is not None:
            err = self.writer.acknowledge_error()
            warnings.warn(
                f"background checkpoint writer failed ({err!r}); degrading to "
                "synchronous checkpoint writes — the next boundary rewrites a full "
                "consistent checkpoint, then incremental segment writes resume inline",
                RuntimeWarning, stacklevel=3,
            )
            self.writer.flush()  # the later jobs were skipped; drain them
            self.degraded = True
            self._need_full = True

    def save(self, state_np, noise_np, seg, it: int, filled: int) -> dict:
        """Persist one boundary: the host copies of the carried state,
        the noise snapshot and ``seg`` (or None), as of the boundary.
        Returns the chunk record's checkpoint entries: ``ckpt_job`` (the
        writer job that reads the copies) when the write went to the
        writer, else ``ckpt_write_s`` and ``ckpt_bytes``."""
        self._check_degrade()
        # the fault ledger as of this boundary, on the caller's thread:
        # the executor goes on mutating it
        fault = self._fault_src()
        if self.writer is not None and not self.degraded:
            job = self.writer.submit(lambda: self._write(state_np, noise_np, seg, it, fault))
            return {"ckpt_job": job}
        if self._need_full:
            param, w = self._full_draws(filled)
            secs, nbytes = self._write_full(state_np, noise_np, param, w, it, filled)
            self._need_full = False
        else:
            secs, nbytes = self._write(state_np, noise_np, seg, it, fault)
        return {"ckpt_write_s": secs, "ckpt_bytes": nbytes}

    def ensure_synced(self, state_fn, noise_np, it: int, filled: int) -> None:
        """Drain the writer; if a write was lost, rewrite a full
        checkpoint inline from the live state (``state_fn()``, its host
        copy) and draws (at the end of a run, a truncated one included)."""
        if self.writer is None:
            return
        self.writer.flush()
        if self.writer.error is not None and not self.degraded:
            self._check_degrade()
        if self._need_full:
            param, w = self._full_draws(filled)
            self._write_full(state_fn(), noise_np, param, w, it, filled)
            self._need_full = False

    def adopt(self, seg_base: int, n_segments: int, filled: int) -> None:
        """Resume bookkeeping after a load."""
        self.seg_base, self.n_segments, self.filled = seg_base, n_segments, filled

    def compact(self, state_np, noise_np, param, w, it: int, filled: int) -> None:
        """Merge the segments into one (resume-time compaction: the file
        count stays bounded across kills). Call :meth:`adopt` first."""
        self._write_full(state_np, noise_np, param, w, it, filled)

    def rewrite_full(self, state_np, noise_np, param, w, it: int, filled: int) -> None:
        """The lenient refill's closing write: one merged, checksummed
        segment of the whole kept region and a new manifest (the refill
        chunks wrote out of order and saved nothing). Drains the writer
        first, so no stale append lands after it."""
        if self.writer is not None:
            self.writer.flush()
            if self.writer.error is not None:
                self._check_degrade()
        self._write_full(state_np, noise_np, param, w, it, filled)
        self._need_full = False


# ----------------------------------------------------------------------
# the chunk
# ----------------------------------------------------------------------
class _ProgramCtx(NamedTuple):
    """Where a run's chunk programs come from: the L2 ``store`` (or
    None), the ``stats`` sink their acquisitions are recorded in, the K
    and ``chunk_size`` of their bucket keys, and the run's ``mesh`` (or
    None), whose fingerprint ends every key."""

    store: object
    stats: object
    k: int
    chunk_size: Optional[int]
    mesh: object = None


class _Piece(NamedTuple):
    """Rows [lo, hi) of the K*C-wide chain batch that one call of the
    sampler sweeps (all of them unless ``chunk_size`` or a mesh splits
    K), on the device of ``data``, and the context its chunk program is
    acquired in. ``sliced``: the piece's noise is rows [lo, hi) of the
    chunk noise drawn once from ``noise``, the whole batch's source (a
    mesh's pieces; the unmeshed ``chunk_size`` pieces draw from their
    own rows' source). ``entry``: the mesh entry (of this process) whose
    block holds the rows."""

    lo: int
    hi: int
    data: SubsetData
    consts: BuildConsts
    noise: NoiseSource
    ctx: _ProgramCtx
    sliced: bool = False
    entry: int = 0


def _pieces(model: SpatialGPSampler, cdata: SubsetData, noise, k: int, c: int,
            chunk_size: Optional[int], ctx: _ProgramCtx) -> List[_Piece]:
    if ctx.mesh is not None:
        return _mesh_pieces(model, cdata, noise, k, c, chunk_size, ctx)
    if chunk_size is None or chunk_size >= k:
        return [_Piece(0, k * c, cdata, model._consts(cdata), noise, ctx)]
    if k % chunk_size != 0:
        raise ValueError(f"chunk_size {chunk_size} must divide K={k}")
    _require(noise, ("rows",), "chunk_size")
    out = []
    for lo in range(0, k * c, chunk_size * c):
        hi = lo + chunk_size * c
        d = cdata._replace(coords=cdata.coords[lo:hi], x=cdata.x[lo:hi],
                           y=cdata.y[lo:hi], mask=cdata.mask[lo:hi])
        out.append(_Piece(lo, hi, d, model._consts(d), noise.rows(range(lo, hi)), ctx))
    return out


def _mesh_pieces(model, cdata, noise, k, c, chunk_size, ctx) -> List[_Piece]:
    """The pieces of a meshed run: this process's ``k`` subsets laid
    contiguously over its entries of ``ctx.mesh``, each entry's block on
    its device, split into ``chunk_size / mesh.size`` subsets a piece
    when a ``chunk_size`` asks for it (the twin's chunk spans the whole
    mesh). A one-entry mesh on the data's device is one piece of the
    whole batch, the unmeshed computation."""
    mesh = ctx.mesh
    entries = mesh.local_entries()
    per = require_divisible_layout(k, len(entries))
    step = per
    if chunk_size is not None and chunk_size < ctx.k:
        step = require_divisible_layout(chunk_size, mesh.size, what="chunk_size")
        if per % step:
            raise ValueError(f"chunk_size {chunk_size} must divide K={ctx.k}")
    out = []
    for i, e in enumerate(entries):
        dev = torch.device(e.device)
        for lo in range(i * per * c, (i + 1) * per * c, step * c):
            hi = lo + step * c
            if (lo, hi) == (0, k * c) and dev == cdata.x.device:
                d = cdata
            else:
                d = cdata._replace(
                    coords=cdata.coords[lo:hi].to(dev), x=cdata.x[lo:hi].to(dev),
                    y=cdata.y[lo:hi].to(dev), mask=cdata.mask[lo:hi].to(dev),
                    coords_test=cdata.coords_test.to(dev), x_test=cdata.x_test.to(dev))
            out.append(_Piece(lo, hi, d, model._consts(d), noise, ctx, sliced=True, entry=i))
    return out


# L1 of the program store (smk_torch/compile/programs.py). Every program
# of the executor is acquired through `_cached_program`, as in the twin.
def _cached_program(model, key, build, **kw):
    """Program acquisition for one shape bucket: compile.programs
    .get_program (L1 table on the model, then the kernel libraries from
    L2, L3 or nvcc), recorded in ``stats``."""
    return compile_programs.get_program(model, key, build, **kw)


def _chunk_key(model, kind, length, k, chunk_size, m, q, p, t, d, mesh=None, phase=0):
    """Bucket key of one chunk program: (kind, chunk_len, K, chunk_size,
    m, q, p, t, d, n_chains, J, cov_model, link, fused_build, engine,
    n_neighbors, build_dtype, config digest, phase[, topology])."""
    return compile_programs.chunk_bucket_key(model, kind, length, k, chunk_size, m, q, p, t, d,
                                             mesh=mesh, phase=phase)


def _stats_key(model, k, m, q, p, mesh=None):
    # the guard's input is the carried state, shaped by (k, m, q, p)
    return compile_programs.aux_bucket_key(model, "stats", k, m, q, p, mesh=mesh)


def _finalize_key(model, k, m, q, n_kept, d_par, d_w, mesh=None):
    # d_par = n_params(q, p) covers p; d_w = t*q covers t
    return compile_programs.aux_bucket_key(model, "finalize", k, m, q, n_kept, d_par, d_w,
                                           mesh=mesh)


def _refork_key(model, k, m, q, p, mesh=None):
    # state-shaped like the stats program
    return compile_programs.aux_bucket_key(model, "refork", k, m, q, p, mesh=mesh)


def _owner(model: SpatialGPSampler, pc: _Piece) -> SpatialGPSampler:
    """The sampler that owns ``pc``'s programs: the model, or on a mesh
    entry's device other than the run's home its view for that device
    (parallel/executor.model_on)."""
    if pc.ctx.mesh is None:
        return model
    return model_on(model, pc.data.x.device, pc.ctx.mesh.home)


def _chunk_program(model: SpatialGPSampler, collect: bool, n: int, phase: int, pc: _Piece):
    """The chunk program of ``pc``'s bucket for ``n`` sweeps of
    ``phase`` (compile/programs.GraphProgram over the sampler's
    ``chunk_program``), owned by the piece's sampler (:func:`_owner`)."""
    ctx = pc.ctx
    data = pc.data
    _, m, q, p = data.x.shape
    t, d = data.coords_test.shape
    dev = data.x.device
    owner = _owner(model, pc)
    key = _chunk_key(model, "samp" if collect else "burn", n, ctx.k, ctx.chunk_size, m, q, p,
                     t, d, mesh=ctx.mesh, phase=phase)
    return _cached_program(
        owner, key,
        lambda: GraphProgram(owner.chunk_program(collect, n, phase), key, dev, owner=owner),
        store=ctx.store, stats=ctx.stats, libraries=model.kernel_libraries(data.x.dtype, dev),
        device=dev)


def _run_piece(model: SpatialGPSampler, kind: str, pc: _Piece, state: SamplerState,
               start: int, n: int, guard, nz: Optional[SweepNoise] = None):
    """Sweeps [start, start + n) of one piece: its bucket's chunk
    program replayed on the piece's data, the state, the chunk's noise
    (``nz``, or drawn here from the piece's source, sweep by sweep,
    before the program runs: models/probit_gp.chunk_noise) and its
    Robbins–Monro gains. ``guard``: the rows' guard counts in (None for
    none yet). Returns (state, draws, guard out), the guard None when the
    chunk cannot touch it."""
    collect = kind != "burn"
    data = pc.data
    phase = start % model.config.phi_update_every
    prog = _chunk_program(model, collect, n, phase, pc)
    g = None
    if model.chunk_touches_guard(phase, n):
        g = guard
        if g is None:
            g = torch.zeros(data.x.shape[0], dtype=torch.int32, device=data.x.device)
    if nz is None:
        nz = chunk_noise(pc.noise, start, n, collect)
    gains = model.chunk_gains(start, n, collect, data.x.dtype, data.x.device)
    return prog(data, pc.consts, state, nz, gains, g)


def _run_chunk(model: SpatialGPSampler, kind: str, pieces: Sequence[_Piece],
               state: SamplerState, start: int, n: int):
    """One chunk: sweeps [start, start + n) of every piece, burn-in
    (``kind="burn"``) or collecting, each piece through its bucket's
    chunk program (:func:`_run_piece`). Returns (state, draws), draws
    None for a burn-in chunk. The sampler's ``guard_rejects`` counts stay
    per row across pieces. A mesh's pieces take their rows of one draw of
    the chunk noise, move to their entries' devices and back to the
    state's, and run per device (parallel/executor.run_per_device:
    distinct devices at once). testing/faults.inject_subset_nan wraps
    this function while an injection is armed."""
    full = model.guard_rejects
    if len(pieces) == 1 and not pieces[0].sliced:
        st, dr, g = _run_piece(model, kind, pieces[0], state, start, n, full)
        if g is not None:
            model.guard_rejects = g
        return st, dr
    home = state[0].device
    nz_all = (chunk_noise(pieces[0].noise, start, n, kind != "burn")
              if pieces[0].sliced else None)

    def job(pc):
        dev = pc.data.x.device
        st = SamplerState(*(t[pc.lo:pc.hi].to(dev) for t in state))
        g = None if full is None else full[pc.lo:pc.hi].to(dev)
        nz = None if nz_all is None else SweepNoise(*(
            None if f is None else f[:, pc.lo:pc.hi].to(dev) for f in nz_all))
        st, dr, g_out = _run_piece(model, kind, pc, st, start, n, g, nz)
        return st, dr, g if g_out is None else g_out

    outs = run_per_device([(pc.data.x.device, lambda pc=pc: job(pc)) for pc in pieces])
    if len(outs) == 1 and outs[0][0][0].device == home:
        st, dr, g = outs[0]
        model.guard_rejects = g
        return st, dr
    guards = [o[2] for o in outs]
    model.guard_rejects = None if guards[0] is None else torch.cat([g.to(home) for g in guards])
    state = SamplerState(*(_cat_rows(fs, home) for fs in zip(*(o[0] for o in outs))))
    draws = [o[1] for o in outs if o[1] is not None]
    if not draws:
        return state, None
    return state, (torch.cat([d[0].to(home) for d in draws]),
                   torch.cat([d[1].to(home) for d in draws]))


def _cat_rows(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The row blocks ``parts`` (dim 0) as one tensor on ``device``, laid
    out in the first block's memory order, which is the order a
    one-piece run keeps (torch.cat would make it row-major): a batched
    product's kernel, and so its bits, follows its operands' strides, so
    a state gathered from a mesh's pieces, such as the factors cuSOLVER
    returns column-major, must keep the layout an unmeshed run gives
    it. One block moves as it is."""
    first = parts[0]
    if len(parts) == 1:
        return first.to(device)
    rows = first.shape[0]
    # a block whose rows are its outermost dimension, each row one dense
    # slab: the whole keeps the block's strides
    slab = rows > 0 and first.stride(0) * rows == first.numel() and all(
        first.stride(0) >= first.stride(d) for d in range(1, first.dim()) if first.shape[d] > 1)
    if not slab:
        return torch.cat([p.to(device) for p in parts])
    shape = (sum(p.shape[0] for p in parts),) + tuple(first.shape[1:])
    out = torch.empty_strided(shape, first.stride(), dtype=first.dtype, device=device)
    lo = 0
    for p in parts:
        out[lo:lo + p.shape[0]].copy_(p)
        lo += p.shape[0]
    return out


def _init_state(model: SpatialGPSampler, cdata: SubsetData, beta_init,
                pieces: Sequence[_Piece]) -> SamplerState:
    """The run's initial state on the data's device. A mesh's entries each
    start their own block on their device, at once
    (parallel/executor.run_per_device), and the rows are gathered: every
    entry runs its block from the start, as fit_subsets_sharded's
    entries do. An entry split into ``chunk_size`` pieces starts its
    block whole, as the block fitted alone with that ``chunk_size`` does.
    Otherwise the whole batch starts at once."""
    if not pieces[0].sliced:
        return model.init_state(cdata, beta_init,
                                consts=pieces[0].consts if pieces[0].data is cdata else None)
    home = cdata.x.device
    blocks: dict = {}
    for pc in pieces:
        blocks.setdefault(pc.entry, []).append(pc)

    def job(group):
        pc = group[0]
        dev = pc.data.x.device
        data, consts = pc.data, pc.consts
        if len(group) > 1:
            lo, hi = pc.lo, group[-1].hi
            data = pc.data._replace(coords=cdata.coords[lo:hi].to(dev), x=cdata.x[lo:hi].to(dev),
                                    y=cdata.y[lo:hi].to(dev), mask=cdata.mask[lo:hi].to(dev))
            consts = model._consts(data)
        return _owner(model, pc).init_state(
            data, None if beta_init is None else beta_init.to(dev), consts=consts)

    outs = run_per_device([(g[0].data.x.device, lambda g=g: job(g)) for g in blocks.values()])
    return SamplerState(*(_cat_rows(fs, home) for fs in zip(*outs)))


def _require(noise, ops, why: str) -> None:
    missing = [op for op in ops if not callable(getattr(noise, op, None))]
    if missing:
        raise ValueError(
            f"{why} needs a noise source with {', '.join(missing)} (as "
            "models/probit_gp.GeneratorNoise has)"
        )


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def fit_subsets_chunked(
    model: SpatialGPSampler,
    part,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    chunk_iters: int = 500,
    checkpoint_path: Optional[str] = None,
    chunk_size: Optional[int] = None,
    progress=None,
    stop_after_chunks: Optional[int] = None,
    nan_guard: bool = False,
    pipeline_stats: Optional[ChunkPipelineStats] = None,
    domain_map: Optional[FailureDomainMap] = None,
    mesh=None,
) -> Optional[SubsetResult]:
    """The K-subset fan-out as a host loop of ``chunk_iters``-sweep
    chunks (twin of ``fit_subsets_chunked``; ``noise`` stands where the
    twin takes its key: the K*C rows' noise source, default one
    generator per row seeded from 0).

    - ``checkpoint_path``: checkpoint after every chunk, burn-in chunks
      included; an interrupted call with the same arguments (a fresh
      noise source of the same seed) resumes from the last boundary,
      bitwise. A checkpoint of another config, noise stream or data is
      rejected.
    - ``chunk_size``: sweep the K subsets that many at a time inside
      each chunk (it must divide K).
    - ``progress``: callback(dict) after every chunk — phase ("burn" or
      "sample"), iteration, n_samples and the running phi acceptance
      rate. A callback that raises is warned about once and the run
      goes on; a :class:`ProgressAbort` stops it.
    - ``stop_after_chunks``: return None after that many chunks, with
      the checkpoint on disk (the kill-and-resume hook).
    - ``nan_guard``: after every chunk, raise :class:`SubsetNaNError`
      naming the subsets whose small state leaves are non-finite,
      before the checkpoint save.
    - ``pipeline_stats``: a ChunkPipelineStats the loop records into.
    - ``domain_map``: the failure domains quarantine attributes faults
      to (default :meth:`FailureDomainMap.derive`).
    - ``mesh``: a parallel/executor.Mesh. K (and ``chunk_size``) must
      divide over it (the layout oracle); each chunk program runs per
      entry block on the entry's device (distinct devices at once), the
      state and draws gathered on ``mesh.home``, the programs keyed under
      the mesh's topology fingerprint. A multi-process mesh runs this
      process's rows (executor.process_row_range) and returns them, and
      its ``checkpoint_path`` is the distributed checkpoint (format 8,
      parallel/checkpoint.py), a path every process shares. A ragged
      partition runs its RaggedMeshPlan.

    ``model.config.fault_policy="quarantine"`` turns the guard into the
    fault-isolation engine and makes resume lenient,
    ``chunk_pipeline="overlap"`` overlaps each boundary with the next
    chunk and writes the checkpoint in the background,
    ``watchdog=True`` puts each chunk under a deadline,
    ``live_diagnostics`` arms the streaming monitor,
    ``adaptive_schedule="on"`` the adaptive schedule, ``run_log_dir`` a
    run log (this call opens one unless ``pipeline_stats`` carries its
    caller's) and ``profile_dir`` a profiler window (module docstring). A
    :class:`~smk_torch.parallel.partition.PaddedPartition` runs through
    :func:`_fit_ragged_chunked`."""
    kw = dict(chunk_iters=chunk_iters, checkpoint_path=checkpoint_path,
              chunk_size=chunk_size, progress=progress,
              stop_after_chunks=stop_after_chunks, nan_guard=nan_guard,
              pipeline_stats=pipeline_stats, domain_map=domain_map, mesh=mesh)
    if isinstance(part, PaddedPartition):
        return _fit_ragged_chunked(model, part, coords_test, x_test, noise, beta_init, **kw)
    cfg = model.config
    if not cfg.run_log_dir or (pipeline_stats is not None
                               and pipeline_stats.run_log is not None):
        return _fit_subsets_chunked_impl(model, part, coords_test, x_test, noise, beta_init,
                                         **kw)
    # a run log of its own, root span "fit_subsets_chunked", closed on
    # every exit (inside fit_meta_kriging the caller's log is used)
    run_log = open_run_log(cfg.run_log_dir, name="fit_subsets_chunked", meta={
        "n_subsets": part.n_subsets, "n_samples": cfg.n_samples, "chunk_iters": chunk_iters,
        "chunk_pipeline": cfg.chunk_pipeline, "fault_policy": cfg.fault_policy})
    kw["pipeline_stats"] = pstats = pipeline_stats or ChunkPipelineStats()
    pstats.run_log = run_log
    try:
        with run_log.span("fit_subsets_chunked", n_subsets=part.n_subsets):
            return _fit_subsets_chunked_impl(model, part, coords_test, x_test, noise,
                                             beta_init, **kw)
    finally:
        run_log.close()


def _n_work_chunks(pstats: ChunkPipelineStats) -> int:
    """Chunks recorded so far (the ragged fan-out's budget ledger)."""
    return sum(1 for c in pstats.chunks if c.get("phase") != "drain")


def _group_ess_final(pstats: ChunkPipelineStats, start: int) -> Optional[float]:
    """The last total streaming ESS a group's chunks recorded (None
    without live diagnostics), summed over groups by
    ``ChunkPipelineStats.aggregate``."""
    vals = [ch["live_ess_sum"] for ch in pstats.chunks[start:]
            if ch.get("live_ess_sum") is not None]
    return vals[-1] if vals else None


def _remap_fault_events(pstats: ChunkPipelineStats, start: int, ids: list) -> None:
    """Rewrite the fault events a group fit recorded (group rows) into
    original subset indices."""
    for ev in pstats.fault_events[start:]:
        for fld in ("retried", "dropped", "deferred"):
            if fld in ev:
                ev[fld] = [ids[j] for j in ev[fld]]
        if "attempts" in ev:
            ev["attempts"] = {ids[j]: n for j, n in ev["attempts"].items()}


def _fit_ragged_chunked(
    model: SpatialGPSampler,
    part: PaddedPartition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    chunk_iters: int = 500,
    checkpoint_path: Optional[str] = None,
    chunk_size: Optional[int] = None,
    progress=None,
    stop_after_chunks: Optional[int] = None,
    nan_guard: bool = False,
    pipeline_stats: Optional[ChunkPipelineStats] = None,
    domain_map: Optional[FailureDomainMap] = None,
    mesh=None,
) -> Optional[SubsetResult]:
    """The ragged fan-out (twin of ``_fit_ragged_chunked``): one ordinary
    chunked fit per occupied bucket, in ascending bucket order, stitched
    back into original subset order.

    - Each group draws the noise rows of its GLOBAL subset ids
      (``noise.rows``, at the group's bucket size), so a subset's chain
      depends on its index and data only: a PaddedPartition whose
      subsets share one exact bucket is bitwise the plain Partition fit.
    - Each group checkpoints to ``<path>.bNNNNN``; a resume replays only
      the groups the kill interrupted.
    - SubsetNaNError ids and the fault events come back as original
      subset indices.
    - ``stop_after_chunks`` budgets the whole run, not a group.

    On a ``mesh`` the units are the entries of the RaggedMeshPlan
    (compile/buckets.plan_ragged_mesh), each run on its prefix sub-mesh:
    a group K-padded with clones of its first real subset (fed that
    subset's numbers, _PaddedNoise, as the twin's pads carry its keys;
    dropped at the stitch), or small groups fused at the largest member
    bucket. ``pstats.ragged_mesh_plan`` records the plan. A one-entry
    mesh's plan is the identity, bitwise the host path. A ``chunk_size``
    that does not fit an entry's own layout is dropped for that entry."""
    if domain_map is not None:
        raise ValueError(
            "domain_map is derived per bucket group on a ragged fit — an explicit "
            "map cannot span groups of different K"
        )
    cfg = model.config
    k_total = part.n_subsets
    if noise is None:  # one generator per (subset, chain) row, seeded from 0
        g0 = part.groups[0].part
        shapes = sweep_shapes(cfg, k_total, max(part.buckets), *g0.x.shape[2:],
                              coords_test.shape[0], model.weight)
        noise = GeneratorNoise(subset_generators(0, shapes.k, g0.x.device), shapes,
                               dtype=g0.x.dtype, device=g0.x.device)
    _require(noise, ("rows",), "a ragged partition")
    pstats = pipeline_stats
    run_log = pstats.run_log if pstats is not None else None
    opened_log = None
    if run_log is None and cfg.run_log_dir:
        opened_log = run_log = open_run_log(cfg.run_log_dir, name="fit_subsets_ragged", meta={
            "n_subsets": k_total, "buckets": list(part.buckets), "sizes": list(part.sizes),
            "n_samples": cfg.n_samples, "chunk_iters": chunk_iters})
    if pstats is None and (run_log is not None or stop_after_chunks is not None):
        pstats = ChunkPipelineStats()
    if run_log is not None:
        pstats.run_log = run_log
    plan = None
    if mesh is not None:
        plan = plan_ragged_mesh([g.bucket for g in part.groups],
                                [len(g.subset_ids) for g in part.groups], mesh.size)
        if pstats is not None:
            pstats.ragged_mesh_plan = plan.summary()
    try:
        with (run_log.span("fit_subsets_ragged", n_subsets=k_total, buckets=list(part.buckets))
              if run_log is not None else contextlib.nullcontext()):
            out = _ragged_groups(model, part, coords_test, x_test, noise, beta_init,
                                 pstats, run_log, chunk_iters=chunk_iters,
                                 checkpoint_path=checkpoint_path, chunk_size=chunk_size,
                                 progress=progress, stop_after_chunks=stop_after_chunks,
                                 nan_guard=nan_guard, mesh=mesh, plan=plan)
    finally:
        if opened_log is not None:
            opened_log.close(pipeline=pstats.aggregate())
    return out


def _ragged_groups(model, part, coords_test, x_test, noise, beta_init, pstats, run_log, *,
                   chunk_iters, checkpoint_path, chunk_size, progress, stop_after_chunks,
                   nan_guard, mesh=None, plan=None):
    """The units of :func:`_fit_ragged_chunked` (bucket groups, or the
    plan's entries on a mesh), one after another, each under a
    ``bucket_group`` span of the run log."""
    c = model.config.n_chains
    group_results, ragged_groups, guards = [], [], []
    remaining = stop_after_chunks
    units = list(part.groups) if plan is None else list(plan.entries)
    for gi, u in enumerate(units):
        model.guard_rejects = None  # the sampler's guard counts are per group
        if plan is None:
            upart, ids, umesh, k_real, pad_k, ucs = (
                u.part, list(u.subset_ids), None, len(u.subset_ids), 0, chunk_size)
        else:
            upart, ids = ragged_mesh_entry_partition(part, u)
            umesh, k_real, pad_k = sub_mesh(mesh, u.n_devices), u.k_real, u.pad_k
            ucs = chunk_size
            if chunk_size is not None and (u.padded_k % chunk_size
                                           or not fits_layout(chunk_size, u.n_devices)):
                ucs = None
        gnoise = noise.rows([j * c + ch for j in ids for ch in range(c)], m=u.bucket)
        if pad_k:
            gnoise = _PaddedNoise(gnoise, pad_k * c, c)
        gpath = None if checkpoint_path is None else f"{checkpoint_path}.b{u.bucket:05d}"
        gprog = None
        if progress is not None:
            def gprog(info, _b=u.bucket, _ids=tuple(ids)):
                progress({**info, "bucket": _b, "subset_ids": list(_ids)})
        chunks_before = _n_work_chunks(pstats) if pstats is not None else 0
        entries_before = len(pstats.chunks) if pstats is not None else 0
        faults_before = len(pstats.fault_events) if pstats is not None else 0
        try:
            with (run_log.span("bucket_group", bucket=u.bucket, n_subsets=len(ids))
                  if run_log is not None else contextlib.nullcontext()):
                res = _fit_subsets_chunked_impl(
                    model, upart, coords_test, x_test, gnoise, beta_init,
                    chunk_iters=chunk_iters, checkpoint_path=gpath, chunk_size=ucs,
                    progress=gprog, stop_after_chunks=remaining, nan_guard=nan_guard,
                    pipeline_stats=pstats, domain_map=None, mesh=umesh,
                )
        except SubsetNaNError as e:
            # a K-pad clone row names its source, the entry's first subset
            gl = list(dict.fromkeys(ids[j] if j < len(ids) else ids[0] for j in e.subset_ids))
            raise SubsetNaNError(gl, e.iteration) from e
        if pstats is not None:
            _remap_fault_events(pstats, faults_before, ids + [-1] * pad_k)
            rec = {"bucket": int(u.bucket), "n_subsets": k_real,
                   "live_ess_sum_final": _group_ess_final(pstats, entries_before)}
            if plan is not None:
                rec.update(group_ids=list(u.group_ids), padded_k=u.padded_k,
                           n_devices=u.n_devices, fused=u.fused)
            ragged_groups.append(rec)
            pstats.ragged_groups = ragged_groups
        guard = model.guard_rejects
        if res is not None and pad_k:
            # the plan's K-pad clones are invisible downstream
            res = SubsetResult(*(f[:k_real] for f in res))
            guard = None if guard is None else guard[:k_real * c]
        guards.append(guard)
        if res is None:
            return None
        if remaining is not None:
            remaining -= _n_work_chunks(pstats) - chunks_before
            if remaining <= 0 and gi < len(units) - 1:
                return None
        group_results.append(res)
    # stitch: result row j is subset j, guard row j * C + ch its chain ch
    order = np.asarray([j for u in units for j in (
        u.subset_ids if plan is None
        else [i for g in u.group_ids for i in part.groups[g].subset_ids])])
    dev = group_results[0].param_grid.device
    inv = torch.as_tensor(np.argsort(order), device=dev)
    if guards[0] is not None:
        rows = (order[:, None] * c + np.arange(c)).reshape(-1)
        model.guard_rejects = torch.cat(guards)[torch.as_tensor(np.argsort(rows), device=dev)]
    return SubsetResult(*(torch.cat(f)[inv] for f in zip(*group_results)))


def _on_mesh(model, part, coords_test, x_test, noise, beta_init, domain_map, mesh, *,
             chunk_size):
    """A meshed run's inputs: the layout checks (K and ``chunk_size``
    over the mesh, the twin's), the data on ``mesh.home``, and under a
    multi-process mesh this process's rows alone, with their noise rows
    and their failure domains (its checkpoint is then format 8)."""
    cfg = model.config
    k = part.n_subsets
    c = cfg.n_chains
    require_divisible_layout(k, mesh.size)
    if chunk_size is not None:
        # each step runs chunk_size subsets over the whole mesh
        require_divisible_layout(chunk_size, mesh.size, what="chunk_size")
    home = mesh.home
    part = Partition(*(t.to(home) for t in part))
    coords_test, x_test = coords_test.to(home), x_test.to(home)
    if beta_init is not None:
        beta_init = beta_init.to(home)
    if not mesh.multi_process:
        return part, coords_test, x_test, noise, beta_init, domain_map
    if domain_map is not None:
        raise ValueError("a multi-process mesh derives its failure domains from the mesh")
    lo, hi = process_row_range(k, mesh)
    if noise is None:  # the whole run's rows, seeded from 0, then this process's
        noise = model.default_noise(stacked_subset_data(part, coords_test, x_test))
    _require(noise, ("subset",), "a multi-process mesh")
    domain_map = FailureDomainMap.derive(k, mesh).restrict(lo, hi)
    part = Partition(*(t[lo:hi] for t in part))
    return part, coords_test, x_test, noise.subset(lo * c, hi * c), beta_init, domain_map


def _fit_subsets_chunked_impl(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    chunk_iters: int = 500,
    checkpoint_path: Optional[str] = None,
    chunk_size: Optional[int] = None,
    progress=None,
    stop_after_chunks: Optional[int] = None,
    nan_guard: bool = False,
    pipeline_stats: Optional[ChunkPipelineStats] = None,
    domain_map: Optional[FailureDomainMap] = None,
    mesh=None,
) -> Optional[SubsetResult]:
    """The equal-m executor (see :func:`fit_subsets_chunked`)."""
    cfg = model.config
    if chunk_iters < 1:
        raise ValueError(f"chunk_iters must be >= 1, got {chunk_iters}")
    k_key = part.n_subsets  # the K of the bucket keys: the whole run's
    c = cfg.n_chains
    if mesh is not None:
        part, coords_test, x_test, noise, beta_init, domain_map = _on_mesh(
            model, part, coords_test, x_test, noise, beta_init, domain_map, mesh,
            chunk_size=chunk_size)
    k = part.n_subsets
    # this process's first subset in the run's numbering (0 but on a
    # multi-process mesh, where k is this process's rows of the K)
    lo = process_row_range(k_key, mesh)[0] if mesh is not None else 0
    data = stacked_subset_data(part, coords_test, x_test)
    dev, dtype = part.x.device, part.x.dtype
    if noise is None:
        noise = model.default_noise(data)
    mode = cfg.chunk_pipeline
    policy_q = cfg.fault_policy == "quarantine"
    adaptive = cfg.adaptive_schedule == "on"
    live_on = cfg.live_diagnostics
    if policy_q:
        _require(noise, ("snapshot", "restore", "fork"), "fault_policy='quarantine'")
    # the checkpoint's format: format 8 (parallel/checkpoint.py) under a
    # multi-process mesh, under the testing hook, or to resume a format-8
    # checkpoint (the elastic resume onto one process); format 7 otherwise
    use_v8 = checkpoint_path is not None and (
        (mesh is not None and mesh.multi_process) or dist_ckpt.FORCE_DISTRIBUTED_FOR_TESTING
        or (os.path.exists(checkpoint_path)
            and dist_ckpt.is_distributed_manifest(checkpoint_path)))
    if adaptive and use_v8:
        raise NotImplementedError(
            "adaptive_schedule='on' is not supported with the distributed checkpoint (format "
            "8, a multi-process mesh): the scheduler sidecar and the full-K state merge are "
            "single-process operations — run the fixed schedule, or checkpoint adaptively "
            "in a single process")
    if checkpoint_path is not None:
        _require(noise, ("snapshot", "restore", "identity") + (("rows",) if use_v8 else ()),
                 "checkpoint_path")
    n_burn = cfg.n_burn_in
    n_kept = cfg.n_samples - n_burn
    if adaptive:
        if chunk_size is not None:
            raise ValueError(
                "adaptive_schedule='on' is incompatible with chunk_size: the inner "
                "batching bakes a fixed K into the chunk, and active-set compaction "
                "changes it mid-run — drop chunk_size or run the fixed schedule"
            )
        _require(noise, ("rows",), "adaptive_schedule='on'")
        # one scheduler over all K on every process: under a mesh every
        # compaction rung is a device multiple, the rung its budget
        # ledger charges whatever the layout of the group
        sched = AdaptiveScheduler(cfg, k=k_key, n_kept=n_kept, chunk_iters=chunk_iters,
                                  n_devices=mesh.size if mesh is not None else 1)
        n_cap = sched.n_cap
    else:
        sched = None
        n_cap = n_kept
    run_log = pipeline_stats.run_log if pipeline_stats is not None else None
    cdata = model.chain_data(data)
    # every chunk runs its bucket's program (compile/programs.py), the
    # kernel libraries from the L2 store when the config names one
    store = compile_programs.store_from_config(cfg, mesh)
    if store is not None:
        # before anything launches a kernel (the initial state's build)
        cuda_build.ensure(model.kernel_libraries(dtype, dev), store)
    ctx = _ProgramCtx(store, pipeline_stats, k_key, chunk_size, mesh)
    pieces = _pieces(model, cdata, noise, k, c, chunk_size, ctx)
    m_sub, q_dim, p_dim = part.x.shape[1:]
    d_par = n_params(*part.x.shape[2:])
    d_w = coords_test.shape[0] * part.x.shape[2]
    # the whole run's K (k is this process's rows under a multi-process mesh)
    meta = np.asarray([cfg.n_samples, n_burn, k_key, d_par, d_w, c], np.int64)

    if domain_map is None:
        domain_map = FailureDomainMap.derive(k, mesh)
    elif domain_map.k != k:
        raise ValueError(
            f"domain_map covers {domain_map.k} subsets but the partition has K={k}"
        )
    attempts = np.zeros(k, np.int64)
    dead = np.zeros(k, bool)
    domain_attempts = np.zeros(domain_map.n_domains, np.int64)
    domain_dead = np.zeros(domain_map.n_domains, bool)
    domain_arr = np.asarray(domain_map.domain_of_subset, np.int64)
    pstats = pipeline_stats
    if pstats is not None:
        pstats.mode = mode
        pstats.fault_policy = cfg.fault_policy
        if domain_map.n_domains > 1:
            pstats.domain_of_subset = domain_arr.tolist()

    def fault_snapshot():
        return (attempts.copy(), dead.astype(np.int64), domain_arr.copy(),
                domain_attempts.copy(), domain_dead.astype(np.int64))

    opts = dict(dtype=dtype, device=dev)
    param_draws = torch.zeros((k * c, n_cap, d_par), **opts)
    w_draws = torch.zeros((k * c, n_cap, d_w), **opts)
    writer = BackgroundWriter() if mode == "overlap" and checkpoint_path is not None else None
    ck = None

    def draws_np(filled):
        # the sanctioned full fetch of the filled draws region: only the
        # degraded writer's recovery and a resume's compaction pay it
        with explicit_d2h("checkpoint_full_rewrite"):
            return param_draws[:, :filled].cpu().numpy(), w_draws[:, :filled].cpu().numpy()

    if use_v8:
        layout = dist_ckpt.ShardLayout.current(k_key, mesh)
        ident = dist_ckpt.distributed_run_identity(cfg, noise, data, beta_init, layout,
                                                   timeout_s=cfg.ckpt_commit_timeout_s)
        ck = dist_ckpt.DistributedCheckpoint(
            checkpoint_path, meta, ident, layout, writer=writer, pstats=pstats,
            local_draws=draws_np, fault_src=fault_snapshot,
            commit_timeout_s=cfg.ckpt_commit_timeout_s, run_log=run_log)
    elif checkpoint_path is not None:
        ident = _run_identity(cfg, noise, data, beta_init)
        ck = _SegmentedCheckpoint(checkpoint_path, meta, ident, writer=writer, pstats=pstats,
                                  full_draws=draws_np, fault_src=fault_snapshot)

    def adopt_fault_bookkeeping(src) -> None:
        attempts[:] = np.asarray(src["fault_attempts"], np.int64)
        dead[:] = np.asarray(src["fault_dead"], np.int64) != 0
        ck_dom = np.asarray(src["fault_domain"], np.int64)
        ck_dom_att = np.asarray(src["fault_domain_attempts"], np.int64)
        ck_dom_dead = np.asarray(src["fault_domain_dead"], np.int64)
        if (ck_dom.shape[0] == k and np.array_equal(ck_dom, domain_arr)
                and ck_dom_att.shape[0] == domain_map.n_domains):
            domain_attempts[:] = ck_dom_att
            domain_dead[:] = ck_dom_dead != 0
        else:
            warnings.warn(
                "elastic resume: the checkpoint was written under a different "
                f"failure-domain topology ({ck_dom_att.shape[0]} domains) than the "
                f"current one ({domain_map.n_domains}); per-subset deaths persist and "
                "the per-domain retry ladders reset",
                RuntimeWarning, stacklevel=3,
            )

    holes: list = []
    host = None
    if use_v8 and os.path.exists(checkpoint_path):
        # the last committed generation: this process's rows, read from
        # its own shards, or assembled from every shard on another
        # topology (parallel/checkpoint.DistributedCheckpoint.load)
        loaded = ck.load(state_like=SamplerState(*([np.zeros(0)] * len(SamplerState._fields))),
                         noise_like=noise.snapshot(),
                         dtype=torch.empty(0, dtype=dtype).numpy().dtype, d_par=d_par,
                         d_w=d_w, lenient=policy_q)
        it = loaded["it"]
        filled = ck.filled
        if filled != max(0, it - n_burn):
            raise ValueError(
                f"checkpoint {checkpoint_path} is inconsistent: manifest covers {filled} "
                f"kept draws but the iteration counter {it} implies {max(0, it - n_burn)}"
            )
        holes = loaded["holes"]
        adopt_fault_bookkeeping(loaded)
        host = loaded["state"]
        state = _device_state(host, dev)
        noise.restore(loaded["noise"])
        if loaded["param"] is not None:
            with explicit_h2d("checkpoint_restore"):
                param_draws[:, :filled] = torch.as_tensor(loaded["param"], device=dev)
                w_draws[:, :filled] = torch.as_tensor(loaded["w"], device=dev)
        del loaded
    elif checkpoint_path is not None and os.path.exists(checkpoint_path):
        like = {
            "state": SamplerState(*([np.zeros(0)] * len(SamplerState._fields))),
            "layout": SamplerState(*([np.zeros(0)] * len(SamplerState._fields))),
            "noise": noise.snapshot(),
            **dict.fromkeys(("it", "meta", "ident", "version", "seg_base", "n_segments",
                             "filled", "fault_attempts", "fault_dead", "fault_domain",
                             "fault_domain_attempts", "fault_domain_dead"), np.zeros(0)),
        }
        try:
            ckpt = load_pytree(checkpoint_path, like)
        except ValueError as e:
            raise ValueError(
                f"checkpoint {checkpoint_path} does not match the current checkpoint "
                f"format v{CKPT_VERSION} of smk_torch (a manifest with the carried state, "
                "the noise snapshot, the counters, the run identity and the fault "
                "ledger) — it was written by another build, another package or for a "
                "different run shape; delete the file or pass a fresh checkpoint_path"
            ) from e
        if int(np.asarray(ckpt["version"])[0]) != CKPT_VERSION:
            raise ValueError(
                f"checkpoint {checkpoint_path} has format version "
                f"{int(np.asarray(ckpt['version'])[0])}, expected {CKPT_VERSION} — "
                "delete the file or re-run"
            )
        if not np.array_equal(np.asarray(ckpt["meta"]), meta):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different run: meta "
                f"{np.asarray(ckpt['meta'])} vs expected {meta}"
            )
        if not np.array_equal(np.asarray(ckpt["ident"]), ck.ident):
            raise ValueError(
                f"checkpoint {checkpoint_path} was written for a different run: "
                "config/noise/data fingerprint mismatch — same shapes, different chain; "
                "delete the file or pass a different checkpoint_path"
            )
        it = int(np.asarray(ckpt["it"])[0])
        seg_base = int(np.asarray(ckpt["seg_base"])[0])
        n_seg = int(np.asarray(ckpt["n_segments"])[0])
        filled = int(np.asarray(ckpt["filled"])[0])
        if filled != max(0, it - n_burn):
            raise ValueError(
                f"checkpoint {checkpoint_path} is inconsistent: manifest covers {filled} "
                f"kept draws but the iteration counter {it} implies {max(0, it - n_burn)}"
            )
        adopt_fault_bookkeeping(ckpt)
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        if policy_q:
            # lenient: a corrupt, truncated or missing segment is a hole,
            # re-sampled by the fill chunks planned below
            param_np, w_np, holes = _read_segments_lenient(
                checkpoint_path, seg_base, n_seg, filled, np_dtype, (k * c,), d_par, d_w)
        else:
            param_np, w_np = _read_segments(checkpoint_path, seg_base, n_seg, filled,
                                            np_dtype)
        host = _HostState(ckpt["state"], ckpt["layout"])
        state = _device_state(host, dev)
        noise.restore(ckpt["noise"])
        if filled > 0:
            with explicit_h2d("checkpoint_restore", nbytes=param_np.nbytes + w_np.nbytes):
                param_draws[:, :filled] = torch.as_tensor(param_np, device=dev)
                w_draws[:, :filled] = torch.as_tensor(w_np, device=dev)
        ck.adopt(seg_base, n_seg, filled)
        if n_seg > 1 and not holes:
            # compacting a holed region would bake its zeros into a clean
            # segment; the refill's closing rewrite compacts instead
            ck.compact(host, ckpt["noise"], param_np, w_np, it, filled)
        del ckpt
    else:
        state = _init_state(model, cdata, beta_init, pieces)
        it = 0

    # ---- the adaptive regime ------------------------------------------
    # The chunks sweep a compacted dispatch group: the live subsets
    # ("members", frozen riders included until the rung shrinks) padded
    # to their rung with clones of the first member. The draw buffers and
    # the checkpoint stay K wide (the scatter drops pad and rider rows),
    # and a host mirror of the K*C-row state (``state_full``, each leaf in
    # its memory order, as a manifest holds it) keeps every subset's
    # stop-time rows; it is brought up to date from the group where a
    # regroup, a manifest or the finalize needs it. The noise is not in
    # the state: the group draws from its members' rows of the source
    # (``noise.rows``, shared, so a departed subset's stream waits where
    # it stopped and a rider's advances), and a pad is fed its first
    # member's numbers (_PaddedNoise), as the twin's pad carries a clone
    # of that member's key.
    #
    # The scheduler speaks the run's subset numbers (0..K-1) and charges
    # the group's rung over the whole mesh (``g_members``, ``g_kc``,
    # ``g_written``). On a multi-process mesh each process dispatches
    # its own survivors alone (``members``, its row numbers), padded to a
    # rung over its own entries (``kc``), which may be empty while
    # another process samples on; with one process the two views are
    # the same. Each boundary's statistics and guard verdicts are
    # gathered over the process group whenever one is up, so every
    # process folds the same (K,) vectors and applies the same decision.
    members: list = list(range(k))
    kc = k
    g_members: list = list(range(k_key))
    g_kc = k_key
    g_written: tuple = tuple(range(k_key))
    chunk_noise = noise
    state_full: Optional[_HostState] = None
    full_fresh = False
    guard_full = None
    last_group: list = []  # the group the run ended with, once it is empty
    write_members: tuple = tuple(range(k))
    write_dst = write_src = write_mask_dev = None
    adaptive_done = False
    sched_saved: list = [None]
    regroup_s: list = []
    n_local_entries = len(mesh.local_entries()) if mesh is not None else 1
    # the gather needs the mesh to span the job's processes (a world of
    # one included); replicas that each fit a one-process mesh share nothing
    gather_on = (adaptive and mesh is not None and distributed.backend_name() is not None
                 and len(mesh.process_indices) == distributed.process_count())
    ranges = all_process_row_ranges(k_key, mesh) if gather_on else [(0, k_key)]
    gather_s: list = []
    sweep_s = [0.0]  # the slowest sweep of this process's own chunks, dispatch to boundary

    def batch_rows(slots):
        return [j * c + ch for j in slots for ch in range(c)]

    def local_rung(n_local: int) -> int:
        # the twin's rung over this process's rows and entries (the
        # scheduler's own rung when this process holds the whole run)
        return compaction_rung(n_local, k, n_local_entries) if n_local else 0

    def process_rungs() -> list:
        """Each process's dispatch-group size for ``g_members``: its
        survivors on a rung over its rows and entries."""
        out = []
        for p, (a, b_) in zip(mesh.process_indices, ranges):
            n_p = sum(1 for j in g_members if a <= j < b_)
            e_p = sum(1 for e in mesh.devices.flat if e.process_index == p)
            out.append(compaction_rung(n_p, b_ - a, e_p) if n_p else 0)
        return out

    def boundary_gather(b, verdict: int, finite, live_rh, live_es):
        """Boundary ``b``'s agreement over the process group: each
        process's guard verdict (0 clean, 1 a quarantine rewind, 2 a
        ``nan_guard`` abort), its rows' finite flags and its rows of the
        streaming statistics (None at a boundary without them), each
        placed in the run's subset order. Returns (the largest verdict,
        the (K,) finite flags, R-hat and ESS). The wait is the commit
        deadline (``ckpt_commit_timeout_s``) plus the chunk at this
        process's slowest sweep: a process whose group has emptied waits
        out a peer's whole chunk."""
        t0 = monotonic()
        mine = [[float(verdict)], finite] + ([] if live_rh is None else [live_rh, live_es])
        parts = [np.frombuffer(b_, np.float64) for b_ in distributed.allgather_bytes(
            "adaptive_boundary", np.concatenate(mine).astype(np.float64).tobytes(),
            timeout_s=cfg.ckpt_commit_timeout_s + sweep_s[0] * b["n"])]
        gather_s.append(monotonic() - t0)
        out = np.full((3, k_key), np.nan)
        for p_, (a, b_) in zip(parts, ranges):
            cols = p_[1:].reshape(-1, b_ - a)
            out[:len(cols), a:b_] = cols
        return (int(max(p_[0] for p_ in parts)), out[0] > 0.5,
                *((None, None) if live_rh is None else (out[1], out[2])))

    def merge_state_full(staged: Optional[_HostState] = None):
        """Bring ``state_full`` up to date with the group's member rows:
        from ``staged``, a saving boundary's pinned copy of the group's
        state read after the boundary's wait, or else by one
        synchronising fetch of the group's state."""
        nonlocal state_full, full_fresh
        if full_fresh or not members:
            return
        if staged is None:
            with explicit_d2h("adaptive_state_merge"):
                live = _host_state(state)
        else:
            live = staged
        if state_full is None:  # the first merge: the group is the whole run
            # a staged copy lives in a buffer the next boundary refills
            state_full = live if staged is None else _HostState(
                SamplerState(*(a.copy() for a in live.arrays)), live.layout)
        else:
            _merge_rows(state_full, live, batch_rows(members))
        merge_guards(members)
        full_fresh = True

    def merge_guards(slots):
        """The group's guard counts (``model.guard_rejects``, group rows)
        into the K*C-row ``guard_full``, for the member ``slots``."""
        nonlocal guard_full
        if model.guard_rejects is None:
            return
        if guard_full is None:
            guard_full = torch.zeros(k * c, dtype=model.guard_rejects.dtype, device=dev)
        with explicit_h2d("adaptive_regroup"):
            rows_t = torch.as_tensor(batch_rows(slots), device=dev)
        guard_full[rows_t] = model.guard_rejects[:rows_t.numel()]

    def set_write_group():
        """The scatter's rows and the stream's mask for the current group:
        members that are not frozen write, pads and frozen riders do
        not."""
        nonlocal write_members, write_dst, write_src, write_mask_dev, g_written
        frozen = sched.frozen
        g_written = tuple(j for j in g_members if not frozen[j])
        writing = [(r, j) for r, j in enumerate(members) if not frozen[lo + j]]
        write_members = tuple(j for _, j in writing)
        wm = np.zeros(k, bool)
        wm[list(write_members)] = True
        with explicit_h2d("adaptive_regroup"):
            write_src = torch.as_tensor(batch_rows([r for r, _ in writing]), dtype=torch.long,
                                        device=dev)
            write_dst = torch.as_tensor(batch_rows([j for _, j in writing]), dtype=torch.long,
                                        device=dev)
            write_mask_dev = torch.as_tensor(wm, device=dev)

    def apply_group(new_members):
        """(Re)form the dispatch group from ``state_full``: the state and
        data rows of this process's ``new_members`` (the run's subset
        numbers) padded to the rung with clones of the first. A reopened
        subset resumes from its stop-time rows and its stream from where
        it stopped."""
        nonlocal state, pieces, members, kc, chunk_noise, full_fresh, last_group, g_members
        nonlocal g_kc
        t0 = monotonic()
        g_members = [int(j) for j in new_members]
        g_kc = sched.rung(len(g_members)) if g_members else 0
        if not g_members:
            # the run ends: the finalize reads this group's rows from the
            # live state, so nothing is fetched
            last_group, members, kc = list(members), [], 0
            regroup_s.append(monotonic() - t0)
            return
        merge_state_full()
        members = [j - lo for j in g_members if lo <= j < lo + k]
        kc = local_rung(len(members))
        if members:
            group = members + [members[0]] * (kc - len(members))
            rows = np.asarray(batch_rows(group), np.int64)
            gathered = [np.take(full, rows, axis=_row_axis(fp))
                        for full, fp in zip(state_full.arrays, state_full.layout)]
            state = _device_state(_HostState(SamplerState(*gathered), state_full.layout), dev,
                                  tag="adaptive_regroup")
            with explicit_h2d("adaptive_regroup"):
                sel = torch.as_tensor(group, device=dev)
                rows_dev = torch.as_tensor(rows, device=dev)
            gdata = data._replace(coords=data.coords[sel], x=data.x[sel], y=data.y[sel],
                                  mask=data.mask[sel])
            g_cdata = model.chain_data(gdata)
            chunk_noise = _PaddedNoise(noise.rows(batch_rows(members)), (kc - len(members)) * c,
                                       c)
            # the compacted group over the same pieces the fixed schedule
            # uses: on a mesh, kc (a multiple of this process's entries)
            # laid over its entries
            pieces = _pieces(model, g_cdata, chunk_noise, kc, c, None, ctx._replace(k=kc))
            if guard_full is not None:
                model.guard_rejects = guard_full[rows_dev]
        else:
            # every subset of this process has left the group while
            # another process samples on: its rows wait in the host
            # mirror, and its chunks dispatch nothing until a reopen
            last_group, state, pieces = [], None, []
        set_write_group()
        full_fresh = True
        regroup_s.append(monotonic() - t0)
        if mesh is not None:
            # the shrunken group replanned onto the unchanged mesh: g_kc
            # is a device multiple, so the plan is one full-mesh entry;
            # the rung's pad waste (the rows its ledger charges) is
            # reported apart from the m-axis pad. On a multi-process mesh
            # each process dispatches its own survivors on its own rung:
            # the rows dispatched and their pad waste are reported too
            mplan = plan_ragged_mesh([m_sub], [g_kc], mesh.size)
            if run_log is not None:
                layout = {}
                if mesh.multi_process:
                    pk = process_rungs()
                    layout = dict(process_kc=pk,
                                  dispatch_pad_waste_frac=(sum(pk) - len(g_members)) / sum(pk))
                run_log.event("adaptive_mesh_replan", kc=g_kc, n_active=len(g_members),
                              entries=len(mplan.entries),
                              rung_pad_waste_frac=(g_kc - len(g_members)) / g_kc,
                              **layout)

    if adaptive:
        if holes:
            raise ValueError(
                "adaptive_schedule='on' cannot resume a checkpoint with corrupt draw "
                "segments (lenient holes): the scheduler's row-validity map cannot "
                "attribute refilled rows — delete the checkpoint, or resume with "
                "adaptive_schedule='off'"
            )
        spath = None if checkpoint_path is None else sidecar_path(checkpoint_path, "sched")
        if spath is not None and os.path.exists(spath):
            blobs = load_sidecar(checkpoint_path, "sched")
            snaps = [{n_[len(pfx):]: v for n_, v in blobs.items() if n_.startswith(pfx)}
                     for pfx in ("cur_", "prev_")]
            # adopt the snapshot written at the manifest's boundary (the
            # sidecar keeps that boundary and the one before it, so a
            # crash between sidecar and manifest still pairs exactly)
            adopted = next((sn for sn in snaps
                            if sn and int(np.asarray(sn["ledger"])[4]) == it), None)
            if adopted is not None:
                sched.restore_arrays(adopted)
                sched_saved[0] = sched.to_arrays()
            elif max(0, it - n_burn) > 0:
                raise ValueError(
                    f"checkpoint {checkpoint_path} does not pair with its scheduler "
                    f"sidecar (manifest iteration {it} matches neither sidecar snapshot) "
                    "— the sidecar is written before every manifest and keeps one "
                    "boundary of history, so this pairing cannot come from one run; "
                    "delete both and restart"
                )
        elif max(0, it - n_burn) > 0:
            raise ValueError(
                f"checkpoint {checkpoint_path} has kept draws but no scheduler sidecar "
                f"({spath}) — it was written by a fixed-schedule run (adaptive schedules "
                "change run identity; cross-policy resume is rejected) or the sidecar "
                "was deleted"
            )
        if host is not None:
            state_full = _HostState(
                SamplerState(*(np.require(a, requirements="W") for a in host.arrays)),
                host.layout)
            full_fresh = True
        # the group the uninterrupted run had at this boundary, frozen
        # riders (frozen, no departure stamp) included
        group_now = sorted(set(sched.active_ids) | {
            int(j) for j in np.flatnonzero(sched.frozen) if sched.it_stopped[j] < 0})
        if len(group_now) == k_key:
            set_write_group()
        else:
            apply_group(group_now)
    del host

    # (kind, start iteration, sweeps, write offset on the kept axis): both
    # pipelines run exactly this plan, so the draws cannot depend on the
    # mode. A hole of a lenient resume is re-sampled by "fill" chunks that
    # extend the chain past n_samples and write at the hole's offset. The
    # adaptive schedule appends "extra" chunks as it grants them.
    plan = []
    it_plan = it
    while it_plan < n_burn:
        n = min(chunk_iters, n_burn - it_plan)
        plan.append(("burn", it_plan, n, 0))
        it_plan += n
    while it_plan < cfg.n_samples:
        n = min(chunk_iters, cfg.n_samples - it_plan)
        plan.append(("samp", it_plan, n, it_plan - n_burn))
        it_plan += n
    for a, b_ in holes:
        ofs, left = a, b_ - a
        while left > 0:
            n_f = min(chunk_iters, left)
            plan.append(("fill", it_plan, n_f, ofs))
            it_plan += n_f
            ofs += n_f
            left -= n_f
    truncated = False
    if adaptive:
        # granted extra chunks not committed yet survive a kill in the
        # sidecar (written before the manifest)
        for s_g, ln_g in sched.pending_extras(it):
            plan.append(("extra", s_g, ln_g, s_g - n_burn))
        if not g_members:
            plan = []  # every subset frozen at resume: straight to the finalize
    elif stop_after_chunks is not None and stop_after_chunks < len(plan):
        # (an adaptive plan grows at its grants: its stop is checked at
        # each boundary)
        plan = plan[:stop_after_chunks]
        truncated = True

    # the streaming monitor: accumulators on the device, folded in behind
    # each sampling chunk; its (K,) rhat_max and ess_min ride in the
    # boundary's one copy to the host
    stream = stream_update = stream_stats = None
    if live_on:
        stream_stats = make_stream_stats(c)
        stream_update = (make_stream_update_masked if adaptive else make_stream_update)(
            n_kept // 2, c)
        stream = init_stream(k, c, d_par, dtype, per_subset_counts=adaptive, device=dev)
        filled_now = max(0, it - n_burn)
        if filled_now > 0 and not holes:
            # resume: replay the filled region in its chunk layout (the
            # base sampling lengths, then the extra-chunk length), masked
            # by the rows each chunk wrote under the adaptive schedule
            ofs = 0
            while ofs < filled_now:
                if ofs < n_kept:
                    ln = min(chunk_iters, n_kept - ofs, filled_now - ofs)
                else:
                    ln = min(sched.l_extra, filled_now - ofs)
                x = param_draws[:, ofs:ofs + ln].reshape(k, c, ln, d_par)
                if adaptive:
                    col = np.ascontiguousarray(sched.rows_valid[lo:lo + k, ofs])
                    stream = stream_update(stream, x, ofs, torch.as_tensor(col, device=dev))
                else:
                    stream = stream_update(stream, x, ofs)
                ofs += ln
        elif holes:
            warnings.warn(
                "live_diagnostics on a lenient (hole) resume covers only draws sampled "
                "after the resume — the surviving segments are not replayed into the "
                "streaming accumulators while corrupt ranges await refill "
                "(obs/streaming.py)",
                RuntimeWarning, stacklevel=3,
            )

    # device-memory watermarks at each boundary (None on the CPU)
    sample_memory = pstats is not None and dev.type == "cuda"
    prof = ProfilerCapture.from_config(cfg)

    want_stats = nan_guard or progress is not None or policy_q or live_on
    esize = param_draws.element_size()
    staging = _HostStaging(2 if writer is not None else 1, writer) if ck is not None else None
    staging_cap = _state_nbytes(state) + 64 * (len(state) + 2) + (
        k * c * min(chunk_iters, max(n_kept, 1)) * (d_par + d_w) * esize)
    warned_progress = [False]

    def call_progress(info):
        if progress is None:
            return
        try:
            progress(info)
        except ProgressAbort:
            raise
        except Exception as e:
            if not warned_progress[0]:
                warned_progress[0] = True
                warnings.warn(
                    f"progress callback raised {e!r}; the run continues (this warning "
                    "is emitted once — raise a ProgressAbort subclass from the callback "
                    "to abort deliberately)",
                    RuntimeWarning, stacklevel=3,
                )

    def report(phase, it_end, window_start, accept_mean, live=None):
        pe = cfg.phi_update_every
        n_updates = max(1, -(-it_end // pe) - -(-window_start // pe))
        info = {
            "phase": phase,
            "iteration": it_end,
            "n_samples": cfg.n_samples,
            "phi_accept_rate": float(accept_mean) / n_updates,
        }
        if live is not None:
            # this boundary's streaming verdict: the worst split-R-hat and
            # the smallest ESS over subsets and parameters (a callback may
            # raise a ProgressAbort on a sick value)
            info["live_rhat_max"], info["live_ess_min"] = live
        call_progress(info)

    def live_subsets(d):
        return [int(j) for j in domain_map.subsets_of(d) if not dead[j]]

    def quarantine_check(b, finite):
        """The twin's quarantine_check: classify newly non-finite
        subsets into retries and deaths (whole-domain faults on their
        domain's ladder), defer a death while a rewind replays the
        chunk anyway, spare a terminal-boundary death whose recorded
        draws are finite; raise _QuarantineRewind when a retry is due."""
        bad = (~finite.astype(bool)) & (~dead)
        if not bad.any():
            return
        dom_hit = domain_map.whole_domain_faults(bad, dead) if domain_map.n_domains > 1 else []
        dom_retried, dom_dropped = [], []
        dom_live = {int(d): live_subsets(d) for d in dom_hit}
        dom_subsets: set = set()
        for d in dom_hit:
            dom_subsets.update(dom_live[int(d)])
            domain_attempts[d] += 1
            if domain_attempts[d] > cfg.fault_max_retries:
                dom_dropped.append(int(d))
            else:
                dom_retried.append(int(d))
        retried, dropped = [], []
        for j in np.where(bad)[0]:
            if int(j) in dom_subsets:
                continue
            attempts[j] += 1
            if attempts[j] > cfg.fault_max_retries:
                dropped.append(int(j))
            else:
                retried.append(int(j))
        retry_subsets = list(retried)
        for d in dom_retried:
            retry_subsets += dom_live[d]
        deferred, dom_deferred, dom_spared = [], [], []
        if retry_subsets:
            deferred, dropped = dropped, []
            dom_deferred, dom_dropped = dom_dropped, []
        elif (dropped or dom_dropped) and b["index"] == len(plan) - 1:
            with explicit_d2h("terminal_guard", nbytes=k):
                draws_ok = _subset_draws_finite(param_draws, w_draws, c)
            spared = [j for j in dropped if draws_ok[j]]
            if spared:
                deferred += spared
                dropped = [j for j in dropped if not draws_ok[j]]
            still_dropped = []
            for d in dom_dropped:
                subs = dom_live[d]
                sp = [j for j in subs if draws_ok[j]]
                if sp:
                    deferred += sp
                    dropped += [j for j in subs if not draws_ok[j]]
                    dom_spared.append(d)
                else:
                    still_dropped.append(d)
            dom_dropped = still_dropped
        dom_dropped_subsets = []
        for d in dom_dropped:
            dom_dropped_subsets += dom_live[d]
            domain_dead[d] = True
        for j in dropped + dom_dropped_subsets:
            dead[j] = True
        dom_deferred_subsets = []
        for d in dom_deferred:
            dom_deferred_subsets += dom_live[d]
        all_dropped = sorted(dropped + dom_dropped_subsets)
        all_deferred = sorted(deferred + dom_deferred_subsets)
        warnings.warn(
            "subset state non-finite in subsets "
            f"{sorted(retry_subsets) + all_dropped + all_deferred} at iteration "
            f"{b['it']} (fault_policy='quarantine'): retrying "
            f"{sorted(retry_subsets) or 'none'} from their chunk-start state with forked "
            f"streams; dropping {all_dropped or 'none'} (retry ladder of "
            f"{cfg.fault_max_retries} exhausted)"
            + (f"; death of {all_deferred} deferred pending the replay"
               if all_deferred else "")
            + ("; whole-domain faults: " + ", ".join(
                f"domain {d} ({domain_map.labels[d]})"
                for d in dom_retried + dom_dropped + dom_deferred)
               if dom_retried or dom_dropped or dom_deferred else ""),
            RuntimeWarning, stacklevel=3,
        )
        if pstats is not None:
            att = {j: int(attempts[j]) for j in retried + dropped + deferred}
            for d in dom_retried + dom_dropped + dom_deferred + dom_spared:
                for j in dom_live[d]:
                    att[int(j)] = int(domain_attempts[d])
            pstats.record_fault(
                chunk=b["index"], iteration=b["it"], phase=b["phase"],
                retried=sorted(retry_subsets), dropped=all_dropped,
                deferred=all_deferred, attempts=att, domains_retried=dom_retried,
                domains_dropped=dom_dropped, domains_deferred=dom_deferred,
            )
        if retry_subsets:
            mask = np.zeros(k, bool)
            mask[retry_subsets] = True
            raise _QuarantineRewind(mask)

    def program(key, fn):
        """An eager program of the run (the guard, the finalize, the
        refork, the streaming monitor's), keyed and recorded as the
        twin's are."""
        return _cached_program(model, key, lambda: fn, store=store, stats=pstats, device=dev)

    def chunk_work(idx, kind, start, n, w_ofs):
        """Queue one chunk's sweeps, its draws' write, the streaming
        fold-in and the boundary's copies to the host; returns the
        boundary's record. The quarantine's held state and noise snapshot
        and the checkpoint's noise snapshot are taken here, before the
        next chunk draws (the noise source is not in the state)."""
        nonlocal state, it, stream, full_fresh
        t0 = monotonic()
        ev_start = _record_event(dev, timing=True) if pstats is not None else None
        held = draws = None
        if policy_q and members:
            held = (SamplerState(*(t.clone() for t in state)), chunk_noise.snapshot())
        guards_before = model.guard_rejects
        if members:  # an empty group (another process samples on) dispatches nothing
            state, draws = _run_chunk(model, kind, pieces, state, start, n)
            full_fresh = False
        if draws is not None:
            if not adaptive:
                param_draws[:, w_ofs:w_ofs + n] = draws[0]
                w_draws[:, w_ofs:w_ofs + n] = draws[1]
            elif write_dst.numel():
                # the compacted group's rows land at their subsets' rows;
                # pads and frozen riders are dropped
                param_draws[write_dst, w_ofs:w_ofs + n] = draws[0][write_src]
                w_draws[write_dst, w_ofs:w_ofs + n] = draws[1][write_src]
            del draws
        it_end = start + n
        if kind != "fill":
            it = it_end
        stream_prev = stream
        live = None
        if stream is not None and kind in ("samp", "extra"):
            # refill chunks are left out: the terminal rewrite publishes them
            x = param_draws[:, w_ofs:w_ofs + n].reshape(k, c, n, d_par)
            upd = program(compile_programs.aux_bucket_key(
                model, "streamm" if adaptive else "stream", n, k, d_par, mesh=mesh),
                stream_update)
            stream = (upd(stream, x, w_ofs, write_mask_dev) if adaptive
                      else upd(stream, x, w_ofs))
            live = program(compile_programs.aux_bucket_key(model, "stream_stats", k, d_par,
                                                           mesh=mesh),
                           stream_stats)(stream)[2:]
        stats = ev_stats = None
        if want_stats:
            vec = [program(_stats_key(model, kc, m_sub, q_dim, p_dim, mesh=mesh), _chunk_stats)(state, c)
                   if members else torch.zeros(1, dtype=dtype, device=dev)]
            if live is not None:
                vec += [live[0].to(dtype), live[1].to(dtype)]
            # one pinned copy behind an event; the boundary reads it
            # under the twin's tags (chunk_stats, streaming_stats)
            stats, ev_stats = _to_host_async(torch.cat(vec))
        if kind == "burn" and it_end == n_burn and members:
            # post-burn-in acceptance accounting, after the stats (the
            # last burn report carries the full burn-in acceptance)
            state = state._replace(phi_accept=torch.zeros_like(state.phi_accept))
        save = ck is not None and kind != "fill"
        filled = max(0, it_end - n_burn)
        d2h = stats.numel() * esize if stats is not None else 0
        slot = state_np = seg = noise_np = None
        snap_bytes = []
        wait_s = 0.0
        if save:
            # under the adaptive schedule this is the group's state: the
            # boundary merges its members' rows into the host mirror, and
            # the manifest holds the mirror (all K subsets' rows)
            tensors, layout = _state_views(state)
            if kind in ("samp", "extra"):
                tensors += [param_draws[:, w_ofs:w_ofs + n], w_draws[:, w_ofs:w_ofs + n]]
            slot, arrays, wait_s = staging.take(tensors, staging_cap)
            sizes = [t.numel() * t.element_size() for t in tensors]
            d2h += sum(sizes)
            # the twin's host snapshots: the state, and a sampling
            # chunk's draw segment
            snap_bytes = [sum(sizes[:len(state)])] + (
                [sum(sizes[len(state):])] if len(sizes) > len(state) else [])
            state_np = _HostState(SamplerState(*arrays[:len(state)]), layout)
            if kind in ("samp", "extra"):
                seg = (arrays[-2], arrays[-1], w_ofs, w_ofs + n)
            noise_np = noise.snapshot()
        ev_state = (_record_event(dev, timing=ev_start is not None)
                    if (save or pstats is not None) else None)
        group = members + [members[0]] * (kc - len(members)) if members else []
        return {
            "index": idx, "kind": kind, "phase": _PHASES[kind], "start": start, "n": n,
            "it": it_end, "window_start": 0 if kind == "burn" else n_burn,
            "stats": stats, "ev_stats": ev_stats, "ev_state": ev_state, "ev_start": ev_start,
            "k_stats": kc, "live": live is not None, "stream_prev": stream_prev,
            "save": save, "slot": slot, "state_np": state_np, "seg": seg,
            "snap_bytes": snap_bytes,
            "noise_np": noise_np, "filled": filled, "held": held,
            "guards_before": guards_before, "wait_s": wait_s, "d2h_bytes": d2h,
            "dispatch_s": monotonic() - t0 - wait_s, "t_dispatch": t0,
            # the adaptive consult's and rewind's context, as dispatched:
            # the rung and writers the scheduler folds in (the run's
            # subset numbers), this process's members and group
            "kc": g_kc, "members": tuple(members), "group": tuple(group),
            # the pieces that ran the chunk's program (one per mesh entry
            # of this process, or per chunk_size step; none for an empty
            # group): each launched the chunk's builds
            "pieces": len(pieces) if members else 0,
            "written": g_written, "written_local": write_members, "a": w_ofs, "b": w_ofs + n,
        }

    def apply_decision(dec, b):
        """Apply one committed boundary's scheduler decision: append the
        granted extra chunk, re-form the dispatch group when the rung or
        the membership changes (a compaction, or a reopened straggler),
        and mark the run done when nothing is left to sample."""
        nonlocal adaptive_done
        if dec.grant is not None:
            s_g, ln_g = dec.grant
            plan.append(("extra", s_g, ln_g, s_g - n_burn))
        new_active = [int(j) for j in dec.active]
        new_kc = sched.rung(len(new_active)) if new_active else 0
        now = set(g_members)
        if new_kc != g_kc or any(j not in now for j in new_active):
            keep = set(new_active)
            sched.mark_stopped([j for j in g_members if j not in keep], b["it"])
            apply_group(new_active)
            if run_log is not None:
                run_log.event(
                    "adaptive_compaction", iteration=b["it"], kc=g_kc,
                    n_active=len(new_active),
                    newly_frozen=list(dec.newly_frozen),
                    newly_budget_frozen=list(dec.newly_budget_frozen),
                    newly_reopened=list(dec.newly_reopened),
                    regroup_s=regroup_s[-1],
                )
        elif dec.newly_frozen or dec.newly_budget_frozen or dec.newly_reopened:
            # the rung still covers the active set: newly frozen subsets
            # ride as rows that no longer write
            set_write_group()
        if dec.all_done:
            adaptive_done = True

    def merge_staged(b, entry):
        """A saving boundary of the adaptive schedule: the group's rows,
        staged in pinned memory behind the boundary's wait, merged into
        the host mirror, which the manifest then holds. Once a boundary,
        after its guard (a rewind discards the staged rows)."""
        if adaptive and b["save"] and b["state_np"] is not state_full:
            merge_state_full(b["state_np"])
            b["state_np"] = state_full

    def boundary_host_work(b, stall):
        """Guard, report and checkpoint one chunk, and consult the
        adaptive schedule. Under "sync" the device waits for it
        (``stall``); under "overlap" it runs while the next chunk is
        queued, and blocks only on this chunk's own stats. The first
        synchronisation is the boundary's one fetch: the guard's vector,
        the acceptance and the streaming statistics in one copy."""
        t0 = monotonic()
        entry = {}
        if b["ev_stats"] is not None:
            b["ev_stats"].synchronize()
            entry["device_wait_s"] = monotonic() - t0
        if b["ev_state"] is not None:
            t1 = monotonic()
            b["ev_state"].synchronize()
            if b["save"]:
                entry["state_fetch_s"] = monotonic() - t1
            if b["ev_start"] is not None:
                entry["device_s"] = b["ev_start"].elapsed_time(b["ev_state"]) / 1e3
        if b["stats"] is not None:
            ks = b["k_stats"]
            with contextlib.ExitStack() as fetch:
                fetch.enter_context(explicit_d2h("chunk_stats", nbytes=(ks + 1) * esize))
                if b["live"]:
                    fetch.enter_context(explicit_d2h("streaming_stats", nbytes=2 * k * esize))
                stats = b["stats"].numpy()
            if gather_on and b["members"]:
                sweep_s[0] = max(sweep_s[0], (monotonic() - b["t_dispatch"]) / b["n"])
            finite = stats[:ks] > 0.5
            if adaptive:
                # the guard covers the group's rows: a frozen rider or a
                # pad is never a rewind candidate
                fin_full = np.ones(k, bool)
                wset = set(b["written_local"])
                for r, j in enumerate(b["members"]):
                    if j in wset:
                        fin_full[j] = bool(finite[r])
                finite = fin_full
            live_rh = live_es = None
            if b["live"]:
                live_rh = stats[ks + 1:ks + 1 + k].astype(np.float64)
                live_es = stats[ks + 1 + k:ks + 1 + 2 * k].astype(np.float64)
            if gather_on and (b["kind"] in ("samp", "extra") or policy_q or nan_guard):
                # every process takes the same branch: a rewind or an
                # abort anywhere is one everywhere (a process with no
                # retry of its own replays the chunk as it ran), and the
                # consult folds the run's (K,) statistics
                verdict, rewind = 0, None
                if policy_q:
                    try:
                        quarantine_check(b, finite)
                    except _QuarantineRewind as rw:
                        verdict, rewind = 1, rw
                elif nan_guard and not finite.all():
                    verdict = 2
                verdict, finite_all, live_rh, live_es = boundary_gather(
                    b, verdict, finite, live_rh, live_es)
                if verdict == 1:
                    raise rewind or _QuarantineRewind(np.zeros(k, bool))
                if verdict == 2:
                    raise SubsetNaNError(np.where(~finite_all)[0], b["it"])
            elif policy_q:
                # a rewind skips this boundary's report and save
                quarantine_check(b, finite)
            elif nan_guard and not finite.all():
                if writer is not None:
                    writer.flush()  # the last checkpoint precedes the failure
                raise SubsetNaNError(np.where(~finite)[0], b["it"])
            merge_staged(b, entry)  # before the consult can regroup
            live_vals = None
            if b["live"]:
                any_rh, any_es = np.isfinite(live_rh).any(), np.isfinite(live_es).any()
                live_vals = (float(np.nanmax(live_rh)) if any_rh else float("nan"),
                             float(np.nanmin(live_es)) if any_es else float("nan"))
                entry["live_rhat_max"], entry["live_ess_min"] = live_vals
                # the total streaming ESS over subsets (the numerator of
                # the convergence-adjusted ess_per_second)
                entry["live_ess_sum"] = (
                    float(np.nansum(np.where(np.isfinite(live_es), live_es, 0.0)))
                    if any_es else None)
                if run_log is not None:
                    run_log.event("live_diagnostics", iteration=b["it"], rhat_max=live_rh,
                                  ess_min=live_es)
                if sched is not None and b["kind"] in ("samp", "extra"):
                    # the schedule's one consult site: fold the committed
                    # boundary in and apply the decision, the sidecar
                    # written before the manifest, so a crash between the
                    # two replays the boundary without folding it twice
                    decision = sched.observe(
                        kind=b["kind"], it=b["it"], span=(b["a"], b["b"]),
                        written=b["written"], kc_dispatched=b["kc"],
                        rhat_max=live_rh, ess_min=live_es,
                        plan_exhausted=(b["index"] == len(plan) - 1),
                    )
                    apply_decision(decision, b)
                    if ck is not None and b["save"]:
                        cur = sched.to_arrays()
                        prev = sched_saved[0] if sched_saved[0] else cur
                        save_sidecar(checkpoint_path, "sched",
                                     {**{f"prev_{n_}": v for n_, v in prev.items()},
                                      **{f"cur_{n_}": v for n_, v in cur.items()}})
                        sched_saved[0] = cur
            if b["kind"] not in ("fill", "extra"):
                # refill and extra chunks run past n_samples: the
                # callback's contract is a monotone iteration <= n_samples
                report(b["phase"], b["it"], b["window_start"], stats[ks], live=live_vals)
        if b["save"]:
            merge_staged(b, entry)
            with contextlib.ExitStack() as snaps:
                # the save reads the boundary's staged host snapshots
                for nb in b["snap_bytes"]:
                    snaps.enter_context(explicit_d2h("host_snapshot", nbytes=nb))
                entry.update(ck.save(b["state_np"], b["noise_np"], b["seg"], b["it"],
                                     b["filled"]))
            job = entry.pop("ckpt_job", 0)
            if job:
                staging.claim(b["slot"], job)
        host_s = monotonic() - t0
        if pstats is not None:
            if writer is not None:
                entry["staging_wait_s"] = b["wait_s"]
            entry["pieces"] = b["pieces"]
            if adaptive:
                entry["kc"] = b["kc"]  # the chunk's dispatch group (the rung charged)
                if mesh is not None and mesh.multi_process:
                    entry["local_kc"] = b["k_stats"]  # this process's share of it
            mem = device_memory_stats(dev) if sample_memory else None
            if mem is not None:
                entry["hbm_bytes_in_use"] = mem.get("bytes_in_use")
                entry["hbm_peak_bytes"] = mem.get("peak_bytes_in_use", mem.get("bytes_in_use"))
            pstats.record_chunk(chunk=b["index"], phase=b["phase"], n_iters=b["n"],
                                iteration=b["it"], dispatch_s=b["dispatch_s"],
                                host_work_s=host_s,
                                host_stall_s=(host_s if stall else 0.0) + b["wait_s"],
                                d2h_bytes=b["d2h_bytes"], **entry)
        if prof is not None and prof.maybe_stop(b["index"]) and run_log is not None:
            run_log.event("profile_stop", chunk=b["index"], out_dir=prof.out_dir,
                          trace_path=prof.trace_path)

    half = math.log(0.5)  # the retried subsets' phi step halves

    def apply_rewind(b, rw, successor):
        """Rewind the faulted chunk to its held start state, the retried
        rows on forked streams with a halved phi step, and discard the
        successor in flight (its draws are overwritten by the replay; its
        guard counts are dropped, as the sync loop never ran it). The
        streaming monitor forgets every fold-in from the faulted chunk
        on."""
        nonlocal state, it, stream, full_fresh
        if b["held"] is not None:  # None: this process dispatched nothing
            held_state, held_noise = b["held"]
            # the retry mask is in subset space; the held state is the
            # chunk's group (all K subsets on the fixed schedule)
            grp = np.asarray(b["group"] if adaptive else range(k), np.int64)
            row_mask = np.repeat(rw.retry_mask[grp], c)
            chunk_noise.restore(held_noise)
            chunk_noise.fork(row_mask, np.repeat(attempts[grp], c))
            refork = program(_refork_key(model, len(grp), m_sub, q_dim, p_dim, mesh=mesh),
                             _refork)
            with explicit_h2d("quarantine_refork"):
                row_mask_dev = torch.as_tensor(row_mask, device=dev)
            state = refork(held_state, row_mask_dev, half)
            full_fresh = False
        if stream is not None:
            stream = b["stream_prev"]
        if b["kind"] != "fill":
            it = b["start"]
        if successor is not None:
            model.guard_rejects = successor["guards_before"]

    # The chunk watchdog: each guarded section runs on a worker thread
    # under a deadline. The first dispatch of each (kind, length, phase,
    # rung) runs unguarded and unobserved, as the twin's compiling dispatch does.
    watchdog = (ChunkWatchdog(domain_map, min_deadline_s=cfg.watchdog_min_deadline_s,
                              margin=cfg.watchdog_margin, run_log=run_log)
                if cfg.watchdog else None)

    def guarded(fn, chunk, iteration, novel=False):
        if watchdog is None or novel:
            return fn()
        return watchdog.run(in_callers_context(fn, dev), chunk=chunk, iteration=iteration)

    def dispatch(a):
        """chunk_work under the profiler's scope for the chunk while a
        window is open."""
        if prof is not None and prof.active:
            with torch.profiler.record_function(chunk_scope(a[0])):
                return chunk_work(*a)
        return chunk_work(*a)

    # One loop drives both pipelines, the quarantine rewind and the
    # adaptive schedule. "sync" runs each boundary as its chunk ends;
    # "overlap" queues chunk t + 1 before chunk t's boundary, then drains
    # the last one. A rewind resets the plan index to the faulted chunk
    # and drops the successor in flight. Under "abort" with the fixed
    # schedule this is the twin's schedule exactly.
    loop_span = None
    if run_log is not None:
        run_log.event("plan", n_chunks=len(plan), chunk_iters=chunk_iters, mode=mode,
                      fault_policy=cfg.fault_policy, n_holes=len(holes), truncated=truncated,
                      resumed_at_iteration=it, adaptive=adaptive)
        loop_span = run_log.span("chunk_loop", n_chunks=len(plan), mode=mode)
        loop_span.__enter__()
    t_loop0 = monotonic()
    try:
        idx = 0
        pending = None
        seen = set()
        while True:
            if idx < len(plan):
                kind, start, n, w_ofs = plan[idx]
                if prof is not None and prof.maybe_start(idx) and run_log is not None:
                    run_log.event("profile_start", chunk=idx, out_dir=prof.out_dir)
                # a new bucket program captures on its first dispatch:
                # the phase of its first sweep is part of its key
                phase = start % cfg.phi_update_every
                key = (kind, n, phase, kc) if adaptive else (kind, n, phase)
                novel = key not in seen
                seen.add(key)
                rec = guarded(lambda a=(idx, kind, start, n, w_ofs): dispatch(a),
                              idx, start + n, novel=novel)
                idx += 1
                if mode == "overlap":
                    todo, pending, stall = pending, rec, False
                else:
                    todo, stall = rec, True
                rec = None
            elif pending is not None:
                # the terminal drain: nothing is in flight behind it
                todo, pending, stall = pending, None, True
            else:
                break
            if todo is None:
                continue
            try:
                guarded(lambda t=todo, st=stall: boundary_host_work(t, st),
                        todo["index"], todo["it"])
            except _QuarantineRewind as rw:
                apply_rewind(todo, rw, pending)
                idx = todo["index"]
                pending = None
            # drop the record (and its quarantine clone) before the next
            # chunk takes its own
            todo = None
            if adaptive:
                if adaptive_done:
                    # every subset frozen and nothing granted: the rest
                    # of the plan is the saving (the schedule is sync, so
                    # nothing is in flight)
                    idx = len(plan)
                if stop_after_chunks is not None and idx >= stop_after_chunks:
                    truncated = True
                    break
        if writer is not None:
            t0 = monotonic()
            ck.ensure_synced(lambda: _snapshot_state(state), noise.snapshot(), it,
                             max(0, it - n_burn))
            if pstats is not None:
                drain_s = monotonic() - t0
                pstats.record_chunk(chunk=len(plan), phase="drain", n_iters=0, iteration=it,
                                    dispatch_s=0.0, host_work_s=drain_s,
                                    host_stall_s=drain_s, d2h_bytes=0)
        if holes and not truncated and ck is not None:
            # the refill wrote out of order and saved nothing: publish the
            # whole kept region as one checksummed segment (a process's
            # rows of it in a fresh generation, under format 8)
            with explicit_d2h("checkpoint_full_rewrite"):
                p_np, w_np = param_draws.cpu().numpy(), w_draws.cpu().numpy()
                if use_v8:
                    ck.rewrite_full_from_device(state, noise.snapshot(), p_np, w_np,
                                                cfg.n_samples, n_kept)
                else:
                    ck.rewrite_full(_host_state(state), noise.snapshot(), p_np, w_np,
                                    cfg.n_samples, n_kept)
    finally:
        if prof is not None:
            prof.close()
        if loop_span is not None:
            loop_span.__exit__(None, None, None)
        if writer is not None:
            writer.close()
        if pstats is not None:
            pstats.total_wall_s = monotonic() - t_loop0
            if staging is not None:
                pstats.host_staging_bytes = max(pstats.host_staging_bytes, staging.nbytes)
            if sched is not None:
                # recorded on every exit, a stop_after_chunks kill included
                pstats.adaptive = {**sched.summary(), "regroup_s": list(regroup_s),
                                   "host_mirror_bytes": (0 if state_full is None else sum(
                                       a.nbytes for a in state_full.arrays))}
                if gather_on:
                    pstats.adaptive["decision_gather_s"] = list(gather_s)
    if truncated:
        return None
    with (run_log.span("finalize") if run_log is not None else contextlib.nullcontext()):
        if not adaptive:
            return program(_finalize_key(model, k, m_sub, q_dim, n_kept, d_par, d_w, mesh=mesh),
                           model.finalize)(state, param_draws, w_draws)
        # subsets still in the group at the end ran the whole schedule
        if g_members:
            sched.mark_stopped(g_members, it)
        # the finalize reads phi_accept alone: the departed subsets' rows
        # from the host mirror, the last group's from its live state
        live = members or last_group
        with explicit_h2d("adaptive_regroup"):
            rows_t = torch.as_tensor(batch_rows(live), device=dev)
        if state_full is None:  # never regrouped: the group is the run
            accept = state.phi_accept[:rows_t.numel()].clone()
        else:
            i_acc = SamplerState._fields.index("phi_accept")
            with explicit_h2d("adaptive_regroup"):
                accept = _logical(state_full.arrays[i_acc], state_full.layout[i_acc]).to(dev)
            if live and not full_fresh:
                accept[rows_t] = state.phi_accept[:rows_t.numel()]
        if live:
            merge_guards(live)
        if guard_full is not None:
            model.guard_rejects = guard_full
        stops = np.where(sched.it_stopped < 0, it, sched.it_stopped)[lo:lo + k]
        fin_state = SamplerState(*([None] * len(SamplerState._fields)))._replace(
            phi_accept=accept)
        fin = program(compile_programs.aux_bucket_key(model, "finadapt", k, m_sub, q_dim, n_cap,
                                                      d_par, d_w, mesh=mesh),
                      model.finalize_masked)
        return fin(fin_state, param_draws, w_draws, sched.rows_valid[lo:lo + k], stops)


_PHASES = {"burn": "burn", "samp": "sample", "fill": "fill", "extra": "extra"}


def fit_subsets_checkpointed(
    model: SpatialGPSampler,
    part,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    checkpoint_path: str,
    chunk_iters: int = 500,
    stop_after_chunks: Optional[int] = None,
    chunk_size: Optional[int] = None,
    progress=None,
    nan_guard: bool = False,
    pipeline_stats: Optional[ChunkPipelineStats] = None,
    domain_map: Optional[FailureDomainMap] = None,
) -> Optional[SubsetResult]:
    """:func:`fit_subsets_chunked` with a checkpoint (the twin's
    checkpoint-requiring entry point)."""
    return fit_subsets_chunked(
        model, part, coords_test, x_test, noise, beta_init, chunk_iters=chunk_iters,
        checkpoint_path=checkpoint_path, chunk_size=chunk_size, progress=progress,
        stop_after_chunks=stop_after_chunks, nan_guard=nan_guard,
        pipeline_stats=pipeline_stats, domain_map=domain_map,
    )


def find_failed_subsets(results: SubsetResult) -> np.ndarray:
    """Indices of subsets whose compressed grids hold a non-finite
    value."""
    ok = (torch.isfinite(results.param_grid).flatten(1).all(dim=1)
          & torch.isfinite(results.w_grid).flatten(1).all(dim=1))
    return np.where(~ok.cpu().numpy())[0]


def rerun_subsets(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: NoiseSource,
    results: SubsetResult,
    subset_ids: Sequence[int],
    beta_init: Optional[torch.Tensor] = None,
) -> SubsetResult:
    """Re-run only ``subset_ids`` and scatter them into ``results``.
    ``noise`` is a fresh source of the original fit's streams (the same
    seed; the twin takes the same fan-out key), so a re-run subset
    draws its original chain: its rows are taken with ``noise.rows``."""
    _require(noise, ("rows",), "rerun_subsets")
    c = model.config.n_chains
    ids = [int(i) for i in subset_ids]
    sel = torch.as_tensor(ids, device=part.x.device)
    data = SubsetData(coords=part.coords[sel], x=part.x[sel], y=part.y[sel],
                      mask=part.mask[sel], coords_test=coords_test, x_test=x_test)
    rows = noise.rows([j * c + ch for j in ids for ch in range(c)])
    cdata = model.chain_data(data)
    consts = model._consts(cdata)
    init = model.init_state(cdata, beta_init, consts=consts)
    rerun = model.run(data, init, rows, consts=consts)

    def scatter(full, new):
        out = full.clone()
        out[sel] = new
        return out

    return SubsetResult(*(scatter(f, n) for f, n in zip(results, rerun)))
