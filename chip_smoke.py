#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smk_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Needs one CUDA card (compute
capability 9.0, an H100), the CUDA toolkit's nvcc, and PyTorch built
for CUDA; imports nothing of JAX or of the JAX package. Phases, each
printed as one JSON line:

1. device   — the card (nvidia-smi name and power limit), its compute
              capability, the TF32 flags (both off).
2. build    — nvcc builds every kernel of the port from the sources in
              the checkout (one nvcc per source, started together).
3. kernels  — every fused-build entry point on the card against its
              plain PyTorch version on the same inputs: three models,
              masked/shifted/cross variants at a ragged m = 147, a
              mismatched cross (147, 123), and the main-path shapes
              (K = 32, m = 3906, t = 64), with the exact invariants
              (unit diagonal, pad identity, bitwise symmetry) and, at
              the main-path shapes, kernel / plain / library times
              (CUDA events around one call from an idle card, so the
              wrapper's host time counts; median of 20) beside the
              device-memory bound, and the kernel's device time alone
              (`device_ms`: each call queued behind a short device
              sleep), beside an empty launch's device time.
              Masked square builds run the symmetric kernel: at the
              main-path shape it must be bitwise equal to the tile
              kernel for both big builds, and a ragged sweep (m from 1
              to 3907, every row alignment mod 4) holds it against the
              plain version and the tile kernel, into NaN-filled
              outputs so that an element it misses fails. The kriging
              builds run the narrow kernel: at the main-path shapes it
              must be bitwise equal to the tile kernel (cross build;
              with its row mask in the kernel, to the tile kernel's
              output masked afterwards) and to the symmetric kernel
              (test stack); a second ragged sweep (1 to 257 columns,
              1 to 3907 rows, shared or per-k columns) does the same.
              Then the narrow and tile kernels at wider cross builds
              (up to 4096 columns), and the sampler's whole kriging build
              (SpatialGPSampler._cross_test_corr) timed at the main
              path's shape.
4. fit_small_parity — a small fit through the kernel on the card
              against the same fit through the plain version on the
              CPU, with the same random numbers.
5. fit_config5 — fit_meta_kriging at the repo's per-chip north-star
              shape (n = 124,992, K = 32, m = 3906, q = 1, p = 2,
              t = 64, exponential, fused_build="pallas", 40 sweeps:
              30 burn-in, 10 kept), with its kernel launch counts,
              saved as a serving artifact.
5b. serve_config5 — that artifact (S = 1000 draws, t = 64 anchors)
              loaded and served by smk_torch.serve.PredictionEngine
              with buckets (8, 32, 128, 1024, 4096): cold and warm
              first-request latency; 64 requests of 32 rows serially
              and from 8 clients with 4 in flight, twice (p50/p99, QPS,
              every concurrent response bitwise the serial one); a 65,536-row
              map request (rows/s); a 2-replica fleet; the card engine
              against predict_at on the CPU on the same noise (1e-6);
              pad-row identity, a NaN row masked alone, a stalled
              dispatch timing out typed at 0.5 s, a queue flood shed
              typed, the health counters; a warm request's synchronising
              calls under the sync debug mode (the guard's fetch only);
              TF32 on changes no response; the host and device ms of a
              predict per bucket, the cross build's share of the device
              time at 4096, the engine's peak memory; 0 fused-build
              launches.
6. fit_q2   — the bivariate case (q = 2, K = 8, m = 3906, 20 sweeps).

Phases 5 and 6 run the default SMKConfig sampler. Phases 7-11 run the
production sampler that bench.py:rung_config builds (collapsed phi on
a sparse schedule, Nystrom CG with a bf16 operator, blocked triangular
solves; production_config below):

7. kernels_config4 — the symmetric and narrow kernels at config4's
              shapes, (64, 2, 1024, 1024) and (64, 1, 1024, 64), on
              eBird-proxy coordinates, against their plain versions.
8. production_ops — at config5's shape: the bf16 operator's product
              against its plain upcast form, an 8-step Nystrom CG solve
              against a dense solve (error <= 5e-2), the blocked
              triangular solve against the native one; device times.
9. fit_production_small_parity — the production fit, probit and
              logit, on the card against the CPU, same random numbers.
10. fit_production_config5 — fit_meta_kriging with the production
              sampler at config5's shape, 64 sweeps (48 burn-in), phi
              every 16th; launches against probit_gp.build_calls; then
              the same schedule sweep by sweep: update and non-update
              sweep times (CUDA events), factorizations per sweep, the
              finite-factor guard's count, profiler windows.
11. fit_production_config4 — the same at config4's shape (eBird proxy,
              n = 65,536 + 64 test sites, K = 64, m = 1024, q = 2,
              p = 3, logit, phi every 8th).

Phases 12-16 run the rest of the sampler's knobs:

12. kernels_float64 — the double symmetric and narrow kernels (every
              float64 build) against their plain version at float64 and
              bitwise against the double tile kernel, three models:
              masked / masked + shifted / scalar shift / square over a
              ragged m sweep (1 to 3907, every row alignment mod 4
              doubles), cross builds with and without the row mask at
              widths 1 to 257, into NaN-filled outputs, with the exact
              invariants; every float64 entry point and the kernel it is
              counted under; device times of each new kernel and the tile
              kernel in turns at the masked (32, 1, 3906, 3906) and cross
              (32, 1, 3906, 64) builds, beside the byte bound and the FP64
              bound from the SASS (cuobjdump); a small float64 fit on the
              card against the same fit on the CPU.
13. fit_variants_small_parity — small fits on the card against the CPU
              with the same random numbers: multiple-try phi (J = 3) in
              each proposal family, two chains, the blocked Cholesky
              (block 16 at m = 40), bf16 correlation builds; and
              matmul_precision="highest" bit for bit the default run.
14. chol_blocked — ops/chol.blocked_cholesky at (32, 3906, 3906) fp32,
              blocks 256, 512 and 1024, against cuSOLVER (cholesky_ex):
              device times and the factors' difference and residuals;
              then one production update sweep at config5 with
              chol_block_size 512 against 0, in turns.
15. fit_production_config5_mtm — the production sampler at config5 with
              phi_proposals = 4, student-t proposals, 32 sweeps (24
              burn-in), phi every 16th: launches against build_calls, and
              9 factorizations in 3 batched calls per component on every
              update sweep.
16. fit_production_config4_chains — fit_production_config4 with two
              chains (the bench's full ladder): launches equal to the
              one-chain run's, a finite cross-chain R-hat on every subset.
17. fit_config5_float64 — fit_meta_kriging at config5's full width in
              float64 (SMKConfig(dtype="float64"), the default sampler,
              16 sweeps: 12 burn-in): launches per entry point and per
              kernel (the double symmetric and narrow kernels only),
              ms/sweep, peak memory, and one profiler window over two
              sweeps: device busy and idle, the factorizations' share.

Phases 18-21 run the Vecchia/NNGP subset engine (ops/vecchia.py:
SMKConfig(subset_engine="vecchia"), which builds no (m, m) matrix and
so launches none of the kernels above), under the JAX bench's Vecchia
rung (bench.py:1709-1720, :1761; vecchia_config below):

18. vecchia_ops — at config5's shape (K = 32, m = 3906, nn = 16, t = 64)
              on config5's data: device times (CUDA events, median of 20)
              of the neighbor builds (train and test; their stable sort of
              the candidate rows beside torch.topk, with the sites where
              topk's tie order would differ), vecchia_coeffs on the
              124,992 sites beside its cholesky_ex alone and its byte
              bound, the reverse neighbor lists, the loglik, the Q matvec,
              F^T through the reverse lists beside one scatter_add (and
              whether five calls of each agree bit for bit), q_diag, an
              8-step posterior draw and a kriging draw; the
              neighbor build's peak memory; then every op on the card
              against the CPU on small seeded inputs (the neighbor sets
              equal, the rest at 1e-5 + 1e-5|x| at m = 60, of the largest
              entry at m = 200).
19. fit_vecchia_small_parity — a small Vecchia fit on the card against
              the CPU, same random numbers (2e-3 (1 + |x|)), then the card
              fit again, bit for bit (F^T and diag(Q) are summed through
              reverse neighbor lists, not with float atomics).
20. fit_vecchia_config5 — fit_meta_kriging with the Vecchia engine at
              config5's full width, 64 sweeps (48 burn-in), phi every
              16th: ms/sweep, phase_seconds, peak memory, finite outputs,
              no build launched; then the schedule sweep by sweep
              (direct_sweeps: update and non-update sweep ms, coefficient
              builds per sweep, profiler windows with the idle share).
21. fit_vecchia_m_large — the same n at K = 16, m = 7812 (the bench's
              "dense-undispatchable" leg at twice m), 32 sweeps: ms/sweep,
              peak memory, finite outputs, no build launched.

Phases 22-24 run the chunked, checkpointed, fault-isolating executor
(parallel/recovery.py) through fit_meta_kriging's chunked arguments,
with checkpoints in a temporary directory that the script removes:

22. fit_chunked_small_parity — a chunked, checkpointed fit (n = 200,
              K = 4, q = 2, chunks of 4) on the card against the CPU,
              same random numbers (2e-3 (1 + |x|)), launches against
              build_calls(chunk_iters=4); on the card: killed after two
              checkpointed chunks (a progress callback raising
              ProgressAbort) and resumed from disk, bitwise the
              uninterrupted run; quarantine with one injected NaN
              (retried once; the other subsets bitwise the clean run)
              and with an exhausted ladder (the subset dropped, the
              combine finite); a coherent fit (two bucket groups) on the
              card against the CPU.
23. fit_chunked_config5 — the production sampler at config5 with
              fault_policy="quarantine", 64 sweeps in chunks of 16,
              checkpointed every chunk (each manifest holds the 1.95 GB
              carried state), nan_guard and progress on: ms/sweep beside
              the unchunked production fit's, per chunk the sweeps'
              seconds and the checkpoint's fetch and write seconds and
              bytes, peak memory, launches against
              build_calls(chunk_iters=16), whether the draws equal the
              unchunked fit's bitwise; then killed after two chunks
              (under "abort") and resumed from disk in a fresh call,
              bitwise the uninterrupted run, with that run's peak; free
              disk space before and after.
24. fit_coherent_config4 — config4's eBird proxy with
              partition_method="coherent" (production sampler, logit,
              chunks of 16): the buckets (1024 and 1448) and their pad
              share, the symmetric and narrow kernels at each group's
              shape against their plain version, ms/sweep per group and
              for the fit beside the random split's, peak memory,
              launches per group against build_calls(chunk_iters=16),
              finite outputs.

Phases 25-26 run the overlap pipeline (chunk_pipeline="overlap": chunk
t's boundary while chunk t + 1 is queued, the checkpoint written by a
background thread from two pinned staging buffers), lenient resume and
the chunk watchdog, with the fault injectors of smk_torch/testing:

25. fit_overlap_config5 — the production sampler at config5 with
              fault_policy="quarantine", 288 sweeps (216 burn-in) in
              chunks of 96, a 1.95 GB manifest at each of the four
              boundaries, under "sync" and then "overlap": the fit's wall
              and ms/sweep, the chunks' dispatch seconds and device
              waits, the writes' seconds and bytes, host_stall_s and
              overlap_efficiency, the drain, peak device memory and the
              pinned staging bytes, launches against
              build_calls(chunk_iters=96); the overlap's draws bitwise the
              sync run's. First one burn-in and one sampling chunk of 16
              sweeps under torch.cuda.set_sync_debug_mode("warn"): every
              synchronising call inside a chunk, by line.
26. fit_overlap_small_faults — K = 4, m = 200, chunks of 4, quarantine,
              on the card: an overlapped checkpointed fit bitwise the sync
              fit (launches against build_calls); a kill after two chunks
              under overlap resumed under sync, bitwise; a failed writer
              job (fail_writer_job) degrading with a warning to a
              checkpoint that resumes; kill_at_manifest and a resume,
              bitwise; a bit-flipped segment resumed leniently (refilled,
              finite, the rest bitwise, one merged segment after);
              watchdog=True on a healthy fit, bitwise the sync fit, and
              stall_chunk under it raising ChunkTimeoutError;
              dead_domain over two failure domains, dropped through the
              domain ladder, the survivors bitwise.

Phases 27-29 run the chunked executor's last knobs (the streaming
monitor, the run log, the adaptive schedule, profiling):

27. fit_adaptive_config5 — config5 at full width, the production sampler
              with two chains, 160 sweeps (120 burn-in) in chunks of 10,
              through fit_meta_kriging: (a) the fixed schedule; (b) the
              fixed schedule with live_diagnostics and a run log, bitwise
              (a), its last boundary's streaming R-hat against post-hoc
              R-hat on the same draws (1e-4 relative), its run log with
              root coverage >= 0.95 and no orphan span; (c) the adaptive
              schedule with the JAX bench's targets (bench.py:1461-1560),
              its launches equal to what its own chunk records imply at
              their rungs and its frozen_at replayed on the host from its
              logged statistics; (a) again, warm. Walls, ms/sweep, the
              monitor's cost ((b) against the warm (a)), peak memory, the
              adaptive telemetry. First one armed and one unarmed chunk
              through the executor under the sync debug mode (the armed
              one adds no synchronising call), and what a compaction moves
              at this width (the host mirror's merge, the gather of the
              rungs 23, 16 and 11). The kernels phase also holds the
              symmetric and narrow kernels at those batches.
28. fit_adaptive_small — the JAX package's adaptive problem (K = 4,
              m = 16, two chains, 80 sweeps in chunks of 10) and K = 8,
              m = 200 on the card: a freeze with fewer subset-chunks than
              the fixed schedule, an extra grant past n_kept, a compaction
              below K = 8, launches against the chunk records, a kill at
              the first freeze resumed from the checkpoint and the
              scheduler sidecar bitwise; the refusals (chunk_size,
              "overlap").
29. fit_profile_config5 — config5, the production sampler, 32 sweeps in
              chunks of 8, unprofiled and with profile_chunks="1:3": the
              Chrome trace, its top device ops (the symmetric kernel and
              potrf among them), the chunk scopes' device span within 25 %
              of the chunks' CUDA-event times, the profiler's overhead.

Then each phase's wall time and the script's, the kernel summary line
{"kernels": [...]} (launches from fit_config5, the double kernels' from
fit_config5_float64, and per path, the Vecchia paths' all 0), the card's
nvidia-smi line, and last {"ok": true, "device": {...}}. A failing phase
raises: the script exits non-zero and prints no ok line. It exits
non-zero at once where no CUDA card is visible, or where the port
cannot be imported (the script alone, outside a checkout).
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 (non
# tensor-core) rate — the bound of a kernel is the larger of its bytes
# over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

SEED = 20261016
# the main path's shapes: config5's per-chip slice (K subsets of m rows,
# t test sites)
MAIN_K, MAIN_M, MAIN_T = 32, 3906, 64
KERNEL_SOURCE = "smk_torch/csrc/fused_corr.cu"
# file:line of the TPU entry point each wrapper replaces (all launch
# the one Pallas kernel _corr_kernel, smk_tpu/ops/pallas_build.py:179)
REPLACES = {
    "fused_correlation": "smk_tpu/ops/pallas_build.py:330",
    "fused_masked_correlation_stack": "smk_tpu/ops/pallas_build.py:366",
    "fused_masked_shifted_build": "smk_tpu/ops/pallas_build.py:405",
    "fused_cross_correlation": "smk_tpu/ops/pallas_build.py:387",
    "fused_correlation_stack": "smk_tpu/ops/pallas_build.py:349",
}
MAIN_PATH = (
    "fused_masked_correlation_stack",
    "fused_masked_shifted_build",
    "fused_cross_correlation",
    "fused_correlation_stack",
)
# every kernel of the summary line: the main path's four and
# fused_correlation, which the fit does not launch
KERNELS = MAIN_PATH + ("fused_correlation",)
# the symmetric kernel's ragged sweep: one tile, a partial last tile,
# the diagonal tile, and every row alignment mod 4
RAGGED_M = (1, 2, 3, 63, 64, 65, 127, 129, 3905, 3906, 3907)
# the narrow kernel's ragged sweep: one to five columns, every row
# alignment mod 4 around 64 and 128, the main path's t = 64, the widest
# rows the layout takes and one past them; one row, a ragged strip,
# and the main path's m + 1 rows
NARROW_MB = (1, 3, 4, 5, 63, 64, 65, 123, 128, 256, 257)
# the adaptive schedule's first compaction rungs below K = 32
# (compile/buckets.k_ladder(32)): the kernels' batch sizes there
COMPACT_K = (23, 16, 11)
NARROW_MA = (1, 147, 3907)
# cross builds timed on both the narrow and the tile kernel: t = 123
# (rows not on 16 bytes) and prediction rasters of 1024 and 4096 sites
WIDE_MB = (123, 1024, 4096)
MODELS = ("exponential", "matern32", "matern52")
# kernel vs plain version on the same card: the two follow the same
# operation order (the kernel disables FMA contraction), so they differ
# only where expf and torch.exp round differently — a few fp32 ulps of
# values <= 1; the relative term covers the 1e8 pad shifts
ATOL, RTOL = 4e-6, 1e-6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# device clock cycles (~0.5 ms) the card spins before a call timed as
# device time, so that the host has queued the call's launches when its
# start event is reached
SLEEP_CYCLES = 1_000_000


def ms_median(fn, reps: int = 20, warmup: int = 3, device_only: bool = False) -> float:
    """Median time of one call by CUDA events. The card is idle when the
    start event is recorded, so the time holds the call's host time (the
    wrapper's Python, the launch) with its device time. With
    `device_only`, each call is queued behind a short device sleep, so
    the time is the device's alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ----------------------------------------------------------------------
# phase 3: kernels
# ----------------------------------------------------------------------
MODEL_OPS = {"exponential": 2, "matern32": 5, "matern52": 8}


def min_bytes(inputs, out):
    """Each input read once and the output written once."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs if t is not None)
    return nbytes + out.numel() * out.element_size()


def bound(inputs, out, model, masked, shifted, row_masked=False):
    """(bound_ms, bound_by): the least time for the function — its
    bytes (min_bytes) over the HBM rate, or its operations over the
    fp32 rate, whichever is larger. Operations per element: 3 per
    coordinate (sub, mul, add), max and sqrt, the model's own, 4 for
    the mask blend, 1 for the shift, 1 for the row mask."""
    d = inputs[0].shape[-1]
    ops = out.numel() * (3 * d + 2 + MODEL_OPS[model] + 4 * masked + shifted + row_masked)
    t_bytes = min_bytes(inputs, out) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, what, atol=ATOL, rtol=RTOL):
    """max |got - want|, checked against atol + rtol |want|."""
    err = (got - want).abs()
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: kernel disagrees with plain version (max err {err.max().item():.3e})")
    return float(err.max())


def square_invariants(out, mask, shift, what):
    """Exact invariants of a square zero-diagonal build (K, s, m, m):
    bitwise symmetry, unit (or 1 + shift) diagonal, identity pad rows."""
    import torch

    check(torch.equal(out, out.transpose(-1, -2)), f"{what}: not bitwise symmetric")
    diag = torch.diagonal(out, dim1=-2, dim2=-1)
    want_diag = torch.ones_like(diag)
    if shift is not None:
        want_diag = want_diag + shift[:, None, :]
    check(torch.equal(diag, want_diag), f"{what}: diagonal is not exactly 1 (+ shift)")
    if mask is not None:
        pad = mask == 0  # (K, m)
        m = out.shape[-1]
        eye = torch.eye(m, dtype=out.dtype, device=out.device)
        rows = out.masked_select(pad[:, None, :, None].expand_as(out))
        ref = (eye[None, None] + torch.diag_embed(
            torch.zeros_like(diag) if shift is None else shift[:, None, :].expand_as(diag)
        )).masked_select(pad[:, None, :, None].expand_as(out))
        check(torch.equal(rows, ref), f"{what}: pad rows are not exactly the identity")


def launch_nan(ca, cb, phis, model, layout, *, mask=None, shift=None, zero_diag=False,
               row_mask=None):
    """One launch of the kernel `layout` (tile, symmetric or narrow) on
    (K, ma, d) and (K, mb, d) coordinates into a NaN-filled
    (K, s, ma, mb) output, so that an element the kernel does not write
    fails every comparison. Not counted: LAUNCHES counts the entry
    points' launches."""
    import torch
    from smk_torch.ops import fused_build as fb

    out = torch.full((ca.shape[0], phis.shape[1], ca.shape[1], cb.shape[1]), float("nan"),
                     device=ca.device, dtype=ca.dtype)
    fb._launch(ca, cb, phis, mask, shift, model, zero_diag, out, layout, row_mask)
    return out


def ragged_sweep(uni, ms=RAGGED_M, tol=(ATOL, RTOL)):
    """The symmetric kernel at every m of `ms` (K = 2, s = 2, d = 2;
    three models; masked, masked + shifted, scalar shift, unmasked), and
    at d = 1, 3, 8: equal to the plain version within `tol`, bitwise
    equal to the tile kernel, with the exact invariants. On the type
    `uni` draws (float32, or float64 for the double kernels)."""
    import torch
    from smk_torch.ops import fused_build as fb

    k, s = 2, 2
    worst, cases = 0.0, 0
    # d = 2 (the fit's) at every m and all models; the other dimensions,
    # which take the kernel's generic instantiation, at two m
    sizes = [(m, 2, MODELS) for m in ms]
    sizes += [(m, d, ("matern32",)) for d in (1, 3, 8) for m in (129, 3907)]
    for m, d, models in sizes:
        coords = uni(k, m, d, hi=2.0)
        phis = uni(k, s, lo=4.0, hi=12.0)
        mask = (uni(k, m) > 0.1).to(coords.dtype)
        shift = torch.where(mask > 0, uni(k, m, lo=0.5, hi=2.0), torch.full_like(mask, 1e8))
        scalar = torch.full_like(mask, 0.25)
        for model in models:
            for mk, sh in ((mask, None), (mask, shift), (mask, scalar), (None, None)):
                what = f"ragged m={m}/d={d}/{model}/masked={mk is not None}/shift={sh is not None}"
                got = launch_nan(coords, coords, phis, model, fb.SYMMETRIC, mask=mk, shift=sh,
                                 zero_diag=True)
                tile = launch_nan(coords, coords, phis, model, fb.TILED, mask=mk, shift=sh,
                                  zero_diag=True)
                want = fb.plain_build(coords, coords, phis, model, mask=mk, shift=sh,
                                      zero_diag=True)
                worst = max(worst, compare(got, want, what, *tol))
                check(torch.equal(got, tile), f"{what}: symmetric kernel != tile kernel")
                square_invariants(got, mk, sh, what)
                cases += 1
    return {"m": list(ms), "d": [1, 2, 3, 8], "K": k, "s": s, "cases": cases,
            "max_abs_err": worst}


def narrow_sweep(uni, tol=(ATOL, RTOL)):
    """The narrow kernel at every (ma, mb) of NARROW_MA x NARROW_MB
    (K = 2, s = 2, d = 2, three models): the cross build with and
    without the row mask, its columns per k and shared over K (stride
    0), equal to the plain version within `tol` and bitwise equal to
    the tile kernel (with the row mask: to the tile kernel's output
    masked afterwards); then the square zero-diagonal build on shared
    coordinates (the test stack) at every mb and at d = 1, 3, 8, bitwise
    equal to the symmetric kernel, with the exact invariants. On the
    type `uni` draws."""
    import torch
    from smk_torch.ops import fused_build as fb

    k, s = 2, 2
    worst, cases = 0.0, 0
    for ma in NARROW_MA:
        coords = uni(k, ma, 2, hi=2.0)
        rmask = (uni(k, ma) > 0.2).to(coords.dtype)
        for mb in NARROW_MB:
            other = uni(k, mb, 2, hi=2.0) + 0.3
            phis = uni(k, s, lo=4.0, hi=12.0)
            for model in MODELS:
                for cb in (other, other[:1].expand(k, mb, 2)):
                    tile = launch_nan(coords, cb, phis, model, fb.TILED)
                    for rm in (None, rmask):
                        what = (f"narrow cross ma={ma}/mb={mb}/{model}/shared={cb.stride(0) == 0}"
                                f"/row_mask={rm is not None}")
                        got = launch_nan(coords, cb, phis, model, fb.NARROW, row_mask=rm)
                        want = fb.plain_build(coords, cb, phis, model, row_mask=rm)
                        worst = max(worst, compare(got, want, what, *tol))
                        ref = tile if rm is None else rm[:, None, :, None] * tile
                        check(torch.equal(got, ref), f"{what}: narrow kernel != tile kernel")
                        cases += 1
    for m, d in [(m, 2) for m in NARROW_MB] + [(123, 1), (123, 3), (64, 8)]:
        sites = uni(m, d, hi=2.0)[None].expand(k, m, d)
        phis = uni(k, s, lo=4.0, hi=12.0)
        for model in MODELS:
            what = f"narrow square m={m}/d={d}/{model}"
            got = launch_nan(sites, sites, phis, model, fb.NARROW, zero_diag=True)
            sym = launch_nan(sites, sites, phis, model, fb.SYMMETRIC, zero_diag=True)
            want = fb.plain_build(sites, sites[:1], phis, model, zero_diag=True)
            worst = max(worst, compare(got, want, what, *tol))
            check(torch.equal(got, sym), f"{what}: narrow kernel != symmetric kernel")
            square_invariants(got, None, None, what)
            cases += 1
    return {"ma": list(NARROW_MA), "mb": list(NARROW_MB), "d": [1, 2, 3, 8], "K": k, "s": s,
            "cases": cases, "max_abs_err": worst}


def kernels_phase(device):
    import torch
    from smk_torch.ops import fused_build as fb

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def uni(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    checks = []
    # ---- ragged m = 147 and the mismatched cross (147, 123), K = 3 ----
    k, m, mb = 3, 147, 123
    coords = uni(k, m, 2, hi=2.0)
    other = uni(k, mb, 2, hi=2.0) + 0.3
    phis = uni(k, 3, lo=4.0, hi=12.0)
    mask = torch.ones(k, m, device=device)
    mask[:, -11:] = 0.0
    shift = torch.where(mask > 0, uni(k, m, lo=0.5, hi=2.0), torch.full_like(mask, 1e8))
    for model in MODELS:
        cases = [
            ("fused_masked_correlation_stack",
             lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model),
             dict(ca=coords, cb=coords, mask=mask, zero_diag=True), mask, None),
            ("fused_masked_shifted_build",
             lambda: fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
             dict(ca=coords, cb=coords, mask=mask, shift=shift, zero_diag=True), mask, shift),
            ("fused_masked_shifted_build",  # scalar shift, broadcast
             lambda: fb.fused_masked_shifted_build(coords, phis, mask, 0.25, model),
             dict(ca=coords, cb=coords, mask=mask, shift=torch.full_like(mask, 0.25),
                  zero_diag=True), mask, torch.full_like(mask, 0.25)),
            ("fused_correlation_stack",
             lambda: fb.fused_correlation_stack(coords, phis, model),
             dict(ca=coords, cb=coords, zero_diag=True), None, None),
            ("fused_cross_correlation",
             lambda: fb.fused_cross_correlation(coords, other, phis, model),
             dict(ca=coords, cb=other), None, None),
            ("fused_cross_correlation",  # the sampler's call: pad rows zeroed
             lambda: fb.fused_cross_correlation(coords, other, phis, model, row_mask=mask),
             dict(ca=coords, cb=other, row_mask=mask), None, None),
            ("fused_correlation",
             lambda: fb.fused_correlation(coords, phis[:, 0], model)[:, None],
             dict(ca=coords, cb=coords, zero_diag=True, phis=phis[:, :1]), None, None),
        ]
        for name, run, spec, mk, sh in cases:
            before = fb.LAUNCHES[name]
            got = run()
            torch.cuda.synchronize()
            check(fb.LAUNCHES[name] == before + 1, f"{name}: launch not counted")
            want = fb.plain_build(
                spec["ca"], spec["cb"], spec.get("phis", phis), model,
                mask=spec.get("mask"), shift=spec.get("shift"),
                zero_diag=spec.get("zero_diag", False), row_mask=spec.get("row_mask"),
            )
            err = compare(got, want, f"{name}/{model}/m={m}")
            if spec.get("zero_diag"):
                square_invariants(got, mk, sh, f"{name}/{model}")
            checks.append({"entry": name, "model": model, "shape": list(got.shape),
                           "row_mask": "row_mask" in spec, "max_abs_err": err})
    # shared 2-D coords (the kriging test build) keep stride 0 on K
    got = fb.fused_correlation_stack(other[0], phis, "exponential")
    want = fb.plain_build(other[:1].expand(k, mb, 2), other[:1], phis, "exponential",
                          zero_diag=True)
    checks.append({"entry": "fused_correlation_stack", "model": "exponential",
                   "shape": list(got.shape), "shared_coords": True,
                   "max_abs_err": compare(got, want, "shared-coords stack")})

    sweep = ragged_sweep(uni)
    narrow = narrow_sweep(uni)
    torch.cuda.empty_cache()

    # ---- main-path shapes: K = 32, m = 3906, t = 64, s = q = 1 ----
    k, m, t = MAIN_K, MAIN_M, MAIN_T
    coords = uni(k, m, 2)
    test = uni(t, 2)
    phis = uni(k, 1, lo=4.0, hi=12.0)
    mask = torch.ones(k, m, device=device)
    shift = uni(k, m, lo=0.5, hi=2.0) + 4.0e-3
    model = "exponential"
    test_k = test[None].expand(k, t, 2)  # the test sites, shared over K
    main = {
        "fused_masked_correlation_stack": (
            lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model),
            dict(ca=coords, cb=coords, mask=mask, zero_diag=True),
            [coords, phis, mask], (True, False), (coords, coords)),
        "fused_masked_shifted_build": (
            lambda: fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
            dict(ca=coords, cb=coords, mask=mask, shift=shift, zero_diag=True),
            [coords, phis, mask, shift], (True, True), (coords, coords)),
        "fused_cross_correlation": (  # as the sampler calls it
            lambda: fb.fused_cross_correlation(coords, test, phis, model, row_mask=mask),
            dict(ca=coords, cb=test[None], row_mask=mask),
            [coords, test, phis, mask], (False, False), (coords, test_k)),
        "fused_correlation_stack": (
            lambda: fb.fused_correlation_stack(test, phis, model),
            dict(ca=test[None].expand(k, t, 2), cb=test[None], zero_diag=True),
            [test, phis], (False, False), (test[None], test[None])),
        "fused_correlation": (
            lambda: fb.fused_correlation(coords, phis[:, 0], model)[:, None],
            dict(ca=coords, cb=coords, zero_diag=True),
            [coords, phis], (False, False), (coords, coords)),
    }
    timings = {}
    for name, (run, spec, inputs, (masked, shifted), (a, b)) in main.items():
        got = run()
        want = fb.plain_build(
            spec["ca"], spec["cb"], phis, model, mask=spec.get("mask"),
            shift=spec.get("shift"), zero_diag=spec.get("zero_diag", False),
            row_mask=spec.get("row_mask"),
        )
        err = compare(got, want, f"{name} at the main-path shape")
        if spec.get("zero_diag"):
            square_invariants(got, spec.get("mask"), spec.get("shift"), name)
        del want
        tile_ms = tile_device_ms = sym_ms = sym_device_ms = None
        if name in ("fused_masked_correlation_stack", "fused_masked_shifted_build"):
            # the symmetric kernel against the tile kernel, bitwise, and
            # the tile kernel's times on the same inputs
            sym = launch_nan(coords, coords, phis, model, fb.SYMMETRIC, mask=mask,
                             shift=spec.get("shift"), zero_diag=True)
            tile = launch_nan(coords, coords, phis, model, fb.TILED, mask=mask,
                              shift=spec.get("shift"), zero_diag=True)
            check(torch.equal(sym, tile), f"{name}: symmetric kernel != tile kernel at the main-path shape")
            check(torch.equal(sym, got), f"{name}: entry point != symmetric kernel")
            del sym
            tile_run = lambda: fb._launch(  # noqa: E731
                coords, coords, phis, mask, spec.get("shift"), model, True, tile, fb.TILED)
            tile_ms = ms_median(tile_run)
            tile_device_ms = ms_median(tile_run, device_only=True)
            del tile
        elif name == "fused_cross_correlation":
            # the narrow kernel against the tile kernel, bitwise, without
            # the row mask, and with it in the kernel against the tile
            # kernel's output masked afterwards (the sampler's product
            # before the mask moved into the kernel), with pad rows so
            # that the mask has zeros; and the tile kernel's times (no
            # mask) on the same inputs
            pad = mask.clone()
            pad[:, -11:] = 0.0
            tile = launch_nan(coords, test_k, phis, model, fb.TILED)
            nar = launch_nan(coords, test_k, phis, model, fb.NARROW)
            check(torch.equal(nar, tile), f"{name}: narrow kernel != tile kernel at the main-path shape")
            nar = launch_nan(coords, test_k, phis, model, fb.NARROW, row_mask=pad)
            check(torch.equal(nar, pad[:, None, :, None] * tile),
                  f"{name}: the in-kernel row mask != the tile kernel masked afterwards")
            nar = launch_nan(coords, test_k, phis, model, fb.NARROW, row_mask=mask)
            check(torch.equal(nar, got), f"{name}: entry point != narrow kernel")
            del nar
            tile_run = lambda: fb._launch(  # noqa: E731
                coords, test_k, phis, None, None, model, False, tile, fb.TILED)
            tile_ms = ms_median(tile_run)
            tile_device_ms = ms_median(tile_run, device_only=True)
            del tile
        elif name == "fused_correlation_stack":
            # the narrow kernel against the symmetric kernel (this build's
            # kernel before the narrow one), bitwise, and the latter's times
            nar = launch_nan(test_k, test_k, phis, model, fb.NARROW, zero_diag=True)
            sym = launch_nan(test_k, test_k, phis, model, fb.SYMMETRIC, zero_diag=True)
            check(torch.equal(nar, sym), f"{name}: narrow kernel != symmetric kernel at the main-path shape")
            check(torch.equal(nar, got), f"{name}: entry point != narrow kernel")
            sym_run = lambda: fb._launch(  # noqa: E731
                test_k, test_k, phis, None, None, model, True, sym, fb.SYMMETRIC)
            sym_ms = ms_median(sym_run)
            sym_device_ms = ms_median(sym_run, device_only=True)
            del nar, sym
        rm = spec.get("row_mask")
        plain = lambda: fb.plain_build(  # noqa: E731
            spec["ca"], spec["cb"], phis, model, mask=spec.get("mask"),
            shift=spec.get("shift"), zero_diag=spec.get("zero_diag", False), row_mask=rm,
        )

        def library():
            rho = torch.exp(-phis[:, :, None, None] * torch.cdist(a, b)[:, None])
            return rho if rm is None else rm[:, None, :, None] * rho

        ms = ms_median(run)
        device_ms = ms_median(run, device_only=True)
        plain_ms = ms_median(plain)
        library_ms = ms_median(library)
        b_ms, b_by = bound(inputs, got, model, masked, shifted, rm is not None)
        timings[name] = {
            "shape": list(got.shape), "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "achieved_GBps": min_bytes(inputs, got) / (ms * 1e-3) / 1e9,
            "bound_fraction": b_ms / ms, "device_bound_fraction": b_ms / device_ms,
            "write_bytes": got.numel() * 4, "tile_kernel_ms": tile_ms,
            "tile_kernel_device_ms": tile_device_ms,
            "symmetric_kernel_ms": sym_ms, "symmetric_kernel_device_ms": sym_device_ms,
        }
        del got
        torch.cuda.empty_cache()

    # the adaptive schedule's compacted groups: the symmetric and narrow
    # kernels at the first rungs of the K ladder below K = 32, at m = 3906,
    # timed as at K = 32
    compacted = []
    for kb in COMPACT_K:
        cb, pb, mb_, sb = coords[:kb], phis[:kb], mask[:kb], shift[:kb]
        tb = test[None].expand(kb, t, 2)
        cases = (
            ("fused_masked_correlation_stack", "symmetric",
             lambda: fb.fused_masked_correlation_stack(cb, pb, mb_, model),
             dict(ca=cb, cb=cb, mask=mb_, zero_diag=True), [cb, pb, mb_], (True, False),
             (cb, cb)),
            ("fused_masked_shifted_build", "symmetric",
             lambda: fb.fused_masked_shifted_build(cb, pb, mb_, sb, model),
             dict(ca=cb, cb=cb, mask=mb_, shift=sb, zero_diag=True), [cb, pb, mb_, sb],
             (True, True), (cb, cb)),
            ("fused_cross_correlation", "narrow",
             lambda: fb.fused_cross_correlation(cb, test, pb, model, row_mask=mb_),
             dict(ca=cb, cb=test[None], row_mask=mb_), [cb, test, pb, mb_], (False, False),
             (cb, tb)),
            ("fused_correlation_stack", "narrow",
             lambda: fb.fused_correlation_stack(test, pb, model),
             dict(ca=tb, cb=test[None], zero_diag=True), [test, pb], (False, False),
             (test[None], test[None])),
        )
        for name, kern, run, spec, inputs, (masked, shifted), (a, b) in cases:
            before = launches_by_kernel()[kern]
            got = run()
            torch.cuda.synchronize()
            check(launches_by_kernel()[kern] == before + 1,
                  f"{name} at K = {kb}: the {kern} kernel did not launch")
            rm = spec.get("row_mask")
            plain = lambda: fb.plain_build(  # noqa: E731
                spec["ca"], spec["cb"], pb, model, mask=spec.get("mask"),
                shift=spec.get("shift"), zero_diag=spec.get("zero_diag", False), row_mask=rm)

            def library():
                rho = torch.exp(-pb[:, :, None, None] * torch.cdist(a, b)[:, None])
                return rho if rm is None else rm[:, None, :, None] * rho

            want = plain()
            err = compare(got, want, f"{name} at K = {kb}")
            del want
            b_ms, b_by = bound(inputs, got, model, masked, shifted, rm is not None)
            compacted.append({"entry": name, "kernel": kern, "shape": list(got.shape),
                              "max_abs_err": err, "ms": ms_median(run),
                              "device_ms": ms_median(run, device_only=True),
                              "plain_ms": ms_median(plain), "library_ms": ms_median(library),
                              "bound_ms": b_ms, "bound_by": b_by})
            del got
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()

    # the narrow and the tile kernel on wider cross builds
    wide = []
    for mb in WIDE_MB:
        sites = uni(mb, 2)[None].expand(k, mb, 2)
        row = {"shape": [k, 1, m, mb]}
        outs = []
        for label, layout in (("narrow", fb.NARROW), ("tile", fb.TILED)):
            out = launch_nan(coords, sites, phis, model, layout)
            outs.append(out)
            row[f"{label}_device_ms"] = ms_median(
                lambda out=out, layout=layout: fb._launch(
                    coords, sites, phis, None, None, model, False, out, layout),
                device_only=True)
        check(torch.equal(outs[0], outs[1]), f"cross mb={mb}: narrow kernel != tile kernel")
        row["bound_ms"] = bound([coords, sites[0], phis], outs[0], model, False, False)[0]
        wide.append(row)
        del outs, out
        torch.cuda.empty_cache()

    # an empty launch: the floor of the small stack's device time
    floor = {"launch_floor_ms": ms_median(lambda: torch.cuda._sleep(1)),
             "launch_floor_device_ms": ms_median(lambda: torch.cuda._sleep(1),
                                                 device_only=True)}

    # the sampler's whole kriging build (cross build with its row mask,
    # test stack) as the fit calls it
    from smk_torch import SMKConfig
    from smk_torch.models.probit_gp import BuildConsts, SpatialGPSampler

    sampler = SpatialGPSampler(SMKConfig(n_subsets=k, fused_build="pallas"))
    consts = BuildConsts(None, None, None, coords, test)
    before = dict(fb.LAUNCHES)
    r_cross, r_test = sampler._cross_test_corr(consts, phis, mask)
    check(fb.LAUNCHES["fused_cross_correlation"] == before["fused_cross_correlation"] + 1
          and fb.LAUNCHES["fused_correlation_stack"] == before["fused_correlation_stack"] + 1,
          "_cross_test_corr: its two builds did not launch their kernels")
    krige = {
        "shapes": [list(r_cross.shape), list(r_test.shape)],
        "max_abs_err": max(
            compare(r_cross, fb.plain_build(coords, test[None], phis, model, row_mask=mask),
                    "_cross_test_corr cross"),
            compare(r_test, fb.plain_build(test_k, test[None], phis, model, zero_diag=True),
                    "_cross_test_corr test")),
        "ms": ms_median(lambda: sampler._cross_test_corr(consts, phis, mask)),
        "device_ms": ms_median(lambda: sampler._cross_test_corr(consts, phis, mask),
                               device_only=True),
    }
    emit({"phase": "kernels", "tolerance": {"atol": ATOL, "rtol": RTOL},
          "checks": checks, "ragged_sweep": sweep, "narrow_sweep": narrow,
          "main_path": timings, "compacted_batches": compacted, "wide_cross": wide, **floor,
          "cross_test_corr": krige, "launches_in_phase": dict(fb.LAUNCHES)})
    return timings


# ----------------------------------------------------------------------
# phases 4-6: fits
# ----------------------------------------------------------------------
def binary_field(n, q, p, t, seed, phi=6.0, n_features=256):
    """Probit binary field over uniform locations with an
    RFF-approximated exponential-type GP latent (the bench's
    make_binary_field recipe), in numpy from ``seed``; the last t points
    are the test sites."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n + t, 2))
    freqs = phi * rng.standard_cauchy(size=(n_features, 2))
    phase = rng.uniform(0.0, 2.0 * np.pi, size=n_features)
    coef = rng.normal(size=(q, n_features))
    w = np.sqrt(2.0 / n_features) * np.cos(coords @ freqs.T + phase) @ coef.T
    x = np.concatenate(
        [np.ones((n + t, q, 1)), rng.normal(size=(n + t, q, p - 1))], -1
    )
    beta = np.linspace(0.8, -0.6, q * p).reshape(q, p)
    eta = np.einsum("nqp,qp->nq", x, beta) + w
    import torch

    prob = torch.special.ndtr(torch.from_numpy(eta)).numpy()
    y = (rng.uniform(size=eta.shape) < prob).astype(np.float32)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return f32(y[:n]), f32(x[:n]), f32(coords[:n]), f32(coords[n:]), f32(x[n:])


class NoiseOnDevice:
    """A FitRandomness whose numbers are drawn on the CPU and moved to
    the card, so a card fit and a CPU fit consume the same numbers."""

    def __init__(self, seed, device, dtype=None):
        import torch
        from smk_torch.api import TorchRandomness

        self.rng = TorchRandomness(seed, "cpu", dtype or torch.float32)
        self.device = device

    def permutation(self, n):
        return self.rng.permutation(n)

    def sweep_noise(self, shapes):
        return DeviceNoise(self.rng.sweep_noise(shapes), self.device)

    def resample_index(self, n_draws, n_grid):
        return self.rng.resample_index(n_draws, n_grid)


class DeviceNoise:
    """A noise source drawing on the CPU (GeneratorNoise) and handing each
    sweep's numbers to the card, with the chunked executor's operations
    (rows, snapshot, restore, fork, identity) on the CPU streams."""

    def __init__(self, src, device):
        self.src, self.device = src, device

    def __call__(self, it, collect):
        from smk_torch.models.probit_gp import SweepNoise

        return SweepNoise(*(None if a is None else a.to(self.device)
                            for a in self.src(it, collect)))

    def rows(self, ids, *, m=None):
        return DeviceNoise(self.src.rows(ids, m=m), self.device)

    def snapshot(self):
        return self.src.snapshot()

    def restore(self, snap):
        self.src.restore(snap)

    def fork(self, mask, attempts):
        self.src.fork(mask, attempts)

    def identity(self):
        return self.src.identity()


def expected_launches(cfg, q):
    """Launches per entry point implied by the sampler (phi updated every
    sweep): B1a once at init and once per sweep (the phi proposal); B1b
    once per component per sweep (the u-draw's S build); B1c and B1d
    once at the start of sampling (the kriging cache) and once per kept
    sweep (the proposal's kriging operators)."""
    return {
        "fused_correlation": 0,
        "fused_correlation_stack": 1 + cfg.n_kept,
        "fused_masked_correlation_stack": 1 + cfg.n_samples,
        "fused_cross_correlation": 1 + cfg.n_kept,
        "fused_masked_shifted_build": q * cfg.n_samples,
    }


def launches_by_kernel():
    """fused_build.LAYOUT_LAUNCHES by kernel name."""
    from smk_torch.ops import fused_build as fb

    names = {fb.TILED: "tile", fb.SYMMETRIC: "symmetric", fb.NARROW: "narrow",
             fb.TILED_F64: "tile_f64", fb.SYMMETRIC_F64: "symmetric_f64",
             fb.NARROW_F64: "narrow_f64"}
    return {name: fb.LAYOUT_LAUNCHES[key] for key, name in names.items()}


def expected_by_kernel(launches, float64=False):
    """Launches by kernel that launches per entry point imply at config
    scale: the masked and shifted builds (and fused_correlation, 0 on
    every path) on the symmetric kernel, the kriging builds on the
    narrow kernel, both of the fit's type; none on either tile kernel."""
    sfx = "_f64" if float64 else ""
    out = dict.fromkeys(("tile", "symmetric", "narrow", "tile_f64", "symmetric_f64",
                         "narrow_f64"), 0)
    out["symmetric" + sfx] = (launches["fused_masked_correlation_stack"]
                              + launches["fused_masked_shifted_build"]
                              + launches["fused_correlation"])
    out["narrow" + sfx] = (launches["fused_cross_correlation"]
                           + launches["fused_correlation_stack"])
    return out


def run_fit(name, *, n, k, q, p, t, n_samples, device, dtype="float32", profile=False,
            artifact_path=None):
    """fit_meta_kriging with the default sampler at (n, K, q, p, t) in
    `dtype`: launches per entry point and per kernel against the
    sampler's formula, no plain call, finite outputs of the expected
    shapes, p and acceptance rates in [0, 1]; with `profile`, one
    profiler window over two sweeps of the same sampler on the fit's
    inputs (profile_sweeps: device busy and idle, the factorizations'
    share); with `artifact_path`, the fit saved there as a serving
    artifact (serve/artifact.save_artifact: its seconds and bytes under
    "artifact")."""
    import numpy as np
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.models.probit_gp import n_params
    from smk_torch.ops import fused_build as fb

    cfg = SMKConfig(n_subsets=k, n_samples=n_samples, fused_build="pallas", dtype=dtype)
    data = binary_field(n, q, p, t, SEED + n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    start = time.perf_counter()
    res = fit_meta_kriging(*data, config=cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(fb.LAUNCHES)
    want = expected_launches(cfg, q)
    check(launches == want, f"{name}: launches {launches} != expected {want}")
    # the kriging builds on the narrow kernel, the masked ones on the
    # symmetric kernel, of the fit's type; none on a tile kernel
    layouts = launches_by_kernel()
    want_layouts = expected_by_kernel(want, float64=dtype == "float64")
    check(layouts == want_layouts, f"{name}: launches by kernel {layouts} != {want_layouts}")
    check(all(launches[e] > 0 for e in MAIN_PATH), f"{name}: a main-path kernel never launched")
    check(sum(fb.PLAIN_CALLS.values()) == 0, f"{name}: a plain build ran on the card path")
    check(tuple(res.p_quant.shape) == (3, t * q), f"{name}: p_quant shape {tuple(res.p_quant.shape)}")
    check(tuple(res.param_quant.shape) == (3, n_params(q, p)), f"{name}: param_quant shape")
    check(bool(torch.isfinite(res.p_quant).all()), f"{name}: non-finite p_quant")
    check(bool(torch.isfinite(res.param_quant).all()), f"{name}: non-finite param_quant")
    acc = res.phi_accept_rate
    check(bool(((acc >= 0) & (acc <= 1)).all()), f"{name}: phi_accept_rate outside [0, 1]")
    p_q = res.p_quant.cpu().numpy()
    check(bool(((p_q >= 0) & (p_q <= 1)).all()), f"{name}: p outside [0, 1]")
    artifact = None
    if artifact_path is not None:
        import os

        from smk_torch.serve import save_artifact

        start = time.perf_counter()
        save_artifact(artifact_path, res, data[3], config=cfg)
        artifact = {"path": artifact_path, "save_s": time.perf_counter() - start,
                    "bytes": os.path.getsize(artifact_path)}
    secs = res.phase_seconds
    out = {
        "artifact": artifact,
        "phase": name, "n": n, "K": k, "m": -(-n // k), "q": q, "p": p, "t": t,
        "dtype": dtype, "n_samples": cfg.n_samples, "n_burn_in": cfg.n_burn_in,
        "n_kept": cfg.n_kept, "fused_build": cfg.fused_build, "wall_s": wall,
        "phase_seconds": secs, "ms_per_sweep": secs["subset_fits"] / cfg.n_samples * 1e3,
        "latent_ess_per_sec": res.latent_ess_per_sec,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_expected": want, "launches_by_kernel": layouts,
        "phi_accept_rate_mean": float(acc.mean()),
        "param_quant_median": np.round(res.param_quant[0].cpu().numpy(), 4).tolist(),
    }
    if profile:
        check(res.param_quant.dtype == getattr(torch, dtype), f"{name}: outputs not {dtype}")
        del res
        torch.cuda.empty_cache()
        model, sdata, state, consts, noise = sampler_setup(cfg, data, device)
        cache = model._solve_cache(consts, sdata.mask, state)

        def sweeps(its):
            nonlocal state, cache
            for it in its:
                state, cache, _ = model._gibbs_step(sdata, consts, state, cache, it,
                                                    noise(it, False), collect=False)

        sweeps([0])  # warm
        prof = profile_sweeps(lambda: sweeps([1, 2]))
        busy = prof["device_busy_ms"]
        prof["factor_share_of_busy"] = prof["potrf_device_ms"] / busy if busy else None
        prof["factor_share_of_window"] = prof["potrf_device_ms"] / prof["window_ms"]
        out["profile_two_sweeps"] = prof
        check(bool(torch.isfinite(state.chol_r).all()), f"{name}: non-finite state after profiling")
    emit(out)
    return out


def fit_small_parity(device):
    """A small fit through the kernel on the card against the same fit
    through the plain version on the CPU (same random numbers). Both
    sides are fp32 with cuSOLVER vs LAPACK factorizations; over 12
    sweeps the chains agree to ~1e-5, so 2e-3 flags a real fault."""
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.ops import fused_build as fb

    cfg = SMKConfig(n_subsets=4, n_samples=12, fused_build="pallas")
    data = binary_field(400, 2, 2, 8, SEED)
    fb.reset_counts()
    gpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, device),
                           device=device)
    check(sum(fb.LAUNCHES.values()) > 0 and sum(fb.PLAIN_CALLS.values()) == 0,
          "small parity: the card fit did not run the kernel")
    cpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, "cpu"),
                           device="cpu")
    check(sum(fb.PLAIN_CALLS.values()) > 0, "small parity: the CPU fit did not run the plain version")
    errs = {}
    for f in ("param_grid", "w_grid", "p_quant", "param_quant"):
        err = float((getattr(gpu, f).cpu() - getattr(cpu, f)).abs().max())
        errs[f] = err
        check(err <= 2e-3, f"small parity: {f} differs by {err:.3e}")
    emit({"phase": "fit_small_parity", "max_abs_err": errs, "tolerance": 2e-3})


# ----------------------------------------------------------------------
# phases 7-11: the production sampler (bench.py:rung_config)
# ----------------------------------------------------------------------
# config4's shape: K subsets of m eBird-proxy checklists, q = 2 species,
# p = 3 covariates, t test sites
C4_K, C4_M, C4_Q, C4_P, C4_T = 64, 1024, 2, 3, 64
# the production CG: Nystrom rank, iterations, blocked-solve panel
PROD_RANK, PROD_CG_ITERS, PROD_BLOCK = 256, 8, 512
# the CG solve's error floor against a dense solve: the bf16 operator's
# rounding (the twin's docstring, smk_tpu/ops/cg.py:143-147, puts it
# near 2e-2 at m = 3906)
CG_ERR_MAX = 5e-2


def production_config(*, k, n_samples, link="probit", phi_every=16, rank=PROD_RANK,
                      block=PROD_BLOCK, **overrides):
    """The sampler bench.py:rung_config builds for every rung of the JAX
    benchmark: collapsed phi every `phi_every` sweeps, single-try
    Gaussian; Nystrom-preconditioned CG (8 steps) with a bf16 operator;
    blocked triangular solves; the inverse-Wishart A prior; one chain
    (the bench's full ladder runs two: n_chains in `overrides`, as any
    other field). Its live diagnostics (observability; the draws are the
    same without them, bench.py:592-596) are not ported."""
    from smk_torch import PriorConfig, SMKConfig

    fields = dict(
        n_subsets=k, n_samples=n_samples, link=link, cov_model="exponential",
        fused_build="pallas", phi_sampler="collapsed", phi_update_every=phi_every,
        phi_proposals=1, phi_proposal_family="gaussian", u_solver="cg",
        cg_precond="nystrom", cg_precond_rank=rank, cg_iters=PROD_CG_ITERS,
        cg_matvec_dtype="bfloat16", trisolve_block_size=block,
        priors=PriorConfig(a_prior="invwishart", temper="none"),
    )
    fields.update(overrides)
    return SMKConfig(**fields)


def ebird_data(n, t):
    """config4's data (bench.py:_ebird_triplet): the eBird proxy at n + t
    checklists, the last t the test sites."""
    from smk_torch.data.ebird import make_ebird_proxy

    d = make_ebird_proxy(n=n + t)
    return d.y[:n], d.x[:n], d.coords[:n], d.coords[n:], d.x[n:]


def kernels_config4(device):
    """The symmetric kernel at config4's (64, 2, 1024, 1024) builds, masked
    and masked + shifted, and the narrow kernel at its (64, 1, 1024, 64)
    cross build with the row mask, on eBird-proxy coordinates (Thomas
    clusters: near-duplicate points), each against its plain version with
    the exact invariants; with and without pad rows. Device times beside
    the plain version's."""
    import numpy as np
    import torch
    from smk_torch.ops import fused_build as fb

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 4)
    k, m, t = C4_K, C4_M, C4_T
    _, _, coords_np, test_np, _ = ebird_data(k * m, t)
    perm = np.random.default_rng(SEED).permutation(k * m)
    coords = torch.as_tensor(coords_np[perm].reshape(k, m, 2), device=device)
    test = torch.as_tensor(test_np, device=device)
    d2 = torch.cdist(coords.double(), coords.double())
    d2.diagonal(dim1=-2, dim2=-1).fill_(float("inf"))
    nearest = d2.amin(dim=(-2, -1))  # closest pair in each subset
    del d2
    phis = 4.0 + 8.0 * torch.rand((k, C4_Q), generator=gen, device=device)
    ones = torch.ones(k, m, device=device)
    pad = ones.clone()
    pad[:, -13:] = 0.0
    model = "exponential"
    out, worst = [], 0.0
    for label, mask in (("no_pad", ones), ("pad", pad)):
        shift = torch.where(
            mask > 0, 0.5 + 1.5 * torch.rand((k, m), generator=gen, device=device),
            torch.full_like(mask, 1e8)) + 2.56e-4
        cases = {
            "fused_masked_correlation_stack": (
                lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model),
                dict(mask=mask, zero_diag=True), phis, None),
            "fused_masked_shifted_build": (
                lambda: fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
                dict(mask=mask, shift=shift, zero_diag=True), phis, shift),
            "fused_cross_correlation": (
                lambda: fb.fused_cross_correlation(coords, test, phis[:, :1], model,
                                                   row_mask=mask),
                dict(row_mask=mask), phis[:, :1], None),
        }
        for name, (run, spec, ph, sh) in cases.items():
            got = run()
            cb = coords if spec.get("zero_diag") else test[None]
            want = fb.plain_build(coords, cb, ph, model, **spec)
            err = compare(got, want, f"config4 {name}/{label}")
            worst = max(worst, err)
            if spec.get("zero_diag"):
                square_invariants(got, mask, sh, f"config4 {name}/{label}")
            row = {"entry": name, "mask": label, "shape": list(got.shape), "max_abs_err": err}
            if label == "no_pad":
                row["device_ms"] = ms_median(run, device_only=True)
                row["plain_ms"] = ms_median(lambda: fb.plain_build(coords, cb, ph, model, **spec))
            out.append(row)
            del got, want
    emit({"phase": "kernels_config4", "tolerance": {"atol": ATOL, "rtol": RTOL},
          "closest_pair_min": float(nearest.min()), "closest_pair_median":
          float(nearest.median()), "checks": out, "max_abs_err": worst})


def production_ops(device):
    """The production solver's pieces at config5's shape (K = 32,
    m = 3906), on a masked R~ from the kernel (11 pad rows a subset):
    the bf16 operator's product against its plain upcast form; an 8-step
    Nystrom CG solve (rank 256) of (R~ + diag(jit + d)) s = b against an
    fp32 Cholesky solve; the blocked triangular solve (panel 512, carried
    panel inverses) against torch.linalg.solve_triangular with 1 and 64
    right-hand sides. Device times throughout."""
    import torch
    from smk_torch.ops import cg
    from smk_torch.ops import chol
    from smk_torch.ops import fused_build as fb

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    k, m = MAIN_K, MAIN_M
    coords = torch.rand((k, m, 2), generator=gen, device=device)
    phis = 4.0 + 8.0 * torch.rand((k, 1), generator=gen, device=device)
    mask = torch.ones(k, m, device=device)
    mask[:, -11:] = 0.0
    jit = max(1e-5, 2.5e-7 * m)
    r = fb.fused_masked_correlation_stack(coords, phis, mask, "exponential")[:, 0]
    x = torch.randn((k, m), generator=gen, device=device)
    res = {"phase": "production_ops", "K": k, "m": m}

    # the bf16 operator's product: exact products, fp32 sums
    r_mv = r.to(torch.bfloat16)
    got = cg.bf16_matvec(r_mv, x)
    check(got.dtype == torch.float32, "bf16 product: the output is not fp32")
    xb = x.to(torch.bfloat16).float()
    want = (r_mv.float() @ xb[..., None])[..., 0]
    scale = (r_mv.float().abs() @ xb.abs()[..., None])[..., 0]
    rel = float(((got - want).abs() / scale).max())
    # two fp32 sums of the same m exact products: at most ~m * 2^-24 apart
    check(rel <= m * 2.0 ** -24, f"bf16 product: relative error {rel:.3e}")
    rounded = float(((got.to(torch.bfloat16).float() - got).abs() / scale).max())
    check(rounded > 0, "bf16 product: the output is bf16-representable (rounded)")
    r_f32 = r.clone()
    res["bf16_product"] = {
        "route": "torch.bmm(bf16, bf16, out_dtype=torch.float32)",
        "max_rel_err_vs_upcast": rel, "bound": m * 2.0 ** -24,
        "device_ms": ms_median(lambda: cg.bf16_matvec(r_mv, x), device_only=True),
        "upcast_device_ms": ms_median(lambda: (r_mv.float() @ xb[..., None]), device_only=True),
        "fp32_device_ms": ms_median(lambda: r_f32 @ x[..., None], device_only=True),
        "bound_ms": (r_mv.numel() * 2 + x.numel() * 4 * 2) / HBM_BYTES_PER_S * 1e3,
    }
    del want, scale, r_f32

    # the 8-step Nystrom CG solve against a dense fp32 solve
    d = torch.where(mask > 0, 0.5 + 1.5 * torch.rand((k, m), generator=gen, device=device),
                    torch.full_like(mask, 1e8))
    shift = jit + d
    b = torch.randn((k, m), generator=gen, device=device)

    z = cg.nystrom_factor(r[..., :PROD_RANK])
    pre = cg.nystrom_apply(z, shift)
    mv_bf16 = cg.shifted_correlation_operator(r, shift, torch.bfloat16, torch.float32)[0]
    mv_f32 = cg.shifted_correlation_operator(r, shift, torch.float32, torch.float32)[0]
    s_bf16 = cg.cg_solve(mv_bf16, b, PROD_CG_ITERS, precond=pre)
    s_f32 = cg.cg_solve(mv_f32, b, PROD_CG_ITERS, precond=pre)
    a_mat = r.clone()
    a_mat.diagonal(dim1=-2, dim2=-1).add_(shift)
    l_s = chol.cholesky(a_mat)
    s_ref = chol.chol_solve(l_s, b)
    check(bool(torch.isfinite(s_ref).all()), "CG reference: non-finite dense solve")

    def rel_norm(v, ref):
        return float((torch.linalg.vector_norm(v - ref, dim=-1)
                      / torch.linalg.vector_norm(ref, dim=-1)).max())

    resid = (a_mat @ s_bf16[..., None])[..., 0] - b
    err_bf16 = rel_norm(s_bf16, s_ref)
    check(err_bf16 <= CG_ERR_MAX, f"CG: relative error {err_bf16:.3e} > {CG_ERR_MAX}")
    res["cg"] = {
        "iters": PROD_CG_ITERS, "rank": PROD_RANK, "precond": "nystrom",
        "rel_err_bf16": err_bf16, "rel_err_fp32": rel_norm(s_f32, s_ref),
        "rel_residual_bf16": float((torch.linalg.vector_norm(resid, dim=-1)
                                    / torch.linalg.vector_norm(b, dim=-1)).max()),
        "err_max": CG_ERR_MAX,
        # the 8 steps alone (operator and Nystrom factor built): what a
        # non-update sweep's u-draw costs per component
        "solve_device_ms": ms_median(
            lambda: cg.cg_solve(mv_bf16, b, PROD_CG_ITERS, precond=pre), reps=10,
            device_only=True),
        "nystrom_factor_device_ms": ms_median(
            lambda: cg.nystrom_factor(r[..., :PROD_RANK]), reps=10, device_only=True),
        "cholesky_solve_device_ms": ms_median(
            lambda: chol.chol_solve(chol.cholesky(a_mat), b), reps=5, device_only=True),
    }
    del a_mat, l_s, resid, mv_bf16, mv_f32, pre, z

    # blocked triangular solves against the native solve
    r.diagonal(dim1=-2, dim2=-1).add_(jit)
    l_r = chol.cholesky(r)[:, None]  # (K, 1, m, m)
    del r
    inv = chol.panel_inverses(l_r, PROD_BLOCK)
    tri = {"block": PROD_BLOCK,
           "panel_inverses_device_ms": ms_median(
               lambda: chol.panel_inverses(l_r, PROD_BLOCK), reps=10, device_only=True)}
    for n_rhs in (1, 64):
        rhs = torch.randn((k, 1, m, n_rhs), generator=gen, device=device)
        for trans in (False, True):
            got = chol.blocked_tri_solve(l_r, rhs, PROD_BLOCK, inv, trans=trans)
            want = chol.tri_solve(l_r, rhs, trans=trans)
            err = float((got - want).abs().max() / want.abs().max())
            check(err <= 1e-4, f"blocked solve rhs={n_rhs} trans={trans}: error {err:.3e}")
            tri[f"rhs{n_rhs}_{'trans' if trans else 'fwd'}"] = {
                "rel_err": err,
                "blocked_device_ms": ms_median(
                    lambda: chol.blocked_tri_solve(l_r, rhs, PROD_BLOCK, inv, trans=trans),
                    reps=10, device_only=True),
                "native_device_ms": ms_median(
                    lambda: chol.tri_solve(l_r, rhs, trans=trans), reps=10, device_only=True),
                "bound_ms": (l_r.numel() * 4 / 2 + 2 * rhs.numel() * 4) / HBM_BYTES_PER_S * 1e3,
            }
    res["tri_solve"] = tri
    emit(res)


def fit_production_small_parity(device):
    """The production sampler at a small size (rank 32 and panel 64 below
    m = 100, so both engage; phi every 2nd sweep) through the kernel on
    the card against the plain version on the CPU, with the same random
    numbers, probit and logit. The bf16 operator rounds each CG vector to
    bf16, and where the two devices' fp32 sums differ by an ulp an entry
    can land on the neighbouring bf16 value: ~2^-9 of a latent's scale
    (between the JAX and the port on the CPU: up to 6.2e-3 relative in
    three sweeps). Over 12 sweeps and the quantile compression the grids
    must agree to 3e-2 (1 + |x|)."""
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.ops import fused_build as fb

    out = {"phase": "fit_production_small_parity", "tolerance": "3e-2 * (1 + |cpu|)"}
    for link in ("probit", "logit"):
        cfg = production_config(k=4, n_samples=12, link=link, phi_every=2, rank=32, block=64)
        if link == "logit":
            y, x, coords, ct, xt = ebird_data(400, 8)
        else:
            y, x, coords, ct, xt = binary_field(400, 2, 2, 8, SEED)
        fb.reset_counts()
        gpu = fit_meta_kriging(y, x, coords, ct, xt, config=cfg,
                               randomness=NoiseOnDevice(SEED, device), device=device)
        check(sum(fb.LAUNCHES.values()) > 0 and sum(fb.PLAIN_CALLS.values()) == 0,
              f"production small parity ({link}): the card fit did not run the kernel")
        cpu = fit_meta_kriging(y, x, coords, ct, xt, config=cfg,
                               randomness=NoiseOnDevice(SEED, "cpu"), device="cpu")
        errs = {}
        for f in ("param_grid", "w_grid", "p_quant", "param_quant"):
            g, c = getattr(gpu, f).cpu(), getattr(cpu, f)
            err = float(((g - c).abs() / (1.0 + c.abs())).max())
            errs[f] = err
            check(err <= 3e-2, f"production small parity ({link}): {f} differs by {err:.3e}")
        out[link] = {"max_rel_err": errs, "accept_equal": bool(torch.equal(
            gpu.phi_accept_rate.cpu(), cpu.phi_accept_rate))}
    emit(out)


def _us(evt, *names) -> float:
    """The first of the timing attributes ``names`` a profiler event
    carries (their names changed across PyTorch versions), in us."""
    for name in names:
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def profile_sweeps(run_sweeps, top=10):
    """Device busy time (the sum of kernel times on the card) and idle
    share of a torch.profiler window over ``run_sweeps()``, with the
    largest kernels, and the time of the factorizations: the kernels
    cuSOLVER's batched potrf launches, all named potrf*."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_sweeps()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    per_kernel = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + _us(
                e, "device_time_total", "cuda_time_total")
    busy_ms = sum(per_kernel.values()) / 1e3
    potrf_us = sum(us for name, us in per_kernel.items() if "potrf" in name.lower())
    return {"window_ms": window_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / window_ms),
            "potrf_device_ms": potrf_us / 1e3,
            "top_device_ms": [[n[:80], us / 1e3] for n, us in
                              sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]]}


def sampler_setup(cfg, data_np, device, *, weight=1):
    """The fit's sampler on the fit's own inputs (TorchRandomness(SEED):
    the same partition, warm start and noise as fit_meta_kriging's):
    (model, data, state, consts, noise), data and state K*C rows wide."""
    import torch
    from smk_torch.api import TorchRandomness, stacked_design
    from smk_torch.models import probit_gp as tp
    from smk_torch.ops.glm import glm_warm_start
    from smk_torch.parallel.partition import random_partition

    dt = torch.float64 if cfg.dtype == "float64" else torch.float32
    y, x, coords, ct, xt = (torch.as_tensor(a, device=device, dtype=dt) for a in data_np)
    n, q = y.shape
    p = x.shape[-1]
    rng = TorchRandomness(SEED, device, dt)
    part = random_partition(rng.permutation(n).to(device), y, x, coords, cfg.n_subsets)
    y_long, x_long = stacked_design(y, x)
    beta0 = glm_warm_start(y_long, x_long, weight=weight, link=cfg.link).coef.reshape(q, p)
    model = tp.SpatialGPSampler(cfg, weight=weight)
    shapes = tp.sweep_shapes(cfg, part.n_subsets, part.subset_size, q, p, ct.shape[0], weight)
    noise = rng.sweep_noise(shapes)
    data = model.chain_data(tp.SubsetData(part.coords, part.x, part.y, part.mask, ct, xt))
    consts = model._consts(data)
    state = model.init_state(data, beta0, consts=consts)
    return model, data, state, consts, noise


def direct_sweeps(cfg, data_np, device, *, weight=1):
    """The fit's sampler schedule driven sweep by sweep, on the fit's own
    inputs (sampler_setup): each sweep's span on the device timeline
    (CUDA events), its factorization counts, and the subsets whose
    finite-factor guard turned an accepted move down; then
    torch.profiler windows over one update sweep and four non-update
    sweeps past the schedule."""
    import statistics as st

    import torch

    model, data, state, consts, noise = sampler_setup(cfg, data_np, device, weight=weight)
    e = cfg.phi_update_every
    spans, counts = {"update": [], "other": []}, {"update": set(), "other": set()}
    cache = None

    def sweep(it, collect, record=True):
        nonlocal state, cache
        n0 = (cache.n_chol, cache.n_chol_calls)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, cache, _ = model._gibbs_step(data, consts, state, cache, it, noise(it, collect),
                                            collect=collect)
        end.record()
        if record:
            kind = "update" if it % e == 0 else "other"
            spans[kind].append((start, end))
            counts[kind].add((cache.n_chol - n0[0], cache.n_chol_calls - n0[1]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = model._solve_cache(consts, data.mask, state)
    for it in range(cfg.n_burn_in):
        sweep(it, False)
    cache = model._solve_cache(consts, data.mask, state, predict=True)
    for it in range(cfg.n_burn_in, cfg.n_samples):
        sweep(it, True)
    torch.cuda.synchronize()
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    guard = model.guard_rejects
    out = {
        "update_sweep_ms_median": st.median(ms["update"]),
        "other_sweep_ms_median": st.median(ms["other"]),
        "update_sweep_ms": ms["update"],
        "n_update_sweeps": len(ms["update"]), "n_other_sweeps": len(ms["other"]),
        "n_chol_n_chol_calls_per_sweep": {k: sorted(v) for k, v in counts.items()},
        "guard_rejected_subsets": 0 if guard is None else int((guard > 0).sum()),
        "guard_rejected_moves": 0 if guard is None else int(guard.sum()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "finite_state": bool(torch.isfinite(state.chol_r).all() and torch.isfinite(state.u).all()),
    }
    check(out["finite_state"], "direct sweeps: non-finite chain state")
    nxt = cfg.n_samples + (-cfg.n_samples) % e  # the next update sweep
    out["profile_update_sweep"] = profile_sweeps(lambda: sweep(nxt, True, False))
    out["profile_other_sweeps"] = profile_sweeps(
        lambda: [sweep(nxt + i, True, False) for i in range(1, 5)])
    return out


def fit_production(name, *, cfg, data_np, device, weight=1, update_chol=None):
    """fit_meta_kriging with the production sampler: launches per entry
    point against the sampler's formula (probit_gp.build_calls) and per
    kernel, no plain call, finite outputs of the expected shapes, p and
    acceptance rates in [0, 1], with several chains the pooled draws and
    a finite cross-chain R-hat on every subset; then the same schedule
    sweep by sweep (direct_sweeps), where every update sweep must count
    `update_chol` (logical factorizations, batched calls) if given."""
    import numpy as np
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls, n_params
    from smk_torch.ops import fused_build as fb

    y, x, coords, ct, xt = data_np
    q, p, t = y.shape[1], x.shape[2], ct.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    start = time.perf_counter()
    res = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, weight=weight, seed=SEED,
                           device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fb.LAUNCHES)
    want = build_calls(cfg, q, cfg.n_samples, cfg.n_burn_in)
    check(launches == want, f"{name}: launches {launches} != expected {want}")
    layouts = launches_by_kernel()
    want_layouts = expected_by_kernel(want)
    check(layouts == want_layouts, f"{name}: launches by kernel {layouts} != {want_layouts}")
    check(all(launches[e] > 0 for e in MAIN_PATH), f"{name}: a main-path kernel never launched")
    check(sum(fb.PLAIN_CALLS.values()) == 0, f"{name}: a plain build ran on the card path")
    check(tuple(res.p_quant.shape) == (3, t * q), f"{name}: p_quant shape {tuple(res.p_quant.shape)}")
    check(tuple(res.param_quant.shape) == (3, n_params(q, p)), f"{name}: param_quant shape")
    check(tuple(res.subset_results.param_samples.shape[:2]) == (cfg.n_subsets,
                                                                cfg.n_chains * cfg.n_kept),
          f"{name}: pooled draws {tuple(res.subset_results.param_samples.shape)}")
    if cfg.n_chains > 1:
        check(bool(torch.isfinite(res.param_rhat).all()),
              f"{name}: a non-finite cross-chain R-hat")
    for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"{name}: non-finite {f}")
    acc = res.phi_accept_rate
    check(bool(((acc >= 0) & (acc <= 1)).all()), f"{name}: phi_accept_rate outside [0, 1]")
    p_q = res.p_quant.cpu().numpy()
    check(bool(((p_q >= 0) & (p_q <= 1)).all()), f"{name}: p outside [0, 1]")
    secs = res.phase_seconds
    out = {
        "phase": name, "n": y.shape[0], "K": cfg.n_subsets, "m": -(-y.shape[0] // cfg.n_subsets),
        "q": q, "p": p, "t": t, "link": cfg.link, "phi_update_every": cfg.phi_update_every,
        "n_samples": cfg.n_samples, "n_burn_in": cfg.n_burn_in, "n_kept": cfg.n_kept,
        "wall_s": wall, "phase_seconds": secs,
        "ms_per_sweep": secs["subset_fits"] / cfg.n_samples * 1e3,
        "latent_ess_per_sec": res.latent_ess_per_sec, "peak_memory_bytes": peak,
        "launches": launches, "launches_expected": want, "launches_by_kernel": layouts,
        "phi_accept_rate_mean": float(acc.mean()),
        "param_quant_median": np.round(res.param_quant[0].cpu().numpy(), 4).tolist(),
        "n_chains": cfg.n_chains, "phi_proposals": cfg.phi_proposals,
        "phi_proposal_family": cfg.phi_proposal_family,
        "param_rhat_max": float(res.param_rhat.max()),
        "param_rhat_median": float(res.param_rhat.median()),
        "mtm_workspace_bytes_per_subset": cfg.mtm_workspace_bytes(-(-y.shape[0] // cfg.n_subsets)),
    }
    del res
    torch.cuda.empty_cache()
    out["direct"] = direct_sweeps(cfg, data_np, device, weight=weight)
    if update_chol is not None:
        got = out["direct"]["n_chol_n_chol_calls_per_sweep"]["update"]
        check(got == [tuple(update_chol)],
              f"{name}: factorizations per update sweep {got} != {update_chol}")
    emit(out)
    return out


# ----------------------------------------------------------------------
# phases 12-16: the rest of the sampler's knobs
# ----------------------------------------------------------------------
# FP64 rate outside the tensor cores (H100 SXM data sheet: 34 TFLOP/s,
# counting a DFMA as two operations): its FP64 units issue half as many
# instructions. The double kernels' operation bound is their FP64
# instructions (sass_fp64_per_element) over this
FP64_INSTR_PER_S = 34e12 / 2
# the double symmetric kernel's ragged sweep (32 x 32 tiles, a 4-double
# halo): one row to five, one tile pair (m + 3 <= 32) and one past it,
# two and one past them, a ragged m and config5's m - 1, m, m + 1: every
# row alignment mod 4 doubles at tile edges and at the main shape
F64_M = (1, 2, 3, 4, 5, 29, 30, 31, 32, 33, 61, 62, 63, 64, 65, 147, 3905, 3906, 3907)
# kernel vs plain version at float64: the same operation order, so they
# differ only where the card's exp and torch.exp round differently (an
# ulp or two of values <= 1); the relative term covers the 1e8 shifts
ATOL64, RTOL64 = 1e-14, 1e-14
# card vs CPU, the same float64 fit: cuSOLVER vs LAPACK factorizations,
# ~1e-15 per sweep, grown over 12 sweeps
FIT64_TOL = 1e-8
# the double kernels of the exponential main-path builds at d = 2, by
# their mangled names (template arguments: type, model, flags, d)
SASS_F64 = {
    "symmetric": "fused_corr_sym_kernelIdLi0ELb1ELb0ELi2E",
    "narrow": "fused_corr_narrow_kernelIdLi0ELb1ELb0ELi2E",
}
# FP64-unit instructions, and the special-function steps of sqrt and exp
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX")


def sass_fp64_per_element(lib_path, kernel: str):
    """Instructions per element of `kernel` in the SASS of the built
    library at `lib_path` (cuobjdump): each FP64-unit opcode of FP64_OPCODES and MUFU, counted
    over the kernel's code and divided by its count of MUFU.RSQ64H, the
    first step of an element's double sqrt (one an element, so loops the
    compiler unrolled count once per element they compute). A static
    count: the out-of-line slow paths (sqrt of a denormal, exp beyond
    its range) count as if taken. None where cuobjdump or the kernel is
    missing."""
    import re
    from pathlib import Path

    from smk_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "--dump-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300).stdout
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        if kernel not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)", body)
        counts = {}
        for op in ops:
            base = op.split(".")[0]
            if base in FP64_OPCODES or base == "MUFU":
                key = op if base == "MUFU" else base
                counts[key] = counts.get(key, 0) + 1
        per = counts.get("MUFU.RSQ64H", 0)
        if per == 0:
            return None
        fp64 = sum(v for key, v in counts.items() if key in FP64_OPCODES)
        return {"kernel": kernel, "sass_instructions": len(ops), "sqrt_sites": per,
                "counts": counts, "fp64_per_element": fp64 / per,
                "mufu_per_element": sum(v for key, v in counts.items()
                                        if key.startswith("MUFU")) / per}
    return None


def f64_bound(inputs, out, elements, sass):
    """(bound_ms, bound_by, bytes_ms, fp64_ms) of a float64 build: its
    bytes (min_bytes) over the HBM rate, or `elements` (what the function
    needs computed: one half and the diagonal of a symmetric build) times
    the FP64 instructions an element from the SASS over the FP64 rate,
    whichever is larger (the bytes where the SASS count is missing)."""
    t_bytes = min_bytes(inputs, out) / HBM_BYTES_PER_S * 1e3
    t_ops = None if sass is None else elements * sass["fp64_per_element"] / FP64_INSTR_PER_S * 1e3
    if t_ops is None or t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


def kernels_float64(device):
    """The double kernels (every float64 build) on the card, three
    models: the symmetric kernel over F64_M (masked, masked + shifted,
    scalar shift, unmasked; d = 1, 3, 8 at two m) and the narrow kernel
    over NARROW_MA x NARROW_MB (cross builds with and without the row
    mask, per-k and shared columns; square stacks), into NaN-filled
    outputs, against their plain version at float64 and bitwise against
    the double tile kernel (the narrow square builds against the double
    symmetric kernel), with the exact invariants; every float64 entry
    point against its plain version, bitwise against the tile kernel,
    counted under its double kernel. Then, at the masked (32, 1, 3906,
    3906) build and the cross (32, 1, 3906, 64) build with its row mask,
    each new kernel's device time and the tile kernel's in turns (tile,
    new, new, tile), the entry point's, the plain version's and the
    library call's, beside the byte bound and the FP64 bound from the
    SASS. Last a small float64 fit through the kernels on the card
    against the same fit on the CPU."""
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.ops import fused_build as fb

    f64 = torch.float64
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 64)

    def uni(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=f64)

    tol = (ATOL64, RTOL64)
    sym_sweep = ragged_sweep(uni, F64_M, tol)
    narrow = narrow_sweep(uni, tol)
    torch.cuda.empty_cache()

    # every entry point at float64: plain version, the tile kernel bit
    # for bit, and the kernel it is counted under
    k, s, m, t = 2, 2, 147, 33
    coords = uni(k, m, 2, hi=2.0)
    test = uni(t, 2, hi=2.0) + 0.3
    test_k = test[None].expand(k, t, 2)
    phis = uni(k, s, lo=4.0, hi=12.0)
    mask = (uni(k, m) > 0.1).to(f64)
    shift = torch.where(mask > 0, uni(k, m, lo=0.5, hi=2.0), torch.full_like(mask, 1e8))
    model = "matern32"
    entries = {
        "fused_masked_shifted_build": (
            lambda: fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
            (coords, coords), dict(mask=mask, shift=shift, zero_diag=True), fb.SYMMETRIC_F64),
        "fused_masked_correlation_stack": (
            lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model),
            (coords, coords), dict(mask=mask, zero_diag=True), fb.SYMMETRIC_F64),
        "fused_cross_correlation": (
            lambda: fb.fused_cross_correlation(coords, test, phis, model, row_mask=mask),
            (coords, test_k), dict(row_mask=mask), fb.NARROW_F64),
        "fused_correlation_stack": (
            lambda: fb.fused_correlation_stack(test, phis, model),
            (test_k, test_k), dict(zero_diag=True), fb.NARROW_F64),
        "fused_correlation": (
            lambda: fb.fused_correlation(coords, phis[:, 0], model)[:, None],
            (coords, coords), dict(zero_diag=True), fb.NARROW_F64),
    }
    entry_checks = {}
    for name, (run, (ca, cb), kw, key) in entries.items():
        before = dict(fb.LAYOUT_LAUNCHES)
        got = run()
        torch.cuda.synchronize()
        # the reference launch reads phis by raw pointer: contiguous
        ph = phis[:, :1].contiguous() if name == "fused_correlation" else phis
        delta = {x: fb.LAYOUT_LAUNCHES[x] - before[x] for x in before}
        check(delta == {x: int(x == key) for x in before},
              f"float64 {name}: launches by kernel {delta}, expected one of kernel {key}")
        check(got.dtype == f64, f"float64 {name}: output is {got.dtype}")
        tile = launch_nan(ca, cb, ph, model, fb.TILED, **kw)
        check(torch.equal(got, tile), f"float64 {name}: entry point != the double tile kernel")
        entry_checks[name] = compare(got, fb.plain_build(ca, cb, ph, model, **kw),
                                     f"float64 {name}", *tol)
        if kw.get("zero_diag"):
            square_invariants(got, kw.get("mask"), kw.get("shift"), f"float64 {name}")
    torch.cuda.empty_cache()

    # the two main-path builds: the new kernels against the tile kernel,
    # bitwise and in turns
    k, m, t = MAIN_K, MAIN_M, MAIN_T
    coords = uni(k, m, 2)
    test = uni(t, 2)
    test_k = test[None].expand(k, t, 2)
    phis = uni(k, 1, lo=4.0, hi=12.0)
    mask = torch.ones(k, m, device=device, dtype=f64)
    pad = mask.clone()
    pad[:, -11:] = 0.0
    model = "exponential"
    builds = {
        # name: (entry point, layout, (ca, cb), kernel kwargs, inputs,
        #        elements the function computes, library call)
        "fused_masked_correlation_stack": (
            lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model), fb.SYMMETRIC,
            (coords, coords), dict(mask=mask, zero_diag=True), [coords, phis, mask],
            k * m * (m + 1) // 2,
            lambda: torch.exp(-phis[:, :, None, None] * torch.cdist(coords, coords)[:, None])),
        "fused_cross_correlation": (  # as the sampler calls it
            lambda: fb.fused_cross_correlation(coords, test, phis, model, row_mask=mask),
            fb.NARROW, (coords, test_k), dict(row_mask=mask), [coords, test, phis, mask],
            k * m * t,
            lambda: mask[:, None, :, None] * torch.exp(
                -phis[:, :, None, None] * torch.cdist(coords, test_k)[:, None])),
    }
    from smk_torch.ops import cuda_build

    lib = cuda_build.library_path("fused_corr_f64")
    sass = {label: sass_fp64_per_element(lib, name) for label, name in SASS_F64.items()}
    timing = {}
    for name, (run, layout, (ca, cb), kw, inputs, elements, library) in builds.items():
        got = run()
        want = fb.plain_build(ca, cb, phis, model, **kw)
        err = compare(got, want, f"float64 {name} at the main-path shape", *tol)
        del want
        if kw.get("zero_diag"):
            square_invariants(got, kw.get("mask"), None, f"float64 {name}")
        # bitwise against the tile kernel, on pad rows too (the mask's
        # zeros), and the entry point against its kernel
        padded = {key: (pad if key in ("mask", "row_mask") else v) for key, v in kw.items()}
        new = launch_nan(ca, cb, phis, model, layout, **padded)
        tile = launch_nan(ca, cb, phis, model, fb.TILED, **padded)
        check(torch.equal(new, tile), f"float64 {name}: new kernel != tile kernel at the main shape")
        if kw.get("zero_diag"):
            square_invariants(new, pad, None, f"float64 {name} with pad rows")
        new = launch_nan(ca, cb, phis, model, layout, **kw)
        check(torch.equal(new, got), f"float64 {name}: entry point != its kernel")
        mk, rm = kw.get("mask"), kw.get("row_mask")
        runs = {label: (lambda out=out, lay=lay: fb._launch(
                    ca, cb, phis, mk, None, model, kw.get("zero_diag", False), out, lay, rm))
                for label, out, lay in (("tile", tile, fb.TILED), ("new", new, layout))}
        turns = {"tile": [], "new": []}
        for label in ("tile", "new", "new", "tile"):
            turns[label].append(ms_median(runs[label], device_only=True))
        label = "symmetric" if layout == fb.SYMMETRIC else "narrow"
        b_ms, b_by, bytes_ms, fp64_ms = f64_bound(inputs, got, elements, sass[label])
        device_ms = statistics.mean(turns["new"])
        timing[name] = {
            "kernel": label, "shape": list(got.shape), "max_abs_err": err,
            "device_ms_turns": turns["new"], "tile_kernel_device_ms_turns": turns["tile"],
            "device_ms": device_ms, "tile_kernel_device_ms": statistics.mean(turns["tile"]),
            "ms": ms_median(run), "entry_device_ms": ms_median(run, device_only=True),
            "plain_ms": ms_median(lambda: fb.plain_build(ca, cb, phis, model, **kw), reps=5),
            "library_ms": ms_median(library, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "bytes_bound_ms": bytes_ms,
            "fp64_bound_ms": fp64_ms, "fp64_bound_ms_full": None if sass[label] is None else
            got.numel() * sass[label]["fp64_per_element"] / FP64_INSTR_PER_S * 1e3,
            "elements": elements, "sass": sass[label],
            "device_bound_fraction": b_ms / device_ms, "write_bytes": got.numel() * 8,
        }
        del got, new, tile
        torch.cuda.empty_cache()

    # a small float64 fit through the kernels, card against CPU
    cfg = SMKConfig(n_subsets=4, n_samples=12, fused_build="pallas", dtype="float64")
    data = binary_field(400, 2, 2, 8, SEED)
    fb.reset_counts()
    gpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, device, f64),
                           device=device)
    launches = dict(fb.LAUNCHES)
    by_kernel = launches_by_kernel()
    want = expected_by_kernel(launches, float64=True)
    check(by_kernel == want and sum(launches.values()) > 0 and sum(fb.PLAIN_CALLS.values()) == 0,
          f"float64 fit: launches {launches}, by kernel {by_kernel} != {want}")
    cpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, "cpu", f64),
                           device="cpu")
    errs = {}
    for f in ("param_grid", "w_grid", "p_quant", "param_quant"):
        g = getattr(gpu, f)
        check(g.dtype == f64, f"float64 fit: {f} is {g.dtype}")
        errs[f] = float((g.cpu() - getattr(cpu, f)).abs().max())
        check(errs[f] <= FIT64_TOL, f"float64 fit: {f} differs by {errs[f]:.3e}")
    out = {"phase": "kernels_float64", "tolerance": {"atol": ATOL64, "rtol": RTOL64},
           "symmetric_sweep": sym_sweep, "narrow_sweep": narrow, "entry_points": entry_checks,
           "main_path": timing, "fit_small": {"max_abs_err": errs, "tolerance": FIT64_TOL,
                                              "launches": launches,
                                              "launches_by_kernel": by_kernel}}
    emit(out)
    return out


def fit_variants_small_parity(device):
    """The sampler's knobs on the card against the CPU, same random
    numbers, at n = 160, K = 4 (m = 40), 16 sweeps: multiple-try phi
    (J = 3, every 2nd sweep) in each proposal family, two chains, the
    blocked Cholesky at block 16, bf16 correlation builds (unfused).
    fp32 with cuSOLVER vs LAPACK, as fit_small_parity: 2e-3 (1 + |x|);
    the bf16 builds 3e-2 (1 + |x|), where the two devices' fp32 exp can
    round to neighbouring bf16 values. Then matmul_precision="highest"
    on the card, bit for bit the default config's run."""
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.ops import fused_build as fb

    data = binary_field(160, 2, 2, 8, SEED + 160)
    # 16 sweeps keep 4 draws a chain, the fewest R-hat takes
    base = dict(n_subsets=4, n_samples=16, fused_build="pallas")
    mtm = dict(phi_sampler="collapsed", phi_proposals=3, phi_update_every=2)
    variants = {
        "mtm_gaussian": (dict(mtm), 2e-3),
        "mtm_student_t": (dict(mtm, phi_proposal_family="student_t"), 2e-3),
        "mtm_mixture": (dict(mtm, phi_proposal_family="mixture"), 2e-3),
        "chains2": (dict(n_chains=2, phi_sampler="collapsed"), 2e-3),
        "chol_block16": (dict(chol_block_size=16), 2e-3),
        "build_bf16": (dict(build_dtype="bfloat16", fused_build="off"), 3e-2),
    }
    out = {"phase": "fit_variants_small_parity"}
    for name, (kw, tol) in variants.items():
        cfg = SMKConfig(**{**base, **kw})
        fb.reset_counts()
        gpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, device),
                               device=device)
        if cfg.fused_build == "pallas":
            check(sum(fb.LAUNCHES.values()) > 0, f"{name}: the card fit did not run the kernel")
        check(sum(fb.PLAIN_CALLS.values()) == 0, f"{name}: a plain build ran on the card")
        cpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, "cpu"),
                               device="cpu")
        errs = {}
        for f in ("param_grid", "w_grid", "p_quant", "param_quant", "param_rhat"):
            g, c = getattr(gpu, f).cpu(), getattr(cpu, f)
            errs[f] = float(((g - c).abs() / (1.0 + c.abs())).max())
            check(errs[f] <= tol, f"{name}: {f} differs by {errs[f]:.3e} (tolerance {tol})")
        out[name] = {"max_rel_err": errs, "tolerance": tol,
                     "accept_equal": bool(torch.equal(gpu.phi_accept_rate.cpu(),
                                                      cpu.phi_accept_rate)),
                     "pooled_draws": list(gpu.subset_results.param_samples.shape)}
    settings = lambda: (torch.get_float32_matmul_precision(),  # noqa: E731
                        torch.backends.cudnn.allow_tf32)
    before = settings()
    fits = [fit_meta_kriging(*data, config=SMKConfig(**base, **kw), seed=SEED, device=device)
            for kw in ({}, dict(matmul_precision="highest"))]
    for f in ("param_grid", "w_grid", "p_quant", "sample_par"):
        check(torch.equal(getattr(fits[0], f), getattr(fits[1], f)),
              f"matmul_precision='highest': {f} differs from the default run")
    check(settings() == before, "a fit left the matmul settings changed")
    out["matmul_precision_highest_bitwise_default"] = True
    emit(out)


def chol_blocked(device, c5_data):
    """ops/chol.blocked_cholesky against cuSOLVER (torch.linalg.cholesky_ex
    through chol.cholesky) on R~ + jit I at config5's (32, 3906, 3906)
    fp32 (a masked build from the kernel, 11 pad rows a subset): device
    ms (CUDA events), the largest factor difference relative to the
    largest entry, and each factor's residual max |L L^T - A| / max |A|.
    Then one production update sweep at config5 (sweep 0, the same
    state's noise) with chol_block_size 512 against 0, in turns."""
    import torch
    from smk_torch.ops import chol
    from smk_torch.ops import fused_build as fb

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 14)
    k, m = MAIN_K, MAIN_M
    coords = torch.rand((k, m, 2), generator=gen, device=device)
    phis = 4.0 + 8.0 * torch.rand((k, 1), generator=gen, device=device)
    mask = torch.ones(k, m, device=device)
    mask[:, -11:] = 0.0
    a = fb.fused_masked_correlation_stack(coords, phis, mask, "exponential")[:, 0]
    a.diagonal(dim1=-2, dim2=-1).add_(max(1e-5, 2.5e-7 * m))
    a_max = a.abs().amax()

    def residual(l):
        return float(((l @ l.mT - a).abs().amax() / a_max))

    native = lambda: chol.cholesky(a)  # noqa: E731
    l_nat = native()
    check(bool(torch.isfinite(l_nat).all()), "cuSOLVER factor not finite")
    flops = k * m ** 3 / 3
    res = {"phase": "chol_blocked", "shape": [k, m, m],
           "cusolver": {"device_ms": ms_median(native, reps=5, warmup=1, device_only=True),
                        "residual": residual(l_nat)}}
    res["cusolver"]["tflops"] = flops / (res["cusolver"]["device_ms"] * 1e-3) / 1e12
    for bs in (256, 512, 1024):
        run = lambda bs=bs: chol.blocked_cholesky(a, 0.0, bs)  # noqa: E731
        l_b = run()
        check(bool(torch.isfinite(l_b).all()), f"blocked factor (block {bs}) not finite")
        row = {"device_ms": ms_median(run, reps=5, warmup=1, device_only=True),
               "max_rel_diff_vs_cusolver": float((l_b - l_nat).abs().amax() / l_nat.abs().amax()),
               "residual": residual(l_b)}
        row["tflops"] = flops / (row["device_ms"] * 1e-3) / 1e12
        check(row["residual"] <= max(10 * res["cusolver"]["residual"], 1e-5),
              f"blocked factor (block {bs}): residual {row['residual']:.3e}")
        res[f"block_{bs}"] = row
        del l_b
    del a, l_nat
    torch.cuda.empty_cache()

    # one production update sweep, chol_block_size 512 against 0
    sweeps = {0: [], 512: []}
    for bs in (0, 512, 512, 0):
        cfg = production_config(k=MAIN_K, n_samples=64, phi_every=16, chol_block_size=bs)
        model, data, state, consts, noise = sampler_setup(cfg, c5_data, device)
        cache = model._solve_cache(consts, data.mask, state)
        nz = noise(0, False)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, cache, _ = model._gibbs_step(data, consts, state, cache, 0, nz, collect=False)
        end.record()
        end.synchronize()
        check(bool(torch.isfinite(state.chol_r).all()), f"update sweep (block {bs}): non-finite")
        sweeps[bs].append(start.elapsed_time(end))
        del model, data, state, consts, cache, nz
        torch.cuda.empty_cache()
    res["update_sweep_ms"] = {"chol_block_size_0": sweeps[0], "chol_block_size_512": sweeps[512]}
    emit(res)
    return res


# ----------------------------------------------------------------------
# phases 18-21: the Vecchia engine
# ----------------------------------------------------------------------
# neighbors per site (the twin's default, the bench rung's)
VECCHIA_NN = 16
# card vs CPU on the small seeded input: the test suite's fp32 tolerance
# for the Vecchia ops against the twin
VECCHIA_TOL = (1e-5, 1e-5)


def vecchia_config(*, k, n_samples):
    """The JAX bench's Vecchia rung (bench.py:1709-1720 and :1761): the
    production sampler's fields (phi every 16th sweep) with
    u_solver="chol", conditional single-try phi, no fused build, and the
    Vecchia engine at 16 neighbors (its u-draw is its own 8-step Jacobi
    CG, cg_iters)."""
    return production_config(
        k=k, n_samples=n_samples, u_solver="chol", phi_sampler="conditional",
        phi_proposals=1, fused_build="off", subset_engine="vecchia",
        n_neighbors=VECCHIA_NN)


def vecchia_ops(device, c5_data):
    """The Vecchia ops at config5's shape on config5's data (the fit's
    partition, warm start and state), device times beside the byte bound
    of the coefficient build; then each op card against CPU on a small
    seeded input."""
    import torch
    from smk_torch.ops import vecchia as v
    from smk_torch.ops.kernels import correlation

    cfg = vecchia_config(k=MAIN_K, n_samples=64)
    model, data, state, consts, noise = sampler_setup(cfg, c5_data, device)
    nn, m = VECCHIA_NN, data.mask.shape[-1]
    jit = cfg.effective_jitter(m)
    phi = state.phi  # (K, 1)
    out = {"phase": "vecchia_ops", "K": data.mask.shape[0], "m": m, "nn": nn,
           "t": data.coords_test.shape[0], "sites": data.mask.numel()}

    # the neighbor builds, and their candidate selection alone
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    v.build_neighbor_consts(data.coords, data.mask, nn)
    torch.cuda.synchronize()
    out["neighbor_build_peak_extra_bytes"] = torch.cuda.max_memory_allocated() - base
    out["neighbor_build_ms"] = ms_median(
        lambda: v.build_neighbor_consts(data.coords, data.mask, nn), warmup=1, device_only=True)
    out["test_neighbor_build_ms"] = ms_median(
        lambda: v.build_test_neighbor_consts(data.coords, data.mask, data.coords_test, nn),
        device_only=True)
    out["reverse_lists_ms"] = ms_median(lambda: v.reverse_neighbors(consts.nbr_idx))
    out["reverse_list_width"] = consts.nbr_rev.shape[-1]
    from smk_torch.ops.distance import pairwise_distance

    cand = pairwise_distance(data.coords)
    ar = torch.arange(m, device=device)
    cand.masked_fill_(~((ar[None, :] < ar[:, None])[None] & (data.mask > 0)[:, None, :]), v.LARGE)
    top = torch.topk(cand, nn, dim=-1, largest=False, sorted=True)
    srt = v._nearest(cand, nn)  # the stable sort, one subset at a time
    valid = top.values < v.LARGE / 2
    differ = lambda a, b: int(((a != b) & valid).any(-1).sum())  # noqa: E731
    out["candidate_select"] = {
        "topk_ms": ms_median(lambda: torch.topk(cand, nn, dim=-1, largest=False, sorted=True),
                             device_only=True),
        "stable_sort_per_subset_ms": ms_median(lambda: v._nearest(cand, nn), reps=5, warmup=1,
                                               device_only=True),
        "values_equal": bool(torch.equal(top.values, srt[0])),
        # sites whose valid neighbors topk orders otherwise, or picks
        # otherwise, than the twin's lower-index-first rule
        "sites_order_differs": differ(top.indices, srt[1]),
        "sites_set_differs": int(((top.indices.sort(-1).values != srt[1].sort(-1).values)
                                  .any(-1) & valid.all(-1)).sum()),
    }
    check(out["candidate_select"]["values_equal"], "topk and the stable sort select other values")
    del cand, top, srt, valid
    torch.cuda.empty_cache()

    # the coefficient build (one batched factor of K*m (nn, nn) blocks)
    def coeffs():
        return model._vecchia_coeffs(consts.nbr_dist, consts.nbr_valid, phi, m)

    corr = correlation(consts.nbr_dist[:, None], phi[..., None, None, None], cfg.cov_model)
    val = consts.nbr_valid[:, None]
    vv = val[..., :, None] * val[..., None, :]
    eye = torch.eye(nn, device=device)
    c_nn = vv * corr[..., :nn, :nn] + (1.0 - vv) * eye + jit * eye
    packed = coeffs()
    bound_bytes = sum(t.numel() * t.element_size()
                      for t in (consts.nbr_dist, consts.nbr_valid, packed))
    out["coeffs"] = {
        "ms": ms_median(coeffs, device_only=True),
        "cholesky_ex_ms": ms_median(lambda: torch.linalg.cholesky_ex(c_nn), device_only=True),
        "blocks": list(c_nn.shape), "bound_bytes": bound_bytes,
        "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    out["coeffs"]["bound_fraction"] = out["coeffs"]["bound_ms"] / out["coeffs"]["ms"]
    check(bool(torch.isfinite(packed).all()), "vecchia_coeffs: non-finite coefficients")
    del corr, val, vv, c_nn
    idx, rev = consts.nbr_idx, consts.nbr_rev
    u_t = state.u.transpose(1, 2).contiguous()  # (K, 1, m)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 18)
    vec = lambda: torch.randn((data.mask.shape[0], m), generator=gen, device=device)  # noqa: E731
    b_vec, e1, e2 = vec(), vec(), vec()
    c_safe = 0.5 + torch.rand((data.mask.shape[0], m), generator=gen, device=device)
    p0 = packed[:, 0]

    def scatter_ft(pk, nbr, w):
        b, d = v.unpack_coeffs(pk)
        wd = w / d
        src = -(b * wd[..., None])
        return wd.scatter_add(-1, nbr.reshape(nbr.shape[0], -1), src.reshape(src.shape[0], -1))

    ft_rev, ft_sc = v.vecchia_ft_matvec(p0, idx, b_vec, rev), scatter_ft(p0, idx, b_vec)
    # two summation orders of up to D terms: within fp32 roundoff of the
    # largest entry
    check(float((ft_rev - ft_sc).abs().max()) <= 1e-5 * (1.0 + float(ft_sc.abs().max())),
          "F^T: the reverse lists and scatter_add disagree")
    # run to run: five calls of each form on the same inputs
    sc = [scatter_ft(p0, idx, b_vec) for _ in range(5)]
    rv = [v.vecchia_ft_matvec(p0, idx, b_vec, rev) for _ in range(5)]
    out["ft_repeats"] = {
        "scatter_add_bitwise": all(torch.equal(sc[0], r) for r in sc[1:]),
        "scatter_add_max_abs_diff": max(float((sc[0] - r).abs().max()) for r in sc[1:]),
        "reverse_lists_bitwise": all(torch.equal(rv[0], r) for r in rv[1:]),
    }
    check(out["ft_repeats"]["reverse_lists_bitwise"], "F^T through the reverse lists differs run to run")
    del sc, rv
    tpacked = model._vecchia_coeffs(consts.tnbr_dist, consts.tnbr_valid, phi, m)
    z = torch.randn(tpacked.shape[:-1], generator=gen, device=device)
    out["ops_ms"] = {
        "loglik": ms_median(lambda: v.vecchia_loglik(packed, idx, u_t), device_only=True),
        "q_matvec": ms_median(lambda: v.vecchia_q_matvec(p0, idx, b_vec, rev),
                              device_only=True),
        # F^T summed through the reverse lists, beside the twin's form, one
        # scatter_add (float atomics) of the same slot values
        "ft_matvec": ms_median(lambda: v.vecchia_ft_matvec(p0, idx, b_vec, rev),
                               device_only=True),
        "ft_matvec_scatter_add": ms_median(lambda: scatter_ft(p0, idx, b_vec),
                                           device_only=True),
        "q_diag": ms_median(lambda: v.vecchia_q_diag(p0, idx, rev), device_only=True),
        "posterior_draw_8": ms_median(lambda: v.vecchia_posterior_draw(
            p0, idx, b_vec, c_safe, e1, e2, 8, rev), device_only=True),
        "posterior_draw_8_with_host": ms_median(lambda: v.vecchia_posterior_draw(
            p0, idx, b_vec, c_safe, e1, e2, 8, rev)),
        "test_coeffs": ms_median(lambda: model._vecchia_coeffs(
            consts.tnbr_dist, consts.tnbr_valid, phi, m), device_only=True),
        "krige_draw": ms_median(lambda: v.vecchia_krige_draw(tpacked, consts.tnbr_idx, u_t, z),
                                device_only=True),
    }
    del model, data, state, consts, noise, packed, tpacked
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = vecchia_ops_card_vs_cpu(device)
    emit(out)
    return out


def vecchia_ops_card_vs_cpu(device):
    """Every op of ops/vecchia.py on the card against the CPU on seeded
    inputs: K = 3 subsets, 7 pad rows in the last, t = 11, two decays a
    subset, nn 4 and 16. The neighbor sets must be equal where valid;
    the rest runs on the CPU's geometry. At m = 60 (the test suite's
    shapes) each op within VECCHIA_TOL elementwise; at m = 200, where
    the sites are denser, d smaller and the entries of Q v reach ~1e3
    with cancelling terms, within VECCHIA_TOL of the op's largest
    entry."""
    import numpy as np
    import torch
    from smk_torch.ops import vecchia as v

    atol, rtol = VECCHIA_TOL
    report = {"tolerance": {"atol": atol, "rtol": rtol}}
    for m, elementwise in ((60, True), (200, False)):
        rng = np.random.default_rng(SEED + m)
        k, t, pad = 3, 11, 7
        coords = rng.uniform(size=(k, m, 2)).astype(np.float32)
        mask = np.ones((k, m), np.float32)
        mask[-1, -pad:] = 0.0
        coords[-1, -pad:] += 5.0
        arrays = dict(coords=coords, mask=mask, ct=rng.uniform(size=(t, 2)).astype(np.float32),
                      phi=rng.uniform(4.0, 12.0, size=(k, 2)).astype(np.float32))
        for name in ("u", "b_vec", "e1", "e2"):
            arrays[name] = rng.normal(size=(k, 2, m)).astype(np.float32)
        arrays["c_safe"] = rng.uniform(0.5, 2.0, size=(k, 2, m)).astype(np.float32)
        arrays["z"] = rng.normal(size=(k, 2, t)).astype(np.float32)
        for nn in (4, 16):
            geos = {}
            for dev in ("cpu", device):
                a = {n: torch.as_tensor(x, device=dev) for n, x in arrays.items()}
                geos[str(dev)] = [g.cpu() for g in (
                    v.build_neighbor_consts(a["coords"], a["mask"], nn)
                    + v.build_test_neighbor_consts(a["coords"], a["mask"], a["ct"], nn))]
            cpu_geo, card_geo = geos["cpu"], geos[str(device)]
            for i in (0, 3):  # the train and the test indices, with their valid masks
                ok = cpu_geo[i + 2] > 0
                check(torch.equal(cpu_geo[i + 2], card_geo[i + 2]),
                      f"vecchia m={m} nn={nn}: valid slots differ card vs CPU")
                check(torch.equal(cpu_geo[i][ok].reshape(-1).sort().values,
                                  card_geo[i][ok].reshape(-1).sort().values)
                      and torch.equal(cpu_geo[i].sort(-1).values * ok,
                                      card_geo[i].sort(-1).values * ok),
                      f"vecchia m={m} nn={nn}: neighbor sets differ card vs CPU")
            outs = {}
            for dev in ("cpu", device):
                a = {n: torch.as_tensor(x, device=dev) for n, x in arrays.items()}
                idx, dist, valid, tidx, tdist, tvalid = (g.to(dev) for g in cpu_geo)
                packed = v.vecchia_coeffs(dist[:, None], valid[:, None], a["phi"], 1e-5,
                                          "exponential")
                tpacked = v.vecchia_coeffs(tdist[:, None], tvalid[:, None], a["phi"], 1e-5,
                                           "exponential")
                flat = lambda x: x.flatten(0, 1)  # noqa: E731
                outs[str(dev)] = {
                    "coeffs": packed, "test_coeffs": tpacked,
                    "loglik": v.vecchia_loglik(packed, idx, a["u"]),
                    "f": v.vecchia_f_matvec(packed, idx, a["u"]),
                    "ft": v.vecchia_ft_matvec(packed, idx, a["u"]),
                    "q": v.vecchia_q_matvec(packed, idx, a["u"]),
                    "q_diag": v.vecchia_q_diag(packed, idx),
                    "draw": v.vecchia_posterior_draw(
                        flat(packed), idx.repeat_interleave(2, 0), flat(a["b_vec"]),
                        flat(a["c_safe"]), flat(a["e1"]), flat(a["e2"]), 8),
                    "krige": v.vecchia_krige_draw(tpacked, tidx, a["u"], a["z"]),
                }
            errs = {}
            for name, want in outs["cpu"].items():
                got = outs[str(device)][name].cpu()
                if elementwise:
                    errs[name] = compare(got, want, f"vecchia m={m} nn={nn} {name}",
                                         atol=atol, rtol=rtol)
                else:
                    scale = float(want.abs().max())
                    err = float((got - want).abs().max())
                    check(err <= atol + rtol * scale,
                          f"vecchia m={m} nn={nn} {name}: card vs CPU {err:.3e} of {scale:.3e}")
                    errs[name] = {"max_abs_err": err, "max_abs": scale}
            report[f"m{m}_nn{nn}"] = {"max_abs_err": errs, "neighbor_sets_equal": True,
                                      "elementwise_tolerance": elementwise}
    return report


def fit_vecchia_small_parity(device):
    """A small Vecchia fit (n = 400, K = 4, m = 100, 12 sweeps) on the
    card against the CPU with the same random numbers, 2e-3 (1 + |x|) as
    the other small fits; then the card fit again, which must agree bit
    for bit (F^T and diag(Q) sum through the reverse neighbor lists in a
    fixed order, not with float atomics)."""
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.ops import fused_build as fb

    cfg = SMKConfig(n_subsets=4, n_samples=12, subset_engine="vecchia",
                    n_neighbors=VECCHIA_NN)
    data = binary_field(400, 2, 2, 8, SEED)
    fb.reset_counts()
    runs = [fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, device),
                             device=device) for _ in range(2)]
    check(sum(fb.LAUNCHES.values()) + sum(fb.PLAIN_CALLS.values()) == 0,
          "vecchia small parity: a correlation build ran")
    cpu = fit_meta_kriging(*data, config=cfg, randomness=NoiseOnDevice(SEED, "cpu"),
                           device="cpu")
    fields = ("param_grid", "w_grid", "p_quant", "param_quant", "sample_par")
    errs, same = {}, {}
    for f in fields:
        g, c = getattr(runs[0], f).cpu(), getattr(cpu, f)
        errs[f] = float(((g - c).abs() / (1.0 + c.abs())).max())
        check(errs[f] <= 2e-3, f"vecchia small parity: {f} differs by {errs[f]:.3e}")
        same[f] = bool(torch.equal(getattr(runs[0], f), getattr(runs[1], f)))
        check(same[f], f"vecchia small parity: two card runs differ in {f}")
    out = {"phase": "fit_vecchia_small_parity", "max_rel_err": errs, "tolerance": 2e-3,
           "accept_equal": bool(torch.equal(runs[0].phi_accept_rate.cpu(), cpu.phi_accept_rate)),
           "two_card_runs_bitwise": same,
           "two_card_runs_max_abs_diff": {
               f: float((getattr(runs[0], f) - getattr(runs[1], f)).abs().max()) for f in fields}}
    emit(out)
    return out


def fit_vecchia(name, *, cfg, data_np, device, direct=False):
    """fit_meta_kriging with the Vecchia engine: no correlation build
    launched or run plain, finite outputs of the expected shapes, p and
    acceptance rates in [0, 1]; ms/sweep, phase_seconds and peak memory;
    with `direct`, the schedule sweep by sweep (direct_sweeps), where an
    update sweep counts q coefficient builds in one call and a non-update
    sweep none."""
    import numpy as np
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls, n_params
    from smk_torch.ops import fused_build as fb

    y, x, coords, ct, xt = data_np
    q, p, t = y.shape[1], x.shape[2], ct.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    start = time.perf_counter()
    res = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fb.LAUNCHES)
    check(launches == build_calls(cfg, q, cfg.n_samples, cfg.n_burn_in)
          and sum(launches.values()) == 0, f"{name}: a correlation build launched: {launches}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, f"{name}: a plain correlation build ran")
    check(tuple(res.p_quant.shape) == (3, t * q), f"{name}: p_quant shape")
    check(tuple(res.param_quant.shape) == (3, n_params(q, p)), f"{name}: param_quant shape")
    for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"{name}: non-finite {f}")
    acc = res.phi_accept_rate
    check(bool(((acc >= 0) & (acc <= 1)).all()), f"{name}: phi_accept_rate outside [0, 1]")
    p_q = res.p_quant.cpu().numpy()
    check(bool(((p_q >= 0) & (p_q <= 1)).all()), f"{name}: p outside [0, 1]")
    secs = res.phase_seconds
    m = -(-y.shape[0] // cfg.n_subsets)
    out = {
        "phase": name, "n": y.shape[0], "K": cfg.n_subsets, "m": m, "q": q, "p": p, "t": t,
        "n_neighbors": cfg.n_neighbors, "phi_update_every": cfg.phi_update_every,
        "cg_iters": cfg.cg_iters, "n_samples": cfg.n_samples, "n_burn_in": cfg.n_burn_in,
        "wall_s": wall, "phase_seconds": secs,
        "ms_per_sweep": secs["subset_fits"] / cfg.n_samples * 1e3,
        "latent_ess_per_sec": res.latent_ess_per_sec, "peak_memory_bytes": peak,
        "launches": launches, "launches_by_kernel": launches_by_kernel(),
        "phi_accept_rate_mean": float(acc.mean()),
        "param_quant_median": np.round(res.param_quant[0].cpu().numpy(), 4).tolist(),
    }
    check(sum(out["launches_by_kernel"].values()) == 0, f"{name}: a kernel launched")
    del res
    torch.cuda.empty_cache()
    if direct:
        out["direct"] = direct_sweeps(cfg, data_np, device)
        got = out["direct"]["n_chol_n_chol_calls_per_sweep"]
        check(got == {"update": [(q, 1)], "other": [(0, 0)]},
              f"{name}: coefficient builds per sweep {got}")
    emit(out)
    return out


# ----------------------------------------------------------------------
# phases 22-24: the chunked, checkpointed, fault-isolating executor
# (parallel/recovery.py) and coherent fits
# ----------------------------------------------------------------------
# card vs CPU, a chunked fit: the fit_variants_small_parity tolerance
CHUNKED_TOL = 2e-3
# the coherent split of config4's eBird proxy (n = 65,536, K = 64):
# (occupied buckets, subsets in each)
C4_COHERENT = ([1024, 1448], [34, 30])


def kill_after(n_saved):
    """A progress callback that kills the fit at boundary n_saved + 1,
    before that boundary's save: the checkpoint on disk holds n_saved
    chunks and the killed chunk's work is lost, as in a real kill."""
    from smk_torch.parallel.recovery import ProgressAbort

    class Kill(ProgressAbort):
        pass

    calls = []

    def progress(info):
        calls.append(info)
        if len(calls) == n_saved + 1:
            raise Kill()

    return progress, Kill


def kill_and_resume(fit, path, n_saved):
    """Run ``fit(checkpoint_path=path, progress=...)`` killed after
    n_saved checkpointed chunks, then resume it from disk in a fresh call
    (a fresh model, state and noise source loaded from the files).
    Returns (result, resume seconds)."""
    progress, kill = kill_after(n_saved)
    try:
        fit(checkpoint_path=path, progress=progress)
        raise AssertionError("the kill did not stop the fit")
    except kill:
        pass
    start = time.perf_counter()
    res = fit(checkpoint_path=path, progress=None)
    return res, time.perf_counter() - start


def bitwise(a, b, fields=("param_grid", "w_grid", "p_quant", "param_quant", "sample_par")):
    import torch

    return {f: bool(torch.equal(getattr(a, f), getattr(b, f))) for f in fields}


def clustered_small(n, t, seed):
    """A small fit's data (binary_field) on clustered coordinates (six
    Gaussian clusters), which the coherent split cuts into unequal
    subsets."""
    import numpy as np

    y, x, _, ct, xt = binary_field(n, 1, 2, t, seed)
    rng = np.random.default_rng(0)
    centers = rng.uniform(size=(6, 2))
    coords = centers[rng.integers(0, 6, n)] + 0.04 * rng.normal(size=(n, 2))
    return y, x, coords.astype(np.float32), ct, xt


def fit_chunked_small_parity(device, tmp):
    """A chunked, checkpointed fit (n = 200, K = 4, q = 2, 16 sweeps in
    chunks of 4) through fit_meta_kriging on the card against the same
    fit on the CPU, same random numbers, at CHUNKED_TOL (1 + |x|);
    launches against build_calls(chunk_iters=4). On the card: killed
    after two chunks and resumed from disk, bitwise the uninterrupted
    run; one injected NaN under quarantine retried once, the survivors
    bitwise the uninjected run; an exhausted ladder, the subset dropped
    and the combine finite. Then a coherent fit (two bucket groups) on
    the card against the CPU."""
    import os
    import warnings

    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.testing.faults import inject_subset_nan
    from smk_torch.utils.tracing import ChunkPipelineStats

    data = binary_field(200, 2, 2, 8, SEED + 200)
    cfg = SMKConfig(n_subsets=4, n_samples=16, fused_build="pallas")
    qcfg = SMKConfig(n_subsets=4, n_samples=16, fused_build="pallas", fault_policy="quarantine")

    def fit(config=cfg, dev=device, **kw):
        return fit_meta_kriging(*data, config=config, randomness=NoiseOnDevice(SEED, dev),
                                device=dev, chunk_iters=4, **kw)

    fb.reset_counts()
    gpu = fit(checkpoint_path=os.path.join(tmp, "small_card.npz"))
    launches = dict(fb.LAUNCHES)
    want = build_calls(cfg, 2, cfg.n_samples, cfg.n_burn_in, chunk_iters=4)
    check(launches == want, f"chunked small: launches {launches} != {want}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "chunked small: a plain build ran on the card")
    layouts = launches_by_kernel()
    cpu = fit(dev="cpu", checkpoint_path=os.path.join(tmp, "small_cpu.npz"))
    errs = {}
    for f in ("param_grid", "w_grid", "p_quant", "param_quant"):
        g, c = getattr(gpu, f).cpu(), getattr(cpu, f)
        errs[f] = float(((g - c).abs() / (1.0 + c.abs())).max())
        check(errs[f] <= CHUNKED_TOL, f"chunked small: {f} differs by {errs[f]:.3e}")
    resumed, _ = kill_and_resume(fit, os.path.join(tmp, "small_kill.npz"), 2)
    resume_equal = bitwise(gpu, resumed)
    check(all(resume_equal.values()), f"chunked small: kill and resume {resume_equal}")
    clean = fit(config=qcfg)
    check(all(bitwise(clean, gpu).values()), "chunked small: quarantine differs from abort")
    faults = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for name, fires in (("one_retry", 1), ("exhausted", 99)):
            stats = ChunkPipelineStats()
            with inject_subset_nan(1, 6, max_fires=fires):
                res = fit(config=qcfg, pipeline_stats=stats)
            keep = [0, 2, 3]
            survivors = bool(torch.equal(res.subset_results.param_samples[keep],
                                         clean.subset_results.param_samples[keep]))
            check(survivors, f"chunked small ({name}): survivors differ from the clean run")
            check(bool(torch.isfinite(res.p_quant).all()), f"chunked small ({name}): p_quant")
            faults[name] = {"fault": stats.fault_summary(), "survivors_bitwise": survivors,
                            "subsets_dropped": list(res.subsets_dropped)}
    check(faults["one_retry"]["fault"]["retry_attempts"] == {"1": 1}
          and faults["one_retry"]["subsets_dropped"] == [],
          f"chunked small: one retry {faults['one_retry']}")
    check(faults["exhausted"]["subsets_dropped"] == [1],
          f"chunked small: exhausted ladder {faults['exhausted']}")
    cdata = clustered_small(200, 8, SEED + 201)
    ccfg = SMKConfig(n_subsets=4, n_samples=16, fused_build="pallas",
                     partition_method="coherent")
    coh = {d: fit_meta_kriging(*cdata, config=ccfg, randomness=NoiseOnDevice(SEED, d),
                               device=d, chunk_iters=4) for d in (device, "cpu")}
    coh_errs = {}
    for f in ("param_grid", "w_grid", "p_quant"):
        g, c = getattr(coh[device], f).cpu(), getattr(coh["cpu"], f)
        coh_errs[f] = float(((g - c).abs() / (1.0 + c.abs())).max())
        check(coh_errs[f] <= CHUNKED_TOL, f"coherent small: {f} differs by {coh_errs[f]:.3e}")
    out = {"phase": "fit_chunked_small_parity", "tolerance": f"{CHUNKED_TOL} * (1 + |cpu|)",
           "max_rel_err": errs, "launches": launches, "launches_expected": want,
           "launches_by_kernel": layouts, "kill_resume_bitwise": resume_equal,
           "faults": faults, "coherent_max_rel_err": coh_errs}
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    emit(out)
    return out


def free_disk_bytes(path):
    import shutil

    return shutil.disk_usage(path).free


def fit_chunked_config5(device, c5_data, tmp, unchunked_ms):
    """The chunked executor at config5's full width: the production
    sampler with fault_policy="quarantine", 64 sweeps in chunks of 16
    (three burn-in chunks, one sampling chunk, one update sweep each),
    checkpointed every chunk, nan_guard and a progress callback on:
    ms/sweep beside the unchunked production fit's, per chunk the
    dispatch seconds and the checkpoint's fetch and write seconds and
    bytes, peak memory, launches against build_calls(chunk_iters=16),
    and whether the draws equal the unchunked fit's bitwise. Then the
    fit killed after two chunks (fault_policy="abort") and resumed from
    disk: bitwise the uninterrupted run, the peaks of both legs (the
    run without the quarantine clone)."""
    import os

    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.tracing import ChunkPipelineStats

    qcfg = production_config(k=MAIN_K, n_samples=64, phi_every=16, fault_policy="quarantine")
    acfg = production_config(k=MAIN_K, n_samples=64, phi_every=16)
    path = os.path.join(tmp, "c5.npz")
    stats, calls = ChunkPipelineStats(), []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    start = time.perf_counter()
    res = fit_meta_kriging(*c5_data, config=qcfg, seed=SEED, device=device, chunk_iters=16,
                           checkpoint_path=path, nan_guard=True, progress=calls.append,
                           pipeline_stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak_q = torch.cuda.max_memory_allocated()
    launches = dict(fb.LAUNCHES)
    want = build_calls(qcfg, 1, qcfg.n_samples, qcfg.n_burn_in, chunk_iters=16)
    check(launches == want, f"chunked config5: launches {launches} != {want}")
    layouts = launches_by_kernel()
    check(layouts == expected_by_kernel(want), f"chunked config5: by kernel {layouts}")
    check(all(launches[e] > 0 for e in MAIN_PATH), "chunked config5: a kernel never launched")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "chunked config5: a plain build ran on the card")
    for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"chunked config5: non-finite {f}")
    check([c["iteration"] for c in calls] == [16, 32, 48, 64],
          f"chunked config5: progress {calls}")
    disk_after_run = free_disk_bytes(tmp)
    ckpt_files = sorted(os.listdir(tmp))
    agg = stats.aggregate()
    # every boundary writes the whole carried state, chol_r and all
    chol_bytes = MAIN_K * MAIN_M * MAIN_M * 4
    check(len(agg["ckpt_boundary_bytes"]) == 4
          and min(agg["ckpt_boundary_bytes"]) > chol_bytes,
          f"chunked config5: boundary bytes {agg['ckpt_boundary_bytes']}")
    secs = res.phase_seconds
    out = {
        "phase": "fit_chunked_config5", "n": c5_data[0].shape[0], "K": MAIN_K, "m": MAIN_M,
        "chunk_iters": 16, "n_samples": qcfg.n_samples, "fault_policy": "quarantine",
        "wall_s": wall, "phase_seconds": secs,
        "ms_per_sweep": secs["subset_fits"] / qcfg.n_samples * 1e3,
        "unchunked_ms_per_sweep": unchunked_ms,
        "chunks": stats.chunks, "aggregate": {k: agg[k] for k in (
            "n_chunks", "total_wall_s", "dispatch_s", "host_work_s", "host_stall_frac",
            "d2h_bytes", "ckpt_write_s", "ckpt_bytes", "ckpt_boundary_bytes", "fault")},
        "progress": calls, "peak_memory_bytes_quarantine": peak_q,
        "launches": launches, "launches_expected": want, "launches_by_kernel": layouts,
        "checkpoint_files": ckpt_files, "free_disk_bytes_with_checkpoint": disk_after_run,
    }
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    # the unchunked fit of the same sampler: chunked draws bitwise?
    ref = fit_meta_kriging(*c5_data, config=acfg, seed=SEED, device=device)
    same = bitwise(res, ref)
    out["chunked_equals_unchunked"] = same
    if not all(same.values()):
        out["chunked_vs_unchunked_max_abs"] = {
            f: float((getattr(res, f) - getattr(ref, f)).abs().max()) for f in same}
    del ref
    torch.cuda.empty_cache()

    def fit(**kw):
        return fit_meta_kriging(*c5_data, config=acfg, seed=SEED, device=device,
                                chunk_iters=16, **kw)

    # kill at the third boundary (two chunks on disk), resume from disk
    torch.cuda.reset_peak_memory_stats()
    kpath = os.path.join(tmp, "c5_kill.npz")
    resumed, resume_s = kill_and_resume(fit, kpath, 2)
    out["peak_memory_bytes_abort_kill_and_resume"] = torch.cuda.max_memory_allocated()
    out["resume_call_s"] = resume_s
    same = bitwise(res, resumed, ("param_grid", "w_grid", "p_quant"))
    out["kill_resume_bitwise"] = same
    check(all(same.values()), f"chunked config5: kill and resume {same}")
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    out["free_disk_bytes_after_cleanup"] = free_disk_bytes(tmp)
    emit(out)
    return out


def ragged_kernel_checks(device, part):
    """The symmetric kernel (masked and shifted builds) and the narrow
    kernel (the cross build with the row mask) at each bucket group's
    shape of a coherent partition, against the plain version."""
    import torch
    from smk_torch.ops import fused_build as fb

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    test = torch.rand((C4_T, 2), generator=gen, device=device)
    rows = []
    for g in part.groups:
        coords = g.part.coords.to(device)
        mask = g.part.mask.to(device)
        k, m = mask.shape
        phis = 4.0 + 8.0 * torch.rand((k, C4_Q), generator=gen, device=device)
        shift = torch.where(mask > 0, 0.5 + torch.rand((k, m), generator=gen, device=device),
                            torch.full_like(mask, 1e8))
        model = "exponential"
        cases = {
            "fused_masked_correlation_stack": (
                fb.fused_masked_correlation_stack(coords, phis, mask, model),
                fb.plain_build(coords, coords, phis, model, mask=mask, zero_diag=True)),
            "fused_masked_shifted_build": (
                fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
                fb.plain_build(coords, coords, phis, model, mask=mask, shift=shift,
                               zero_diag=True)),
            "fused_cross_correlation": (
                fb.fused_cross_correlation(coords, test, phis[:, :1], model, row_mask=mask),
                fb.plain_build(coords, test[None], phis[:, :1], model, row_mask=mask)),
        }
        for name, (got, want) in cases.items():
            err = compare(got, want, f"coherent config4 {name} at K={k}, m={m}")
            rows.append({"entry": name, "bucket": g.bucket, "shape": list(got.shape),
                         "max_abs_err": err})
        del cases
    return rows


def fit_coherent_config4(device, c4_data, random_ms):
    """fit_meta_kriging at config4's width on the eBird proxy with the
    coherent partition (partition_method="coherent", the production
    sampler, logit, phi every 8th, 64 sweeps in chunks of 16): the
    buckets and pad share (pad_summary), the kernels at each group's
    shape against their plain version, ms/sweep per group and for the
    whole fit beside the random split's, peak memory, launches per
    group against build_calls(chunk_iters=16), finite outputs of K
    rows."""
    import numpy as np
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel.partition import coherent_partition
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg = production_config(k=C4_K, n_samples=64, link="logit", phi_every=8,
                            partition_method="coherent")
    y, x, coords, ct, xt = c4_data
    part = coherent_partition(*(torch.as_tensor(a) for a in (y, x, coords)), C4_K)
    pads = part.pad_summary()
    buckets = list(part.buckets)
    sizes = [len(g.subset_ids) for g in part.groups]
    check((buckets, sizes) == C4_COHERENT, f"coherent config4: buckets {buckets} {sizes}")
    kernel_rows = ragged_kernel_checks(device, part)
    del part
    torch.cuda.empty_cache()
    stats, marks = ChunkPipelineStats(), []

    def progress(info):
        marks.append((info["bucket"], info["iteration"], dict(fb.LAUNCHES)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    start = time.perf_counter()
    res = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, seed=SEED, device=device,
                           chunk_iters=16, progress=progress, pipeline_stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fb.LAUNCHES)
    want = build_calls(cfg, C4_Q, cfg.n_samples, cfg.n_burn_in, chunk_iters=16)
    first = [mk for mk in marks if mk[0] == buckets[0]][-1][2]
    per_group = {str(buckets[0]): first,
                 str(buckets[1]): {e: launches[e] - first[e] for e in launches}}
    for b, got in per_group.items():
        check(got == want, f"coherent config4: group {b} launches {got} != {want}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "coherent config4: a plain build ran on the card")
    layouts = launches_by_kernel()
    total_want = {e: 2 * v for e, v in want.items()}
    check(layouts == expected_by_kernel(total_want), f"coherent config4: by kernel {layouts}")
    check(tuple(res.subset_results.param_grid.shape[:1]) == (C4_K,), "coherent config4: K rows")
    for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"coherent config4: non-finite {f}")
    check(bool(torch.isfinite(res.subset_results.param_grid).all()),
          "coherent config4: a non-finite subset grid")
    p_q = res.p_quant.cpu().numpy()
    check(bool(((p_q >= 0) & (p_q <= 1)).all()), "coherent config4: p outside [0, 1]")
    by_group = {}
    for gi, b in enumerate(buckets):
        chunks = stats.chunks[4 * gi: 4 * gi + 4]
        by_group[str(b)] = {"sweep_s": sum(c["dispatch_s"] for c in chunks),
                            "ms_per_sweep": sum(c["dispatch_s"] for c in chunks)
                            / cfg.n_samples * 1e3}
    secs = res.phase_seconds
    out = {
        "phase": "fit_coherent_config4", "n": y.shape[0], "K": C4_K, "q": C4_Q, "p": C4_P,
        "t": C4_T, "link": cfg.link, "buckets": buckets, "subsets_per_bucket": sizes,
        "pad_summary": pads, "kernel_checks": kernel_rows, "wall_s": wall,
        "phase_seconds": secs, "ms_per_sweep": secs["subset_fits"] / cfg.n_samples * 1e3,
        "ms_per_sweep_by_group": by_group, "random_partition_ms_per_sweep": random_ms,
        "peak_memory_bytes": peak, "launches": launches, "launches_per_group": per_group,
        "launches_expected_per_group": want, "launches_by_kernel": layouts,
        "pad_waste_frac": res.pad_waste_frac, "ragged_groups": stats.ragged_groups,
        "param_quant_median": np.round(res.param_quant[0].cpu().numpy(), 4).tolist(),
    }
    emit(out)
    return out


OVERLAP_SAMPLES, OVERLAP_CHUNK = 288, 96


def sync_debug_chunk(cfg, data_np, device, n=16):
    """One burn-in chunk and one sampling chunk of ``n`` sweeps at the
    fit's width, called directly on the sampler (sampler_setup) under
    torch.cuda.set_sync_debug_mode("warn"): every synchronising call
    inside a chunk, by the Python line that made it and the innermost
    line of smk_torch on its stack; first the mode switched on and off
    around no work ("none"), what the switch alone reports."""
    import collections
    import os
    import traceback
    import warnings

    import torch

    model, data, state, consts, noise = sampler_setup(cfg, data_np, device)
    torch.cuda.synchronize()
    found = {}
    for kind in ("none", "burn", "sample"):
        sites = collections.Counter()

        def hook(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            ours = [f for f in traceback.extract_stack()[:-1] if "smk_torch" in f.filename]
            where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
                     f" ({ours[-1].name})" if ours else "outside smk_torch")
            sites[f"{os.path.basename(filename)}:{lineno} from {where}"] += 1

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if kind == "burn":
                    state = model.burn_chunk(data, consts, state, noise, 0, n)
                elif kind == "sample":
                    state, _ = model.sample_chunk(data, consts, state, noise,
                                                  cfg.n_burn_in, n)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        found[kind] = {"n_sweeps": 0 if kind == "none" else n, "n_syncs": sum(sites.values()),
                       "by_line": dict(sites.most_common())}
    torch.cuda.synchronize()
    return found


def fit_overlap_config5(device, c5_data, tmp):
    """The overlap pipeline at config5's full width: the production
    sampler with fault_policy="quarantine", 288 sweeps (216 burn-in) in
    chunks of 96, a 1.95 GB manifest at each of the four boundaries,
    nan_guard on, through fit_meta_kriging under chunk_pipeline="sync"
    and then "overlap". For each: the fit's wall and ms/sweep, the sum of
    the chunks' dispatch seconds and device waits, the checkpoint's write
    seconds and bytes, host_stall_s and overlap_efficiency, the drain,
    the peak device memory and the pinned staging bytes, launches against
    build_calls(chunk_iters=96) with no plain build. The overlap's draws
    must equal the sync run's bitwise. First one chunk of each kind under
    the sync debug mode (sync_debug_chunk)."""
    import dataclasses
    import gc
    import os

    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg_sync = production_config(k=MAIN_K, n_samples=OVERLAP_SAMPLES, phi_every=16,
                                 fault_policy="quarantine")
    out = {"phase": "fit_overlap_config5", "n": c5_data[0].shape[0], "K": MAIN_K,
           "m": MAIN_M, "t": MAIN_T, "n_samples": OVERLAP_SAMPLES,
           "n_burn_in": cfg_sync.n_burn_in, "chunk_iters": OVERLAP_CHUNK,
           "fault_policy": "quarantine"}
    out["sync_debug"] = sync_debug_chunk(cfg_sync, c5_data, device)
    gc.collect()  # the direct sampler's state must not count in the fits' peaks
    torch.cuda.empty_cache()
    want = build_calls(cfg_sync, 1, OVERLAP_SAMPLES, cfg_sync.n_burn_in,
                       chunk_iters=OVERLAP_CHUNK)
    results = {}
    for mode in ("sync", "overlap"):
        cfg = dataclasses.replace(cfg_sync, chunk_pipeline=mode)
        path = os.path.join(tmp, f"overlap5_{mode}.npz")
        stats = ChunkPipelineStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        fb.reset_counts()
        start = time.perf_counter()
        res = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                               chunk_iters=OVERLAP_CHUNK, checkpoint_path=path,
                               nan_guard=True, pipeline_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = dict(fb.LAUNCHES)
        layouts = launches_by_kernel()
        check(launches == want, f"overlap config5 ({mode}): launches {launches} != {want}")
        check(layouts == expected_by_kernel(want), f"overlap config5 ({mode}): {layouts}")
        check(sum(fb.PLAIN_CALLS.values()) == 0,
              f"overlap config5 ({mode}): a plain build ran on the card")
        for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
            check(bool(torch.isfinite(getattr(res, f)).all()),
                  f"overlap config5 ({mode}): non-finite {f}")
        agg = stats.aggregate()
        work = [c for c in stats.chunks if c["phase"] != "drain"]
        check(len(agg["ckpt_boundary_bytes"]) == 4,
              f"overlap config5 ({mode}): boundaries {agg['ckpt_boundary_bytes']}")
        secs = res.phase_seconds
        results[mode] = res
        out[mode] = {
            "wall_s": wall, "subset_fits_s": secs["subset_fits"],
            "ms_per_sweep": secs["subset_fits"] / OVERLAP_SAMPLES * 1e3,
            "dispatch_s_sum": sum(c["dispatch_s"] for c in work),
            "device_wait_s_sum": sum(c.get("device_wait_s", 0.0) for c in work),
            "state_fetch_s_sum": sum(c.get("state_fetch_s", 0.0) for c in work),
            "staging_wait_s_sum": sum(c.get("staging_wait_s", 0.0) for c in work),
            "drain_s": sum(c["host_work_s"] for c in stats.chunks if c["phase"] == "drain"),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "allocated_before_fit_bytes": held_before,
            "pinned_staging_bytes": stats.host_staging_bytes,
            "launches": launches, "launches_by_kernel": layouts,
            "chunks": stats.chunks,
            "aggregate": {k: agg[k] for k in (
                "n_chunks", "total_wall_s", "dispatch_s", "host_work_s", "host_stall_s",
                "host_stall_frac", "overlap_efficiency", "d2h_bytes", "ckpt_write_s",
                "ckpt_bytes", "ckpt_boundary_bytes", "fault")},
        }
        for f in os.listdir(tmp):
            os.remove(os.path.join(tmp, f))
        torch.cuda.empty_cache()
    same = bitwise(results["sync"], results["overlap"])
    sub = {f: bool(torch.equal(getattr(results["sync"].subset_results, f),
                               getattr(results["overlap"].subset_results, f)))
           for f in ("param_samples", "w_samples", "phi_accept_rate")}
    out["overlap_equals_sync"] = {**same, **sub}
    check(all(same.values()) and all(sub.values()),
          f"overlap config5: overlap differs from sync {out['overlap_equals_sync']}")
    out["launches"] = out["overlap"]["launches"]
    out["launches_by_kernel"] = out["overlap"]["launches_by_kernel"]
    out["launches_expected"] = want
    emit(out)
    return out


def fit_overlap_small_faults(device, tmp):
    """The overlap pipeline's fault legs on the card, small (n = 800,
    K = 4, m = 200, q = 1, 24 sweeps with 12 burn-in in chunks of 4:
    three burn-in and three sampling chunks), quarantine: an overlapped,
    checkpointed fit (launches against build_calls) bitwise the sync
    fit; killed after two chunks under overlap and resumed under sync,
    bitwise; a failed writer job (fail_writer_job) that degrades with a
    warning and leaves a checkpoint that resumes to the same result;
    kill_at_manifest and a resume, bitwise; a bit-flipped segment
    resumed leniently (its range refilled, finite, the rest bitwise);
    stall_chunk under watchdog=True, a ChunkTimeoutError within its
    deadline; dead_domain over two failure domains through the domain
    ladder (fit_subsets_chunked); the watchdog armed on a healthy fit,
    bitwise the sync fit. Every leg runs on the card."""
    import dataclasses
    import os
    import shutil as sh
    import warnings

    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.api import TorchRandomness
    from smk_torch.models import probit_gp as tp
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel.domains import ChunkTimeoutError, FailureDomainMap
    from smk_torch.parallel.partition import random_partition
    from smk_torch.parallel.recovery import fit_subsets_chunked
    from smk_torch.testing import faults
    from smk_torch.utils.checkpoint import segment_path
    from smk_torch.utils.tracing import ChunkPipelineStats

    k, chunk = 4, 4
    data = binary_field(800, 1, 2, 8, SEED + 800)
    sync_cfg = SMKConfig(n_subsets=k, n_samples=24, burn_in_frac=0.5, phi_update_every=2,
                         fused_build="pallas", fault_policy="quarantine")
    ov_cfg = dataclasses.replace(sync_cfg, chunk_pipeline="overlap")

    def fit(cfg, **kw):
        return fit_meta_kriging(*data, config=cfg, seed=SEED, device=device,
                                chunk_iters=chunk, **kw)

    golden = os.path.join(tmp, "golden")

    def fresh(name):
        """Clear the checkpoint files (the golden copy stays)."""
        for f in os.listdir(tmp):
            if os.path.isfile(os.path.join(tmp, f)):
                os.remove(os.path.join(tmp, f))
        return os.path.join(tmp, name)

    legs = {}
    fields = ("param_grid", "w_grid", "p_quant", "param_quant", "sample_par")
    # the overlapped, checkpointed fit: the path's launches
    fb.reset_counts()
    ov = fit(ov_cfg, checkpoint_path=fresh("ov.npz"))
    launches, layouts = dict(fb.LAUNCHES), launches_by_kernel()
    want = build_calls(sync_cfg, 1, sync_cfg.n_samples, sync_cfg.n_burn_in, chunk_iters=chunk)
    check(launches == want, f"overlap small: launches {launches} != {want}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "overlap small: a plain build ran on the card")
    ref_path = fresh("ref.npz")
    ref = fit(sync_cfg, checkpoint_path=ref_path)
    legs["overlap_equals_sync"] = bitwise(ov, ref, fields)
    check(all(legs["overlap_equals_sync"].values()), f"overlap small: {legs}")
    os.makedirs(golden)
    for f in os.listdir(tmp):
        if os.path.isfile(os.path.join(tmp, f)):
            sh.copy(os.path.join(tmp, f), golden)
    # killed after two chunks under overlap, resumed under sync
    path = fresh("kill.npz")
    progress, kill = kill_after(2)
    try:
        fit(ov_cfg, checkpoint_path=path, progress=progress)
        raise AssertionError("overlap small: the kill did not stop the fit")
    except kill:
        pass
    legs["kill_overlap_resume_sync"] = bitwise(fit(sync_cfg, checkpoint_path=path), ref,
                                               fields)
    check(all(legs["kill_overlap_resume_sync"].values()), f"overlap small: {legs}")
    # a writer job fails: a warning, inline writes, a checkpoint that resumes
    path = fresh("writer.npz")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.fail_writer_job(2):
            res = fit(ov_cfg, checkpoint_path=path)
    degraded = [str(w.message)[:80] for w in caught if "degrading" in str(w.message)]
    check(len(degraded) == 1, f"overlap small: writer failure warnings {degraded}")
    legs["writer_failure"] = {"warning": degraded[0], "result": bitwise(res, ref, fields),
                              "resume": bitwise(fit(sync_cfg, checkpoint_path=path), ref,
                                                fields)}
    check(all(legs["writer_failure"]["result"].values())
          and all(legs["writer_failure"]["resume"].values()), f"overlap small: {legs}")
    # a kill between a segment and its manifest, then a resume
    path = fresh("manifest.npz")
    try:
        with faults.kill_at_manifest(5):
            fit(sync_cfg, checkpoint_path=path)
        raise AssertionError("overlap small: kill_at_manifest did not fire")
    except faults.SimulatedKill:
        pass
    legs["kill_at_manifest_resume"] = bitwise(fit(sync_cfg, checkpoint_path=path), ref,
                                              fields)
    check(all(legs["kill_at_manifest_resume"].values()), f"overlap small: {legs}")
    # a bit-flipped segment, resumed leniently under quarantine
    fresh("none")
    for f in os.listdir(golden):
        sh.copy(os.path.join(golden, f), tmp)
    faults.corrupt_segment(ref_path, 1, "bitflip")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = fit(ov_cfg, checkpoint_path=ref_path)
    holes = [str(w.message)[:80] for w in caught if "re-sampled" in str(w.message)]
    got, want_s = res.subset_results.param_samples, ref.subset_results.param_samples
    legs["lenient_refill"] = {
        "warnings": holes, "finite": bool(torch.isfinite(got).all()),
        "outside_hole_bitwise": bool(torch.equal(got[:, :4], want_s[:, :4])
                                     and torch.equal(got[:, 8:], want_s[:, 8:])),
        "hole_resampled": not bool(torch.equal(got[:, 4:8], want_s[:, 4:8])),
        "segments_after": sorted(f for f in os.listdir(tmp) if ".seg" in f
                                 and os.path.isfile(os.path.join(tmp, f))),
    }
    check(len(holes) == 1 and legs["lenient_refill"]["finite"]
          and legs["lenient_refill"]["outside_hole_bitwise"]
          and legs["lenient_refill"]["hole_resampled"]
          and legs["lenient_refill"]["segments_after"]
          == [os.path.basename(segment_path(ref_path, 3))],
          f"overlap small: lenient refill {legs['lenient_refill']}")
    sh.rmtree(golden, ignore_errors=True)
    # the watchdog armed: the same draws; then a stalled chunk under it
    wd_cfg = dataclasses.replace(ov_cfg, watchdog=True, watchdog_min_deadline_s=2.0,
                                 watchdog_margin=4.0)
    fresh("none")
    legs["watchdog_armed_equals_sync"] = bitwise(fit(wd_cfg), ref, fields)
    check(all(legs["watchdog_armed_equals_sync"].values()), f"overlap small: {legs}")
    start = time.perf_counter()
    try:
        with faults.stall_chunk(18, max_stall_s=120.0) as inj:
            fit(wd_cfg)
        raise AssertionError("overlap small: the stalled chunk did not time out")
    except ChunkTimeoutError as e:
        legs["watchdog"] = {"deadline_s": e.deadline_s, "chunk": e.chunk,
                            "iteration": e.iteration, "fires": inj.fires,
                            "labels": e.domain_labels,
                            "wall_s": time.perf_counter() - start}
    check(legs["watchdog"]["fires"] == 1 and legs["watchdog"]["wall_s"] < 60.0,
          f"overlap small: watchdog {legs['watchdog']}")
    time.sleep(0.5)  # the abandoned worker finishes its chunk
    torch.cuda.synchronize()
    # a dead domain through the domain ladder (two domains of two subsets)
    y, x, coords, ct, xt = (torch.as_tensor(a, device=device, dtype=torch.float32)
                            for a in data)
    rng = TorchRandomness(SEED, device, torch.float32)
    part = random_partition(rng.permutation(y.shape[0]).to(device), y, x, coords, k)
    shapes = tp.sweep_shapes(ov_cfg, k, part.subset_size, 1, 2, ct.shape[0])
    dmap = FailureDomainMap.from_n_domains(k, 2)

    def domain_fit():
        stats = ChunkPipelineStats()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res = fit_subsets_chunked(
                tp.SpatialGPSampler(ov_cfg), part, ct, xt,
                TorchRandomness(SEED, device, torch.float32).sweep_noise(shapes),
                chunk_iters=chunk, pipeline_stats=stats, domain_map=dmap)
        return res, stats

    clean, _ = domain_fit()
    with faults.dead_domain(dmap.subsets_of(0), 14):
        dead, dstats = domain_fit()
    summary = dstats.fault_summary()
    legs["dead_domain"] = {
        "fault": summary,
        "survivors_bitwise": bool(torch.equal(dead.param_samples[2:],
                                              clean.param_samples[2:])),
        "dropped_non_finite": not bool(torch.isfinite(dead.param_samples[:2]).all()),
    }
    check(summary["domains_dropped"] == [0] and summary["subsets_dropped"] == [0, 1]
          and legs["dead_domain"]["survivors_bitwise"]
          and legs["dead_domain"]["dropped_non_finite"],
          f"overlap small: dead domain {legs['dead_domain']}")
    fresh("none")
    out = {"phase": "fit_overlap_small_faults", "n": 800, "K": k, "m": 200,
           "n_samples": sync_cfg.n_samples, "chunk_iters": chunk, "legs": legs,
           "launches": launches, "launches_expected": want, "launches_by_kernel": layouts}
    emit(out)
    return out

# ----------------------------------------------------------------------
# phases 27-29: the chunked executor's last knobs — the streaming
# monitor, the run log, the adaptive schedule, profiling
# ----------------------------------------------------------------------
ADAPT_SAMPLES, ADAPT_CHUNK = 160, 10
PROFILE_SAMPLES, PROFILE_CHUNK, PROFILE_WINDOW = 32, 8, "1:3"
# the streaming R-hat at the last boundary against post-hoc rhat on the
# same draws (obs/streaming.py's contract), and the profiler's device
# time over its window against the chunks' CUDA-event times
STREAM_RTOL, PROFILE_AGREE = 1e-4, 0.25


def dispatched_build_calls(cfg, q, chunks):
    """The launches a chunked run implies from its own record: the
    initial state's stack plus each dispatched chunk's calls at its rung
    (``chunks``: ChunkPipelineStats.chunks, the drain left out), each
    chunk's calls from probit_gp.chunk_build_calls."""
    from smk_torch.models.probit_gp import chunk_build_calls

    out = chunk_build_calls(cfg, q, "burn", 0, 0)
    out["fused_masked_correlation_stack"] = 1  # the initial state's R~
    for ch in chunks:
        if ch["phase"] == "drain":
            continue
        kind = "burn" if ch["phase"] == "burn" else "samp"
        for key, v in chunk_build_calls(cfg, q, kind, ch["iteration"] - ch["n_iters"],
                                        ch["n_iters"]).items():
            out[key] += v
    return out


def replay_schedule(cfg, k, events, chunks):
    """A fresh AdaptiveScheduler replayed on the host over a run's logged
    live_diagnostics events, the dispatch group re-formed as the
    executor does (members, rung, the frozen riders that stop writing,
    the plan growing at each grant). Returns the scheduler."""
    import numpy as np
    from smk_torch.parallel.schedule import AdaptiveScheduler

    n_burn, n_kept = cfg.n_burn_in, cfg.n_kept
    sched = AdaptiveScheduler(cfg, k=k, n_kept=n_kept, chunk_iters=ADAPT_CHUNK)
    plan_len = -(-n_burn // ADAPT_CHUNK) + -(-n_kept // ADAPT_CHUNK)
    members, kc = list(range(k)), k
    live = {e["iteration"]: e for e in events}
    for idx, ch in enumerate(c for c in chunks if c["phase"] != "drain"):
        if ch["phase"] not in ("sample", "extra"):
            continue
        ev = live[ch["iteration"]]
        written = [j for j in members if not sched.frozen[j]]
        b = ch["iteration"] - n_burn
        dec = sched.observe(
            kind="samp" if ch["phase"] == "sample" else "extra", it=ch["iteration"],
            span=(b - ch["n_iters"], b), written=written, kc_dispatched=kc,
            rhat_max=np.asarray(ev["rhat_max"], np.float64),
            ess_min=np.asarray(ev["ess_min"], np.float64),
            plan_exhausted=idx == plan_len - 1)
        if dec.grant is not None:
            plan_len += 1
        new = list(dec.active)
        new_kc = sched.rung(len(new)) if new else 0
        if new_kc != kc or any(j not in members for j in new):
            sched.mark_stopped([j for j in members if j not in new], ch["iteration"])
            members, kc = new, new_kc
    return sched


def regroup_cost(state, c, device):
    """What a compaction of the adaptive schedule moves at the fit's
    width, timed on ``state`` (K*C rows): the merge of the group's state
    into the host mirror (the whole state, as the first compaction
    fetches it), the gather of a compacted group's rows back to the
    card at the first rungs below K, and a checkpointed boundary's merge
    at K and at those rungs: the group's state copied into the pinned
    staging buffer behind one event, then its rows written into the
    mirror (recovery._host_state, _device_state, _HostStaging,
    _merge_rows: the executor's own helpers)."""
    import numpy as np
    import torch
    from smk_torch.models.probit_gp import SamplerState
    from smk_torch.parallel import recovery as rec

    torch.cuda.synchronize()
    start = time.perf_counter()
    full = rec._host_state(state)
    out = {"merge_s": time.perf_counter() - start,
           "host_mirror_bytes": sum(a.nbytes for a in full.arrays), "gather_s": {}}
    for rung in COMPACT_K:
        rows = np.asarray([j * c + ch for j in range(rung) for ch in range(c)])
        start = time.perf_counter()
        got = rec._device_state(rec._HostState(SamplerState(*(
            np.take(a, rows, axis=rec._row_axis(p)) for a, p in zip(full.arrays, full.layout))),
            full.layout), device)
        torch.cuda.synchronize()
        out["gather_s"][str(rung)] = time.perf_counter() - start
        check(all(torch.equal(g, t[:rung * c]) and g.stride() == t[:rung * c].stride()
                  for g, t in zip(got, state)), f"regroup at rung {rung}: rows or layout differ")
        del got
    # the first take pins the buffer (once a fit); K is timed again after
    staging = rec._HostStaging(1)
    out["boundary_merge_s"] = []
    k = len(state[0]) // c
    for rung in (k,) + tuple(COMPACT_K) + (k,):
        group = SamplerState(*(t[:rung * c] for t in state))
        views, layout = rec._state_views(group)
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, arrays, _ = staging.take(views, rec._state_nbytes(state))
        torch.cuda.current_stream().synchronize()
        rec._merge_rows(full, rec._HostState(SamplerState(*arrays), layout),
                        list(range(rung * c)))
        out["boundary_merge_s"].append([rung, time.perf_counter() - start])
    out["staging_bytes"] = staging.nbytes
    again = rec._host_state(state)
    check(all(np.array_equal(a, b) for a, b in zip(full.arrays, again.arrays)),
          "boundary merge: the mirror differs from the state")
    del staging, again
    return out


def sync_debug_armed(cfg, setup, device):
    """One burn-in and one sampling chunk of 4 sweeps at the fit's width
    through the chunked executor (``setup``: sampler_setup's inputs),
    unarmed and then with the streaming monitor armed, both with a
    progress callback (so both make the boundary's one fetch), under
    torch.cuda.set_sync_debug_mode("warn"), after one unrecorded unarmed
    run (the process's one-time synchronisations): the synchronising
    calls by the line that made them, for each, and apart from them
    those made with no port frame on the stack."""
    import collections
    import dataclasses
    import os
    import traceback
    import warnings

    import torch
    from smk_torch.models import probit_gp as tp
    from smk_torch.parallel import recovery as rec
    from smk_torch.utils.tracing import ChunkPipelineStats

    data = setup[1]
    c = cfg.n_chains
    part = _partition_of(data, c)
    found = {}
    for label, live in (("warm-up", False), ("unarmed", False), ("armed", True)):
        run_cfg = dataclasses.replace(cfg, n_samples=8, burn_in_frac=0.5, live_diagnostics=live)
        model = tp.SpatialGPSampler(run_cfg)
        noise = model.default_noise(rec.stacked_subset_data(part, data.coords_test,
                                                            data.x_test), seed=SEED)
        sites = collections.Counter()

        def hook(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return
            ours = [f for f in traceback.extract_stack()[:-1] if "smk_torch" in f.filename]
            where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
                     f" ({ours[-1].name})" if ours else "outside smk_torch")
            sites[f"{os.path.basename(filename)}:{lineno} from {where}"] += 1

        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rec.fit_subsets_chunked(model, part, data.coords_test, data.x_test, noise,
                                        chunk_iters=4,
                                        progress=lambda info: None,
                                        pipeline_stats=ChunkPipelineStats())
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ours = {line: n for line, n in sites.most_common() if "outside smk_torch" not in line}
        found[label] = {"n_syncs": sum(sites.values()), "by_line": ours,
                        "outside_port": sum(sites.values()) - sum(ours.values())}
    torch.cuda.synchronize()
    del found["warm-up"]
    return found


def _partition_of(data, c):
    """The K-subset Partition of a K*C-row chain batch (its first chain's
    rows)."""
    from smk_torch.parallel.partition import Partition

    return Partition(y=data.y[::c], x=data.x[::c], coords=data.coords[::c],
                     mask=data.mask[::c], index=None)


def adaptive_config(*, k, n_samples, n_chains, adaptive, live, run_log_dir=None, **extra):
    """The production sampler (bench.py:rung_config) with the JAX bench's
    adaptive A/B knobs (bench.py:1461-1560): target_rhat 1.2,
    target_ess 50, patience 2, min_samples_before_stop = kept // 4,
    adapt_max_extra_frac 0.5."""
    kept = n_samples - int(0.75 * n_samples)
    return production_config(
        k=k, n_samples=n_samples, phi_every=16, n_chains=n_chains,
        live_diagnostics=live or adaptive, run_log_dir=run_log_dir,
        adaptive_schedule="on" if adaptive else "off", target_rhat=1.2, target_ess=50.0,
        adapt_patience=2, min_samples_before_stop=kept // 4, adapt_max_extra_frac=0.5,
        **extra)


def fit_adaptive_config5(device, c5_data, tmp):
    """config5 at full width (K = 32, m = 3906, t = 64), the production
    sampler with two chains, 160 sweeps (120 burn-in, 40 kept) in chunks
    of 10, through fit_meta_kriging: (a) the fixed schedule, monitor off;
    (b) the fixed schedule with live_diagnostics and run_log_dir; (c)
    adaptive_schedule="on" with the bench's targets and the run log; (a)
    again, warm. (b) and the second (a) must be bitwise (a); the streaming R-hat of (b)'s last boundary is
    held against post-hoc rhat on the same draws; (b)'s run log
    summarizes with root coverage >= 0.95 and no orphan; (c)'s build
    launches equal those its dispatched chunks imply at their rungs; a
    fresh scheduler replayed over (c)'s logged statistics gives (c)'s
    frozen_at. For each run: wall, ms/sweep, peak memory, the adaptive
    telemetry. First one armed chunk against an unarmed one under the
    sync debug mode (sync_debug_armed) and a compaction's moves at this
    width (regroup_cost)."""
    import os

    import numpy as np
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.obs import streaming as st
    from smk_torch.obs.reporter import read_jsonl
    from smk_torch.obs.summarize import summarize
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.diagnostics import rhat
    from smk_torch.utils.tracing import ChunkPipelineStats

    k, c = MAIN_K, 2
    out = {"phase": "fit_adaptive_config5", "n": c5_data[0].shape[0], "K": k, "m": MAIN_M,
           "t": MAIN_T, "n_chains": c, "n_samples": ADAPT_SAMPLES, "chunk_iters": ADAPT_CHUNK}
    cfg_a = adaptive_config(k=k, n_samples=ADAPT_SAMPLES, n_chains=c, adaptive=False,
                            live=False)
    setup = sampler_setup(cfg_a, c5_data, device)
    out["sync_debug"] = sync_debug_armed(cfg_a, setup, device)
    out["regroup_cost"] = regroup_cost(setup[2], c, device)
    del setup
    sd = out["sync_debug"]
    check(sd["armed"]["by_line"] == sd["unarmed"]["by_line"],
          f"adaptive config5: the armed monitor added synchronising calls {sd}")
    torch.cuda.empty_cache()
    runs, results = {}, {}
    # (a) runs again last: the first fit of the phase pays a warm-up, so
    # the monitor's cost is (b) against the warm (a2)
    for label, adaptive, live in (("a_fixed", False, False), ("b_fixed_live", False, True),
                                  ("c_adaptive", True, True), ("a2_fixed", False, False)):
        log_dir = None if not live else os.path.join(tmp, f"log_{label}")
        cfg = adaptive_config(k=k, n_samples=ADAPT_SAMPLES, n_chains=c, adaptive=adaptive,
                              live=live, run_log_dir=log_dir)
        stats = ChunkPipelineStats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb.reset_counts()
        start = time.perf_counter()
        res = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                               chunk_iters=ADAPT_CHUNK, pipeline_stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = dict(fb.LAUNCHES)
        want = dispatched_build_calls(cfg, 1, stats.chunks)
        check(launches == want, f"adaptive config5 ({label}): launches {launches} != {want}")
        check(sum(fb.PLAIN_CALLS.values()) == 0,
              f"adaptive config5 ({label}): a plain build ran on the card")
        for f in ("p_quant", "param_quant", "param_grid", "w_grid"):
            check(bool(torch.isfinite(getattr(res, f)).all()),
                  f"adaptive config5 ({label}): non-finite {f}")
        agg = stats.aggregate()
        work = [ch for ch in stats.chunks if ch["phase"] != "drain"]
        runs[label] = {
            "wall_s": wall, "subset_fits_s": res.phase_seconds["subset_fits"],
            "ms_per_sweep": res.phase_seconds["subset_fits"] / ADAPT_SAMPLES * 1e3,
            "chunk_device_s_sum": sum(ch.get("device_s", 0.0) for ch in work),
            "n_chunks": len(work), "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "launches_by_kernel": launches_by_kernel(),
            "d2h_bytes_last_boundary": work[-1]["d2h_bytes"],
            **{key: agg[key] for key in ("live_rhat_final", "live_ess_min_final",
                                         "live_ess_sum_final", "ess_per_second",
                                         "ess_per_second_adaptive", "chunks_saved_frac",
                                         "frozen_at", "hbm_peak_bytes")},
            "run_log_path": res.run_log_path,
        }
        if adaptive:
            ad = stats.adaptive
            runs[label]["adaptive"] = {key: ad[key] for key in (
                "frozen_at", "kept_counts", "subset_chunks_dispatched", "subset_chunks_baseline",
                "chunks_saved_frac", "extra_granted", "n_frozen", "regroup_s",
                "host_mirror_bytes")}
            check(res.frozen_at == tuple(ad["frozen_at"])
                  and res.chunks_saved_frac == ad["chunks_saved_frac"],
                  "adaptive config5: the result's frozen_at / chunks_saved_frac")
        results[label] = (res, stats)
        torch.cuda.empty_cache()
    (ra, _), (rb, sb) = results["a_fixed"], results["b_fixed_live"]
    for other, key in ((rb, "armed_equals_unarmed"), (results["a2_fixed"][0], "a2_equals_a")):
        same = bitwise(ra, other)
        same.update({f: bool(torch.equal(getattr(ra.subset_results, f),
                                         getattr(other.subset_results, f)))
                     for f in ("param_samples", "w_samples", "phi_accept_rate")})
        out[key] = same
        check(all(same.values()), f"adaptive config5: {key} fails {same}")
    # the monitor's own numbers: the last boundary's statistics against
    # post-hoc rhat of the same draws, per parameter
    live = [r["attrs"] for r in read_jsonl(rb.run_log_path)
            if r.get("kind") == "event" and r.get("name") == "live_diagnostics"]
    draws = rb.subset_results.param_samples.reshape(k, c, -1, rb.param_grid.shape[-1])
    n_kept = ADAPT_SAMPLES - int(0.75 * ADAPT_SAMPLES)
    s_upd, s_stats = st.make_stream_update(n_kept // 2, c), st.make_stream_stats(c)
    stream = st.init_stream(k, c, draws.shape[-1], draws.dtype, device=device)
    for a in range(0, draws.shape[2], ADAPT_CHUNK):
        stream = s_upd(stream, draws[:, :, a:a + ADAPT_CHUNK], a)
    s_rhat = s_stats(stream)[0].cpu().numpy().astype(np.float64)
    post = rhat(draws).cpu().numpy().astype(np.float64)
    last = np.asarray(live[-1]["rhat_max"], np.float64)
    refold = np.nanmax(s_rhat, axis=1)
    check(np.allclose(refold, last, rtol=1e-6, equal_nan=True),
          "adaptive config5: the re-folded monitor != the last boundary's rhat_max")
    halves = draws.reshape(k, c, 2, -1, draws.shape[-1])
    within = halves.var(dim=3).mean(dim=(1, 2)).cpu().numpy()  # (K, d)
    scale = 1.0 + np.square(draws.mean(dim=(1, 2)).cpu().numpy())
    ok = np.isfinite(post) & (within > 1e-8 * scale)
    rel = np.abs(s_rhat - post) / np.abs(post)
    out["stream_vs_posthoc"] = {
        "rtol": STREAM_RTOL, "max_rel_err": float(rel[ok].max()),
        "n_compared": int(ok.sum()), "n_degenerate": int((~ok).sum()),
        "degenerate_columns": sorted({int(j) for j in np.where(~ok)[1]}),
        "last_boundary_rhat_max": last.tolist(), "posthoc_rhat_max": np.nanmax(post, 1).tolist(),
        "stream_bytes_per_boundary": st.fetch_nbytes(k)}
    check(out["stream_vs_posthoc"]["max_rel_err"] <= STREAM_RTOL,
          f"adaptive config5: streaming vs post-hoc R-hat {out['stream_vs_posthoc']}")
    summ = summarize(rb.run_log_path)
    out["run_log_b"] = {key: summ[key] for key in ("root_coverage", "n_orphan_spans",
                                                  "n_spans", "n_events", "truncated")}
    check(summ["root_coverage"] >= 0.95 and summ["n_orphan_spans"] == 0 and not summ["truncated"],
          f"adaptive config5: run log {out['run_log_b']}")
    # (c): the schedule replayed on the host from its own log
    rc, sc = results["c_adaptive"]
    events = [r["attrs"] for r in read_jsonl(rc.run_log_path)
              if r.get("kind") == "event" and r.get("name") == "live_diagnostics"]
    cfg_c = adaptive_config(k=k, n_samples=ADAPT_SAMPLES, n_chains=c, adaptive=True, live=True)
    replayed = replay_schedule(cfg_c, k, events, sc.chunks)
    out["host_replay_frozen_at"] = replayed.summary()["frozen_at"]
    check(out["host_replay_frozen_at"] == sc.adaptive["frozen_at"],
          "adaptive config5: the host replay's frozen_at differs")
    out["runs"] = runs
    a_ms, b_ms = runs["a2_fixed"]["ms_per_sweep"], runs["b_fixed_live"]["ms_per_sweep"]
    out["monitor_cost"] = {"ms_per_sweep": b_ms - a_ms, "frac": (b_ms - a_ms) / a_ms,
                           "chunk_device_s": (runs["b_fixed_live"]["chunk_device_s_sum"]
                                              - runs["a2_fixed"]["chunk_device_s_sum"])}
    out["launches"] = runs["c_adaptive"]["launches"]
    out["launches_by_kernel"] = runs["c_adaptive"]["launches_by_kernel"]
    emit(out)
    return out


def _small_problem(n, k, device, seed=7):
    """The twin's adaptive integration problem on the card (q = 1, p = 2,
    t = 5): uniform sites, normal covariates, coin-flip responses, a
    random partition into ``k`` subsets."""
    import numpy as np
    import torch
    from smk_torch.parallel.partition import random_partition, random_permutation

    rng = np.random.default_rng(seed)
    f = dict(dtype=torch.float32, device=device)
    coords = torch.tensor(rng.uniform(size=(n, 2)), **f)
    x = torch.tensor(rng.normal(size=(n, 1, 2)), **f)
    y = torch.tensor(rng.integers(0, 2, size=(n, 1)), **f)
    ct = torch.tensor(rng.uniform(size=(5, 2)), **f)
    xt = torch.tensor(rng.normal(size=(5, 1, 2)), **f)
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    return random_partition(random_permutation(g, n, device), y, x, coords, k), ct, xt


def fit_adaptive_small(device, tmp):
    """The twin's adaptive integration problem on the card (n = 64,
    K = 4, m = 16, two chains, 80 sweeps in chunks of 10, target_rhat
    1.5, target_ess 8, patience 1, min 8, extra 0.5), and a second case
    at K = 8, m = 200. Each: at least one freeze with strictly fewer
    subset-chunks than the fixed schedule, an extra grant past n_kept,
    launches equal to the dispatched chunks', a kill at the first freeze
    boundary resumed from the checkpoint and the sidecar bitwise the
    uninterrupted run; then the refusals (chunk_size, "overlap")."""
    import os

    import torch
    from smk_torch import SMKConfig
    from smk_torch.models import probit_gp as tp
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import recovery as rec
    from smk_torch.utils.tracing import ChunkPipelineStats

    knobs = dict(n_samples=80, burn_in_frac=0.5, live_diagnostics=True, adaptive_schedule="on",
                 target_rhat=1.5, target_ess=8.0, adapt_patience=1, min_samples_before_stop=8,
                 adapt_max_extra_frac=0.5, n_chains=2, fused_build="pallas")
    out = {"phase": "fit_adaptive_small", "cases": {}}
    total = dict.fromkeys(MAIN_PATH + ("fused_correlation",), 0)
    for label, n, k in (("K4_m16", 64, 4), ("K8_m200", 1600, 8)):
        cfg = SMKConfig(n_subsets=k, **knobs)
        part, ct, xt = _small_problem(n, k, device)

        def fit(**kw):
            model = tp.SpatialGPSampler(cfg)
            stats = ChunkPipelineStats()
            noise = model.default_noise(rec.stacked_subset_data(part, ct, xt), seed=SEED)
            res = rec.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=10,
                                          pipeline_stats=stats, **kw)
            return res, stats

        fb.reset_counts()
        full, stats = fit()
        launches = dict(fb.LAUNCHES)
        want = dispatched_build_calls(cfg, 1, stats.chunks)
        check(launches == want, f"adaptive small {label}: launches {launches} != {want}")
        for key in total:
            total[key] += launches[key]
        ad = stats.adaptive
        frozen = [f for f in ad["frozen_at"] if f >= 0]
        case = {key: ad[key] for key in ("frozen_at", "kept_counts", "subset_chunks_dispatched",
                                         "subset_chunks_baseline", "chunks_saved_frac",
                                         "extra_granted", "n_frozen", "regroup_s")}
        case["rungs"] = sorted({ch.get("kc") for ch in stats.chunks if "kc" in ch})
        check(ad["n_frozen"] >= 1 and ad["subset_chunks_dispatched"]
              < ad["subset_chunks_baseline"], f"adaptive small {label}: no saving {case}")
        check(ad["extra_granted"] >= 1 and max(ad["kept_counts"]) > cfg.n_kept,
              f"adaptive small {label}: no extra grant past n_kept {case}")
        for f in ("param_grid", "w_grid"):
            check(bool(torch.isfinite(getattr(full, f)).all()),
                  f"adaptive small {label}: non-finite {f}")
        first = min(frozen)
        path = os.path.join(tmp, f"adapt_{label}.npz")
        check(fit(checkpoint_path=path, stop_after_chunks=first // 10)[0] is None,
              f"adaptive small {label}: the kill did not stop the fit")
        resumed, rstats = fit(checkpoint_path=path)
        same = {f: bool(torch.equal(getattr(resumed, f).nan_to_num(7.0),
                                    getattr(full, f).nan_to_num(7.0)))
                for f in ("param_grid", "w_grid", "param_samples", "w_samples",
                          "phi_accept_rate")}
        case["kill_at_first_freeze"] = {"after_chunks": first // 10, "bitwise": same}
        check(all(same.values()) and rstats.adaptive["frozen_at"] == ad["frozen_at"],
              f"adaptive small {label}: the resume differs {same}")
        out["cases"][label] = case
    check(min(out["cases"]["K8_m200"]["rungs"]) < 8,
          f"adaptive small K8: no compaction below K = 8 {out['cases']['K8_m200']}")
    refusals = {}
    part, ct, xt = _small_problem(64, 4, device)
    try:
        rec.fit_subsets_chunked(tp.SpatialGPSampler(SMKConfig(n_subsets=4, **knobs)), part,
                                ct, xt, chunk_iters=10, chunk_size=2)
        refusals["chunk_size"] = None
    except ValueError as e:
        refusals["chunk_size"] = str(e)
    try:
        SMKConfig(n_subsets=4, chunk_pipeline="overlap", **knobs)
        refusals["overlap"] = None
    except ValueError as e:
        refusals["overlap"] = str(e)
    out["refusals"] = refusals
    check(refusals["chunk_size"] is not None and "incompatible with chunk_size"
          in refusals["chunk_size"], f"adaptive small: chunk_size not refused {refusals}")
    check(refusals["overlap"] is not None and "chunk_pipeline='sync'" in refusals["overlap"],
          f"adaptive small: overlap not refused {refusals}")
    for f in os.listdir(tmp):
        if f.startswith("adapt_"):
            os.remove(os.path.join(tmp, f))
    out["launches"] = total
    out["launches_by_kernel"] = expected_by_kernel(total)
    emit(out)
    return out


def fit_profile_config5(device, c5_data, tmp):
    """config5, the production sampler, one chain, 32 sweeps in chunks of
    8, first unprofiled and then with profile_chunks="1:3" through
    fit_meta_kriging: a Chrome trace must exist; its device ops must
    hold the symmetric build kernel, no more often than the window's
    chunks launched it (probit_gp.chunk_build_calls; the count, its
    share of the device time and its rank reported), and cuSOLVER's
    potrf; the window's
    device time (each chunk scope's device span) must agree within 25 %
    with the CUDA-event times of the same chunks.
    The profiler's overhead: those chunks' CUDA-event times profiled
    against unprofiled."""
    import os

    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import chunk_build_calls
    from smk_torch.obs import profiling
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.tracing import ChunkPipelineStats

    prof_dir = os.path.join(tmp, "profile")
    a, b = (int(v) for v in PROFILE_WINDOW.split(":"))
    out = {"phase": "fit_profile_config5", "n_samples": PROFILE_SAMPLES,
           "chunk_iters": PROFILE_CHUNK, "profile_chunks": PROFILE_WINDOW}
    secs = {}
    for label, pdir in (("unprofiled", None), ("profiled", prof_dir)):
        cfg = production_config(k=MAIN_K, n_samples=PROFILE_SAMPLES, phi_every=16,
                                profile_dir=pdir, profile_chunks=PROFILE_WINDOW if pdir else None)
        stats = ChunkPipelineStats()
        fb.reset_counts()
        start = time.perf_counter()
        res = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                               chunk_iters=PROFILE_CHUNK, pipeline_stats=stats)
        torch.cuda.synchronize()
        launches = dict(fb.LAUNCHES)
        want = dispatched_build_calls(cfg, 1, stats.chunks)
        check(launches == want, f"profile config5 ({label}): launches {launches} != {want}")
        check(bool(torch.isfinite(res.p_quant).all()), f"profile config5 ({label}): p_quant")
        secs[label] = [ch["device_s"] for ch in stats.chunks]
        out[label] = {"wall_s": time.perf_counter() - start, "chunk_device_s": secs[label],
                      "launches": launches}
        del res
        torch.cuda.empty_cache()
    summ = profiling.summarize_trace(prof_dir)
    check(summ is not None, "profile config5: the window wrote no trace")
    events = profiling.load_trace_events(summ["trace_path"])
    totals = sorted(profiling.device_op_totals(events).items(), key=lambda kv: -kv[1])
    device_names = [e["name"] for e in events if profiling._is_device(e)]
    # the window's chunks' own symmetric launches, as the counted wrappers
    # made them (the masked and shifted builds)
    win = [ch for ch in stats.chunks if a <= ch["chunk"] < b]
    want_sym = 0
    for ch in win:
        calls = chunk_build_calls(cfg, 1, "burn" if ch["phase"] == "burn" else "samp",
                                  ch["iteration"] - ch["n_iters"], ch["n_iters"])
        want_sym += expected_by_kernel(calls)["symmetric"]
    n_sym = sum("fused_corr_sym_kernel" in n for n in device_names)
    n_potrf = sum("potrf" in n.lower() for n in device_names)
    sym_us = sum(us for n, us in totals if "fused_corr_sym_kernel" in n)
    rank = {name: next((i + 1 for i, (n, _) in enumerate(totals) if key(n)), None)
            for name, key in (("symmetric_kernel", lambda n: "fused_corr_sym_kernel" in n),
                              ("potrf", lambda n: "potrf" in n.lower()))}
    window_s = sum(secs["profiled"][a:b])
    scopes = [s for s in summ["scopes"] if s["scope"].startswith("smk_chunk[")]
    span_s = sum(s["span_us"] for s in scopes) / 1e6
    busy_s = sum(s["busy_us"] for s in scopes) / 1e6
    out["trace"] = {"path": os.path.basename(summ["trace_path"]),
                    "bytes": os.path.getsize(summ["trace_path"]),
                    "device_us_total": summ["device_us_total"], "top_ops_us": summ["top_ops_us"],
                    "n_device_ops": summ["n_device_ops"], "scopes": scopes, "rank": rank,
                    "symmetric_launches": {"trace": n_sym, "window_chunks": want_sym},
                    "symmetric_share": sym_us / summ["device_us_total"],
                    "potrf_launches": n_potrf,
                    "window_device_span_s": span_s, "window_device_busy_s": busy_s,
                    "window_cuda_event_s": window_s,
                    "span_vs_events": span_s / window_s - 1.0,
                    "device_idle_share": 1.0 - busy_s / span_s if span_s else None}
    out["profiler_overhead"] = {
        "chunks": PROFILE_WINDOW, "profiled_s": window_s,
        "unprofiled_s": sum(secs["unprofiled"][a:b]),
        "frac": window_s / sum(secs["unprofiled"][a:b]) - 1.0}
    # the profiler may drop a device event at its window's edge (4 of the
    # 5 in one run), never add one: the trace holds at least one and at
    # most the launches the counted wrappers made in the window
    check(0 < n_sym <= want_sym,
          f"profile config5: {n_sym} symmetric kernels in the trace, the window's chunks "
          f"launched {want_sym}")
    check(n_potrf > 0, f"profile config5: no potrf among the device ops {totals[:40]}")
    check(len(scopes) == b - a, f"profile config5: chunk scopes {[s['scope'] for s in scopes]}")
    check(abs(span_s / window_s - 1.0) <= PROFILE_AGREE,
          f"profile config5: trace {span_s} s vs CUDA events {window_s} s")
    out["launches"] = out["profiled"]["launches"]
    out["launches_by_kernel"] = expected_by_kernel(out["launches"])
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 5b: serve_config5
# ----------------------------------------------------------------------
# the bucket ladder the config5 artifact is served with, the twin's
# serve rung (bench.py:1113-1160: 64 requests of 32 rows, 8 clients),
# the engine's in-flight bound under the 8 clients, and the map request
# (a 256 x 256 raster: 16 dispatches at the 4096 bucket)
SERVE_BUCKETS = (8, 32, 128, 1024, 4096)
SERVE_ROWS, SERVE_REQUESTS, SERVE_CLIENTS, SERVE_IN_FLIGHT = 32, 64, 8, 4
MAP_SIDE = 256
# the card engine against the port's predict_at on the CPU, same
# artifact and noise: both compose in float64 and round p to float32,
# so they part only where the two BLAS round a float64 sum differently
# and the float32 rounding of a p <= 1 lands on the other side (an ulp,
# 6e-8)
SERVE_ATOL = 1e-6


def serve_queries(rng, n):
    """``n`` query sites uniform over the field's domain (binary_field's
    unit square) with designs [1, N(0, 1)], float32."""
    import numpy as np

    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    x = np.concatenate([np.ones((n, 1, 1)), rng.normal(size=(n, 1, 1))], -1)
    return coords, x.astype(np.float32)


def cpu_noise(seed, shape, dtype, device):
    """Composition noise drawn on the CPU from ``seed`` and moved to
    ``device``: the card engine and the CPU predict_at consume the same
    numbers."""
    import torch

    gen = torch.Generator().manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=dtype).to(device)


def sync_debug_request(eng, cq, xq, seed):
    """One request under torch.cuda.set_sync_debug_mode("warn"): every
    synchronising call, by the engine step whose worker made it
    ("dispatch", "guard", or "other" for anything outside both) and the
    innermost smk_torch line on its stack; first ("none") the mode
    switched on and off around no work, what the switch alone reports."""
    found = {}
    for kind in ("none", "request"):
        found[kind] = _sync_sites(eng, cq, xq, seed, kind == "request")
    return found


def _sync_sites(eng, cq, xq, seed, run):
    """The synchronising calls of one request (``run``) or of none."""
    import collections
    import os
    import traceback
    import warnings

    import torch

    sites = {k: collections.Counter() for k in ("dispatch", "guard", "other")}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        names = {f.name for f in stack}
        step = ("guard" if "guard_worker" in names
                else "dispatch" if "dispatch_worker" in names else "other")
        ours = [f for f in stack if "smk_torch" in f.filename]
        where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno}"
                 if ours else "outside smk_torch")
        sites[step][f"{os.path.basename(filename)}:{lineno} from {where}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if run:
                eng.predict(cq, xq, seed=seed)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return {k: dict(v) for k, v in sites.items()}


def host_and_device_ms(fn, reps=20):
    """(host ms, device ms) of one call, medians: the host clock around
    the call from an idle card (what queuing it costs the host), and CUDA
    events around it queued behind a ~20 ms device sleep, longer than the
    call takes to queue, so the events see the device's time alone."""
    import torch

    for _ in range(3):
        fn()
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(40 * SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    return statistics.median(host), statistics.median(dev)


def _latency_summary(lat_s, wall_s):
    import numpy as np

    ms = np.asarray(lat_s) * 1e3
    return {"n": len(lat_s), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max()),
            "wall_s": wall_s, "qps": len(lat_s) / wall_s}


def serve_config5(device, artifact_path, tmp):
    """The query path and the engine (smk_torch/serve) on fit_config5's
    artifact (K = 32, m = 3906, t = 64 anchors, q = 1, p = 2, S = 1000
    draws), saved by run_fit and loaded here, served with buckets
    (8, 32, 128, 1024, 4096):

    - a cold engine (warm=False) and a warm one, each answering the same
      first request (cold and warm first-request latency, the same
      response bit for bit);
    - 64 requests of 32 rows uniform over the domain, serially, then from
      8 clients into a second engine with max_in_flight = 4, twice (the
      first round also starts its worker threads), and into a third with
      max_in_flight = 1 (p50/p99 latency and QPS; (b) every concurrent
      response bitwise the serial one, and the same seed twice bitwise);
    - one map request of 65,536 rows (a 256 x 256 raster, 16 dispatches
      at the 4096 bucket): rows per second;
    - a 2-replica ReplicaFleet on the artifact taking 8 requests.

    Checks: (a) the card engine against predict_at on the CPU on the same
    artifact and noise (SERVE_ATOL); (c) rows shared by two batches of one
    bucket bitwise equal; (d) inject_predict_nan(rows=[1]) masks exactly
    that row and leaves the others bitwise clean; (e) stall_predict at a
    0.5 s deadline raises RequestTimeoutError within the deadline and the
    next request is served; (f) a queue flood (max_queue = 2, the
    in-flight slot stalled) sheds typed at once and the admitted requests
    complete; (g) health() counts what was sent; (h) under the sync debug
    mode, one warm request synchronises only in the guard's fetch. Also
    the response with TF32 switched on bitwise the response without it
    (the composition is float64), 0 fused-build launches, the host and
    device ms of one predict program per bucket (host_and_device_ms),
    the (q, t, u) cross build's share of the device time at 4096, and the
    engine's peak memory."""
    import collections
    import threading
    import types

    import numpy as np
    import torch
    from smk_torch.api import predict_at
    from smk_torch.config import SMKConfig
    from smk_torch.ops import fused_build as fb
    from smk_torch.ops.distance import cross_distance
    from smk_torch.ops.factor_cache import FactorCache
    from smk_torch.ops.kernels import correlation
    from smk_torch.serve import (
        PredictionEngine,
        QueueFullError,
        ReplicaFleet,
        RequestTimeoutError,
        load_artifact,
    )
    from smk_torch.testing.faults import inject_predict_nan, stall_predict

    fb.reset_counts()
    art = load_artifact(artifact_path)
    s_draws, t, q = art.n_draws, art.n_anchor, art.q
    check((s_draws, t, q, art.p) == (1000, MAIN_T, 1, 2),
          f"serve: artifact geometry {(s_draws, t, q, art.p)}")
    rng = np.random.default_rng(SEED + 5)
    reqs = [serve_queries(rng, SERVE_ROWS) for _ in range(SERVE_REQUESTS)]
    out = {"phase": "serve_config5", "artifact_bytes": int(sum(
        np.asarray(a).nbytes for a in art if isinstance(a, np.ndarray))),
        "n_draws": s_draws, "t": t, "q": q, "buckets": list(SERVE_BUCKETS)}
    sent = collections.Counter()

    # cold and warm first request (the same request and seed)
    start = time.perf_counter()
    cold = PredictionEngine(artifact_path, buckets=SERVE_BUCKETS, warm=False)
    out["cold_construct_s"] = time.perf_counter() - start
    start = time.perf_counter()
    r_cold = cold.predict(*reqs[0], seed=0)
    out["cold_first_request_ms"] = (time.perf_counter() - start) * 1e3
    cold.close()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = time.perf_counter()
    eng = PredictionEngine(artifact_path, buckets=SERVE_BUCKETS)
    out["warm_construct_s"] = time.perf_counter() - start
    start = time.perf_counter()
    r_warm = eng.predict(*reqs[0], seed=0)
    out["warm_first_request_ms"] = (time.perf_counter() - start) * 1e3
    sent["served"] += 1
    sent["dispatches"] += 1
    check(np.array_equal(r_cold.p_quant, r_warm.p_quant), "serve: cold and warm engines differ")

    # (h) synchronising calls of one warm request
    found = sync_debug_request(eng, *reqs[1], seed=1)
    sent["served"] += 1
    sent["dispatches"] += 1
    out["sync_debug_request"] = found
    syncs = found["request"]
    # the first switch of the mode reports one call of its own (torch's,
    # outside the port): the request may show no site the bare switch
    # did not
    switch = found["none"]["other"]
    check(not syncs["dispatch"]
          and all(n <= switch.get(site, 0) for site, n in syncs["other"].items()),
          f"serve: a synchronising call outside the guard's fetch: {found}")
    check(sum(syncs["guard"].values()) > 0, "serve: the guard's fetch did not synchronise")

    # serial traffic, then the same seed again
    serial, lat = [], []
    start = time.perf_counter()
    for i, (cq, xq) in enumerate(reqs):
        t0 = time.perf_counter()
        serial.append(eng.predict(cq, xq, seed=i))
        lat.append(time.perf_counter() - t0)
    out["serial"] = _latency_summary(lat, time.perf_counter() - start)
    sent["served"] += SERVE_REQUESTS
    sent["dispatches"] += SERVE_REQUESTS
    for r in serial:
        check(r.buckets == (32,) and r.p_quant.shape == (3, SERVE_ROWS, 1),
              f"serve: response shape {r.p_quant.shape} buckets {r.buckets}")
        check(bool(np.isfinite(r.p_quant).all()) and not r.degraded, "serve: a bad row")
        check(bool(((r.p_quant >= 0) & (r.p_quant <= 1)).all()), "serve: p outside [0, 1]")
    again = eng.predict(*reqs[0], seed=0)
    sent["served"] += 1
    sent["dispatches"] += 1
    check(np.array_equal(again.p_quant, serial[0].p_quant), "serve: (b) the same seed differs")
    check(np.array_equal(serial[0].p_quant, r_warm.p_quant), "serve: (b) the first request differs")
    other_seed = eng.predict(*reqs[0], seed=1)
    sent["served"] += 1
    sent["dispatches"] += 1
    check(not np.array_equal(other_seed.p_quant, serial[0].p_quant), "serve: seed ignored")

    # TF32 on for one request: the composition is float64, so nothing moves
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = eng.predict(*reqs[0], seed=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    sent["served"] += 1
    sent["dispatches"] += 1
    check(np.array_equal(tf32.p_quant, serial[0].p_quant), "serve: TF32 moved a response")

    # (b) 8 clients into max_in_flight = 4, against the serial responses
    eng8 = PredictionEngine(artifact_path, buckets=SERVE_BUCKETS, max_queue=64,
                            max_in_flight=SERVE_IN_FLIGHT)
    eng1 = PredictionEngine(artifact_path, buckets=SERVE_BUCKETS, max_queue=64)
    conc, lat8, errs = {}, [], []
    lock = threading.Lock()

    def client(target, c):
        try:
            for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                t0 = time.perf_counter()
                r = target.predict(*reqs[i], seed=i)
                with lock:
                    lat8.append(time.perf_counter() - t0)
                    conc[i] = r
        except Exception as e:  # recorded and failed below
            errs.append(repr(e))

    # two rounds at 4 in flight (the first also starts the engine's worker
    # threads and their library handles; the second is the steady state),
    # then one at 1 in flight: what the in-flight bound itself does
    for rnd, target in (("concurrent_first_round", eng8), ("concurrent", eng8),
                        ("concurrent_in_flight_1", eng1)):
        conc.clear()
        lat8.clear()
        threads = [threading.Thread(target=client, args=(target, c))
                   for c in range(SERVE_CLIENTS)]
        start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        out[rnd] = dict(_latency_summary(lat8, time.perf_counter() - start),
                        clients=SERVE_CLIENTS, max_in_flight=target.max_in_flight)
        check(not any(th.is_alive() for th in threads), "serve: a client hung")
        check(not errs and len(conc) == SERVE_REQUESTS, f"serve: concurrent errors {errs[:3]}")
        check(all(np.array_equal(conc[i].p_quant, serial[i].p_quant) for i in conc),
              "serve: (b) a concurrent response differs from the serial one")
    h8, h1 = eng8.health(), eng1.health()
    check(h8["requests_served"] == 2 * SERVE_REQUESTS
          and h8["dispatches"] == 2 * SERVE_REQUESTS
          and h1["requests_served"] == SERVE_REQUESTS, f"serve: 8-way health {h8} {h1}")
    eng8.close()
    eng1.close()

    # the map request: a 256 x 256 raster of the domain
    g = (np.arange(MAP_SIDE, dtype=np.float32) + 0.5) / MAP_SIDE
    map_c = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    map_x = serve_queries(rng, map_c.shape[0])[1]
    torch.cuda.synchronize()
    start = time.perf_counter()
    r_map = eng.predict(map_c, map_x, seed=7, deadline_s=120.0)
    map_s = time.perf_counter() - start
    n_map = map_c.shape[0]
    sent["served"] += 1
    sent["dispatches"] += n_map // SERVE_BUCKETS[-1]
    check(r_map.buckets == (SERVE_BUCKETS[-1],) * (n_map // SERVE_BUCKETS[-1]),
          f"serve: map buckets {r_map.buckets}")
    check(r_map.p_quant.shape == (3, n_map, 1) and bool(np.isfinite(r_map.p_quant).all())
          and not r_map.degraded, "serve: map response")
    out["map_request"] = {"rows": n_map, "wall_s": map_s, "rows_per_s": n_map / map_s,
                          "dispatches": len(r_map.buckets),
                          "p_median_mean": float(r_map.p_quant[0].mean())}
    out["engine_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    out["engine_resident_bytes"] = torch.cuda.memory_allocated() - base

    # (c) pad-row identity: 20 rows each, the first 12 shared, bucket 32
    ca, xa = serve_queries(rng, 20)
    cb, xb = serve_queries(rng, 20)
    cb[:12], xb[:12] = ca[:12], xa[:12]
    ra, rb = eng.predict(ca, xa, seed=9), eng.predict(cb, xb, seed=9)
    sent["served"] += 2
    sent["dispatches"] += 2
    check(ra.buckets == rb.buckets == (32,), "serve: pad batches not in bucket 32")
    check(np.array_equal(ra.p_quant[:, :12], rb.p_quant[:, :12]),
          "serve: (c) a shared row differs across batches")
    check(not np.array_equal(ra.p_quant[:, 12:], rb.p_quant[:, 12:]), "serve: tails equal")

    # (d) a NaN row: exactly it masked, the others bitwise clean
    clean = eng.predict(*reqs[2], seed=3)
    with inject_predict_nan(rows=[1], max_fires=1) as inj:
        hurt = eng.predict(*reqs[2], seed=3)
    sent["served"] += 2
    sent["dispatches"] += 2
    sent["requests_degraded"] += 1
    sent["rows_degraded"] += 1
    want_mask = np.zeros(SERVE_ROWS, bool)
    want_mask[1] = True
    check(inj.fires == 1 and np.array_equal(hurt.rows_degraded, want_mask),
          f"serve: (d) rows_degraded {np.flatnonzero(hurt.rows_degraded)}")
    check(np.array_equal(hurt.p_quant[:, ~want_mask], clean.p_quant[:, ~want_mask]),
          "serve: (d) a healthy row moved")

    # (e) a stalled dispatch at a 0.5 s deadline
    with stall_predict(max_fires=1, max_stall_s=30.0) as inj:
        start = time.perf_counter()
        try:
            eng.predict(*reqs[3], seed=3, deadline_s=0.5)
            timed_out = None
        except RequestTimeoutError as e:
            timed_out = e
        stall_wall = time.perf_counter() - start
    sent["timed_out"] += 1
    sent["dispatches"] += 1
    check(timed_out is not None and timed_out.phase == "dispatch" and inj.fires == 1,
          f"serve: (e) no typed timeout ({timed_out!r})")
    check(stall_wall < 0.5 + 0.1, f"serve: (e) the timeout took {stall_wall:.3f} s")
    after = eng.predict(*reqs[3], seed=3)
    sent["served"] += 1
    sent["dispatches"] += 1
    check(np.array_equal(after.p_quant, serial[3].p_quant), "serve: (e) the next request")
    out["stall"] = {"deadline_s": 0.5, "timeout_after_s": stall_wall, "label": timed_out.label}

    # (g) the engine's counters
    h = eng.health()
    got = {"served": h["requests_served"], "timed_out": h["requests_timed_out"],
           "dispatches": h["dispatches"], "requests_degraded": h["requests_degraded"],
           "rows_degraded": h["rows_degraded"]}
    want = {k: sent[k] for k in got}
    check(got == want and h["requests_shed"] == 0 and h["state"] == "ready",
          f"serve: (g) health {got} != sent {want}")
    out["health"] = h

    # host and device time of one predict program per bucket, and of the
    # (q, t, u) cross build at 4096 (the composition's, in float64)
    a_const = eng._gen.const
    host_ms, dev_ms = {}, {}
    for u in SERVE_BUCKETS:
        pred, _ = eng._programs(u)
        cq = torch.as_tensor(np.resize(map_c, (u, 2)), device=device)
        xq = torch.as_tensor(np.resize(map_x, (u, 1, 2)), device=device)
        host_ms[u], dev_ms[u] = host_and_device_ms(lambda: pred(*a_const, cq, xq, 11))
        if u == SERVE_BUCKETS[-1]:
            ct64, cq64 = a_const[4].double(), cq.double()
            phi64 = a_const[3].double()
            cross_host, cross_ms = host_and_device_ms(lambda: correlation(
                cross_distance(ct64, cq64)[None], phi64[:, None, None], art.cov_model))
    out["predict_host_ms_by_bucket"] = {str(u): v for u, v in host_ms.items()}
    out["predict_device_ms_by_bucket"] = {str(u): v for u, v in dev_ms.items()}
    out["cross_build_device_ms_4096"] = cross_ms
    out["cross_build_share_4096"] = cross_ms / dev_ms[SERVE_BUCKETS[-1]]
    eng.close()

    # (a) the card engine against predict_at on the CPU, same noise
    eng_a = PredictionEngine(artifact_path, buckets=(SERVE_ROWS,), include_samples=True,
                             noise=cpu_noise, warm=False)
    r_a = eng_a.predict(*reqs[4], seed=5)
    eng_a.close()
    cfg = SMKConfig(cov_model=art.cov_model, link=art.link, jitter=art.jitter,
                    jitter_per_m=art.jitter_per_m)
    fit_cpu = types.SimpleNamespace(sample_par=torch.as_tensor(art.sample_par),
                                    sample_w=torch.as_tensor(art.sample_w),
                                    param_grid=torch.as_tensor(art.param_grid))
    cache = FactorCache(None, None, None, krige_chol=torch.as_tensor(art.chol_tt))
    want_a, _ = predict_at(fit_cpu, art.coords_test, *reqs[4], config=cfg, cache=cache,
                           eps=cpu_noise(5, (s_draws, SERVE_ROWS, q), torch.float32, "cpu"))
    err_s = float(np.abs(r_a.p_samples - want_a.p_samples.numpy()).max())
    err_q = float(np.abs(r_a.p_quant - want_a.p_quant.numpy()).max())
    out["card_vs_cpu_max_abs_err"] = {"p_samples": err_s, "p_quant": err_q,
                                      "atol": SERVE_ATOL}
    check(err_s <= SERVE_ATOL and err_q <= SERVE_ATOL,
          f"serve: (a) card vs CPU {err_s:.3g} / {err_q:.3g} > {SERVE_ATOL}")

    # (f) a queue flood: the in-flight slot stalled, a waiting room of 2
    eng_f = PredictionEngine(artifact_path, buckets=(SERVE_ROWS,), max_queue=2,
                             max_in_flight=1)
    results, errors = {}, {}

    def call(name):
        try:
            results[name] = eng_f.predict(*reqs[5], seed=5, deadline_s=60.0)
        except Exception as e:  # recorded and checked below
            errors[name] = e

    with stall_predict(max_fires=1, max_stall_s=30.0) as inj:
        first = threading.Thread(target=call, args=("a",))
        first.start()
        for _ in range(500):
            if inj.fires:
                break
            time.sleep(0.01)
        waiting = [threading.Thread(target=call, args=(n,)) for n in ("b", "c")]
        for th in waiting:
            th.start()
        for _ in range(500):
            if eng_f._queue_sem._value == 0:
                break
            time.sleep(0.01)
        start = time.perf_counter()
        call("d")
        shed_s = time.perf_counter() - start
    for th in [first] + waiting:
        th.join(timeout=60.0)
    check(not first.is_alive() and not any(th.is_alive() for th in waiting),
          "serve: (f) a flooded request hung")
    check(isinstance(errors.get("d"), QueueFullError) and shed_s < 0.05,
          f"serve: (f) the flood did not shed typed at once ({errors}, {shed_s:.4f} s)")
    check(set(results) == {"a", "b", "c"}, f"serve: (f) admitted requests {sorted(results)}")
    hf = eng_f.health()
    check(hf["requests_shed"] == 1 and hf["requests_served"] == 3, f"serve: (f) health {hf}")
    out["flood"] = {"max_queue": 2, "shed_s": shed_s, "served": 3, "shed": 1}
    eng_f.close()

    # the fleet: two replicas on the card, 8 requests
    fleet = ReplicaFleet(artifact_path, n_replicas=2, buckets=SERVE_BUCKETS)
    try:
        start = time.perf_counter()
        for i in range(8):
            r = fleet.predict(*reqs[i], seed=i)
            check(np.array_equal(r.p_quant, serial[i].p_quant), "serve: fleet response differs")
        fleet_s = time.perf_counter() - start
        hfl = fleet.health()
        check(hfl["requests_routed"] == 8 and hfl["totals"]["requests_served"] == 8
              and [rep["requests_served"] for rep in hfl["replicas"]] == [4, 4],
              f"serve: fleet health {hfl}")
        out["fleet"] = {"n_replicas": 2, "requests": 8, "wall_s": fleet_s}
    finally:
        fleet.close()

    launches = dict(fb.LAUNCHES)
    check(sum(launches.values()) == 0 and sum(fb.PLAIN_CALLS.values()) == 0,
          f"serve: a fused build ran on the serving path: {launches}")
    out["launches"] = launches
    emit(out)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke run needs one card",
              file=sys.stderr)
        return 1
    try:
        from smk_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port (smk_torch) is not importable here: {e}",
              file=sys.stderr)
        return 1

    script_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    check(tuple(cap) == (9, 0), f"compute capability {cap}, expected (9, 0)")

    start = time.perf_counter()
    report = cuda_build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - start,
          "libraries": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"][-2000:]}
                        for k, v in report.items()}})

    walls = {}

    def phase(name, fn, *args, **kwargs):
        """Run one phase, record its wall time, free the cached blocks."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        walls[name] = time.perf_counter() - start
        torch.cuda.empty_cache()
        return out

    timings = phase("kernels", kernels_phase, device)
    phase("fit_small_parity", fit_small_parity, device)
    serve_dir = tempfile.mkdtemp(prefix="smk_chip_serve_")
    try:
        c5 = phase("fit_config5", run_fit, "fit_config5", n=MAIN_K * MAIN_M, k=MAIN_K, q=1,
                   p=2, t=MAIN_T, n_samples=40, device=device,
                   artifact_path=f"{serve_dir}/config5.npz")
        phase("serve_config5", serve_config5, device, c5["artifact"]["path"], serve_dir)
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    q2 = phase("fit_q2", run_fit, "fit_q2", n=8 * MAIN_M, k=8, q=2, p=2, t=MAIN_T,
               n_samples=20, device=device)
    phase("kernels_config4", kernels_config4, device)
    phase("production_ops", production_ops, device)
    phase("fit_production_small_parity", fit_production_small_parity, device)
    c5_data = binary_field(MAIN_K * MAIN_M, 1, 2, MAIN_T, SEED + MAIN_K * MAIN_M)
    c4_data = ebird_data(C4_K * C4_M, C4_T)
    p5 = phase(
        "fit_production_config5", fit_production, "fit_production_config5",
        cfg=production_config(k=MAIN_K, n_samples=64, phi_every=16),
        data_np=c5_data, device=device)
    p4 = phase(
        "fit_production_config4", fit_production, "fit_production_config4",
        cfg=production_config(k=C4_K, n_samples=64, link="logit", phi_every=8),
        data_np=c4_data, device=device)
    f64 = phase("kernels_float64", kernels_float64, device)
    phase("fit_variants_small_parity", fit_variants_small_parity, device)
    phase("chol_blocked", chol_blocked, device, c5_data)
    # multiple-try at config5: per component, the (J+1)- and (J-1)-deep
    # stacks and the accept side, 2J+1 factorizations in 3 calls
    j_try = 4
    p5m = phase(
        "fit_production_config5_mtm", fit_production, "fit_production_config5_mtm",
        cfg=production_config(k=MAIN_K, n_samples=32, phi_every=16, phi_proposals=j_try,
                              phi_proposal_family="student_t"),
        data_np=c5_data, device=device, update_chol=(2 * j_try + 1, 3))
    p4c = phase(
        "fit_production_config4_chains", fit_production, "fit_production_config4_chains",
        cfg=production_config(k=C4_K, n_samples=64, link="logit", phi_every=8, n_chains=2),
        data_np=c4_data, device=device)
    check(p4c["launches"] == p4["launches"],
          "two chains: launches differ from the one-chain run's")
    c5f64 = phase("fit_config5_float64", run_fit, "fit_config5_float64", n=MAIN_K * MAIN_M,
                  k=MAIN_K, q=1, p=2, t=MAIN_T, n_samples=16, device=device, dtype="float64",
                  profile=True)
    phase("vecchia_ops", vecchia_ops, device, c5_data)
    phase("fit_vecchia_small_parity", fit_vecchia_small_parity, device)
    v5 = phase("fit_vecchia_config5", fit_vecchia, "fit_vecchia_config5",
               cfg=vecchia_config(k=MAIN_K, n_samples=64), data_np=c5_data, device=device,
               direct=True)
    vm = phase("fit_vecchia_m_large", fit_vecchia, "fit_vecchia_m_large",
               cfg=vecchia_config(k=MAIN_K // 2, n_samples=32), data_np=c5_data, device=device)
    tmp = tempfile.mkdtemp(prefix="smk_chip_smoke_")
    try:
        emit({"phase": "checkpoint_dir", "path": tmp, "free_disk_bytes": free_disk_bytes(tmp)})
        chs = phase("fit_chunked_small_parity", fit_chunked_small_parity, device, tmp)
        cc5 = phase("fit_chunked_config5", fit_chunked_config5, device, c5_data, tmp,
                    p5["ms_per_sweep"])
        coh4 = phase("fit_coherent_config4", fit_coherent_config4, device, c4_data,
                     p4["ms_per_sweep"])
        ov5 = phase("fit_overlap_config5", fit_overlap_config5, device, c5_data, tmp)
        ovs = phase("fit_overlap_small_faults", fit_overlap_small_faults, device, tmp)
        ad5 = phase("fit_adaptive_config5", fit_adaptive_config5, device, c5_data, tmp)
        ads = phase("fit_adaptive_small", fit_adaptive_small, device, tmp)
        pr5 = phase("fit_profile_config5", fit_profile_config5, device, c5_data, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "wall_s_by_phase", **walls, "total_s": time.perf_counter() - script_start})
    paths = {"fit_config5": c5, "fit_q2": q2, "fit_production_config5": p5,
             "fit_production_config4": p4, "fit_production_config5_mtm": p5m,
             "fit_production_config4_chains": p4c, "fit_config5_float64": c5f64,
             "fit_vecchia_config5": v5, "fit_vecchia_m_large": vm,
             "fit_chunked_small": chs, "fit_chunked_config5": cc5, "fit_coherent_config4": coh4,
             "fit_overlap_config5": ov5, "fit_overlap_small_faults": ovs,
             "fit_adaptive_config5": ad5, "fit_adaptive_small": ads,
             "fit_profile_config5": pr5}

    f64_time = f64["main_path"]
    f64_kernels = (("symmetric kernel, float64", "symmetric_f64", "fused_masked_correlation_stack"),
                   ("narrow kernel, float64", "narrow_f64", "fused_cross_correlation"))
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": c5["launches"][name],
         "launches_by_path": {path: r["launches"][name] for path, r in paths.items()},
         "max_abs_err": timings[name]["max_abs_err"], "ms": timings[name]["ms"],
         "device_ms": timings[name]["device_ms"], "plain_ms": timings[name]["plain_ms"], "bound_ms": timings[name]["bound_ms"],
         "bound_by": timings[name]["bound_by"],
         "library_ms": timings[name]["library_ms"],
         "achieved_GBps": timings[name]["achieved_GBps"],
         "bound_fraction": timings[name]["bound_fraction"],
         "device_bound_fraction": timings[name]["device_bound_fraction"]}
        for name in KERNELS
    ] + [
        # the double kernels: every float64 build (the float64 fit's
        # path; no float32 path launches them), timed at the main
        # path's masked build and cross build beside the double tile
        # kernel they replace
        {"name": label, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "smk_tpu/ops/pallas_build.py:179",
         "launches": c5f64["launches_by_kernel"][key],
         "launches_by_path": {"fit_float64_small": f64["fit_small"]["launches_by_kernel"][key],
                              **{path: r["launches_by_kernel"][key]
                                 for path, r in paths.items()}},
         "timed_at": build, "max_abs_err": f64_time[build]["max_abs_err"],
         "ms": f64_time[build]["ms"], "device_ms": f64_time[build]["device_ms"],
         "plain_ms": f64_time[build]["plain_ms"], "bound_ms": f64_time[build]["bound_ms"],
         "bound_by": f64_time[build]["bound_by"], "library_ms": f64_time[build]["library_ms"],
         "fp64_bound_ms": f64_time[build]["fp64_bound_ms"],
         "tile_kernel_device_ms": f64_time[build]["tile_kernel_device_ms"],
         "device_bound_fraction": f64_time[build]["device_bound_fraction"]}
        for label, key, build in f64_kernels
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
