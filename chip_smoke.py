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
5c. serve_coalesced_config5 — the same artifact behind a 2 ms
              coalescing window (coalesce_window_ms = 2, 4 in flight): the
              same 64 requests from 8 clients, twice, then one at a time
              (p50/p99, QPS, dispatches against requests, held seconds,
              serve_block of the run log, beside serve_config5's figures);
              every coalesced response bitwise the request served alone,
              fewer dispatches than requests, a deadline-critical request
              not held, a NaN row degrading its own request alone; host and
              device ms of one row-seed predict at 32 and 4096 rows and of
              its row noise at 4096; 0 fused-build launches.
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
24b. ingest_config4 — the live loop (serve/ingest.LiveFit) on the same
              data and config: fit (generation 0) served by an engine and
              a 2-replica fleet; 256 rows ingested into subset 0, the
              dirty refit (generation 1; ingest_to_visible_s), the 63
              other subsets bitwise, subset 0's rung before and after; a
              hot swap of both under 4 clients (no request dropped, each
              response bitwise one generation's, 0 programs built; p50/p99
              beside the steady round's); a full and a warm dirty refit
              (refit_speedup); launches of every refit group against
              build_calls(chunk_iters=16), no plain build; a torn publish;
              generation 1 on the card against predict_at on the CPU; the
              kernels at the refit group's shape; peak memory.

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

Program reuse (ROADMAP A10): from here on every chunk program of the
chunked executor (phases 22-29) and every serving program (5b, 5c, 24b)
is a CUDA graph captured once per bucket key and replayed
(smk_torch/compile/programs.py).

30. programs_config5 — the executor's chunk runner, captured bucket
              programs replayed, against the sampler's eager burn_chunk /
              sample_chunk on two identical setups, at config5 with the
              production sampler and at config4 with the logit link (64
              sweeps in chunks of 16 and one chunk more, so every bucket
              replays): state, draws, noise snapshots and guard counts
              bitwise after every chunk; launches equal to build_calls,
              counted through the replays; per bucket its key, source,
              capture seconds and pool bytes; ms/sweep of both; one update
              and one non-update sweep as one-sweep programs against
              eager (wall ms from an idle card, device ms behind a long
              device sleep, the idle share). Then a fresh process
              (`python3 chip_smoke.py --programs-child STORE`, an empty
              build directory) on the warm compile_store_dir: 0 nvcc runs,
              program sources "l2"; the stored library's fingerprint
              tampered: a warned miss, one nvcc run, "fresh", the store
              refilled.

The device mesh and the process group (ROADMAP A9a; the card is one
H100, so every mesh here has one entry):

31. mesh_config5 — config5 with the production sampler, 32 sweeps: the
              unmeshed fit and fit_meta_kriging(n_devices=1), both with a
              run log: every result field bitwise, the meshed fit's
              launches per entry point == build_calls, its gather span's
              seconds, ms/sweep of both; then the chunked fit (chunks of
              16, quarantine) on the mesh bitwise the unmeshed one, its
              chunk programs new captures keyed under the printed
              topology fingerprint, launches == build_calls(chunk_iters=16).
32. mesh_coherent_config4 — config4 coherent (32 sweeps in chunks of 16)
              on the host path and on a 1-entry mesh: the plan the
              identity, every field bitwise, launches per group ==
              build_calls.
33. dist_world_of_one — a real NCCL process group of one on
              tcp://127.0.0.1 (a free port) through
              flaky_coordinator(2, passthrough=True): 3 init calls;
              barrier_sync and allgather_bytes; a small fit over the
              group's mesh bitwise its unmeshed fit; gather_grids through
              an NCCL all-gather, bitwise; the group destroyed.
33b. dist_ckpt_config5 — the distributed checkpoint (format 8, through
              FORCE_DISTRIBUTED_FOR_TESTING) at config5 with the
              production sampler under quarantine, 64 sweeps in chunks of
              16, inside a real NCCL process group of one (its commit
              barriers on the group's store): (a) bitwise format 7 and
              the uncheckpointed chunked fit in every field, 4
              generations, per boundary the commit seconds, shard bytes
              and host wall beside format 7's, launches == build_calls;
              (b) a kill between shard-land and manifest-publish of
              generation 2 rolled back and resumed bitwise; (c) a torn
              segment refilled leniently, a torn state shard a typed
              error naming shard:0; (d) a checkpoint re-split as two
              processes' shards resumed elastically in one, bitwise.
33c. data_csv_config4 — the eBird proxy at config4's 65,600 rows written
              and loaded through the CSV edge (seconds, rows/s), fitted
              with the config4 production sampler for 16 sweeps
              (launches == build_calls); count_subset_factorizations at
              K = 4 on the card: n_chol the FactorCache's count, and the
              CPU's.
33d. analysis_config5 — the analysis layer at config5 (production
              sampler, quarantine, overlap, nan_guard, 32 sweeps in chunks
              of 16, a checkpoint), three fits on one model: cold; warm
              under the logging sync debug mode (no synchronising call
              outside the sanitizers' ledger); warm under
              recompile_guard(0) and transfer_guard_strict() (0 nvcc runs,
              0 captures, the ledger's tags, counts, bytes, directions;
              every field bitwise the cold fit's; launches == build_calls);
              a fit at an unseen chunk length (8) raising RecompileError,
              and a lone .item() raising in the armed region; the port's
              smklint over smk_torch/, chip_smoke.py and scripts/torch_*.py
              (0 findings, seconds).
33e. adaptive_mesh_config5 — fit_adaptive_config5's adaptive run (c) on
              make_mesh(1): bitwise the unmeshed (c) in every held field,
              frozen_at equal, launches == its dispatched chunks', one
              adaptive_mesh_replan event (entries 1) per compaction of a
              live group; then fit_adaptive_small's K = 8, m = 200 case
              (where compactions happen) unmeshed and on make_mesh(1),
              the same checks.
33f. r_frontend_config4 — the eBird user driving the port from R
              (r/meta_kriging_torch.R, backend = "gpu"), its call sequence
              replayed in Python with the R file's conversions and
              keywords (no R runtime here): meta_kriging_binary at
              config4 (the production sampler through config.overrides,
              logit, 32 sweeps) bitwise a direct fit_meta_kriging of the
              same seed and config, launches == build_calls; then
              smk.live.fit, smk.ingest of 256 rows into subset 0,
              smk.refit (dirty: launches == one group's build_calls) and
              smk.predict.serve of 32 rows on the published generation
              (0 build launches); each call's wall.
33g. adaptive_dist_config5 — fit_adaptive_config5's adaptive run (c)
              over make_mesh() of a real NCCL process group of one:
              bitwise the unmeshed (c) in every held field, frozen_at,
              chunks_saved_frac and extra_granted equal, launches == its
              dispatched chunks', one decision gather over the group a
              sampling boundary (their count and median ms).
34. sharded_chol — one (3906, 3906) fp32 SPD matrix on the 1-entry
              mesh: sharded_cholesky against blocked_cholesky (block 512),
              the difference, both residuals and device times;
              sharded_matvec.
35. thread_launch — the symmetric and narrow kernels launched from a
              worker thread with its own current device and stream,
              bitwise the main thread's launches.
11b. noise_kernel (after fit_production_config4) — the sweep noise
              kernel (ops/sweep_noise.py, csrc/sweep_noise.cu) at
              config5's (32 probit rows, m = 3906) and config4's (128
              logit rows, m = 1024, 64 series terms) per-sweep shapes:
              every field and every generator's state bitwise the per-row
              path's over four sweeps (collecting and not); its device ms
              (behind a device sleep), its ms with the wrapper's host
              time, the per-row path's ms for the same sweep ("plain")
              and the bound (the fields' bytes once over 3.35 TB/s) on a
              collecting sweep; then a 16-sweep production fit at each
              cell's config: one launch a sweep, every row batched.

Then each phase's wall time and the script's, the kernel summary line
{"kernels": [...]} (launches from fit_config5, the double kernels' from
fit_config5_float64, the noise kernel's from noise_kernel's fits, and per path, the Vecchia paths' and the coalesced
serving path's all 0: serving builds its correlations with torch ops, as
the twin does outside Pallas), the card's nvidia-smi line, and last
{"ok": true, "device": {...}}. A failing phase
raises: the script exits non-zero and prints no ok line. It exits
non-zero at once where no CUDA card is visible, or where the port
cannot be imported (the script alone, outside a checkout).
"""

from __future__ import annotations

import gc
import json
import os
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
# the same for a whole sweep: ~0.1 s at the H100's clocks, longer than
# the host takes to queue one sweep's launches
LONG_SLEEP_CYCLES = 200_000_000


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


# ----------------------------------------------------------------------
# phase 24b: ingest_config4
# ----------------------------------------------------------------------
# the live loop's traffic: rows per ingest (the twin's bench rung copies
# subset 0's own coordinates, bench.py:1625-1634), distinct requests and
# the client threads racing the swap, and each client's requests in it
INGEST_ROWS, LIVE_REQUESTS, LIVE_CLIENTS, LIVE_RACE = 256, 16, 4, 24


def _launch_delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def ingest_config4(device, c4_data, tmp):
    """The live loop (smk_torch/serve/ingest.LiveFit) at config4's width
    on the eBird proxy: the production sampler, logit, phi every 8th, 64
    sweeps in chunks of 16, coherent (buckets 1024 x 34 and 1448 x 30).

    1. ``fit`` publishes generation 0; a PredictionEngine and a 2-replica
       ReplicaFleet (buckets SERVE_BUCKETS) serve it: serial answers of
       16 requests of 32 rows (the data's own sites and designs), then a
       steady round from 4 clients.
    2. 256 rows ingested: copies of subset 0's coordinates with fresh y
       and x from default_rng(SEED); the dirty-only refit publishes
       generation 1 (``ingest_to_visible_s``: the ingest call to the
       generation committed and loadable).
    3. ``swap_into`` the engine and the fleet while 4 clients send the
       16 requests; then generation 1's serial answers.
    4. A ``full=True`` refit and a dirty refit of subset 0 (the warm
       ``refit_speedup``); a generation landed and never committed.

    Checks: routed and dirty sets {0}; the served generation unchanged
    until the swap; the 63 untouched subsets' grids and draws bitwise
    after the refit, subset 0's not; launches of every refit group equal
    build_calls(chunk_iters=16), by kernel too, and no plain build; no
    request dropped in the race, each response bitwise one generation's
    serial answer; a same-config swap builds 0 programs; generation 1 on
    the card against predict_at on the CPU (SERVE_ATOL); after the torn
    publish the committed generation still loads and the landed one is an
    orphan; the append log empty after each commit; every output finite,
    p in [0, 1]. Then the symmetric and narrow kernels at the refit
    group's shape against their plain version (ragged_kernel_checks)."""
    import os
    import threading
    import types

    import numpy as np
    import torch
    from smk_torch.api import predict_at
    from smk_torch.compile.buckets import bucket_for
    from smk_torch.config import SMKConfig
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.ops.factor_cache import FactorCache
    from smk_torch.parallel.partition import padded_partition
    from smk_torch.serve import (
        LiveFit,
        PredictionEngine,
        ReplicaFleet,
        current_generation,
        generation_artifact_name,
        land_generation,
        load_artifact,
        load_current_generation,
        orphan_generations,
    )
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg = production_config(k=C4_K, n_samples=64, link="logit", phi_every=8,
                            partition_method="coherent")
    y, x, coords, ct, xt = c4_data
    want = build_calls(cfg, C4_Q, cfg.n_samples, cfg.n_burn_in, chunk_iters=16)
    gen_dir = os.path.join(tmp, "ingest_config4")
    pending = os.path.join(gen_dir, "pending")
    pstats = ChunkPipelineStats()
    live = LiveFit(gen_dir, config=cfg, coords_test=ct, x_test=xt, chunk_iters=16,
                   pipeline_stats=pstats, device=device)
    out = {"phase": "ingest_config4", "n": y.shape[0], "K": C4_K, "q": C4_Q, "p": C4_P,
           "t": C4_T, "ingest_rows": INGEST_ROWS, "buckets": list(SERVE_BUCKETS)}
    steps = {}

    def step(name, fn, groups):
        """Run one step of the loop; its launches against ``groups``
        refit groups of build_calls."""
        before = dict(fb.LAUNCHES)
        start = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        got = _launch_delta(dict(fb.LAUNCHES), before)
        expect = {e: groups() * v for e, v in want.items()}
        check(got == expect, f"ingest: {name} launches {got} != {groups()} x {want}")
        steps[name] = {"wall_s": wall, "groups": groups(), "launches": got}
        return res

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.reset_counts()
    manifest0 = step("fit", lambda: live.fit(SEED, y, x, coords),
                     lambda: len(pstats.ragged_groups))
    check(manifest0["generation"] == 0 and [g["bucket"] for g in pstats.ragged_groups]
          == C4_COHERENT[0], f"ingest: fit {manifest0} {pstats.ragged_groups}")
    rung0_before = bucket_for(len(live._assignments[0]), live._ladder())

    # generation 0 served by an engine and a 2-replica fleet
    art0, _ = live.load_current()
    eng = PredictionEngine(art0, buckets=SERVE_BUCKETS, max_queue=64, device=device)
    fleet = ReplicaFleet(art0, n_replicas=2, buckets=SERVE_BUCKETS, max_queue=64, device=device)
    rng = np.random.default_rng(SEED + 11)
    reqs = []
    for _ in range(LIVE_REQUESTS):
        rows = rng.choice(y.shape[0], SERVE_ROWS, replace=False)
        reqs.append((np.asarray(coords[rows], np.float32), np.asarray(x[rows], np.float32)))

    def serial_answers(target):
        lat, resp = [], []
        start = time.perf_counter()
        for i, (cq, xq) in enumerate(reqs):
            t0 = time.perf_counter()
            resp.append(target.predict(cq, xq, seed=i).p_quant)
            lat.append(time.perf_counter() - t0)
        return resp, _latency_summary(lat, time.perf_counter() - start)

    gen0, out["serial_gen0"] = serial_answers(eng)

    def race(during=None):
        """LIVE_CLIENTS clients, LIVE_RACE requests each, alternating the
        engine and the fleet; ``during`` runs on this thread once 8
        responses are in. Returns (records, errors, during's result and
        its window)."""
        recs, errs = [], []
        lock = threading.Lock()

        def client(c):
            try:
                for j in range(LIVE_RACE):
                    i = (c + LIVE_CLIENTS * j) % LIVE_REQUESTS
                    target = eng if j % 2 == 0 else fleet
                    t0 = time.perf_counter()
                    r = target.predict(*reqs[i], seed=i)
                    with lock:
                        recs.append((i, t0, time.perf_counter(), r.p_quant))
            except Exception as e:  # recorded and failed below
                errs.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(LIVE_CLIENTS)]
        start = time.perf_counter()
        for th in threads:
            th.start()
        got, window = None, None
        if during is not None:
            while len(recs) < 8 and not errs and time.perf_counter() - start < 60.0:
                time.sleep(0.001)
            t0 = time.perf_counter()
            got = during()
            window = (t0, time.perf_counter())
        for th in threads:
            th.join(timeout=300.0)
        check(not any(th.is_alive() for th in threads), "ingest: a client hung")
        wall = time.perf_counter() - start
        check(not errs and len(recs) == LIVE_CLIENTS * LIVE_RACE,
              f"ingest: dropped requests ({len(recs)} served, errors {errs[:3]})")
        return recs, wall, got, window

    recs, wall, _, _ = race()
    check(all(np.array_equal(p, gen0[i]) for i, _, _, p in recs),
          "ingest: a steady response differs from generation 0's")
    out["steady"] = _latency_summary([t1 - t0 for _, t0, t1, _ in recs], wall)

    # ingest 256 rows that route to subset 0 alone, then the dirty refit
    own = np.asarray(live._assignments[0][:INGEST_ROWS], np.int64)
    nrng = np.random.default_rng(SEED)
    y_new = nrng.integers(0, 2, size=(len(own), C4_Q)).astype(np.float64)
    x_new = nrng.normal(size=(len(own), C4_Q, C4_P))
    pre = type(live._subset_results)(*(a.copy() for a in live._subset_results))
    t_ingest = time.perf_counter()
    receipt = live.ingest(y_new, x_new, live._coords[own])
    check(set(receipt.routed_subsets) == {0} and receipt.dirty_subsets == (0,)
          and receipt.generation == 0, f"ingest: receipt {receipt}")
    rep = step("dirty_refit", lambda: live.refit(SEED + 1), lambda: 1)
    art1, manifest1 = load_current_generation(gen_dir)
    out["ingest_to_visible_s"] = time.perf_counter() - t_ingest
    check(manifest1["generation"] == 1 and rep.refit_subsets == (0,)
          and rep.reused_subsets == tuple(range(1, C4_K)), f"ingest: refit {rep}")
    check(os.listdir(pending) == [] and manifest1["ingest_watermark"] == 0,
          "ingest: the append log outlived its commit")
    post = live._subset_results
    for f, a, b in zip(post._fields, pre, post):
        check(np.array_equal(a[1:], b[1:]), f"ingest: an untouched subset's {f} moved")
    check(not np.array_equal(pre.w_samples[0], post.w_samples[0])
          and not np.array_equal(pre.param_grid[0], post.param_grid[0]),
          "ingest: subset 0 did not change")
    rung0_after = bucket_for(len(live._assignments[0]), live._ladder())
    # nothing swapped yet: both still serve generation 0
    check(eng.generation == 0 and [e.generation for e in fleet.engines] == [0, 0]
          and np.array_equal(eng.predict(*reqs[0], seed=0).p_quant, gen0[0])
          and np.array_equal(fleet.predict(*reqs[1], seed=1).p_quant, gen0[1]),
          "ingest: the served generation moved before the swap")

    # swap both while 4 clients send requests
    def fresh(e):
        return e.program_summary()["program_sources"].get("fresh", 0)

    targets = [eng] + list(fleet.engines)
    built = [fresh(e) for e in targets]

    def swap():
        t0 = time.perf_counter()
        s_eng = live.swap_into(eng)
        t1 = time.perf_counter()
        s_fleet = live.swap_into(fleet)
        return {"engine_s": t1 - t0, "fleet_s": time.perf_counter() - t1,
                "generation": (s_eng["generation"], s_fleet["generation"])}

    recs, wall, swap_out, window = race(swap)
    gen1, out["serial_gen1"] = serial_answers(eng)
    check(swap_out["generation"] == (1, 1) and eng.generation == 1
          and [e.generation for e in fleet.engines] == [1, 1], f"ingest: swap {swap_out}")
    which = [0 if np.array_equal(p, gen0[i]) else 1 if np.array_equal(p, gen1[i]) else -1
             for i, _, _, p in recs]
    check(-1 not in which, "ingest: a racing response is neither generation's answer")
    check(not any(np.array_equal(gen0[i], gen1[i]) for i in range(LIVE_REQUESTS)),
          "ingest: generation 1 answers like generation 0")
    swap_out["programs_built"] = [fresh(e) - b for e, b in zip(targets, built)]
    check(swap_out["programs_built"] == [0, 0, 0], f"ingest: the swap built {swap_out}")
    lat = [t1 - t0 for _, t0, t1, _ in recs]
    overlapping = [t1 - t0 for _, t0, t1, _ in recs if t1 >= window[0] and t0 <= window[1]]
    out["swap"] = swap_out
    out["during_swap"] = dict(_latency_summary(lat, wall), answered_gen0=which.count(0),
                              answered_gen1=which.count(1))
    out["overlapping_swap"] = _latency_summary(overlapping, window[1] - window[0])
    h = fleet.health()
    check(h["totals"]["generation_swaps"] == 2 and eng.health()["generation_swaps"] == 1,
          f"ingest: swap counters {h['totals']}")
    eng.close()
    fleet.close()

    # the warm walls: a full refit, then subset 0 alone again
    rep_full = step("full_refit", lambda: live.refit(SEED + 2, full=True),
                    lambda: len(pstats.ragged_groups))
    rep_dirty = step("dirty_refit_warm", lambda: live.refit(SEED + 3, subsets=[0]), lambda: 1)
    check(rep_full.generation == 2 and rep_dirty.generation == 3 and rep_dirty.refit_speedup,
          f"ingest: refits {rep_full} {rep_dirty}")
    launches = dict(fb.LAUNCHES)
    layouts = launches_by_kernel()
    n_groups = sum(st["groups"] for st in steps.values())
    check(launches == {e: n_groups * v for e, v in want.items()},
          f"ingest: path launches {launches}")
    check(layouts == expected_by_kernel(launches), f"ingest: by kernel {layouts}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "ingest: a plain build ran on the card")
    peak = torch.cuda.max_memory_allocated()

    # a torn publish: landed, never committed
    committed = current_generation(gen_dir)
    torn, _ = land_generation(gen_dir, live._last_combined, ct, config=cfg)
    art_now, m_now = load_current_generation(gen_dir)
    check(m_now == committed and orphan_generations(gen_dir) == (torn,) and torn == 4,
          f"ingest: torn publish {m_now} {orphan_generations(gen_dir)}")
    check(bool(np.isfinite(art_now.sample_w).all()), "ingest: the committed bundle")

    # generation 1 on the card against predict_at on the CPU, same noise
    art1 = load_artifact(os.path.join(gen_dir, generation_artifact_name(1)))
    eng_a = PredictionEngine(art1, buckets=(SERVE_ROWS,), include_samples=True,
                             noise=cpu_noise, warm=False, device=device)
    r_a = eng_a.predict(*reqs[2], seed=5)
    eng_a.close()
    acfg = SMKConfig(cov_model=art1.cov_model, link=art1.link, jitter=art1.jitter,
                     jitter_per_m=art1.jitter_per_m)
    fit_cpu = types.SimpleNamespace(sample_par=torch.as_tensor(art1.sample_par),
                                    sample_w=torch.as_tensor(art1.sample_w),
                                    param_grid=torch.as_tensor(art1.param_grid))
    cache = FactorCache(None, None, None, krige_chol=torch.as_tensor(art1.chol_tt))
    want_a, _ = predict_at(fit_cpu, art1.coords_test, *reqs[2], config=acfg, cache=cache,
                           eps=cpu_noise(5, (art1.n_draws, SERVE_ROWS, C4_Q), torch.float32, "cpu"))
    err_s = float(np.abs(r_a.p_samples - want_a.p_samples.numpy()).max())
    err_q = float(np.abs(r_a.p_quant - want_a.p_quant.numpy()).max())
    check(err_s <= SERVE_ATOL and err_q <= SERVE_ATOL,
          f"ingest: generation 1 card vs CPU {err_s:.3g} / {err_q:.3g}")
    for p in gen0 + gen1 + [r_a.p_quant]:
        check(bool(np.isfinite(p).all() and ((p >= 0) & (p <= 1)).all()),
              "ingest: a response not finite or outside [0, 1]")
    live.close()

    # the kernels at the refit group's shape (after the path's count)
    part = padded_partition(*(torch.as_tensor(np.asarray(a, np.float32))
                              for a in (live._y, live._x, live._coords)),
                            [live._assignments[0]], ladder=live._ladder())
    kernel_rows = ragged_kernel_checks(device, part)
    # the later phases clear the checkpoint directory file by file
    shutil.rmtree(gen_dir)
    out.update({
        "fit_wall_s": steps["fit"]["wall_s"], "steps": steps,
        "refit_wall_s": {"dirty_cold": rep.refit_wall_s, "full": rep_full.refit_wall_s,
                         "dirty_warm": rep_dirty.refit_wall_s},
        "refit_speedup": rep_dirty.refit_speedup, "refit_speedup_cold": rep.refit_speedup,
        "dirty_group_frac": rep.dirty_group_frac, "dirty_groups": list(receipt.dirty_groups),
        "subset0_rows": [len(live._assignments[0]) - INGEST_ROWS, len(live._assignments[0])],
        "subset0_rung": [rung0_before, rung0_after],
        "launches_expected_per_group": want, "launches": launches,
        "launches_by_kernel": layouts, "kernel_checks": kernel_rows,
        "card_vs_cpu_gen1_max_abs_err": {"p_samples": err_s, "p_quant": err_q,
                                         "atol": SERVE_ATOL},
        "torn_generation": torn, "committed_generation": m_now["generation"],
        "peak_memory_bytes": peak, "ledger": pstats.ingest,
        "param_rhat_max": rep_dirty.param_rhat_max, "nvidia_smi": nvidia_smi_line(),
    })
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


def replay_schedule(cfg, k, events, chunks, n_devices=1, rungs=None):
    """A fresh AdaptiveScheduler (over ``n_devices`` mesh entries)
    replayed on the host over a run's logged live_diagnostics events, the
    dispatch group re-formed as the executor does (members, rung, the
    frozen riders that stop writing, the plan growing at each grant).
    ``events`` and ``chunks`` may be another run's (a cross replay): the
    replay follows that run's boundaries as far as they go and stops
    where its own schedule ends. Returns the scheduler; ``rungs``, a
    list, gets the rung each sampling chunk was dispatched at."""
    import numpy as np
    from smk_torch.parallel.schedule import AdaptiveScheduler

    n_burn, n_kept = cfg.n_burn_in, cfg.n_kept
    sched = AdaptiveScheduler(cfg, k=k, n_kept=n_kept, chunk_iters=ADAPT_CHUNK,
                              n_devices=n_devices)
    plan_len = -(-n_burn // ADAPT_CHUNK) + -(-n_kept // ADAPT_CHUNK)
    members, kc = list(range(k)), k
    live = {e["iteration"]: e for e in events}
    for idx, ch in enumerate(c for c in chunks if c["phase"] != "drain"):
        if ch["phase"] not in ("sample", "extra"):
            continue
        ev = live[ch["iteration"]]
        written = [j for j in members if not sched.frozen[j]]
        if rungs is not None:
            rungs.append(kc)
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
        if not members:  # the schedule has ended; another run's record may go on
            break
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
    from smk_torch.models.probit_gp import dispatched_build_calls
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
    # (c)'s draws on the host, for adaptive_mesh_config5 (not printed)
    out["c_result"] = {"fields": _adaptive_fields(rc), "frozen_at": list(sc.adaptive["frozen_at"]),
                       "chunks_saved_frac": sc.adaptive["chunks_saved_frac"],
                       "extra_granted": sc.adaptive["extra_granted"]}
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
    from smk_torch.models.probit_gp import dispatched_build_calls
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
    from smk_torch.models.probit_gp import dispatched_build_calls
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


def _graph_leg(name, cfg, data_np, device, chunk=16):
    """One leg of programs_config5: the executor's chunk runner
    (parallel/recovery._run_chunk: captured bucket programs, replayed)
    and the sampler's eager burn_chunk / sample_chunk on two identical
    setups (sampler_setup) over the fit's schedule in chunks of
    ``chunk``, bitwise after every chunk (state, draws, noise snapshot,
    guard counts); launches against build_calls; per bucket its key,
    source, capture seconds and pool bytes; then one update and one
    non-update sweep as one-sweep programs against eager: wall ms from
    an idle card, device ms behind a sleep, the idle share."""
    import statistics as st

    import numpy as np
    import torch
    from smk_torch.compile import programs as cprog
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import recovery
    from smk_torch.utils.tracing import ChunkPipelineStats

    model_g, data, state_g, consts_g, noise_g = sampler_setup(cfg, data_np, device)
    model_e, data_e, state_e, consts_e, noise_e = sampler_setup(cfg, data_np, device)
    k = cfg.n_subsets
    q = data.x.shape[2]
    stats = ChunkPipelineStats()
    ctx = recovery._ProgramCtx(None, stats, k, None)
    pieces = recovery._pieces(model_g, data, noise_g, k, cfg.n_chains, None, ctx)
    plan = [("burn", a, min(chunk, cfg.n_burn_in - a)) for a in range(0, cfg.n_burn_in, chunk)]
    # the collecting chunks, and one more past the schedule so that every
    # bucket is replayed at least once
    n_total = cfg.n_samples + chunk
    plan += [("samp", a, min(chunk, n_total - a)) for a in range(cfg.n_burn_in, n_total, chunk)]
    chunks, same = [], []
    fb.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kind, a, n in plan:
        rec = {"kind": kind, "start": a, "n": n}
        for mode in ("graph", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "graph":
                counts = fb.count_snapshot()
                state_g, dr_g = recovery._run_chunk(model_g, kind, pieces, state_g, a, n)
                graph_counts = fb.count_delta(counts)
            elif kind == "burn":
                counts = fb.count_snapshot()
                state_e, dr_e = model_e.burn_chunk(data_e, consts_e, state_e, noise_e, a, n), None
                fb.restore_counts(counts)
            else:
                counts = fb.count_snapshot()
                state_e, dr_e = model_e.sample_chunk(data_e, consts_e, state_e, noise_e, a, n)
                fb.restore_counts(counts)
            torch.cuda.synchronize()
            rec[f"{mode}_ms_per_sweep"] = (time.perf_counter() - t0) * 1e3 / n
        rec["launches"] = graph_counts[0]
        eq = {f: bool(torch.equal(x, y)) for f, x, y in zip(state_g._fields, state_g, state_e)}
        if dr_g is not None:
            eq["param_draws"] = bool(torch.equal(dr_g[0], dr_e[0]))
            eq["w_draws"] = bool(torch.equal(dr_g[1], dr_e[1]))
        eq["noise_snapshot"] = bool(np.array_equal(noise_g.snapshot(), noise_e.snapshot()))
        if model_e.guard_rejects is not None:
            eq["guard_rejects"] = bool(torch.equal(model_g.guard_rejects, model_e.guard_rejects))
        rec["bitwise"] = eq
        same.append(all(eq.values()))
        chunks.append(rec)
        if kind == "burn" and a + n == cfg.n_burn_in:
            state_g = state_g._replace(phi_accept=torch.zeros_like(state_g.phi_accept))
            state_e = state_e._replace(phi_accept=torch.zeros_like(state_e.phi_accept))
    peak = torch.cuda.max_memory_allocated()
    launches = dict(fb.LAUNCHES)
    # the chunks' launches, counted through the replays: build_calls of
    # the plan less R~ at init (sampler_setup's, before the count)
    want_chunks = build_calls(cfg, q, n_total, cfg.n_burn_in, chunk_iters=chunk)
    want_chunks["fused_masked_correlation_stack"] -= 1
    check(launches == want_chunks,
          f"programs {name}: launches {launches} != build_calls {want_chunks}")
    check(all(same), f"programs {name}: graph chunks differ from eager: "
          f"{[c['bitwise'] for c in chunks]}")
    buckets = [p.info() for p in cprog.programs_of(model_g)]
    check(all(b["captured"] and b["replays"] >= 1 for b in buckets),
          f"programs {name}: a bucket was not captured and replayed: {buckets}")

    # one update and one non-update sweep: one-sweep programs vs eager
    e = cfg.phi_update_every
    base = cfg.n_samples + (-cfg.n_samples) % e  # an update sweep past the schedule
    sweeps = {}
    for label, off in (("update", 0), ("other", 1)):
        starts = iter(range(base + off, base + off + 1000 * e, e))

        def graph_call():
            nonlocal state_g
            state_g, _ = recovery._run_chunk(model_g, "burn", pieces, state_g, next(starts), 1)

        def eager_call():
            nonlocal state_e
            state_e = model_e.burn_chunk(data_e, consts_e, state_e, noise_e, next(starts), 1)

        res = {}
        for mode, fn in (("graph", graph_call), ("eager", eager_call)):
            fn()  # the graph's capture, the eager path's first call
            torch.cuda.synchronize()
            walls = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            # device time alone: each call queued behind a device sleep long
            # enough (~0.1 s) that the host has queued the whole sweep, the
            # eager one's launches included, before the card reaches it
            devs = []
            for _ in range(10):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(LONG_SLEEP_CYCLES)
                start.record()
                fn()
                end.record()
                end.synchronize()
                devs.append(start.elapsed_time(end))
            dev_ms = st.median(devs)
            wall_ms = st.median(walls)
            res[mode] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                         "idle_share": max(0.0, 1.0 - dev_ms / wall_ms)}
        res["graph_over_eager_wall"] = res["graph"]["wall_ms"] / res["eager"]["wall_ms"]
        sweeps[label] = res
    fb.reset_counts()
    out = {"leg": name, "K": k, "m": data.x.shape[1], "q": q, "link": cfg.link,
           "phi_update_every": e, "n_samples": cfg.n_samples, "chunk_iters": chunk,
           "chunks": chunks, "launches": launches, "launches_expected": want_chunks,
           "peak_memory_bytes": peak, "buckets": buckets,
           "program_records": stats.programs, "sweep_ms": sweeps}
    del model_g, model_e, state_g, state_e, pieces
    torch.cuda.empty_cache()
    return out


def _store_child(store_dir: str) -> int:
    """The fresh process of programs_config5's warm-store leg (``python3
    chip_smoke.py --programs-child STORE``): a small chunked production
    fit with compile_store_dir=STORE, in the build directory
    SMK_TORCH_BUILD_DIR names; prints what nvcc ran and where every
    program came from as its last line."""
    import warnings

    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.ops import cuda_build
    from smk_torch.utils.tracing import ChunkPipelineStats

    device = torch.device("cuda", 0)
    cfg = production_config(k=4, n_samples=16, phi_every=4, compile_store_dir=store_dir)
    stats = ChunkPipelineStats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = fit_meta_kriging(*binary_field(4 * 200, 1, 2, 16, SEED), config=cfg, seed=SEED,
                               device=device, chunk_iters=4, pipeline_stats=stats)
    torch.cuda.synchronize()
    print(json.dumps({
        "nvcc_runs": dict(cuda_build.NVCC_RUNS), "origin": dict(cuda_build.ORIGIN),
        "sources": sorted({p["source"] for p in stats.programs
                           if p["key"][0] in ("burn", "samp")}),
        "finite": bool(torch.isfinite(res.p_quant).all()),
        "warnings": [str(w.message)[:300] for w in caught
                     if "compile store" in str(w.message)],
        "build_dir": str(cuda_build.build_dir())}), flush=True)
    return 0


def programs_config5(device, c5_data, c4_data, tmp):
    """Program reuse (ROADMAP A10): the graph legs at config5 (the
    production sampler, 64 sweeps in chunks of 16) and config4 (the
    production sampler with the logit link), then the warm-store leg: a
    fresh subprocess with an empty build directory and a warm
    compile_store_dir runs 0 nvcc builds and reports "l2"; a tampered
    fingerprint is a warned miss, and the rebuild follows."""
    import pickle
    import subprocess

    from smk_torch.compile.store import ProgramStore
    from smk_torch.ops import cuda_build

    out = {"phase": "programs_config5", "legs": []}
    for name, cfg, data_np in (
            ("config5", production_config(k=MAIN_K, n_samples=64, phi_every=16), c5_data),
            ("config4_logit", production_config(k=C4_K, n_samples=64, link="logit",
                                                phi_every=8), c4_data)):
        leg = _graph_leg(name, cfg, data_np, device)
        emit({"phase": "programs_config5_leg", **leg})
        out["legs"].append({k_: leg[k_] for k_ in ("leg", "peak_memory_bytes", "sweep_ms",
                                                   "buckets")})
    store_dir = os.path.join(tmp, "store")
    store = ProgramStore(store_dir)
    cuda_build.ensure(list(cuda_build.SOURCES), store)  # the parent's libraries, stored

    def child(build_name):
        env = dict(os.environ, SMK_TORCH_BUILD_DIR=os.path.join(tmp, build_name))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--programs-child",
                              store_dir], env=env, capture_output=True, text=True,
                             timeout=300)
        check(run.returncode == 0, f"programs: the store child failed: {run.stderr[-2000:]}")
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        rec["wall_s"] = time.perf_counter() - t0
        return rec

    warm = child("child_build_warm")
    check(warm["nvcc_runs"] == {} and warm["sources"] == ["l2"] and warm["finite"],
          f"programs: warm store child {warm}")
    key = cuda_build.store_key("fused_corr")
    path = store.path_for(key)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    blob["fingerprint"] = dict(blob["fingerprint"], torch="0.0.0-tampered")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    tampered = child("child_build_tampered")
    check(tampered["nvcc_runs"] == {"fused_corr": 1} and tampered["sources"] == ["fresh"]
          and any("different environment" in w for w in tampered["warnings"])
          and tampered["finite"], f"programs: tampered store child {tampered}")
    check(store.load(key) is not None, "programs: the rebuild did not refill the store")
    out["warm_store_child"] = warm
    out["tampered_store_child"] = tampered
    emit(out)
    return out



# ----------------------------------------------------------------------
# phase 11b: the sweep noise kernel (ops/sweep_noise.py)
# ----------------------------------------------------------------------
NOISE_SOURCE = "smk_torch/csrc/sweep_noise.cu"


def noise_kernel(device, c5_data, c4_data):
    """The sweep noise kernel against the per-row path at both cells'
    per-sweep shapes (bitwise, every field and generator state), its
    times beside the per-row path's and its bound, and its launches and
    batched rows in a 16-sweep fit at each cell's config."""
    import torch

    from smk_torch import fit_meta_kriging
    from smk_torch.models import probit_gp as tp
    from smk_torch.ops import sweep_noise as sn
    from smk_torch.utils import tracing

    out = {"phase": "noise_kernel", "source": NOISE_SOURCE, "cells": {}}
    cells = (
        ("config5", tp.SweepShapes(MAIN_K, MAIN_M, 1, 2, MAIN_T),
         production_config(k=MAIN_K, n_samples=16, phi_every=16), c5_data),
        ("config4", tp.SweepShapes(2 * C4_K, C4_M, C4_Q, C4_P, C4_T, link="logit"),
         production_config(k=C4_K, n_samples=16, link="logit", phi_every=8, n_chains=2),
         c4_data))
    for name, shapes, cfg, data_np in cells:
        fast, slow = (tp.GeneratorNoise(tp.subset_generators(SEED, shapes.k, device), shapes,
                                        device=device) for _ in range(2))
        check(fast.batched, f"noise_kernel {name}: the kernel does not cover the cell")
        slow.batched = False
        for it in range(4):
            a, b = fast(it, it % 2 == 1), slow(it, it % 2 == 1)
            for field, x, y in zip(tp.SweepNoise._fields, a, b):
                check((x is None and y is None) or torch.equal(x, y),
                      f"noise_kernel {name}: {field} differs at sweep {it}")
            check(all(torch.equal(g.get_state(), h.get_state())
                      for g, h in zip(fast.generators, slow.generators)),
                  f"noise_kernel {name}: a generator's state differs at sweep {it}")
        out_bytes = sum(x.numel() * x.element_size() for x in fast(4, True) if x is not None)
        rec = {
            "rows": shapes.k, "out_bytes": out_bytes, "max_abs_err": 0.0,
            "device_ms": ms_median(lambda: fast(0, True), device_only=True),
            "ms": ms_median(lambda: fast(0, True)),
            "plain_ms": ms_median(lambda: slow(0, True)),
            "bound_ms": out_bytes / HBM_BYTES_PER_S * 1e3,
        }
        before = sn.LAUNCHES
        with tracing.record_spans() as spans:
            res = fit_meta_kriging(*data_np, config=cfg, seed=SEED, device=device)
        torch.cuda.synchronize()
        rec["fit_launches"] = sn.LAUNCHES - before
        rec["fit_rows_batched"] = spans.counters.get("noise_rows_batched", 0)
        rec["fit_rows_rowwise"] = spans.counters.get("noise_rows_rowwise", 0)
        check(rec["fit_launches"] == cfg.n_samples and rec["fit_rows_rowwise"] == 0
              and rec["fit_rows_batched"] == cfg.n_samples * shapes.k
              and bool(torch.isfinite(res.p_quant).all()),
              f"noise_kernel {name}: the fit's noise {rec}")
        out["cells"][name] = rec
    emit(out)
    return out


# ----------------------------------------------------------------------
# phases 31-35: the device mesh and the process group (ROADMAP A9a)
# ----------------------------------------------------------------------
MESH_FIELDS = ("param_grid", "w_grid", "sample_par", "sample_w", "p_samples", "param_quant",
               "w_quant", "p_quant", "phi_accept_rate")


def same_bits(a, b):
    """Bitwise equal tensors, NaN where NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def every_field_bitwise(a, b):
    """Per result field (and per subset_results field) whether the two
    fits are bitwise equal."""
    out = {f: same_bits(getattr(a, f), getattr(b, f)) for f in MESH_FIELDS}
    for f, u, v in zip(a.subset_results._fields, a.subset_results, b.subset_results):
        out["subset_results." + f] = same_bits(u, v)
    return out


def span_seconds(path, name):
    """The summed seconds of the run log's spans called ``name``."""
    total, n = 0.0, 0
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "span" and rec.get("name") == name:
                total += rec["t1"] - rec["t0"]
                n += 1
    return total, n


def mesh_config5(device, c5_data, tmp):
    """config5's production data and sampler, 32 sweeps: the unmeshed
    fit, then fit_meta_kriging(n_devices=1), both with a run log; every
    result field bitwise, the meshed run's launches per entry point ==
    build_calls (counts set to 0 just before it), its gather span's
    seconds, ms/sweep of both. Then the chunked fits (chunks of 16,
    quarantine), unmeshed and on the 1-entry mesh: bitwise, the meshed
    one's programs new captures keyed under the topology fingerprint,
    its launches == build_calls(chunk_iters=16)."""
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.compile.programs import topology_fingerprint
    from smk_torch.models.probit_gp import build_calls, dispatched_build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel.executor import make_mesh
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg = production_config(k=MAIN_K, n_samples=32, phi_every=16,
                            run_log_dir=os.path.join(tmp, "mesh_logs"))
    mesh = make_mesh(1)
    check(mesh.size == 1 and mesh.home == device, f"mesh_config5: mesh {mesh}")
    fits, walls = {}, {}
    for leg in ("unmeshed", "meshed"):
        torch.cuda.synchronize()
        fb.reset_counts()
        t0 = time.perf_counter()
        fits[leg] = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                                     **({"n_devices": 1} if leg == "meshed" else {}))
        torch.cuda.synchronize()
        walls[leg] = time.perf_counter() - t0
        if leg == "meshed":
            launches = dict(fb.LAUNCHES)
            layouts = launches_by_kernel()
            plain = sum(fb.PLAIN_CALLS.values())
    same = every_field_bitwise(fits["meshed"], fits["unmeshed"])
    check(all(same.values()), f"mesh_config5: meshed fit not bitwise the unmeshed one {same}")
    # every entry fits its block: each launches an unmeshed fit's calls
    want = {e: mesh.size * v for e, v in build_calls(cfg, 1, cfg.n_samples,
                                                      cfg.n_burn_in).items()}
    check(launches == want, f"mesh_config5: launches {launches} != {want}")
    check(layouts == expected_by_kernel(want), f"mesh_config5: by kernel {layouts}")
    check(all(launches[e] > 0 for e in MAIN_PATH), "mesh_config5: a kernel never launched")
    check(plain == 0, "mesh_config5: a plain build ran on the card path")
    gather_s, n_gather = span_seconds(fits["meshed"].run_log_path, "gather")
    check(n_gather == 1, f"mesh_config5: {n_gather} gather spans")
    check(span_seconds(fits["unmeshed"].run_log_path, "gather")[1] == 0,
          "mesh_config5: a gather span in the unmeshed fit")
    ms = {leg: r.phase_seconds["subset_fits"] / cfg.n_samples * 1e3 for leg, r in fits.items()}
    out = {"phase": "mesh_config5", "K": MAIN_K, "m": MAIN_M, "n_samples": cfg.n_samples,
           "mesh": repr(mesh), "bitwise": same, "wall_s": walls, "ms_per_sweep": ms,
           "phase_seconds": {leg: r.phase_seconds for leg, r in fits.items()},
           "gather_s": gather_s, "launches": launches, "launches_expected": want,
           "launches_by_kernel": layouts}
    del fits
    torch.cuda.empty_cache()

    # the chunked executor on the same mesh
    qcfg = production_config(k=MAIN_K, n_samples=32, phi_every=16, fault_policy="quarantine")
    chunked, stats = {}, {}
    for leg in ("unmeshed", "meshed"):
        stats[leg] = ChunkPipelineStats()
        torch.cuda.synchronize()
        fb.reset_counts()
        t0 = time.perf_counter()
        chunked[leg] = fit_meta_kriging(*c5_data, config=qcfg, seed=SEED, device=device,
                                        chunk_iters=16, pipeline_stats=stats[leg],
                                        **({"mesh": mesh} if leg == "meshed" else {}))
        torch.cuda.synchronize()
        walls["chunked_" + leg] = time.perf_counter() - t0
        if leg == "meshed":
            c_launches = dict(fb.LAUNCHES)
            c_layouts = launches_by_kernel()
    same_c = every_field_bitwise(chunked["meshed"], chunked["unmeshed"])
    check(all(same_c.values()), f"mesh_config5: chunked meshed fit not bitwise {same_c}")
    c_want = dispatched_build_calls(qcfg, 1, stats["meshed"].chunks, entries=mesh.size)
    check(c_want == build_calls(qcfg, 1, qcfg.n_samples, qcfg.n_burn_in, chunk_iters=16),
          f"mesh_config5: the chunk records imply {c_want}")
    check(c_launches == c_want, f"mesh_config5: chunked launches {c_launches} != {c_want}")
    check(c_layouts == expected_by_kernel(c_want), f"mesh_config5: chunked by kernel {c_layouts}")
    fp = topology_fingerprint(mesh)
    progs = stats["meshed"].programs
    chunk_progs = [p for p in progs if p["key"][0] in ("burn", "samp")]
    check(chunk_progs and all(p["key"][-1] == str(fp) for p in progs),
          f"mesh_config5: programs without the fingerprint {progs}")
    check(any(p["source"] != "l1" for p in chunk_progs),
          "mesh_config5: the meshed chunk programs were not new captures")
    out.update({
        "topology_fingerprint": list(fp), "chunked_bitwise": same_c,
        "chunked_ms_per_sweep": {leg: r.phase_seconds["subset_fits"] / qcfg.n_samples * 1e3
                                 for leg, r in chunked.items()},
        "chunked_launches": c_launches, "chunked_launches_expected": c_want,
        "chunked_launches_by_kernel": c_layouts,
        "meshed_programs": [{"key": p["key"][:2] + p["key"][-2:], "source": p["source"],
                             "compile_s": p["compile_s"]} for p in chunk_progs],
        "wall_s": walls,
    })
    print("topology fingerprint:", fp, flush=True)
    emit(out)
    # mesh_blocks_config5's reference: the unmeshed chunked fit (not printed)
    out["chunked_unmeshed_result"] = chunked["unmeshed"]
    return out


def one_card_mesh(n, device):
    """A mesh of ``n`` entries all on ``device``: the blocks of an
    ``n``-entry mesh, each run as its entry runs it, one after another on
    one card (parallel/executor.run_per_device runs the jobs of one
    device in turn)."""
    import torch
    from smk_torch.parallel.executor import Mesh, MeshEntry

    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return Mesh([MeshEntry(i, dev, 0, kind) for i in range(n)], ("subsets",))


def field_gaps(a, b):
    """Per result field (and subset_results field) of two fits the
    largest absolute difference (NaN where NaN in both counts as equal)."""
    import torch

    def gap(u, v):
        both = u.isnan() & v.isnan()
        d = torch.where(both, torch.zeros_like(u), (u.double() - v.double()).abs())
        return float(d.max()) if d.numel() else 0.0

    out = {f: gap(getattr(a, f), getattr(b, f)) for f in MESH_FIELDS}
    for f, u, v in zip(a.subset_results._fields, a.subset_results, b.subset_results):
        out["subset_results." + f] = gap(u, v)
    return out


# a phi that moved by more than this, relative, took another accept
# decision somewhere (roundoff moves it by ~1e-6)
PHI_DECISION_RTOL = 1e-3


def phi_decisions_differ(a, b, q):
    """The (subset, component) pairs whose kept phi draws differ by more
    than PHI_DECISION_RTOL relative between the two fits: a different
    phi accept decision at an update sweep, not roundoff."""
    pa = a.subset_results.param_samples[..., -q:].double()
    pb = b.subset_results.param_samples[..., -q:].double()
    off = ((pa - pb).abs() > PHI_DECISION_RTOL * pb.abs()).any(dim=-2)
    return int(off.sum())


def mesh_blocks_config5(device, c5_data, m5):
    """The part of C7 that one card shows: config5's four 8-row blocks,
    each run as a card of make_mesh(4) runs it (its own initial state,
    its noise rows, its chunk programs), one after another on this card
    (one_card_mesh(4)), on mesh_config5's chunked schedule (production,
    quarantine, 32 sweeps in chunks of 16). Launches == four times an
    8-row fit's; two runs bitwise; against mesh_config5's unmeshed
    chunked fit, each field's largest difference and the phi decisions
    that differ (the batch-size roundoff: 8 rows a call against 32)."""
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls, dispatched_build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.tracing import ChunkPipelineStats

    ref = m5["chunked_unmeshed_result"]
    mesh = one_card_mesh(4, device)
    qcfg = production_config(k=MAIN_K, n_samples=32, phi_every=16, fault_policy="quarantine")
    # one 8-row fit's calls: build_calls does not depend on the batch
    block = build_calls(qcfg, 1, qcfg.n_samples, qcfg.n_burn_in, chunk_iters=16)
    want = {e: mesh.size * v for e, v in block.items()}
    runs, walls = [], []
    for _ in range(2):
        stats = ChunkPipelineStats()
        torch.cuda.synchronize()
        fb.reset_counts()
        t0 = time.perf_counter()
        res = fit_meta_kriging(*c5_data, config=qcfg, seed=SEED, device=device,
                               chunk_iters=16, pipeline_stats=stats, mesh=mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = dict(fb.LAUNCHES)
        check(launches == want, f"mesh_blocks_config5: launches {launches} != {want}")
        check(launches == dispatched_build_calls(qcfg, 1, stats.chunks, entries=mesh.size),
              "mesh_blocks_config5: launches differ from the chunk records'")
        check(sum(fb.PLAIN_CALLS.values()) == 0, "mesh_blocks_config5: a plain build ran")
        check(set(fb.DEVICE_LAUNCHES) == {device.index},
              f"mesh_blocks_config5: launches on {fb.DEVICE_LAUNCHES}")
        runs.append(res)
    same = every_field_bitwise(runs[0], runs[1])
    check(all(same.values()), f"mesh_blocks_config5: two runs not bitwise {same}")
    gaps = field_gaps(runs[0], ref)
    out = {"phase": "mesh_blocks_config5", "K": MAIN_K, "m": MAIN_M, "blocks": mesh.size,
           "rows_per_block": MAIN_K // mesh.size, "n_samples": qcfg.n_samples,
           "chunk_iters": 16, "wall_s": walls,
           "ms_per_sweep": [r.phase_seconds["subset_fits"] / qcfg.n_samples * 1e3
                            for r in runs],
           "repeat_bitwise": same, "launches": launches, "launches_expected": want,
           "launches_by_kernel": launches_by_kernel(),
           "bitwise_unmeshed": every_field_bitwise(runs[0], ref),
           "max_abs_diff_unmeshed": gaps,
           "phi_decisions_differ": phi_decisions_differ(runs[0], ref, 1),
           "phi_decisions_of": MAIN_K, "nvidia_smi": nvidia_smi_line()}
    emit(out)
    return out


def mesh_coherent_config4(device, c4_data):
    """config4's eBird proxy with the coherent partition (the production
    sampler, logit, 32 sweeps in chunks of 16) on the host path and on a
    1-entry mesh: the plan is the identity (one entry per bucket group,
    no pads), pad_waste_frac 0.0, every field bitwise, launches per
    group == build_calls(chunk_iters=16)."""
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg = production_config(k=C4_K, n_samples=32, link="logit", phi_every=8,
                            partition_method="coherent")
    fits, stats, walls = {}, {}, {}
    for leg in ("host", "meshed"):
        stats[leg] = ChunkPipelineStats()
        torch.cuda.synchronize()
        fb.reset_counts()
        t0 = time.perf_counter()
        fits[leg] = fit_meta_kriging(*c4_data, config=cfg, seed=SEED, device=device,
                                     chunk_iters=16, pipeline_stats=stats[leg],
                                     **({"n_devices": 1} if leg == "meshed" else {}))
        torch.cuda.synchronize()
        walls[leg] = time.perf_counter() - t0
        if leg == "meshed":
            launches = dict(fb.LAUNCHES)
            layouts = launches_by_kernel()
    same = every_field_bitwise(fits["meshed"], fits["host"])
    check(all(same.values()), f"mesh_coherent_config4: not bitwise the host fit {same}")
    plan = stats["meshed"].ragged_mesh_plan
    check(plan is not None and plan["n_devices"] == 1 and plan["pad_waste_frac"] == 0.0
          and [e["group_ids"] for e in plan["entries"]] == [[0], [1]]
          and not any(e["fused"] for e in plan["entries"]),
          f"mesh_coherent_config4: the 1-entry plan is not the identity {plan}")
    check(fits["meshed"].pad_waste_frac == 0.0, "mesh_coherent_config4: pad waste")
    want = build_calls(cfg, C4_Q, cfg.n_samples, cfg.n_burn_in, chunk_iters=16)
    total = {e: 2 * v for e, v in want.items()}
    check(launches == total, f"mesh_coherent_config4: launches {launches} != {total}")
    check(layouts == expected_by_kernel(total), f"mesh_coherent_config4: by kernel {layouts}")
    out = {"phase": "mesh_coherent_config4", "K": C4_K, "n_samples": cfg.n_samples,
           "bitwise": same, "plan": plan, "wall_s": walls,
           "ms_per_sweep": {leg: r.phase_seconds["subset_fits"] / cfg.n_samples * 1e3
                            for leg, r in fits.items()},
           "launches": launches, "launches_expected": total, "launches_by_kernel": layouts}
    emit(out)
    return out


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_world_of_one(device):
    """A real NCCL process group of one (tcp://127.0.0.1, a free port)
    brought up through flaky_coordinator(2, passthrough=True): three
    init_process_group calls; barrier_sync and allgather_bytes; a small
    fit over the process-group mesh bitwise its unmeshed fit (launches
    equal); gather_grids through an NCCL all-gather, bitwise; the group
    destroyed at the end."""
    import warnings

    import torch
    import torch.distributed as tdist
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import distributed as D
    from smk_torch.parallel.combine import gather_grids
    from smk_torch.parallel.executor import make_mesh
    from smk_torch.testing.faults import flaky_coordinator

    port = _free_port()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with flaky_coordinator(2, passthrough=True) as ctr:
            topo = D.init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                                      device=device, backoff_s=0.01, timeout_s=60.0)
    init_s = time.perf_counter() - t0
    try:
        check(ctr["calls"] == 3, f"dist_world_of_one: {ctr['calls']} init calls")
        check(D.backend_name() == "nccl", f"dist_world_of_one: backend {D.backend_name()}")
        check((topo.num_processes, topo.process_id) == (1, 0), f"dist_world_of_one: {topo}")
        D.barrier_sync("smoke", timeout_s=30.0)
        check(D.allgather_bytes("smoke", b"smk", timeout_s=30.0) == [b"smk"],
              "dist_world_of_one: allgather_bytes")
        mesh = make_mesh()
        check(mesh.size == torch.cuda.device_count() and mesh.process_indices == (0,),
              f"dist_world_of_one: mesh {mesh}")
        mesh = make_mesh(1)
        y, x, coords, ct, xt = binary_field(4 * 200, 1, 2, 16, SEED + 7)
        cfg = SMKConfig(n_subsets=4, n_samples=16, fused_build="pallas")
        fb.reset_counts()
        plain = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, seed=SEED, device=device)
        plain_launches = dict(fb.LAUNCHES)
        fb.reset_counts()
        meshed = fit_meta_kriging(y, x, coords, ct, xt, config=cfg, seed=SEED, device=device,
                                  mesh=mesh)
        launches = dict(fb.LAUNCHES)
        layouts = launches_by_kernel()
        same = every_field_bitwise(meshed, plain)
        check(all(same.values()), f"dist_world_of_one: meshed fit not bitwise {same}")
        check(launches == plain_launches and all(launches[e] > 0 for e in MAIN_PATH),
              f"dist_world_of_one: launches {launches} != {plain_launches}")
        grids = plain.subset_results.param_grid
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gathered = gather_grids(grids, mesh)
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t1) * 1e3
        check(gathered.data_ptr() != grids.data_ptr() and same_bits(gathered, grids),
              "dist_world_of_one: the NCCL gather is not bitwise")
    finally:
        D.destroy_distributed()
    check(not tdist.is_initialized(), "dist_world_of_one: the process group survived")
    out = {"phase": "dist_world_of_one", "init_calls": ctr["calls"], "init_s": init_s,
           "backend": "nccl", "topology": topo.__dict__, "bitwise": same,
           "launches": launches, "launches_by_kernel": layouts, "gather_ms": gather_ms}
    emit(out)
    return out


def _dir_bytes(path, prefix):
    """{file name: bytes} of the files under ``path`` starting with
    ``prefix``."""
    import os

    return {f: os.path.getsize(os.path.join(path, f)) for f in sorted(os.listdir(path))
            if f.startswith(prefix)}


def _remove_prefix(path, prefix):
    import os

    for f in os.listdir(path):
        if f.startswith(prefix):
            os.remove(os.path.join(path, f))


def dist_ckpt_config5(device, c5_data, tmp):
    """The distributed checkpoint (format 8, parallel/checkpoint.py) at
    config5 inside a real NCCL process group of one, so its commit
    barriers and identity all-gather run on the group's store: the
    production sampler, fault_policy="quarantine", 64 sweeps in chunks of
    16 (three burn-in generations and one sampling generation), format 8
    through FORCE_DISTRIBUTED_FOR_TESTING.

    (a) the uninterrupted format-8 fit bitwise, in every field, the
        format-7 checkpointed fit and the uncheckpointed chunked fit of
        the same seed; 4 generations; per boundary the commit seconds,
        the shard bytes and the boundary's host wall beside format 7's;
        the state shards on disk at each boundary; launches ==
        build_calls(chunk_iters=16);
    (b) kill_process_at_generation(2): SimulatedKill, the manifest still
        at generation 1, generation 2's shard an orphan on disk; the
        resume warns of it, overwrites it and ends bitwise (a);
    (c) torn_shard(kind="segment") on (a)'s checkpoint: the lenient
        resume completes, its kept draws before the torn range bitwise
        (a)'s; then torn_shard(kind="state"): a typed error naming
        shard:0;
    (d) a run stopped after three generations, its files re-split as two
        processes' shards (rows [0, 16) and [16, 32)), resumed in one
        process: the elastic path, warned, bitwise (a).
    The files of each leg are removed at its end."""
    import os
    import warnings

    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import checkpoint as dck
    from smk_torch.parallel import distributed as D
    from smk_torch.testing.faults import (SimulatedKill, kill_process_at_generation,
                                          resplit_shards, torn_shard)
    from smk_torch.utils.checkpoint import load_pytree
    from smk_torch.utils.tracing import ChunkPipelineStats

    cfg = production_config(k=MAIN_K, n_samples=64, phi_every=16, fault_policy="quarantine")
    want = build_calls(cfg, 1, cfg.n_samples, cfg.n_burn_in, chunk_iters=16)

    def fit(**kw):
        return fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                                chunk_iters=16, **kw)

    def generation(path):
        return int(load_pytree(path, dck._manifest_like())["generation"][0])

    def caught(fn):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(x.message) for x in w]

    def boundaries(stats):
        keys = ("host_work_s", "ckpt_write_s", "ckpt_commit_s", "ckpt_bytes", "state_fetch_s")
        return [{k: c.get(k) for k in keys} for c in stats.chunks if c.get("phase") != "drain"]

    port = _free_port()
    topo = D.init_distributed(f"127.0.0.1:{port}", num_processes=1, process_id=0,
                              device=device, timeout_s=60.0)
    out = {"phase": "dist_ckpt_config5", "K": MAIN_K, "m": MAIN_M, "n_samples": cfg.n_samples,
           "chunk_iters": 16, "fault_policy": "quarantine", "backend": D.backend_name(),
           "topology": topo.__dict__}
    try:
        check(D.backend_name() == "nccl", f"dist_ckpt_config5: backend {D.backend_name()}")
        # (a) uncheckpointed, format 7, format 8
        t0 = time.perf_counter()
        plain = fit()
        out["uncheckpointed_wall_s"] = time.perf_counter() - t0
        p7 = os.path.join(tmp, "v7.npz")
        s7 = ChunkPipelineStats()
        t0 = time.perf_counter()
        v7 = fit(checkpoint_path=p7, pipeline_stats=s7)
        out["v7_wall_s"] = time.perf_counter() - t0
        check(not dck.is_distributed_manifest(p7), "dist_ckpt_config5: format 7 not written")
        _remove_prefix(tmp, "v7.npz")
        p8 = os.path.join(tmp, "v8.npz")
        s8 = ChunkPipelineStats()
        on_disk = []

        def watch(info):
            on_disk.append(len([f for f in os.listdir(tmp)
                                if f.startswith("v8.npz.p") and f.endswith(".state.npz")]))

        dck.FORCE_DISTRIBUTED_FOR_TESTING = True
        barriers0 = sum(v for (kind, _), v in D._KV_SEQ.items() if kind == "barrier")
        fb.reset_counts()
        t0 = time.perf_counter()
        v8 = fit(checkpoint_path=p8, pipeline_stats=s8, progress=watch)
        out["v8_wall_s"] = time.perf_counter() - t0
        launches = dict(fb.LAUNCHES)
        layouts = launches_by_kernel()
        store_barriers = sum(v for (kind, _), v in D._KV_SEQ.items()
                             if kind == "barrier") - barriers0
        check(launches == want, f"dist_ckpt_config5: launches {launches} != {want}")
        check(layouts == expected_by_kernel(want), f"dist_ckpt_config5: by kernel {layouts}")
        check(sum(fb.PLAIN_CALLS.values()) == 0, "dist_ckpt_config5: a plain build ran")
        vs7, vsu = every_field_bitwise(v8, v7), every_field_bitwise(v8, plain)
        check(all(vs7.values()) and all(vsu.values()),
              f"dist_ckpt_config5: format 8 not bitwise: v7 {vs7} uncheckpointed {vsu}")
        check(s8.ckpt_generations == 4 and generation(p8) == 4,
              f"dist_ckpt_config5: {s8.ckpt_generations} generations")
        check(store_barriers == 8, f"dist_ckpt_config5: {store_barriers} store barriers")
        check(max(on_disk) <= 2, f"dist_ckpt_config5: state shards on disk {on_disk}")
        files = _dir_bytes(tmp, "v8.npz")
        out.update(
            bitwise_v7=vs7, bitwise_uncheckpointed=vsu, generations=s8.ckpt_generations,
            store_barriers=store_barriers, ckpt_commit_s=s8.ckpt_commit_s,
            ckpt_write_s={"v7": s7.ckpt_write_s, "v8": s8.ckpt_write_s},
            boundary_bytes={"v7": s7.ckpt_boundary_bytes, "v8": s8.ckpt_boundary_bytes},
            boundaries={"v7": boundaries(s7), "v8": boundaries(s8)},
            state_shards_on_disk_at_each_boundary=on_disk, files_after=files,
            disk_bytes_after=sum(files.values()), launches=launches,
            launches_expected=want, launches_by_kernel=layouts)
        del v7, plain
        torch.cuda.empty_cache()

        # (b) a kill between shard-land and manifest-publish of generation 2
        pk = os.path.join(tmp, "kill.npz")
        try:
            with kill_process_at_generation(2):
                fit(checkpoint_path=pk)
            raise AssertionError("dist_ckpt_config5: the kill did not stop the fit")
        except SimulatedKill:
            pass
        check(generation(pk) == 1, f"dist_ckpt_config5: manifest at {generation(pk)} after kill")
        orphan = os.path.exists(dck.shard_state_path(pk, 0, 2))
        check(orphan, "dist_ckpt_config5: generation 2's shard is not on disk")
        t0 = time.perf_counter()
        resumed, msgs = caught(lambda: fit(checkpoint_path=pk))
        out["kill"] = {"resume_s": time.perf_counter() - t0,
                       "orphan_warned": any("orphan shard" in m for m in msgs),
                       "bitwise": every_field_bitwise(resumed, v8)}
        check(out["kill"]["orphan_warned"] and all(out["kill"]["bitwise"].values()),
              f"dist_ckpt_config5: kill and resume {out['kill']}")
        _remove_prefix(tmp, "kill.npz")
        del resumed

        # (c) torn shards on (a)'s checkpoint
        torn_shard(p8, 0, "segment")
        torn, msgs = caught(lambda: fit(checkpoint_path=p8))
        n_kept = cfg.n_samples - cfg.n_burn_in
        out["torn_segment"] = {
            "resampled_warned": any("re-sampled" in m for m in msgs),
            "finite": bool(torch.isfinite(torn.subset_results.param_samples).all()),
            "kept": n_kept}
        check(out["torn_segment"]["resampled_warned"] and out["torn_segment"]["finite"],
              f"dist_ckpt_config5: torn segment {out['torn_segment']}")
        del torn
        torn_shard(p8, 0, "state")
        try:
            fit(checkpoint_path=p8)
            raise AssertionError("dist_ckpt_config5: a torn state shard resumed")
        except ValueError as e:
            out["torn_state_error"] = str(e)[:200]
            check("shard:0" in str(e), f"dist_ckpt_config5: torn state error {e}")
        _remove_prefix(tmp, "v8.npz")

        # (d) stopped after three generations, re-split, elastic resume
        pe = os.path.join(tmp, "elastic.npz")
        progress, kill = kill_after(3)
        try:
            fit(checkpoint_path=pe, progress=progress)
            raise AssertionError("dist_ckpt_config5: the stop did not stop the fit")
        except kill:
            pass
        check(generation(pe) == 3, f"dist_ckpt_config5: stopped at {generation(pe)}")
        resplit_shards(pe, [[0, MAIN_K // 2], [MAIN_K // 2, MAIN_K]])
        dck.FORCE_DISTRIBUTED_FOR_TESTING = False
        t0 = time.perf_counter()
        elastic, msgs = caught(lambda: fit(checkpoint_path=pe))
        out["elastic"] = {"resume_s": time.perf_counter() - t0,
                          "warned": any("elastic resume" in m for m in msgs),
                          "bitwise": every_field_bitwise(elastic, v8)}
        check(out["elastic"]["warned"] and all(out["elastic"]["bitwise"].values()),
              f"dist_ckpt_config5: elastic resume {out['elastic']}")
        _remove_prefix(tmp, "elastic.npz")
    finally:
        dck.FORCE_DISTRIBUTED_FOR_TESTING = False
        D.destroy_distributed()
    emit(out)
    return out


def data_csv_config4(device, tmp):
    """The CSV edge at config4's size: the eBird proxy (65,600 rows)
    written with write_presence_absence_csv and loaded back with
    load_presence_absence_csv (seconds, rows/s), then fitted with the
    config4 production sampler (logit, phi every 8th) for 16 sweeps on the
    card, launches == build_calls; then count_subset_factorizations on a
    K = 4, m = 200 problem on the card: its n_chol equal to the
    FactorCache counter of the same sweeps run by hand, and to the count
    on the CPU; its launches the sweeps' build calls."""
    import os

    import numpy as np
    import torch
    from smk_torch import fit_meta_kriging
    from smk_torch.data.ebird import (load_presence_absence_csv, make_ebird_proxy,
                                      write_presence_absence_csv)
    from smk_torch.data.synthetic import tiny_binary_problem
    from smk_torch.models.probit_gp import SpatialGPSampler, build_calls, chunk_build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel.executor import (count_subset_factorizations, init_subset_states,
                                             stacked_subset_data)
    from smk_torch.parallel.partition import random_partition

    n = C4_K * C4_M
    d = make_ebird_proxy(n=n + C4_T)
    path = os.path.join(tmp, "ebird.csv")
    t0 = time.perf_counter()
    write_presence_absence_csv(path, d)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_presence_absence_csv(path, list(d.species_names),
                                     covariate_cols=("effort", "elevation"))
    load_s = time.perf_counter() - t0
    rows = back.y.shape[0]
    check(rows == n + C4_T and np.array_equal(back.y, d.y) and back.x.shape == d.x.shape,
          f"data_csv_config4: loaded {back.y.shape}")
    out = {"phase": "data_csv_config4", "rows": rows, "file_bytes": os.path.getsize(path),
           "write_s": write_s, "load_s": load_s, "load_rows_per_s": rows / load_s}
    os.remove(path)
    cfg = production_config(k=C4_K, n_samples=16, link="logit", phi_every=8)
    fb.reset_counts()
    t0 = time.perf_counter()
    res = fit_meta_kriging(back.y[:n], back.x[:n], back.coords[:n], back.coords[n:],
                           back.x[n:], config=cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    out["fit_wall_s"] = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    layouts = launches_by_kernel()
    want = build_calls(cfg, C4_Q, cfg.n_samples, cfg.n_burn_in)
    check(launches == want, f"data_csv_config4: launches {launches} != {want}")
    check(layouts == expected_by_kernel(want), f"data_csv_config4: by kernel {layouts}")
    for f in ("p_quant", "param_grid", "w_grid"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"data_csv_config4: non-finite {f}")
    out.update(launches=launches, launches_expected=want, launches_by_kernel=layouts,
               phase_seconds=res.phase_seconds)
    del res
    # count_subset_factorizations, K = 4, m = 200, 8 sweeps of the default sampler
    y, x, coords, ct, xt = tiny_binary_problem(seed=3, n=800, t=16)
    ccfg = production_config(k=4, n_samples=16, phi_every=2, rank=32)
    counted = {}
    for dev in (device, torch.device("cpu")):
        perm = torch.randperm(800, generator=torch.Generator().manual_seed(0)).to(dev)
        part = random_partition(perm, *(torch.as_tensor(a, device=dev) for a in (y, x, coords)),
                                4)
        ctd, xtd = torch.as_tensor(ct, device=dev), torch.as_tensor(xt, device=dev)
        model = SpatialGPSampler(ccfg)
        fb.reset_counts()
        acc, (n_chol, n_calls) = count_subset_factorizations(model, part, ctd, xtd, n_iters=8,
                                                            with_calls=True)
        counted[dev.type] = {"n_chol": n_chol.tolist(), "n_chol_calls": n_calls.tolist(),
                             "launches": dict(fb.LAUNCHES),
                             "plain_calls": sum(fb.PLAIN_CALLS.values())}
        # the same sweeps by hand: the FactorCache's own counter
        data = stacked_subset_data(part, ctd, xtd)
        consts = model._consts(data)
        state = init_subset_states(model, data, None, consts)
        noise = model.default_noise(data)
        cache = model._solve_cache(consts, data.mask, state)
        for i in range(8):
            state, cache, _ = model._gibbs_step(data, consts, state, cache, i, noise(i, False),
                                                collect=False)
        counted[dev.type]["factor_cache"] = [cache.n_chol, cache.n_chol_calls]
    card = counted[device.type]
    check(card["n_chol"] == [card["factor_cache"][0]] * 4
          and card["n_chol_calls"] == [card["factor_cache"][1]] * 4,
          f"data_csv_config4: count_subset_factorizations {card}")
    check(card["n_chol"] == counted["cpu"]["n_chol"]
          and card["n_chol_calls"] == counted["cpu"]["n_chol_calls"],
          f"data_csv_config4: card {card} vs CPU {counted['cpu']}")
    step = chunk_build_calls(ccfg, 1, "burn", 0, 8)
    step["fused_masked_correlation_stack"] += 1  # R~ at init
    check(card["launches"] == step and card["plain_calls"] == 0,
          f"data_csv_config4: count launches {card['launches']} != {step}")
    out["count_subset_factorizations"] = counted
    emit(out)
    return out


ANALYSIS_SAMPLES, ANALYSIS_CHUNK = 32, 16


def _analysis_setup(cfg, c5_data, device):
    """config5's partition, test sites and warm start, as sampler_setup
    builds them (TorchRandomness(SEED)), for fits that share one model."""
    import torch
    from smk_torch.api import TorchRandomness, stacked_design
    from smk_torch.ops.glm import glm_warm_start
    from smk_torch.parallel.partition import random_partition

    y, x, coords, ct, xt = (torch.as_tensor(a, device=device, dtype=torch.float32)
                            for a in c5_data)
    n, q = y.shape
    rng = TorchRandomness(SEED, device, torch.float32)
    part = random_partition(rng.permutation(n).to(device), y, x, coords, cfg.n_subsets)
    y_long, x_long = stacked_design(y, x)
    beta0 = glm_warm_start(y_long, x_long, link=cfg.link).coef.reshape(q, x.shape[-1])
    return part, ct, xt, beta0


def analysis_config5(device, c5_data, tmp):
    """The analysis layer on the card at config5's full width (K = 32,
    m = 3906): the production sampler with fault_policy="quarantine",
    chunk_pipeline="overlap", nan_guard, 32 sweeps (16 burn-in) in
    chunks of 16, a checkpoint in ``tmp``, all fits on one model (its L1
    table of captured programs):

    (a) a cold fit, unguarded;
    (b) the model's second fit under recompile_guard(0) and
        transfer_guard_strict() (torch's sync debug mode "error"): no
        error, 0 nvcc runs and 0 captures, the ledger's tags, counts,
        bytes and directions, draws bitwise (a)'s in every field, launches
        == build_calls; before it the same warm fit unguarded (the walls'
        baseline) and under the logging mode ("warn"), its synchronising
        calls outside the ledger by line (none expected);
    (c) both guards provoked: a fit at a chunk length the model has not
        seen (8) raises RecompileError with a count > 0, and a lone
        .item() inside transfer_guard_strict() raises;
    (d) the port's smklint over smk_torch/, chip_smoke.py and
        scripts/torch_*.py: 0 findings, and its seconds."""
    import collections
    import glob
    import traceback
    import warnings

    import torch
    from smk_torch.analysis.engine import lint_paths
    from smk_torch.analysis.sanitizers import (RecompileError, recompile_guard,
                                               transfer_guard_strict)
    from smk_torch.models import probit_gp as tp
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import cuda_build
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import recovery as rec

    cfg = production_config(k=MAIN_K, n_samples=ANALYSIS_SAMPLES, phi_every=16,
                            burn_in_frac=0.5, fault_policy="quarantine",
                            chunk_pipeline="overlap")
    part, ct, xt, beta0 = _analysis_setup(cfg, c5_data, device)
    model = tp.SpatialGPSampler(cfg)
    out = {"phase": "analysis_config5", "K": MAIN_K, "m": MAIN_M, "n_samples": cfg.n_samples,
           "n_burn_in": cfg.n_burn_in, "chunk_iters": ANALYSIS_CHUNK,
           "fault_policy": cfg.fault_policy, "chunk_pipeline": cfg.chunk_pipeline}

    def fit(label, chunk_iters=ANALYSIS_CHUNK, **kw):
        noise = model.default_noise(rec.stacked_subset_data(part, ct, xt), seed=SEED)
        path = os.path.join(tmp, f"analysis_{label}.npz")
        t0 = time.perf_counter()
        res = rec.fit_subsets_chunked(model, part, ct, xt, noise, beta0,
                                      chunk_iters=chunk_iters, checkpoint_path=path,
                                      nan_guard=True, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    fb.reset_counts()
    cold, out["cold_wall_s"] = fit("a")
    out["cold_captures"] = sum(1 for p in model.__dict__.get("_program_l1", {}).values()
                               if getattr(p, "captures", False))
    # a warm fit with no guard: the baseline of the two guarded passes' walls
    plain, out["plain_warm_wall_s"] = fit("b_plain")
    # the warm fit under the logging mode: any synchronising call that
    # the ledger does not sanction, by line (torch warns at each call;
    # its one-time notice that the mode is a prototype is not a call)
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if "smk_torch" in f.filename]
        where = (f"{os.path.relpath(ours[-1].filename)}:{ours[-1].lineno} ({ours[-1].name})"
                 if ours else f"{os.path.basename(filename)}:{lineno}")
        sites[where] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        with transfer_guard_strict(d2h="log", h2d="log") as log_ledger:
            logged, out["logged_wall_s"] = fit("b_log")
    out["logged_untagged_syncs"] = dict(sites.most_common())
    check(not sites, f"analysis config5: synchronising calls outside the ledger {dict(sites)}")
    nvcc_before = sum(cuda_build.NVCC_RUNS.values())
    fb.reset_counts()
    with recompile_guard(0, label="analysis_config5 warm fit") as guard:
        with transfer_guard_strict() as ledger:
            check(torch.cuda.get_sync_debug_mode() == 2,
                  "analysis config5: the sync debug mode is not armed")
            warm, out["warm_wall_s"] = fit("b")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "analysis config5: the sync debug mode was not restored")
    launches = dict(fb.LAUNCHES)
    want = build_calls(cfg, 1, cfg.n_samples, cfg.n_burn_in, chunk_iters=ANALYSIS_CHUNK)
    check(launches == want, f"analysis config5: warm launches {launches} != {want}")
    check(sum(fb.PLAIN_CALLS.values()) == 0, "analysis config5: a plain build ran on the card")
    out.update(warm_compiles=guard.compiles,
               warm_nvcc_runs=sum(cuda_build.NVCC_RUNS.values()) - nvcc_before,
               ledger=ledger_report(ledger), ledger_log_pass=ledger_report(log_ledger),
               launches=launches, launches_expected=want,
               launches_by_kernel=launches_by_kernel())
    check(guard.compiles == 0 and out["warm_nvcc_runs"] == 0,
          f"analysis config5: the warm fit had {guard.compiles} compile events, "
          f"{out['warm_nvcc_runs']} nvcc runs")
    check(ledger.tags >= {"run_identity", "chunk_stats", "host_snapshot"},
          f"analysis config5: ledger tags {ledger.tags}")
    n_chunks = cfg.n_samples // ANALYSIS_CHUNK
    check(ledger.count("chunk_stats") == n_chunks,
          f"analysis config5: {ledger.count('chunk_stats')} chunk_stats fetches")
    def fields_same(u, v):
        return {f: (a is None and b is None) or same_bits(a, b)
                for f, a, b in zip(u._fields, u, v)}

    same, same_log = fields_same(cold, warm), fields_same(cold, logged)
    out["warm_equals_cold"], out["logged_equals_cold"] = same, same_log
    out["plain_warm_equals_cold"] = fields_same(cold, plain)
    check(all(same.values()) and all(same_log.values())
          and all(out["plain_warm_equals_cold"].values()),
          f"analysis config5: guarded draws differ {same} {same_log}")
    del cold, warm, logged, plain
    for f in glob.glob(os.path.join(tmp, "analysis_*")):
        os.remove(f)
    # (c) both guards, provoked
    try:
        with recompile_guard(0, label="unseen chunk length"):
            fit("c8", chunk_iters=8, stop_after_chunks=1)
        out["recompile_raised"] = None
    except RecompileError as e:
        out["recompile_raised"] = {"compiles": e.compiles}
    check(out["recompile_raised"] is not None and out["recompile_raised"]["compiles"] > 0,
          f"analysis config5: the unseen chunk length did not raise {out['recompile_raised']}")
    try:
        with transfer_guard_strict():
            torch.ones(4, device=device).sum().item()
        out["item_raised"] = None
    except RuntimeError as e:
        out["item_raised"] = str(e).splitlines()[0][:160]
    check(out["item_raised"] is not None, "analysis config5: a lone .item() did not raise")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "analysis config5: the sync debug mode was not restored after the raise")
    for f in glob.glob(os.path.join(tmp, "analysis_*")):
        os.remove(f)
    # (d) the port's lint over its own tree
    root = os.path.dirname(os.path.abspath(__file__))
    targets = [os.path.join(root, "smk_torch"), os.path.join(root, "chip_smoke.py")] + sorted(
        glob.glob(os.path.join(root, "scripts", "torch_*.py")))
    t0 = time.perf_counter()
    findings = lint_paths(targets, repo_root=root)
    out["lint"] = {"n_files_targets": len(targets), "findings": [f.render() for f in findings],
                   "seconds": time.perf_counter() - t0}
    check(not findings, f"analysis config5: smklint findings {out['lint']['findings']}")
    out["nvidia_smi"] = nvidia_smi_line()
    emit(out)
    return out


def ledger_report(ledger) -> dict:
    """Per tag of a TransferLedger: its count, bytes and directions."""
    rows = {}
    for (tag, _), direction in zip(ledger.entries, ledger.directions):
        rows.setdefault(tag, set()).add(direction)
    return {tag: {"count": ledger.count(tag), "bytes": ledger.bytes_for(tag),
                  "directions": sorted(dirs)} for tag, dirs in sorted(rows.items())}


def _adaptive_fields(res) -> dict:
    """The fields an adaptive fit is held bitwise on, copied to the host
    (a later phase compares against them)."""
    out = {f: getattr(res, f).detach().cpu()
           for f in ("param_grid", "w_grid", "p_quant", "param_quant", "sample_par")}
    out.update({f: getattr(res.subset_results, f).detach().cpu()
                for f in ("param_samples", "w_samples", "phi_accept_rate")})
    return out


def adaptive_mesh_config5(device, c5_data, ad5, tmp):
    """fit_adaptive_config5's adaptive run (c) repeated on make_mesh(1):
    draws and frozen_at bitwise the unmeshed run's (kept by
    fit_adaptive_config5), launches == its dispatched chunks', and one
    adaptive_mesh_replan event with entries 1 per compaction of a live
    group; then the K = 8, m = 200 case of fit_adaptive_small (where
    compactions happen) unmeshed and on make_mesh(1), the same checks."""
    import glob

    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.models import probit_gp as tp
    from smk_torch.models.probit_gp import dispatched_build_calls
    from smk_torch.obs.reporter import read_jsonl
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import recovery as rec
    from smk_torch.parallel.executor import make_mesh
    from smk_torch.utils.tracing import ChunkPipelineStats

    def events(path, name):
        return [r["attrs"] for r in read_jsonl(path)
                if r.get("kind") == "event" and r.get("name") == name]

    mesh = make_mesh(1)
    out = {"phase": "adaptive_mesh_config5", "mesh": repr(mesh), "K": MAIN_K, "m": MAIN_M,
           "n_samples": ADAPT_SAMPLES, "chunk_iters": ADAPT_CHUNK}
    ref = ad5["c_result"]
    log_dir = os.path.join(tmp, "log_c_adaptive_mesh")
    cfg = adaptive_config(k=MAIN_K, n_samples=ADAPT_SAMPLES, n_chains=2, adaptive=True,
                          live=True, run_log_dir=log_dir)
    stats = ChunkPipelineStats()
    fb.reset_counts()
    t0 = time.perf_counter()
    res = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                           chunk_iters=ADAPT_CHUNK, pipeline_stats=stats, mesh=mesh)
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    want = dispatched_build_calls(cfg, 1, stats.chunks, entries=mesh.size)
    check(launches == want, f"adaptive mesh config5: launches {launches} != {want}")
    same = {f: same_bits(v, ref["fields"][f]) for f, v in _adaptive_fields(res).items()}
    out["bitwise_unmeshed"] = same
    out["frozen_at"] = list(stats.adaptive["frozen_at"])
    check(all(same.values()) and out["frozen_at"] == ref["frozen_at"],
          f"adaptive mesh config5: not bitwise the unmeshed run {same}")
    comp = [e for e in events(res.run_log_path, "adaptive_compaction") if e["n_active"] > 0]
    replan = events(res.run_log_path, "adaptive_mesh_replan")
    out["compactions"], out["replans"] = len(comp), replan
    check(len(replan) == len(comp) and all(e["entries"] == 1 for e in replan),
          f"adaptive mesh config5: replans {replan} for {len(comp)} compactions")
    out.update(launches=launches, launches_expected=want,
               launches_by_kernel=launches_by_kernel())
    del res
    # a case with compactions: fit_adaptive_small's K = 8, m = 200
    knobs = dict(n_samples=80, burn_in_frac=0.5, live_diagnostics=True, adaptive_schedule="on",
                 target_rhat=1.5, target_ess=8.0, adapt_patience=1, min_samples_before_stop=8,
                 adapt_max_extra_frac=0.5, n_chains=2, fused_build="pallas")
    part, ct, xt = _small_problem(1600, 8, device)
    small = {}
    for leg, m in (("unmeshed", None), ("meshed", mesh)):
        cfg_s = SMKConfig(n_subsets=8, run_log_dir=os.path.join(tmp, f"log_small_{leg}"), **knobs)
        model = tp.SpatialGPSampler(cfg_s)
        st = ChunkPipelineStats()
        noise = model.default_noise(rec.stacked_subset_data(part, ct, xt), seed=SEED)
        r = rec.fit_subsets_chunked(model, part, ct, xt, noise, chunk_iters=10,
                                    pipeline_stats=st, mesh=m)
        (log,) = glob.glob(os.path.join(cfg_s.run_log_dir, "*.jsonl"))
        small[leg] = (r, st, log)
    (ru, su, _), (rm, sm, log_m) = small["unmeshed"], small["meshed"]
    same_s = {f: (a is None and b is None) or same_bits(a, b)
              for f, a, b in zip(ru._fields, ru, rm)}
    comp_s = [e for e in events(log_m, "adaptive_compaction") if e["n_active"] > 0]
    replan_s = events(log_m, "adaptive_mesh_replan")
    out["small"] = {"K": 8, "m": 200, "bitwise_unmeshed": same_s,
                    "frozen_at": list(sm.adaptive["frozen_at"]),
                    "rungs": sorted({ch.get("kc") for ch in sm.chunks if "kc" in ch}),
                    "compactions": len(comp_s), "replans": replan_s}
    check(all(same_s.values()) and sm.adaptive["frozen_at"] == su.adaptive["frozen_at"],
          f"adaptive mesh small: not bitwise the unmeshed run {same_s}")
    check(len(comp_s) >= 1 and len(replan_s) == len(comp_s)
          and all(e["entries"] == 1 for e in replan_s),
          f"adaptive mesh small: replans {replan_s} for {len(comp_s)} compactions")
    out["nvidia_smi"] = nvidia_smi_line()
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 33f: r_frontend_config4 (r/meta_kriging_torch.R replayed)
# ----------------------------------------------------------------------
def _r_aperm(mats):
    """R's aperm(simplify2array(list of q n x p matrices), c(1, 3, 2)):
    the (n, q, p) stack."""
    import numpy as np

    return np.transpose(np.stack(mats, axis=-1), (0, 2, 1))


def _r_to_r(a):
    """The R file's .smk.to_r: a tensor comes home from its device."""
    import numpy as np

    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "cpu") else a)


def r_meta_kriging_binary(y, x, coords, coords_test, x_test, *, n_core, n_samples, link,
                          fused_build, seed, config_overrides, backend="gpu"):
    """meta_kriging_binary of r/meta_kriging_torch.R, step for step, at
    the R defaults of every argument not given: the layout conversions
    (y a list of q vectors, x and x_test lists of q (n, p) matrices), the
    modifyList config merge, the fit call's keywords (``seed`` an
    integer, ``device`` the backend's), and the returned list. Returns
    (the R list as a dict, the config, the Python result)."""
    import numpy as np
    import smk_torch as smk

    y_arr = np.column_stack([np.asarray(v, np.float64) for v in y])
    x_arr, xt_arr = _r_aperm(x), _r_aperm(x_test)
    cfg_args = dict(
        n_subsets=int(n_core), n_samples=int(n_samples), burn_in_frac=0.75,
        cov_model="exponential", combiner="wasserstein_mean", link=link, phi_proposals=1,
        phi_proposal_family="gaussian", fused_build=fused_build, subset_engine="dense",
        n_neighbors=16, build_dtype="float32", partition_method="random", bucket_ladder=None,
        chunk_pipeline="sync", adaptive_schedule="off", target_rhat=1.05, target_ess=100.0,
        adapt_max_extra_frac=0.5, fault_policy="abort", fault_max_retries=2, watchdog=False,
        dist_init_timeout_s=120.0, ckpt_commit_timeout_s=120.0, compile_store_dir=None,
        run_log_dir=None, priors=smk.PriorConfig(a_prior="invwishart"))
    cfg = smk.SMKConfig(**{**cfg_args, **config_overrides})
    res = smk.fit_meta_kriging(
        *(np.asarray(a, np.float32) for a in (y_arr, x_arr, coords, coords_test, xt_arr)),
        config=cfg, weight=1, seed=int(seed), device="cuda" if backend == "gpu" else "cpu")
    out = {name: _r_to_r(getattr(res, f)) for name, f in (
        ("result", "param_grid"), ("result2", "w_grid"), ("SamplePar", "sample_par"),
        ("Samplew", "sample_w"), ("p.sample", "p_samples"), ("param.quant", "param_quant"),
        ("w.quant", "w_quant"), ("p.quant", "p_quant"), ("phi.accept", "phi_accept_rate"),
        ("ess", "param_ess"), ("rhat", "param_rhat"), ("w.ess", "w_ess"),
        ("w.rhat", "w_rhat"))}
    from smk_torch.api import param_names

    out.update({"ess.per.sec": res.latent_ess_per_sec, "phases": dict(res.phase_seconds),
                "param.names": param_names(len(y), x[0].shape[1])})
    return out, cfg, res


def r_frontend_config4(device, c4_data, tmp):
    """The eBird user at config4 (bench.py:2666-2674: n = 65,536 + 64,
    K = 64, m = 1024, q = 2, p = 3, logit) driving the port through
    r/meta_kriging_torch.R with backend = "gpu", the production sampler
    through config.overrides, 32 sweeps. No R runtime runs here: each
    call is replayed with the R file's conversions and keywords
    (r_meta_kriging_binary; the live calls inline).

    1. meta_kriging_binary: bitwise a direct fit_meta_kriging of the same
       seed and config (every result field), its config equal to the
       direct one, launches == build_calls, every output finite.
    2. smk.live.fit (coherent, the same knobs; generation 0),
       smk.ingest of 256 rows into subset 0 (copies of its own sites,
       fresh y and x), smk.refit (dirty: subset 0 alone, generation 1,
       launches == one refit group's build_calls) and smk.predict.serve
       of 32 rows on generation 1's artifact (0 build launches, finite,
       p in [0, 1]).
    Each call's wall and launches."""
    import dataclasses

    import numpy as np
    import torch
    from smk_torch import SMKConfig, fit_meta_kriging
    from smk_torch.models.probit_gp import build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.serve import LiveFit, PredictionEngine, generation_artifact_name

    y, x, coords, ct, xt = c4_data
    y_l = [np.asarray(y[:, j], np.float64) for j in range(C4_Q)]
    x_l = [np.asarray(x[:, j, :], np.float64) for j in range(C4_Q)]
    xt_l = [np.asarray(xt[:, j, :], np.float64) for j in range(C4_Q)]
    prod = production_config(k=C4_K, n_samples=32, link="logit", phi_every=8)
    overrides = {f: getattr(prod, f) for f in (
        "phi_sampler", "phi_update_every", "u_solver", "cg_precond", "cg_precond_rank",
        "cg_iters", "cg_matvec_dtype", "trisolve_block_size")}
    out = {"phase": "r_frontend_config4", "n": y.shape[0], "K": C4_K, "q": C4_Q, "p": C4_P,
           "t": C4_T, "n_samples": 32, "config_overrides": overrides}
    walls, launches = {}, {}

    backend = "gpu" if device.type == "cuda" else "cpu"  # "cpu": a rehearsal off the card

    def timed(name, fn):
        fb.reset_counts()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = dict(fb.LAUNCHES)
        return got

    r_out, cfg, res = timed("meta_kriging_binary", lambda: r_meta_kriging_binary(
        y_l, x_l, coords, ct, xt_l, n_core=C4_K, n_samples=32, link="logit",
        fused_build="pallas", seed=SEED, config_overrides=overrides, backend=backend))
    by_kernel = launches_by_kernel()
    direct_cfg = dataclasses.replace(prod, burn_in_frac=0.75)
    check(cfg == direct_cfg, f"r_frontend: the R call's config differs {cfg} {direct_cfg}")
    want = build_calls(cfg, C4_Q, cfg.n_samples, cfg.n_burn_in)
    check(launches["meta_kriging_binary"] == want,
          f"r_frontend: launches {launches['meta_kriging_binary']} != {want}")
    direct = timed("direct_fit", lambda: fit_meta_kriging(
        *(np.asarray(a, np.float32) for a in c4_data), config=direct_cfg, weight=1, seed=SEED,
        device=device))
    same = every_field_bitwise(res, direct)
    out["bitwise_direct"] = same
    check(all(same.values()), f"r_frontend: the R call is not bitwise the direct fit {same}")
    check(all(np.isfinite(v).all() for k, v in r_out.items()
              if isinstance(v, np.ndarray) and k not in ("rhat", "w.rhat")),
          "r_frontend: a non-finite output")
    check(r_out["param.names"][0] == "beta[0,0]" and len(r_out["param.names"]) ==
          r_out["result"].shape[1], "r_frontend: param.names")
    r_launches, r_by_kernel = launches["meta_kriging_binary"], by_kernel
    del res, direct
    # the live loop from R: smk.live.fit (its config: the R function's
    # keywords, the production knobs and fused.build through
    # config.overrides), smk.ingest, smk.refit, smk.predict.serve
    gen_dir = os.path.join(tmp, "r_frontend_config4")
    live_cfg = SMKConfig(**{**dict(
        n_subsets=C4_K, n_samples=32, burn_in_frac=0.75, cov_model="exponential",
        combiner="wasserstein_mean", link="logit", partition_method="coherent",
        bucket_ladder=None, run_log_dir=None), **overrides, "fused_build": "pallas"})
    live = LiveFit(gen_dir, config=live_cfg, coords_test=np.asarray(ct, np.float64),
                   x_test=_r_aperm(xt_l).astype(np.float64), weight=1, device=device)
    manifest = timed("smk.live.fit", lambda: live.fit(
        SEED, np.column_stack(y_l), _r_aperm(x_l), np.asarray(coords, np.float64)))
    check(manifest["generation"] == 0, f"r_frontend: live fit {manifest}")
    own = np.asarray(live._assignments[0][:INGEST_ROWS], np.int64)
    nrng = np.random.default_rng(SEED)
    y_new = [nrng.integers(0, 2, size=len(own)).astype(np.float64) for _ in range(C4_Q)]
    x_new = [nrng.normal(size=(len(own), C4_P)) for _ in range(C4_Q)]
    receipt = timed("smk.ingest", lambda: live.ingest(
        np.column_stack(y_new), coords_new=np.asarray(live._coords[own], np.float64),
        x_new=_r_aperm(x_new)))
    check(receipt.dirty_subsets == (0,) and receipt.generation == 0,
          f"r_frontend: ingest {receipt}")
    report = timed("smk.refit", lambda: live.refit(1, full=False))
    check(report.generation == 1 and report.refit_subsets == (0,) and not report.skipped,
          f"r_frontend: refit {report}")
    want_refit = build_calls(live_cfg, C4_Q, live_cfg.n_samples, live_cfg.n_burn_in,
                             chunk_iters=live.chunk_iters or 500)
    check(launches["smk.refit"] == want_refit,
          f"r_frontend: refit launches {launches['smk.refit']} != {want_refit}")
    art = os.path.join(gen_dir, generation_artifact_name(report.generation))
    rows = np.random.default_rng(SEED + 17).choice(y.shape[0], SERVE_ROWS, replace=False)
    eng = timed("engine", lambda: PredictionEngine(art, device=device))
    resp = timed("smk.predict.serve", lambda: eng.predict(
        np.asarray(coords[rows], np.float32),
        _r_aperm([np.asarray(x[rows, j, :]) for j in range(C4_Q)]).astype(np.float32),
        seed=0))
    pq = _r_to_r(resp.p_quant)
    check(pq.shape == (3, SERVE_ROWS, C4_Q) and np.isfinite(pq).all()
          and ((pq >= 0) & (pq <= 1)).all() and not resp.rows_degraded.any(),
          "r_frontend: serve response")
    check(sum(launches["smk.predict.serve"].values()) == 0,
          f"r_frontend: serving launched builds {launches['smk.predict.serve']}")
    out.update(backend=backend, walls_s=walls, launches_by_call=launches, launches=r_launches,
               launches_expected=want, launches_by_kernel=r_by_kernel,
               refit={"generation": report.generation, "refit_subsets": list(report.refit_subsets),
                      "refit_wall_s": report.refit_wall_s},
               serve={"latency_s": resp.latency_s, "buckets": list(resp.buckets)},
               nvidia_smi=nvidia_smi_line())
    del eng, live
    emit(out)
    return out


# ----------------------------------------------------------------------
# phase 33g: adaptive_dist_config5 (the adaptive schedule in a process group)
# ----------------------------------------------------------------------
def adaptive_dist_config5(device, c5_data, ad5, tmp):
    """fit_adaptive_config5's adaptive run (c) over make_mesh() of a real
    NCCL process group of one (dist_world_of_one's recipe): each sampling
    boundary's statistics are gathered over the group before the
    scheduler folds them. Bitwise the unmeshed (c) in every held field,
    frozen_at, chunks_saved_frac and extra_granted equal; launches ==
    its dispatched chunks'; one gather a sampling boundary, their count
    and median ms."""
    import warnings

    import torch
    import torch.distributed as tdist
    from smk_torch import fit_meta_kriging
    from smk_torch.models.probit_gp import dispatched_build_calls
    from smk_torch.ops import fused_build as fb
    from smk_torch.parallel import distributed as D
    from smk_torch.parallel.executor import make_mesh
    from smk_torch.testing.faults import flaky_coordinator
    from smk_torch.utils.tracing import ChunkPipelineStats

    ref = ad5["c_result"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with flaky_coordinator(2, passthrough=True) as ctr:
            D.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=1, process_id=0,
                               device=device, backoff_s=0.01, timeout_s=60.0)
    try:
        check(D.backend_name() == "nccl", f"adaptive_dist: backend {D.backend_name()}")
        mesh = make_mesh(device=device)
        cfg = adaptive_config(k=MAIN_K, n_samples=ADAPT_SAMPLES, n_chains=2, adaptive=True,
                              live=True, run_log_dir=os.path.join(tmp, "log_c_adaptive_dist"))
        stats = ChunkPipelineStats()
        fb.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit_meta_kriging(*c5_data, config=cfg, seed=SEED, device=device,
                               chunk_iters=ADAPT_CHUNK, pipeline_stats=stats, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        D.destroy_distributed()
    check(not tdist.is_initialized(), "adaptive_dist: the process group survived")
    launches = dict(fb.LAUNCHES)
    want = dispatched_build_calls(cfg, 1, stats.chunks, entries=len(mesh.local_entries()))
    check(launches == want, f"adaptive_dist: launches {launches} != {want}")
    ad = stats.adaptive
    same = {f: same_bits(v, ref["fields"][f]) for f, v in _adaptive_fields(res).items()}
    check(all(same.values()) and list(ad["frozen_at"]) == ref["frozen_at"]
          and ad["chunks_saved_frac"] == ref["chunks_saved_frac"]
          and ad["extra_granted"] == ref["extra_granted"],
          f"adaptive_dist: not bitwise the unmeshed (c) {same}")
    gathers = ad.get("decision_gather_s", [])
    consults = sum(1 for ch in stats.chunks if ch["phase"] in ("sample", "extra"))
    check(len(gathers) >= 1 and len(gathers) == consults,
          f"adaptive_dist: {len(gathers)} gathers for {consults} sampling boundaries")
    out = {"phase": "adaptive_dist_config5", "mesh": repr(mesh), "init_calls": ctr["calls"],
           "K": MAIN_K, "m": MAIN_M, "n_samples": ADAPT_SAMPLES, "chunk_iters": ADAPT_CHUNK,
           "wall_s": wall, "bitwise_unmeshed": same, "frozen_at": list(ad["frozen_at"]),
           "chunks_saved_frac": ad["chunks_saved_frac"], "extra_granted": ad["extra_granted"],
           "decision_gathers": len(gathers),
           "decision_gather_ms_median": statistics.median(gathers) * 1e3,
           "decision_gather_ms_max": max(gathers) * 1e3,
           "launches": launches, "launches_expected": want,
           "launches_by_kernel": launches_by_kernel(), "nvidia_smi": nvidia_smi_line()}
    emit(out)
    return out


def sharded_chol(device):
    """parallel/sharded_chol on the 1-entry mesh: a (3906, 3906) fp32 SPD
    matrix (an exponential correlation at phi = 6 plus 1e-3 I on config5's
    coordinates) factored by sharded_cholesky(block 512) and by
    ops/chol.blocked_cholesky(block 512): the factors' difference, both
    residuals ||L L^T - A|| / ||A||, both device times (CUDA events,
    median of 5); sharded_matvec against A @ v."""
    import torch
    from smk_torch.ops.chol import blocked_cholesky
    from smk_torch.parallel.executor import make_mesh
    from smk_torch.parallel.sharded_chol import sharded_cholesky, sharded_matvec

    g = torch.Generator(device="cpu").manual_seed(SEED)
    coords = torch.rand((MAIN_M, 2), generator=g).to(device)
    a = torch.exp(-6.0 * torch.cdist(coords, coords)) + 1e-3 * torch.eye(MAIN_M, device=device)
    mesh = make_mesh(1)
    got = sharded_cholesky(a, mesh, block_size=512)
    l_sh = got.gather()
    l_bl = blocked_cholesky(a, 0.0, 512)

    def resid(lf):
        return float(torch.linalg.norm(lf @ lf.T - a) / torch.linalg.norm(a))

    diff = float((l_sh - l_bl).abs().max())
    r_sh, r_bl = resid(l_sh), resid(l_bl)
    check(bool(torch.isfinite(l_sh).all()) and r_sh < 1e-5 and diff < 1e-3,
          f"sharded_chol: residual {r_sh}, diff {diff}")
    ms_sh = ms_median(lambda: sharded_cholesky(a, mesh, block_size=512), reps=5, warmup=1,
                      device_only=True)
    ms_bl = ms_median(lambda: blocked_cholesky(a, 0.0, 512), reps=5, warmup=1,
                      device_only=True)
    v = torch.randn(MAIN_M, generator=g).to(device)
    mv = sharded_matvec(a, v, mesh).gather()
    mv_err = float((mv - a @ v).abs().max())
    check(mv_err < 1e-3, f"sharded_chol: matvec error {mv_err}")
    out = {"phase": "sharded_chol", "m": MAIN_M, "block": 512, "mesh": repr(mesh),
           "bitwise_blocked": bool(torch.equal(l_sh, l_bl)), "max_abs_diff": diff,
           "residual_sharded": r_sh, "residual_blocked": r_bl, "sharded_ms": ms_sh,
           "blocked_ms": ms_bl, "matvec_max_abs_err": mv_err}
    emit(out)
    return out


def thread_launch(device):
    """The kernel launched from a worker thread (its own current device
    and stream, set there and not by the caller) against the same call
    on the main thread, bitwise: the wrapper enters the output's device
    itself (ops/fused_build._launch). Launches made here are checks and
    are not counted for any path."""
    import threading

    import torch
    from smk_torch.ops import fused_build as fb

    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    coords = torch.rand((4, 1024, 2), generator=g).to(device)
    phis = torch.full((4, 1), 6.0, device=device)
    mask = (torch.rand((4, 1024), generator=g) > 0.1).float().to(device)
    before = fb.count_snapshot()
    main = fb.fused_masked_correlation_stack(coords, phis, mask, "exponential")
    cross = fb.fused_cross_correlation(coords, coords[:, :64], phis, "exponential")
    box = {}

    def worker():
        try:
            torch.cuda.set_device(torch.cuda.device_count() - 1)
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                box["sym"] = fb.fused_masked_correlation_stack(coords, phis, mask,
                                                               "exponential")
                box["narrow"] = fb.fused_cross_correlation(coords, coords[:, :64], phis,
                                                           "exponential")
            s.synchronize()
        except BaseException as e:  # reported on the main thread
            box["error"] = e

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=60)
    check(not t.is_alive() and "error" not in box, f"thread_launch: {box.get('error')}")
    torch.cuda.synchronize()
    fb.restore_counts(before)
    same = {"symmetric": bool(torch.equal(box["sym"], main)),
            "narrow": bool(torch.equal(box["narrow"], cross))}
    check(all(same.values()), f"thread_launch: a worker thread's launch differs {same}")
    out = {"phase": "thread_launch", "bitwise": same, "devices": torch.cuda.device_count()}
    emit(out)
    return out


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
        eps = eng._noise(11, (s_draws, u, q), torch.float32, device)
        host_ms[u], dev_ms[u] = host_and_device_ms(lambda: pred(*a_const, cq, xq, eps))
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


# ----------------------------------------------------------------------
# phase 5c: serve_coalesced_config5
# ----------------------------------------------------------------------
# the coalescing window (ms) of the window-armed engine
COALESCE_WINDOW_MS = 2.0


def serve_coalesced_config5(device, artifact_path, tmp, uncoalesced):
    """Cross-request coalescing (serve/coalesce.py, the engine's row-seed
    path) on serve_config5's artifact (S = 1000, t = 64, q = 1), beside
    serve_config5's uncoalesced figures (``uncoalesced``, this process):
    the same 64 requests of 32 rows from 8 clients into 4 in flight, twice
    (the first round also starts the threads), on an engine with
    coalesce_window_ms = 2 and a run log; then the same requests one at a
    time on that engine.

    Printed: p50, p99 and QPS of each round; dispatches against requests
    and the mean requests a batch; the held-time histogram and the
    admission counters (obs/summarize.serve_block of the run log); the
    host and device ms of one row-seed predict at 32 and at 4096 rows and
    of its default row noise (hash_row_noise) at 4096 rows.

    Checks: every coalesced response bitwise the same request served
    alone; strictly fewer dispatches than requests in each round; a
    deadline-critical request never held; a NaN row (inject_predict_nan)
    degrading only the request that owns it, its batch-mates bitwise
    their solo responses; 0 fused-build launches."""
    import os
    import threading

    import numpy as np
    import torch
    from smk_torch.obs.summarize import load_run, serve_block
    from smk_torch.ops import fused_build as fb
    from smk_torch.serve import PredictionEngine, hash_row_noise
    from smk_torch.testing.faults import inject_predict_nan

    fb.reset_counts()
    rng = np.random.default_rng(SEED + 5)
    reqs = [serve_queries(rng, SERVE_ROWS) for _ in range(SERVE_REQUESTS)]
    log_dir = os.path.join(tmp, "coalesce_logs")
    eng = PredictionEngine(artifact_path, buckets=SERVE_BUCKETS, max_queue=64,
                           max_in_flight=SERVE_IN_FLIGHT, coalesce_window_ms=COALESCE_WINDOW_MS,
                           run_log_dir=log_dir, device=device)
    out = {"phase": "serve_coalesced_config5", "window_ms": COALESCE_WINDOW_MS,
           "buckets": list(SERVE_BUCKETS), "clients": SERVE_CLIENTS,
           "max_in_flight": SERVE_IN_FLIGHT,
           "uncoalesced": {k: uncoalesced[k] for k in ("serial", "concurrent",
                                                       "concurrent_first_round",
                                                       "concurrent_in_flight_1")}}
    rounds = []
    for rnd in ("concurrent_first_round", "concurrent"):
        conc, lat, errs = {}, [], []
        lock = threading.Lock()

        def client(c):
            try:
                for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                    t0 = time.perf_counter()
                    r = eng.predict(*reqs[i], seed=i)
                    with lock:
                        lat.append(time.perf_counter() - t0)
                        conc[i] = r
            except Exception as e:  # recorded and failed below
                errs.append(repr(e))

        d0 = eng.health()["dispatches"]
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        start = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        wall = time.perf_counter() - start
        check(not any(th.is_alive() for th in threads), "coalesce: a client hung")
        check(not errs and len(conc) == SERVE_REQUESTS, f"coalesce: errors {errs[:3]}")
        dispatches = eng.health()["dispatches"] - d0
        check(dispatches < SERVE_REQUESTS,
              f"coalesce: {dispatches} dispatches for {SERVE_REQUESTS} requests")
        held = [conc[i].held_s for i in range(SERVE_REQUESTS)]
        out[rnd] = dict(_latency_summary(lat, wall), dispatches=dispatches,
                        requests=SERVE_REQUESTS,
                        mean_requests_per_dispatch=SERVE_REQUESTS / dispatches,
                        held_ms_median=statistics.median(held) * 1e3,
                        held_ms_max=max(held) * 1e3)
        rounds.append(dict(conc))

    # the same requests one at a time on the same engine
    solo, lat = [], []
    start = time.perf_counter()
    for i, (cq, xq) in enumerate(reqs):
        t0 = time.perf_counter()
        solo.append(eng.predict(cq, xq, seed=i))
        lat.append(time.perf_counter() - t0)
    out["one_at_a_time"] = _latency_summary(lat, time.perf_counter() - start)
    for conc in rounds:
        check(all(np.array_equal(conc[i].p_quant, solo[i].p_quant)
                  and np.array_equal(conc[i].rows_degraded, solo[i].rows_degraded)
                  for i in range(SERVE_REQUESTS)),
              "coalesce: a coalesced response differs from the request served alone")
    for r in solo:
        check(r.buckets == (32,) and bool(np.isfinite(r.p_quant).all()) and not r.degraded
              and bool(((r.p_quant >= 0) & (r.p_quant <= 1)).all()), "coalesce: a bad response")

    # a deadline-critical request: its headroom is gone, so it is not held
    co = eng._coalescer
    crit0 = co.stats_snapshot()["critical_flushes"]
    co._walls.append(5.0)
    try:
        crit = eng.predict(*reqs[0], seed=0, deadline_s=8.0)
    finally:
        co._walls.clear()
    check(co.stats_snapshot()["critical_flushes"] == crit0 + 1
          and crit.held_s < 0.5 * COALESCE_WINDOW_MS / 1e3
          and np.array_equal(crit.p_quant, solo[0].p_quant),
          f"coalesce: a deadline-critical request held {crit.held_s * 1e3:.3f} ms")
    out["critical_held_ms"] = crit.held_s * 1e3

    # a NaN row in a coalesced dispatch degrades its own request alone
    trio = [3, 4, 5]
    results, errs = {}, []
    gate = threading.Barrier(len(trio))

    def member(i):
        try:
            gate.wait(timeout=30.0)
            results[i] = eng.predict(*reqs[i], seed=i)
        except Exception as e:  # recorded and failed below
            errs.append(repr(e))

    with inject_predict_nan(rows=[1], max_fires=1) as inj:
        threads = [threading.Thread(target=member, args=(i,)) for i in trio]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60.0)
    check(not errs and inj.fires == 1 and len(results) == 3, f"coalesce: NaN trio {errs}")
    hurt = [i for i in trio if results[i].degraded]
    check(len(hurt) == 1 and int(results[hurt[0]].rows_degraded.sum()) == 1
          and results[hurt[0]].rows_degraded[1], f"coalesce: degraded {hurt}")
    ok = ~results[hurt[0]].rows_degraded
    check(np.array_equal(results[hurt[0]].p_quant[:, ok], solo[hurt[0]].p_quant[:, ok])
          and all(np.array_equal(results[i].p_quant, solo[i].p_quant)
                  for i in trio if i != hurt[0]), "coalesce: a batch-mate moved")
    out["nan_row"] = {"degraded_request": hurt[0], "rows_degraded": 1}

    # one row-seed predict at 32 and 4096 rows, and its row noise at 4096
    const = eng._gen.const
    s_draws = eng.artifact.n_draws
    host_ms, dev_ms = {}, {}
    for u in (SERVE_ROWS, SERVE_BUCKETS[-1]):
        pred, _ = eng._programs_rows(u)
        cq = torch.as_tensor(np.resize(reqs[0][0], (u, 2)), device=device)
        xq = torch.as_tensor(np.resize(reqs[0][1], (u, 1, 2)), device=device)
        rs = torch.full((u,), 7, dtype=torch.int64, device=device)
        ri = torch.arange(u, dtype=torch.int64, device=device)
        host_ms[u], dev_ms[u] = host_and_device_ms(lambda: pred(*const, cq, xq, rs, ri))
    noise_host, noise_dev = host_and_device_ms(lambda: hash_row_noise(
        rs, ri, (s_draws, 1), torch.float32, device))
    out["row_predict_host_ms"] = {str(u): v for u, v in host_ms.items()}
    out["row_predict_device_ms"] = {str(u): v for u, v in dev_ms.items()}
    out["per_request_predict_device_ms"] = {
        str(u): uncoalesced["predict_device_ms_by_bucket"][str(u)]
        for u in (SERVE_ROWS, SERVE_BUCKETS[-1])}
    out["row_noise_4096"] = {"host_ms": noise_host, "device_ms": noise_dev}
    out["health"] = eng.health()
    log_path = eng.run_log.path
    eng.close()
    block = serve_block(load_run(log_path))
    out["serve_block"] = block
    check(block["coalesce"]["requests"] == 3 * SERVE_REQUESTS + 1 + len(trio),
          f"coalesce: serve_block requests {block['coalesce']}")
    launches = dict(fb.LAUNCHES)
    check(sum(launches.values()) == 0 and sum(fb.PLAIN_CALLS.values()) == 0,
          f"coalesce: a fused build ran on the serving path: {launches}")
    out["launches"] = launches
    out["launches_by_kernel"] = launches_by_kernel()
    emit(out)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--programs-child":
        return _store_child(sys.argv[2])
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
        """Run one phase, record its wall time, free the cached blocks
        (and the graphs of the phase's models, which reference cycles
        keep until the collector runs)."""
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        walls[name] = time.perf_counter() - start
        gc.collect()
        torch.cuda.empty_cache()
        return out

    timings = phase("kernels", kernels_phase, device)
    phase("fit_small_parity", fit_small_parity, device)
    serve_dir = tempfile.mkdtemp(prefix="smk_chip_serve_")
    try:
        c5 = phase("fit_config5", run_fit, "fit_config5", n=MAIN_K * MAIN_M, k=MAIN_K, q=1,
                   p=2, t=MAIN_T, n_samples=40, device=device,
                   artifact_path=f"{serve_dir}/config5.npz")
        sc5 = phase("serve_config5", serve_config5, device, c5["artifact"]["path"], serve_dir)
        co5 = phase("serve_coalesced_config5", serve_coalesced_config5, device,
                    c5["artifact"]["path"], serve_dir, sc5)
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
    nk = phase("noise_kernel", noise_kernel, device, c5_data, c4_data)
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
        ing4 = phase("ingest_config4", ingest_config4, device, c4_data, tmp)
        ov5 = phase("fit_overlap_config5", fit_overlap_config5, device, c5_data, tmp)
        ovs = phase("fit_overlap_small_faults", fit_overlap_small_faults, device, tmp)
        ad5 = phase("fit_adaptive_config5", fit_adaptive_config5, device, c5_data, tmp)
        ads = phase("fit_adaptive_small", fit_adaptive_small, device, tmp)
        pr5 = phase("fit_profile_config5", fit_profile_config5, device, c5_data, tmp)
        phase("programs_config5", programs_config5, device, c5_data, c4_data, tmp)
        m5 = phase("mesh_config5", mesh_config5, device, c5_data, tmp)
        mb5 = phase("mesh_blocks_config5", mesh_blocks_config5, device, c5_data, m5)
        del m5["chunked_unmeshed_result"]
        mc4 = phase("mesh_coherent_config4", mesh_coherent_config4, device, c4_data)
        d1 = phase("dist_world_of_one", dist_world_of_one, device)
        dc5 = phase("dist_ckpt_config5", dist_ckpt_config5, device, c5_data, tmp)
        csv4 = phase("data_csv_config4", data_csv_config4, device, tmp)
        an5 = phase("analysis_config5", analysis_config5, device, c5_data, tmp)
        am5 = phase("adaptive_mesh_config5", adaptive_mesh_config5, device, c5_data, ad5, tmp)
        ad5d = phase("adaptive_dist_config5", adaptive_dist_config5, device, c5_data, ad5, tmp)
        del ad5["c_result"]
        rf4 = phase("r_frontend_config4", r_frontend_config4, device, c4_data, tmp)
        phase("sharded_chol", sharded_chol, device)
        phase("thread_launch", thread_launch, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "wall_s_by_phase", **walls, "total_s": time.perf_counter() - script_start})
    paths = {"fit_config5": c5, "fit_q2": q2, "fit_production_config5": p5,
             "fit_production_config4": p4, "fit_production_config5_mtm": p5m,
             "fit_production_config4_chains": p4c, "fit_config5_float64": c5f64,
             "fit_vecchia_config5": v5, "fit_vecchia_m_large": vm,
             "fit_chunked_small": chs, "fit_chunked_config5": cc5, "fit_coherent_config4": coh4,
             "ingest_config4": ing4, "serve_coalesced_config5": co5,
             "fit_overlap_config5": ov5, "fit_overlap_small_faults": ovs,
             "fit_adaptive_config5": ad5, "fit_adaptive_small": ads,
             "fit_profile_config5": pr5, "mesh_config5": m5, "mesh_blocks_config5": mb5,
             "mesh_coherent_config4": mc4,
             "dist_world_of_one": d1, "dist_ckpt_config5": dc5, "data_csv_config4": csv4,
             "analysis_config5": an5, "adaptive_mesh_config5": am5,
             "adaptive_dist_config5": ad5d, "r_frontend_config4": rf4}

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
    ] + [
        # the sweep noise kernel: replaces no TPU kernel (the per-row
        # generator calls of draw_sweep_noise), timed at both cells'
        # per-sweep shapes, bitwise the per-row path
        {"name": f"sweep noise, {cell}", "route": "cuda", "source": NOISE_SOURCE,
         "replaces": "none: the per-row torch generator calls (models/probit_gp"
                     ".draw_sweep_noise)",
         **{k_: v for k_, v in rec.items() if k_ not in ("fit_rows_batched",
                                                         "fit_rows_rowwise")}}
        for cell, rec in nk["cells"].items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
