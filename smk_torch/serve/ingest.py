"""Streaming ingest and dirty-group re-fits — twin of
``smk_tpu/serve/ingest.py``: the closed fit → serve → ingest → re-fit
loop of one live model.

The posterior decomposes over the K subsets, so a batch of new
observations costs only the subsets it lands in:

- **Routing** (:class:`MortonRouter`): the Morton quantization frame of
  the initial fit (``parallel/partition.morton_codes``, the coherent
  partition's own code arithmetic) is frozen, so a new row quantizes as
  the partition did and lands in the subset whose Z-order run covers its
  code. The same coordinates always route to the same subset.
- **Dirty-subset re-fits** (:meth:`LiveFit.refit`): only the subsets an
  ingest touched are re-fit, as their own
  :class:`~smk_torch.parallel.partition.PaddedPartition` through the
  chunked executor (the √2 ladder re-derived from the grown sizes),
  warm-started from the previous combined posterior's median betas. The
  untouched subsets' grids and kept draws are carried verbatim, bitwise
  by construction; the re-fit ones are fresh (they saw new data).
- **Generations**: every fit and refit publishes through
  serve/artifact.py's two-phase commit, and :meth:`LiveFit.swap_into`
  hot-swaps an engine or fleet onto the new generation
  (``PredictionEngine.swap_artifact``) with no request dropped.
- **Durable append log**: every ingested batch is written to
  ``<gen_dir>/pending/batch.<seq>.npz`` (temp file and rename) before its
  receipt returns. A refit stamps the highest contiguously consumed
  sequence number into the generation manifest (``ingest_watermark``)
  and only then deletes the consumed files: the commit is the handoff. A
  restarted LiveFit on the same directory drops the files at or below
  the committed watermark after its base fit and replays the rest.

Where the twin takes a PRNG key, the port takes a randomness object
(:class:`LiveRandomness`; ``api.TorchRandomness`` by default, seeded from
the call's ``seed``): its ``sweep_noise`` feeds the chunked executor and
its ``resample_index`` the composition resample of the publish. The
tests pass one that replays the twin's key schedule. Everything runs on
``device`` (the CUDA device by default; it raises where there is none);
the carried per-subset results live in host memory, so they pin nothing
on the card across generations.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from smk_torch.api import (
    TorchRandomness,
    _median_row,
    combine,
    matmul_precision,
    plugin_phi_layout,
    prediction_factors,
    stacked_design,
)
from smk_torch.compile.buckets import bucket_for, bucket_ladder, validate_ladder
from smk_torch.compile.xla_cache import maybe_enable_from_config
from smk_torch.config import check_ported
from smk_torch.device import resolve_device
from smk_torch.models.probit_gp import (
    NoiseSource,
    SpatialGPSampler,
    SubsetResult,
    SweepShapes,
    sweep_shapes,
)
from smk_torch.ops.glm import glm_warm_start
from smk_torch.ops.quantiles import interp_quantile_grid, inverse_cdf_resample
from smk_torch.parallel.partition import (
    MORTON_BITS,
    coherent_assignments,
    morton_codes,
    padded_partition,
)
from smk_torch.parallel.recovery import fit_subsets_chunked
from smk_torch.serve.artifact import (
    current_generation,
    load_current_generation,
    publish_generation,
)
from smk_torch.utils.checkpoint import _atomic_savez
from smk_torch.utils.tracing import ChunkPipelineStats, monotonic

_PENDING_DIR = "pending"
_PENDING_FMT = "batch.%08d.npz"


class IngestError(ValueError):
    """An ingest or refit request is malformed (shape, non-finite
    content, an unknown subset) or comes before the initial fit: rejected
    before any state changes."""


class IngestReceipt(NamedTuple):
    """What one :meth:`LiveFit.ingest` did: rows appended, the subsets
    they routed to, the dirty set and its share of bucket groups, and the
    generation still served (ingest never republishes)."""

    n_rows: int
    routed_subsets: Tuple[int, ...]
    dirty_subsets: Tuple[int, ...]
    dirty_groups: Tuple[int, ...]
    dirty_group_frac: float
    generation: Optional[int]


class RefitReport(NamedTuple):
    """What one :meth:`LiveFit.refit` did. ``refit_speedup``: the latest
    full re-fit's wall over this dirty-only re-fit's, the per-subset
    schedule identical on both sides; None until a full wall exists or
    when this refit was full."""

    generation: Optional[int]
    refit_subsets: Tuple[int, ...]
    reused_subsets: Tuple[int, ...]
    dirty_group_frac: float
    refit_wall_s: float
    full_fit_wall_s: Optional[float]
    refit_speedup: Optional[float]
    param_rhat_max: Optional[float]
    skipped: bool = False


class LiveRandomness(Protocol):
    """The random numbers of one fit or refit: the sweeps' noise and the
    publish's resample indices."""

    def sweep_noise(self, shapes: SweepShapes) -> NoiseSource: ...

    def resample_index(self, n_draws: int, n_grid: int) -> torch.Tensor: ...


class MortonRouter(NamedTuple):
    """The frozen fit-time routing: the quantization frame ``(lo, span,
    bits)`` and the code at which each subset's Z-order run begins. A new
    point's code under the frozen frame (out-of-frame points clip onto
    the boundary) is binary-searched in the run boundaries."""

    lo: np.ndarray
    span: np.ndarray
    bits: int
    # boundaries[i]: the least code of subset i+1's run (K-1 entries); a
    # code routes to the number of boundaries <= it
    boundaries: np.ndarray
    n_subsets: int

    @classmethod
    def from_assignments(cls, coords, assignments) -> "MortonRouter":
        """From the initial coordinates and their coherent assignments
        (Morton-ordered runs), with the partitioner's frame (lo = min, a
        zero span taken as 1), so the fit's own rows route back into
        their subsets."""
        c = np.asarray(coords, np.float64)
        lo = c.min(axis=0)
        span = c.max(axis=0) - lo
        span = np.where(span > 0, span, 1.0)
        code = morton_codes(c, lo=lo, span=span)
        k = len(assignments)
        bounds = np.asarray([code[np.asarray(assignments[j])].min() for j in range(1, k)],
                            np.uint64)
        return cls(lo=lo, span=span, bits=MORTON_BITS, boundaries=bounds, n_subsets=k)

    def route(self, coords_new) -> np.ndarray:
        """The subset of each new row."""
        c = np.asarray(coords_new, np.float64)
        if c.ndim != 2 or c.shape[1] != self.lo.shape[0]:
            raise IngestError(
                f"coords_new must be (b, d={self.lo.shape[0]}), got shape {c.shape}"
            )
        code = morton_codes(c, lo=self.lo, span=self.span, bits=self.bits)
        return np.searchsorted(self.boundaries, code, side="right").astype(np.int64)


class _CombinedFit(NamedTuple):
    """What ``save_artifact`` reads of a fit (host arrays): the combined
    grids and the resampled composition draws."""

    sample_par: np.ndarray
    sample_w: np.ndarray
    param_grid: np.ndarray
    w_grid: np.ndarray


class LiveFit:
    """One live model: the growing dataset, its coherent partition, the
    carried per-subset posteriors and the generation directory the
    engines serve from (module docstring).

    ``gen_dir``: the generation directory. ``config``: an
    :class:`~smk_torch.config.SMKConfig` with
    ``partition_method="coherent"`` (the router is that partition's code
    arithmetic). ``coords_test`` / ``x_test``: the anchor grid of every
    generation (frozen, so generations stay swappable). ``chunk_iters``:
    the chunked executor's chunk length (default 500). ``pipeline_stats``:
    a shared ChunkPipelineStats; the ingest ledger is its ``ingest``.
    ``device``: where the fits run (default: the CUDA device)."""

    def __init__(self, gen_dir: str, *, config, coords_test, x_test, weight: int = 1,
                 chunk_iters: Optional[int] = None, pipeline_stats=None, device=None):
        if config.partition_method != "coherent":
            raise IngestError(
                "LiveFit requires partition_method='coherent' — the "
                "ingest router is the Morton partition's own code "
                "arithmetic; a random partition cannot route new "
                "observations spatially"
            )
        check_ported(config)
        self.gen_dir = str(gen_dir)
        self.cfg = config
        self.device = resolve_device(device)
        self._dt = torch.float64 if config.dtype == "float64" else torch.float32
        self.weight = int(weight)
        self.chunk_iters = chunk_iters
        self.coords_test = np.asarray(coords_test)
        self.x_test = np.asarray(x_test)
        self.pstats = pipeline_stats if pipeline_stats is not None else ChunkPipelineStats()
        if self.pstats.ingest is None:
            self.pstats.ingest = {
                "ingest_batches": 0,
                "ingested_rows": 0,
                "refits": 0,
                "full_refits": 0,
                "reused_subsets_total": 0,
                "refit_subsets_total": 0,
                "generation": None,
                "pending_persisted": 0,
                "replayed_batches": 0,
                "replayed_rows": 0,
                "ingest_watermark": -1,
            }
        self._model = None
        self._y = self._x = self._coords = None
        self._ones_design = False
        self._assignments: Optional[list] = None
        self._router: Optional[MortonRouter] = None
        self._subset_results: Optional[SubsetResult] = None  # host arrays, K-leading
        self._param_grid = None  # the last combined grid (the warm start)
        self._last_combined: Optional[_CombinedFit] = None
        self._dirty: set = set()
        # the append log: (seq, routed subsets) per live batch file, the
        # next sequence number, the highest watermark committed
        self._pending: list = []
        self._pending_seq = 0
        self._watermark = -1
        self._full_fit_wall: Optional[float] = None
        self._run_log = None
        if getattr(config, "run_log_dir", None):
            from smk_torch.obs.events import open_run_log

            self._run_log = open_run_log(config.run_log_dir, name="livefit", meta={
                "n_subsets": config.n_subsets, "gen_dir": self.gen_dir,
                "device": str(self.device)})
            self.pstats.run_log = self._run_log

    # -- observability -------------------------------------------------

    def _event(self, name: str, **attrs) -> None:
        if self._run_log is not None:
            try:
                self._run_log.event(name, **attrs)
            except Exception:  # a log that fails is dropped, never the fit
                self._run_log = None

    # -- state ---------------------------------------------------------

    @property
    def fitted(self) -> bool:
        return self._subset_results is not None

    @property
    def generation(self) -> Optional[int]:
        cur = current_generation(self.gen_dir)
        return None if cur is None else int(cur["generation"])

    @property
    def n_rows(self) -> int:
        return 0 if self._y is None else int(self._y.shape[0])

    @property
    def dirty_subsets(self) -> Tuple[int, ...]:
        return tuple(sorted(self._dirty))

    @property
    def subset_sizes(self) -> Tuple[int, ...]:
        if self._assignments is None:
            return ()
        return tuple(len(a) for a in self._assignments)

    def _ladder(self) -> Tuple[int, ...]:
        if self.cfg.bucket_ladder is not None:
            return validate_ladder(self.cfg.bucket_ladder)
        return bucket_ladder(max(self.subset_sizes))

    def _group_sets(self, subsets) -> Tuple[Tuple[int, ...], float]:
        """(the rungs of the bucket groups ``subsets`` fall in, their share
        of all occupied rungs): a group, the subsets of one rung, is what
        the ragged executor fits at once."""
        lad = self._ladder()
        rung_of = [bucket_for(s, lad) for s in self.subset_sizes]
        all_groups = set(rung_of)
        dirty_groups = sorted({rung_of[j] for j in subsets})
        frac = len(dirty_groups) / len(all_groups) if all_groups else 0.0
        return tuple(dirty_groups), frac

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self._dt, device=self.device)

    # -- validation ----------------------------------------------------

    def _validate_batch(self, y_new, x_new, coords_new):
        y = np.asarray(y_new, np.float64)
        c = np.asarray(coords_new, np.float64)
        q = int(self._y.shape[1])
        p = int(self._x.shape[-1])
        d = int(self._coords.shape[1])
        if y.ndim != 2 or y.shape[1] != q:
            raise IngestError(f"y_new must be (b, q={q}) responses, got shape {y.shape}")
        b = y.shape[0]
        if c.shape != (b, d):
            raise IngestError(f"coords_new must be (b={b}, d={d}) locations, got shape {c.shape}")
        if x_new is None:
            if not self._ones_design:
                raise IngestError(
                    "x_new=None is only valid when the fit's design "
                    "is intercept-only (all-ones) — this fit carries "
                    "real covariates; pass x_new explicitly"
                )
            x = np.ones((b, q, p), np.float64)
        else:
            x = np.asarray(x_new, np.float64)
            if x.shape != (b, q, p):
                raise IngestError(f"x_new must be (b={b}, q={q}, p={p}) designs, got shape "
                                  f"{x.shape}")
        for name, a in (("y_new", y), ("x_new", x), ("coords_new", c)):
            if not np.isfinite(a).all():
                raise IngestError(
                    f"{name} contains non-finite values — rejected "
                    "at the boundary (a NaN coordinate would route "
                    "arbitrarily; a NaN response would poison its "
                    "subset's next re-fit)"
                )
        return y, x, c

    # -- the durable append log ----------------------------------------

    def _pending_path(self, seq: int) -> str:
        return os.path.join(self.gen_dir, _PENDING_DIR, _PENDING_FMT % seq)

    def _persist_batch(self, y, x, c) -> int:
        """Write one validated batch before its receipt returns (temp file
        and rename: a reader never sees a torn file)."""
        seq = self._pending_seq
        self._pending_seq = seq + 1
        os.makedirs(os.path.join(self.gen_dir, _PENDING_DIR), exist_ok=True)
        _atomic_savez(self._pending_path(seq), {"y": y, "x": x, "coords": c})
        return seq

    def _scan_pending(self):
        """Sorted (seq, path) of the batch files on disk."""
        pend = os.path.join(self.gen_dir, _PENDING_DIR)
        if not os.path.isdir(pend):
            return []
        out = []
        for name in os.listdir(pend):
            if not (name.startswith("batch.") and name.endswith(".npz")):
                continue
            try:
                out.append((int(name.split(".")[1]), os.path.join(pend, name)))
            except ValueError:
                continue
        return sorted(out)

    def _apply_batch(self, y, x, c) -> np.ndarray:
        """Route a validated batch, append it to the dataset and mark its
        subsets dirty; returns the routed subsets (shared by ingest and
        the restart replay, which must not persist again)."""
        subs = self._router.route(c)
        base = self.n_rows
        self._y = np.concatenate([self._y, y])
        self._x = np.concatenate([self._x, x])
        self._coords = np.concatenate([self._coords, c])
        for i, j in enumerate(subs):
            j = int(j)
            self._assignments[j] = np.concatenate([self._assignments[j], np.asarray([base + i])])
            self._dirty.add(j)
        return subs

    def _replay_pending(self) -> int:
        """The restart path: batch files at or below the committed
        watermark rode a published generation and are dropped; the rest
        route again and dirty their subsets for the next refit. Returns
        the number of batches replayed."""
        led = self.pstats.ingest
        replayed = 0
        for seq, path in self._scan_pending():
            self._pending_seq = max(self._pending_seq, seq + 1)
            if seq <= self._watermark:
                try:
                    os.remove(path)
                except OSError:  # gone already: nothing to drop
                    pass
                continue
            with np.load(path) as z:
                y, x, c = z["y"], z["x"], z["coords"]
            subs = self._apply_batch(y, x, c)
            self._pending.append((seq, frozenset(int(j) for j in subs)))
            replayed += 1
            led["replayed_batches"] += 1
            led["replayed_rows"] += int(y.shape[0])
            self._event("ingest_replayed", seq=seq, n_rows=int(y.shape[0]),
                        routed_subsets=sorted({int(j) for j in subs}))
        led["ingest_watermark"] = self._watermark
        if replayed:
            led["dirty_subsets"] = list(self.dirty_subsets)
        return replayed

    def _advance_watermark(self) -> int:
        """Advance the watermark over the leading run of pending batches
        whose subsets are all clean (their rows are in the splice about to
        publish). A clean batch behind a dirty one stays pending, or a
        restart would skip the dirty one's rows."""
        mark = self._watermark
        for seq, routed in sorted(self._pending):
            if routed & self._dirty:
                break
            mark = max(mark, seq)
        self._watermark = mark
        return mark

    def _drop_committed_pending(self) -> None:
        """Delete the batch files at or below the committed watermark,
        only after the generation carrying their rows has published."""
        live = []
        for seq, routed in self._pending:
            if seq <= self._watermark:
                try:
                    os.remove(self._pending_path(seq))
                except OSError:  # gone already: nothing to drop
                    pass
            else:
                live.append((seq, routed))
        self._pending = live

    # -- fit and publish -----------------------------------------------

    def _fit_subsets(self, rng: LiveRandomness, assignments, beta_init) -> SubsetResult:
        """Fit ``assignments`` as their own PaddedPartition through the
        chunked executor; returns the stacked results as host arrays. The
        model is the live fit's one, so a refit finds its bucket programs
        in the model's L1 (compile/programs.py); the config's
        ``compile_store_dir`` reaches the executor with it, and its
        ``xla_cache_dir`` is armed here as a fit arms it."""
        maybe_enable_from_config(self.cfg)
        part = padded_partition(self._tensor(self._y), self._tensor(self._x),
                                self._tensor(self._coords), assignments, ladder=self._ladder())
        q, p = self._x.shape[1], self._x.shape[2]
        shapes = sweep_shapes(self.cfg, len(assignments), max(part.buckets), q, p,
                              self.coords_test.shape[0], self.weight)
        with matmul_precision(self.cfg.matmul_precision, self.device):
            results = fit_subsets_chunked(
                self._model, part, self._tensor(self.coords_test), self._tensor(self.x_test),
                rng.sweep_noise(shapes), beta_init, chunk_iters=self.chunk_iters or 500,
                pipeline_stats=self.pstats,
            )
        return SubsetResult(*(r.cpu().numpy() for r in results))

    def _combine(self, rng: LiveRandomness, results: SubsetResult) -> _CombinedFit:
        """The combine tail over all K grids, as fit_meta_kriging runs it:
        combined quantile grids, densified, resampled."""
        cfg = self.cfg
        param_grid, w_grid = combine(torch.as_tensor(results.param_grid, device=self.device),
                                     torch.as_tensor(results.w_grid, device=self.device), cfg)
        dense_par = interp_quantile_grid(param_grid, cfg.interp_grid_step)
        dense_w = interp_quantile_grid(w_grid, cfg.interp_grid_step)
        index = rng.resample_index(cfg.resample_size, dense_par.shape[0]).to(self.device)
        sample_par, sample_w = inverse_cdf_resample(index, [dense_par, dense_w])
        out = _CombinedFit(*(a.cpu().numpy() for a in (sample_par, sample_w, param_grid,
                                                       w_grid)))
        self._param_grid = out.param_grid
        return out

    def _warm_beta(self) -> np.ndarray:
        """The previous combined posterior's median betas: the last
        generation already localized the coefficients, and the new rows
        perturb them a little."""
        q = int(self._y.shape[1])
        p = int(self._x.shape[-1])
        grid = self._param_grid
        row = grid[_median_row(grid.shape[0])]
        return np.asarray(row[: q * p], np.float64).reshape(q, p)

    def _publish(self, rng: LiveRandomness, kind: str, extra_meta: dict) -> dict:
        combined = self._combine(rng, self._subset_results)
        self._last_combined = combined
        # the anchor factor is built here, on the fit's device, as
        # save_artifact would build it
        ct = np.asarray(self.coords_test, np.float32)
        _, _, phi = plugin_phi_layout(combined, ct.shape[0])
        cache = prediction_factors(torch.as_tensor(ct, device=self.device),
                                   torch.as_tensor(phi, device=self.device), config=self.cfg)
        manifest = publish_generation(self.gen_dir, combined, self.coords_test, config=self.cfg,
                                      cache=cache, meta={"kind": kind, **extra_meta})
        self.pstats.ingest["generation"] = int(manifest["generation"])
        self._event("generation_published", generation=int(manifest["generation"]), kind=kind,
                    **{k: v for k, v in extra_meta.items()
                       if isinstance(v, (int, float, str, bool, list))})
        return manifest

    # -- the public loop -----------------------------------------------

    def fit(self, seed, y, x, coords, *, randomness: Optional[LiveRandomness] = None) -> dict:
        """The initial full fit: coherent partition, GLM warm start, the
        chunked executor over every bucket group, combine, and publish
        generation 0 (committed + 1 in a directory that holds
        generations), then replay the append log. ``randomness`` defaults
        to ``api.TorchRandomness(seed)`` (seed None: 0). Returns the
        committed manifest."""
        cfg = self.cfg
        y = np.asarray(y, np.float64)
        x = np.asarray(x, np.float64)
        coords = np.asarray(coords, np.float64)
        if y.ndim != 2 or x.ndim != 3 or coords.ndim != 2:
            raise IngestError(
                f"fit expects y (n, q), x (n, q, p), coords (n, d); "
                f"got {y.shape}, {x.shape}, {coords.shape}"
            )
        self._y, self._x, self._coords = y, x, coords
        self._ones_design = bool(np.all(x == 1))
        self._assignments = [np.asarray(a, np.int64)
                             for a in coherent_assignments(coords, cfg.n_subsets)]
        self._router = MortonRouter.from_assignments(coords, self._assignments)
        self._model = SpatialGPSampler(cfg, weight=self.weight)
        rng = randomness or TorchRandomness(0 if seed is None else int(seed), self.device,
                                            self._dt)
        q, p = x.shape[1], x.shape[2]
        y_long, x_long = stacked_design(self._tensor(y), self._tensor(x))
        with matmul_precision(cfg.matmul_precision, self.device):
            beta_init = glm_warm_start(y_long, x_long, weight=self.weight,
                                       link=cfg.link).coef.reshape(q, p)
        t0 = monotonic()
        self._subset_results = self._fit_subsets(rng, self._assignments, beta_init)
        self._full_fit_wall = monotonic() - t0
        self._dirty.clear()
        # the previous lineage's committed watermark decides which batch
        # files replay below; the base fit carries none of their rows, so
        # it republishes that mark
        cur = current_generation(self.gen_dir)
        self._watermark = -1 if cur is None else int(cur.get("ingest_watermark", -1))
        manifest = self._publish(rng, "fit", {"n_rows": self.n_rows, "n_subsets": cfg.n_subsets,
                                              "ingest_watermark": self._watermark})
        self._replay_pending()
        return manifest

    def ingest(self, y_new, x_new=None, coords_new=None) -> IngestReceipt:
        """Append a batch: route each row to its Morton subset, mark the
        subsets dirty, persist the batch, return a receipt. No device
        work and no republish: the engines keep serving the current
        generation until :meth:`refit`."""
        if not self.fitted:
            raise IngestError(
                "ingest before the initial fit — call LiveFit.fit "
                "first (the router is frozen at fit time)"
            )
        if coords_new is None:
            raise IngestError("coords_new is required")
        y, x, c = self._validate_batch(y_new, x_new, coords_new)
        subs = self._apply_batch(y, x, c)
        seq = self._persist_batch(y, x, c)
        self._pending.append((seq, frozenset(int(j) for j in subs)))
        groups, frac = self._group_sets(sorted(self._dirty))
        led = self.pstats.ingest
        led["ingest_batches"] += 1
        led["ingested_rows"] += int(y.shape[0])
        led["pending_persisted"] += 1
        led["dirty_subsets"] = list(self.dirty_subsets)
        led["dirty_groups"] = list(groups)
        led["dirty_group_frac"] = round(frac, 4)
        self._event("ingest_routed", n_rows=int(y.shape[0]),
                    routed_subsets=sorted({int(j) for j in subs}),
                    dirty_subsets=list(self.dirty_subsets), dirty_groups=list(groups))
        return IngestReceipt(
            n_rows=int(y.shape[0]),
            routed_subsets=tuple(int(j) for j in subs),
            dirty_subsets=self.dirty_subsets,
            dirty_groups=groups,
            dirty_group_frac=frac,
            generation=self.generation,
        )

    def refit(self, seed, *, full: bool = False, subsets: Optional[Sequence[int]] = None,
              randomness: Optional[LiveRandomness] = None) -> RefitReport:
        """Re-fit and republish. By default only the dirty subsets, as
        their own bucket groups, warm-started from the previous combined
        posterior; their fresh results are spliced into the carried
        K-stacks (the others bitwise as they were) and the combine reruns
        over all K. ``full=True`` re-fits every subset (the baseline of
        ``refit_speedup``), ``subsets=[...]`` an explicit set. The
        per-subset schedule is the same in every mode. ``randomness``
        defaults to ``api.TorchRandomness(seed)``."""
        if not self.fitted:
            raise IngestError("refit before the initial fit — call LiveFit.fit first")
        k = self.cfg.n_subsets
        if full:
            target = list(range(k))
        elif subsets is not None:
            target = sorted({int(j) for j in subsets})
            if target and not (0 <= target[0] and target[-1] < k):
                raise IngestError(f"subsets must lie in [0, K={k}), got {target}")
        else:
            target = sorted(self._dirty)
        if not target:
            return RefitReport(
                generation=self.generation, refit_subsets=(), reused_subsets=tuple(range(k)),
                dirty_group_frac=0.0, refit_wall_s=0.0, full_fit_wall_s=self._full_fit_wall,
                refit_speedup=None, param_rhat_max=None, skipped=True,
            )
        groups, frac = self._group_sets(target)
        reused = tuple(j for j in range(k) if j not in set(target))
        self._event("refit_scheduled", refit_subsets=list(target), reused_subsets=len(reused),
                    dirty_groups=list(groups), full=bool(full))
        rng = randomness or TorchRandomness(int(seed), self.device, self._dt)
        beta_init = self._tensor(self._warm_beta())
        t0 = monotonic()
        fresh = self._fit_subsets(rng, [self._assignments[j] for j in target], beta_init)
        wall = monotonic() - t0
        idx = np.asarray(target, np.int64)
        if len(target) == k:
            spliced = fresh
        else:
            def splice(old, new):
                if old.shape[1:] != new.shape[1:]:
                    raise IngestError(
                        f"re-fit leaves changed shape {old.shape[1:]} -> {new.shape[1:]} — "
                        "the refit schedule must match the carried stacks (same "
                        "n_samples/burn_in/quantiles) to splice"
                    )
                out = old.copy()
                out[idx] = new
                return out

            spliced = SubsetResult(*(splice(o, n) for o, n in zip(self._subset_results, fresh)))
        self._subset_results = spliced
        self._dirty.difference_update(target)
        if len(target) == k:
            self._full_fit_wall = wall
        speedup = None
        if len(target) < k and self._full_fit_wall and wall > 0:
            speedup = self._full_fit_wall / wall
        rhat = np.asarray(fresh.param_rhat, np.float64)
        rhat_max = float(np.nanmax(rhat)) if rhat.size else None
        led = self.pstats.ingest
        led["refits"] += 1
        if len(target) == k:
            led["full_refits"] += 1
        led["reused_subsets_total"] += len(reused)
        led["refit_subsets_total"] += len(target)
        led["last_refit_wall_s"] = round(wall, 4)
        led["last_refit_speedup"] = round(speedup, 3) if speedup else None
        led["dirty_subsets"] = list(self.dirty_subsets)
        mark = self._advance_watermark()
        led["ingest_watermark"] = mark
        manifest = self._publish(rng, "refit", {
            "refit_subsets": list(target), "reused_subsets": len(reused), "full": bool(full),
            "wall_s": round(wall, 4), "ingest_watermark": mark})
        self._drop_committed_pending()
        return RefitReport(
            generation=int(manifest["generation"]),
            refit_subsets=tuple(target),
            reused_subsets=reused,
            dirty_group_frac=frac,
            refit_wall_s=wall,
            full_fit_wall_s=self._full_fit_wall,
            refit_speedup=speedup,
            param_rhat_max=rhat_max,
        )

    # -- serving -------------------------------------------------------

    def load_current(self):
        """(FitArtifact, manifest) of the committed generation."""
        return load_current_generation(self.gen_dir)

    def swap_into(self, target) -> dict:
        """Hot-swap an engine or fleet onto the committed generation
        (``swap_artifact``); returns its summary."""
        art, manifest = load_current_generation(self.gen_dir)
        return target.swap_artifact(art, generation=int(manifest["generation"]))

    def close(self) -> None:
        if self._run_log is not None:
            self._run_log.close(ingest=self.pstats.ingest)
            self._run_log = None

    def __enter__(self) -> "LiveFit":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
