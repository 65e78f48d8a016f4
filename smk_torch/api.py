"""Top-level API — twin of the default path of ``smk_tpu/api.py``:

    partition -> IRLS warm start -> K batched binary-GP Gibbs chains
    (probit or logit link) -> 200-quantile compression ->
    Wasserstein-mean combine -> inverse-CDF resample -> p(y=1) through
    the link's inverse, with credible summaries.

Runs on the CUDA device unless ``device="cpu"`` is passed; with no
device given and no card present it raises. All randomness of a fit
comes from one :class:`FitRandomness` (the default draws from
``torch.Generator`` streams seeded by ``seed``); the tests pass one that
replays the JAX package's key schedule instead.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Protocol

import numpy as np
import torch
from torch.special import ndtr

from smk_torch.compile.programs import store_from_config
from smk_torch.compile.xla_cache import maybe_enable_from_config
from smk_torch.config import SMKConfig, check_ported
from smk_torch.device import resolve_device
from smk_torch.models.probit_gp import (
    GeneratorNoise,
    NoiseSource,
    SpatialGPSampler,
    SubsetResult,
    SweepShapes,
    subset_generators,
    sweep_shapes,
)
from smk_torch.obs.events import open_run_log
from smk_torch.ops import cuda_build
from smk_torch.ops.chol import jittered_cholesky, tri_solve
from smk_torch.ops.distance import cross_distance, pairwise_distance
from smk_torch.ops.factor_cache import FactorCache, empty_counter, tick
from smk_torch.ops.glm import glm_warm_start
from smk_torch.ops.kernels import correlation
from smk_torch.ops.quantiles import (
    credible_summary,
    interp_quantile_grid,
    inverse_cdf_resample,
    resample_index,
)
from smk_torch.compile.buckets import plan_ragged_mesh
from smk_torch.parallel.combine import combine_quantile_grids, gather_grids
from smk_torch.parallel.domains import FailureDomainMap
from smk_torch.parallel.executor import (
    fit_subsets_sharded,
    fit_subsets_vmap,
    fits_layout,
    make_mesh,
    run_per_device,
)
from smk_torch.parallel.sharded_chol import row_sharding
from smk_torch.parallel.partition import (
    PaddedPartition,
    coherent_partition,
    random_partition,
    random_permutation,
)
from smk_torch.parallel.recovery import find_failed_subsets, fit_subsets_chunked
from smk_torch.utils.tracing import ChunkPipelineStats, PhaseTimes, phase_timer


class MetaKrigingResult(NamedTuple):
    """Everything the reference script materializes, plus diagnostics —
    the twin's fields (see smk_tpu/api.py). ``subsets_dropped`` and
    ``domains_dropped`` name what quarantine dropped, ``pad_waste_frac``
    is 0.0 on a ragged (coherent) fit off the mesh, ``run_log_path``
    names the fit's run log (``config.run_log_dir``), and under
    ``config.adaptive_schedule="on"`` ``frozen_at`` holds each subset's
    freeze iteration (-1 where it ran to the end) and
    ``chunks_saved_frac`` the share of the fixed schedule's subset-chunks
    the run did not dispatch."""

    param_grid: torch.Tensor
    w_grid: torch.Tensor
    sample_par: torch.Tensor
    sample_w: torch.Tensor
    p_samples: torch.Tensor
    param_quant: torch.Tensor
    w_quant: torch.Tensor
    p_quant: torch.Tensor
    subset_results: SubsetResult
    phi_accept_rate: torch.Tensor
    param_ess: torch.Tensor
    param_rhat: torch.Tensor
    w_ess: torch.Tensor
    w_rhat: torch.Tensor
    latent_ess_per_sec: float
    phase_seconds: dict
    subsets_dropped: tuple = ()
    run_log_path: Optional[str] = None
    domains_dropped: tuple = ()
    pad_waste_frac: Optional[float] = None
    frozen_at: Optional[tuple] = None
    chunks_saved_frac: Optional[float] = None


class FitRandomness(Protocol):
    """Every random number of a fit: the partition's permutation, the
    sweeps' noise, and the resample's row indices."""

    def permutation(self, n: int) -> torch.Tensor: ...

    def sweep_noise(self, shapes: SweepShapes) -> NoiseSource: ...

    def resample_index(self, n_draws: int, n_grid: int) -> torch.Tensor: ...


class TorchRandomness:
    """The default :class:`FitRandomness`: ``torch.Generator`` streams on
    the fit's device, seeded from ``seed`` (three independent children,
    as the twin splits its key three ways)."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        part, fit, res = np.random.SeedSequence(seed).spawn(3)
        self._fit_seed = int(fit.generate_state(1, np.uint32)[0])
        self._part = self._generator(part)
        self._res = self._generator(res)

    def _generator(self, seq) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seq.generate_state(1, np.uint32)[0]))
        return g

    def permutation(self, n: int) -> torch.Tensor:
        return random_permutation(self._part, n, self.device)

    def sweep_noise(self, shapes: SweepShapes) -> NoiseSource:
        """One generator per row of ``shapes.k`` (subsets times chains,
        subset-major)."""
        gens = subset_generators(self._fit_seed, shapes.k, self.device)
        return GeneratorNoise(gens, shapes, dtype=self.dtype, device=self.device)

    def resample_index(self, n_draws: int, n_grid: int) -> torch.Tensor:
        return resample_index(self._res, n_draws, n_grid, self.device)


def param_names(q: int, p: int) -> list:
    """Column names of the parameter grid: beta by (response,
    covariate), lower-tri of K = A A^T, phi."""
    names = [f"beta[{j},{r}]" for j in range(q) for r in range(p)]
    names += [f"K[{i},{j}]" for i in range(q) for j in range(i + 1)]
    names += [f"phi[{j}]" for j in range(q)]
    return names


def stacked_design(y: torch.Tensor, x: torch.Tensor):
    """(n, q) responses and (n, q, p) designs in the reference's long
    warm-start layout (R:53): response-major blocks, block-diagonal
    design."""
    n, q, p = x.shape
    y_long = y.T.reshape(-1)
    x_long = torch.zeros((q * n, q * p), dtype=x.dtype, device=x.device)
    for j in range(q):
        x_long[j * n : (j + 1) * n, j * p : (j + 1) * p] = x[:, j, :]
    return y_long, x_long


def predict_probability(
    sample_par: torch.Tensor, sample_w: torch.Tensor, x_test: torch.Tensor,
    *, link: str = "probit",
) -> torch.Tensor:
    """p(y=1 | data) per combined posterior draw (R:153-161), through
    the inverse of ``link``; the first q*p parameter columns are the
    betas, sample_w is response-fastest over test sites."""
    t, q, p = x_test.shape
    betas = sample_par[:, : q * p].reshape(-1, q, p)
    eta_fixed = torch.einsum("tqp,sqp->stq", x_test, betas)
    eta = eta_fixed.reshape(sample_par.shape[0], -1) + sample_w
    return _link_prob(eta, link)


def _link_prob(eta: torch.Tensor, link: str) -> torch.Tensor:
    if link == "probit":
        return ndtr(eta)
    if link == "logit":
        return 1.0 / (1.0 + torch.exp(-eta))
    raise ValueError(f"unknown link {link!r}")


class QueryValidationError(ValueError):
    """A prediction query batch failed validation at the serve/API
    boundary: NaN/Inf coordinates, a wrong coordinate or design
    dimension, or an empty batch. Raised before any dispatch, so a
    non-finite query never comes back as a NaN probability row."""


def validate_query_batch(coords_query, x_query, *, d: int, q: int, p: int):
    """Validate one prediction query batch against the fit's geometry
    (the twin's checks and messages): ``coords_query`` (u, d) locations,
    ``x_query`` (u, q, p) designs. Returns them as contiguous float32
    numpy arrays (the engine pads on the host). Raises
    :class:`QueryValidationError` on an empty batch, wrong shapes or
    non-finite values."""
    try:
        cq = np.asarray(_host(coords_query), np.float32)
    except (TypeError, ValueError) as e:
        raise QueryValidationError(
            f"coords_query is not a numeric array ({e!r})"
        ) from e
    if cq.ndim != 2 or cq.shape[1] != d:
        raise QueryValidationError(
            f"coords_query must be (n_queries, d={d}) locations, got "
            f"shape {cq.shape}"
        )
    if cq.shape[0] == 0:
        raise QueryValidationError(
            "empty query batch — coords_query has zero rows"
        )
    if not np.isfinite(cq).all():
        bad = np.unique(np.argwhere(~np.isfinite(cq))[:, 0])[:8]
        raise QueryValidationError(
            "coords_query contains non-finite values at rows "
            f"{bad.tolist()} — a NaN/Inf coordinate would propagate "
            "into the composition draw as a silent NaN probability"
        )
    try:
        xq = np.asarray(_host(x_query), np.float32)
    except (TypeError, ValueError) as e:
        raise QueryValidationError(
            f"x_query is not a numeric array ({e!r})"
        ) from e
    if xq.shape != (cq.shape[0], q, p):
        raise QueryValidationError(
            f"x_query must be (n_queries={cq.shape[0]}, q={q}, "
            f"p={p}) designs, got shape {xq.shape}"
        )
    if not np.isfinite(xq).all():
        bad = np.unique(np.argwhere(~np.isfinite(xq))[:, 0])[:8]
        raise QueryValidationError(
            "x_query contains non-finite values at rows "
            f"{bad.tolist()}"
        )
    return np.ascontiguousarray(cq), np.ascontiguousarray(xq)


def _host(a):
    """``a`` as something numpy reads: a tensor is copied to the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else a


# smklint: captured
def _krige_predict_core(
    chol_tt, w_test, betas, phi, coords_test, coords_q, x_q, eps,
    *, cov_model: str, link: str, var_floor: float,
):
    """The kriging composition at query locations — the one formula
    :func:`predict_at` and the serving engine (serve/engine.py) run
    (the twin's ``_krige_predict_core``).

    Per component j: W = R_tt^{-1} R_cross through the anchor factor;
    the conditional mean carries each combined-posterior latent draw to
    the queries, and the draw uses each query's marginal conditional
    variance, so every query row is computed independently of every
    other row (pad rows cannot perturb real rows; a non-finite row
    stays alone).

    chol_tt: (q, t, t) anchor Cholesky; w_test: (S, t, q); betas:
    (S, q, p); phi: (q,); coords_test: (t, d); coords_q: (u, d); x_q:
    (u, q, p); eps: (S, u, q) standard normals. Returns p(y=1) (S, u, q)
    in ``w_test``'s dtype.

    The composition runs in float64 and p is rounded to the draws'
    dtype: no TF32 setting reaches a float64 product, and those settings
    are process-global, which a serving thread must not depend on (the
    fit scopes them per call, api.matmul_precision)."""
    out_dt = w_test.dtype
    chol_tt, w_test, betas, phi, coords_test, coords_q, x_q, eps = (
        a.double() for a in (chol_tt, w_test, betas, phi, coords_test, coords_q, x_q, eps)
    )
    rc = correlation(
        cross_distance(coords_test, coords_q)[None], phi[:, None, None], cov_model,
    )  # (q, t, u)
    v = tri_solve(chol_tt, rc)
    wmat = tri_solve(chol_tt, v, trans=True)  # (q, t, u) = R_tt^{-1} R_cross
    mean = torch.einsum("stq,qtu->suq", w_test, wmat)  # (S, u, q)
    var = torch.clamp(
        1.0 - torch.einsum("qtu,qtu->qu", rc, wmat), min=var_floor
    )  # (q, u) marginal conditional variance
    w_q = mean + torch.sqrt(var).T[None, :, :] * eps
    eta = torch.einsum("uqp,sqp->suq", x_q, betas) + w_q
    return _link_prob(eta, link).to(out_dt)


def prediction_factors(
    coords_test: torch.Tensor,
    phi: torch.Tensor,
    *,
    config: Optional[SMKConfig] = None,
) -> FactorCache:
    """The query-independent kriging operator of the predict path, built
    once as a :class:`~smk_torch.ops.factor_cache.FactorCache`:
    ``krige_chol`` holds the (q, t, t) Cholesky of the anchor-grid
    correlation R_tt(phi) + jitter, and ``n_chol`` ticks q (in one
    batched call), so a cache-threaded second predict is seen to factor
    nothing. Every other field is None."""
    cfg = config or SMKConfig()
    t = coords_test.shape[0]
    r_tt = correlation(
        pairwise_distance(coords_test)[None], phi[:, None, None], cfg.cov_model,
    )  # (q, t, t)
    chol_tt = jittered_cholesky(r_tt, cfg.effective_jitter(t))
    cache = FactorCache(
        r_mv=None, nys_z=None, chol_inv=None, krige_w=None, krige_chol=chol_tt,
        n_chol=empty_counter(), n_chol_calls=empty_counter(),
    )
    return tick(cache, int(phi.shape[0]), 1)


def _median_row(n_rows: int) -> int:
    """Row of the 0.5 quantile in a combined quantile grid: row i holds
    probability (i+1)/n, so the exact median of an even-length grid is
    row n//2 - 1; an odd grid takes the upper neighbor."""
    return (n_rows + 1) // 2 - 1


def plugin_phi_layout(result: MetaKrigingResult, t: int) -> tuple:
    """(q, p, phi) of a fit at anchor size ``t`` — the one site that
    inverts the ``sample_par`` packing (q·p betas, q(q+1)/2 K entries,
    q phis) and takes the plug-in posterior-median phi from the combined
    grid. Shared by :func:`predict_at` and ``serve.artifact.save_artifact``.
    ``phi`` is a (q,) numpy array. A ``t`` that is not the fit's anchor
    size raises :class:`QueryValidationError`."""
    n_w = int(result.sample_w.shape[1])
    n_par = int(result.sample_par.shape[1])
    q = n_w // t
    p = (n_par - q * (q + 1) // 2 - q) // q if q > 0 else -1
    # a mismatched t still floor-divides into some (q, p) whose reshape
    # can succeed on element count alone: reject it typed
    if (
        q <= 0 or p <= 0 or n_w != q * t
        or n_par != q * p + q * (q + 1) // 2 + q
    ):
        raise QueryValidationError(
            f"anchor grid of {t} rows is inconsistent with this fit: "
            f"sample_w has {n_w} latents and sample_par {n_par} "
            "parameters, which do not factor as (q responses x "
            f"{t} anchors) + (q*p + q(q+1)/2 + q) — pass the SAME "
            "coords_test the fit was run with"
        )
    grid = np.asarray(_host(result.param_grid))
    phi = np.asarray(grid[_median_row(grid.shape[0]), -q:])
    return q, p, phi


class PredictAtResult(NamedTuple):
    """One query-location predict: ``p_samples`` (S, u, q) posterior
    p(y=1) draws and ``p_quant`` (3, u, q) [median, 2.5%, 97.5%] per
    query row."""

    p_samples: torch.Tensor
    p_quant: torch.Tensor


def predict_at(
    result: MetaKrigingResult,
    coords_test,
    coords_query,
    x_query,
    *,
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    config: Optional[SMKConfig] = None,
    cache: Optional[FactorCache] = None,
) -> tuple:
    """p(y=1) with credible intervals at arbitrary query locations from a
    finished fit (the twin's ``predict_at``), on the device of the
    result's tensors.

    Each resampled draw's latent is kriged from the anchor grid
    (``coords_test``) to the queries with the plug-in posterior-median
    phi. The anchor-grid Cholesky is the query-independent factor: pass
    the returned ``cache`` back in and a repeated predict factors
    nothing. The composition noise is ``eps`` (S, u, q) when given, else
    standard normals from ``generator`` (default: a ``torch.Generator``
    seeded with 0 on the result's device).

    Returns ``(PredictAtResult, FactorCache)``."""
    cfg = config or SMKConfig()
    dev, dt = result.sample_w.device, result.sample_w.dtype
    ct = _as_tensor(coords_test, dt, dev)
    t, d = ct.shape
    q, p, phi_np = plugin_phi_layout(result, t)
    cq, xq = validate_query_batch(coords_query, x_query, d=d, q=q, p=p)
    phi = torch.as_tensor(phi_np, dtype=dt, device=dev)
    if cache is None:
        cache = prediction_factors(ct, phi, config=cfg)
    s = result.sample_par.shape[0]
    shape = (s, cq.shape[0], q)
    if eps is None:
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        eps = torch.randn(shape, generator=generator, dtype=dt, device=dev)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"eps must be (S, u, q) = {shape}, got {tuple(eps.shape)}")
    p_samples = _krige_predict_core(
        cache.krige_chol,
        result.sample_w.reshape(s, t, q),
        result.sample_par[:, : q * p].reshape(s, q, p),
        phi, ct,
        _as_tensor(cq, dt, dev), _as_tensor(xq, dt, dev),
        eps.to(dtype=dt, device=dev),
        cov_model=cfg.cov_model, link=cfg.link,
        var_floor=cfg.effective_jitter(t),
    )
    p_quant = credible_summary(p_samples.reshape(s, -1)).reshape(3, cq.shape[0], q)
    return PredictAtResult(p_samples, p_quant), cache


def combine(grids_par: torch.Tensor, grids_w: torch.Tensor, config: SMKConfig,
            survival_mask=None, domain_of_subset=None):
    """The combine phase: (K, n_q, d) subset grids -> combined grids,
    without the subsets ``survival_mask`` drops (the degraded combine
    of a quarantined fit; see parallel/combine.apply_survival_mask)."""
    kw = dict(n_iter=config.weiszfeld_iters, eps=config.weiszfeld_eps,
              survival_mask=survival_mask, min_surviving_frac=config.min_surviving_frac,
              domain_of_subset=domain_of_subset)
    return (
        combine_quantile_grids(grids_par, config.combiner, **kw),
        combine_quantile_grids(grids_w, config.combiner, **kw),
    )


def resample_predict(
    param_grid: torch.Tensor,
    w_grid: torch.Tensor,
    x_test: torch.Tensor,
    index: torch.Tensor,
    config: SMKConfig,
    mesh=None,
):
    """The resample/predict phase: densify the combined grids, draw the
    rows ``index`` from both, and summarise. Returns (sample_par,
    sample_w, p_samples, param_quant, w_quant, p_quant). Under a ``mesh``
    whose size divides the draws, the link probabilities are computed
    row-split over this process's entries (the draws are independent;
    parallel/sharded_chol.row_sharding) and gathered back on
    ``mesh.home``."""
    dense_par = interp_quantile_grid(param_grid, config.interp_grid_step)
    dense_w = interp_quantile_grid(w_grid, config.interp_grid_step)
    sample_par, sample_w = inverse_cdf_resample(index, [dense_par, dense_w])
    if mesh is not None and fits_layout(sample_par.shape[0], mesh.size):
        lay = row_sharding(mesh.local())
        bp, bw = lay.place(sample_par), lay.place(sample_w)
        parts = run_per_device([
            (a.device, lambda a=a, w=w: predict_probability(a, w, x_test.to(a.device),
                                                            link=config.link))
            for a, w in zip(bp.blocks, bw.blocks)])
        p_samples = (parts[0] if len(parts) == 1
                     else torch.cat([t.to(sample_par.device) for t in parts]))
    else:
        p_samples = predict_probability(sample_par, sample_w, x_test, link=config.link)
    return (
        sample_par, sample_w, p_samples,
        credible_summary(sample_par), credible_summary(sample_w),
        credible_summary(p_samples),
    )


# SMKConfig.matmul_precision (the jax.lax.Precision names) -> PyTorch's
# float32 matmul precision and whether cuDNN may use TF32
_MATMUL_PRECISION = {
    "highest": ("highest", False), "float32": ("highest", False),
    "high": ("high", True), "tensorfloat32": ("high", True),
    "default": ("medium", True), "bfloat16": ("medium", True),
}


@contextlib.contextmanager
def matmul_precision(name: str, device):
    """Run the block under ``SMKConfig.matmul_precision`` ``name`` (see the
    config's field comment) on ``device`` and restore the caller's
    settings after it, as the twin scopes ``jax.default_matmul_precision``
    around a fit. On the CPU nothing is set: the twin's CPU backend
    computes fp32 products in full fp32 whatever the precision, where
    PyTorch's "medium" would take bf16 passes on a CPU that has them."""
    if torch.device(device).type != "cuda":
        yield
        return
    precision, cudnn_tf32 = _MATMUL_PRECISION[name]
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def _as_tensor(a, dtype, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def fit_meta_kriging(
    y,
    x,
    coords,
    coords_test,
    x_test,
    *,
    config: Optional[SMKConfig] = None,
    weight: int = 1,
    seed: int = 0,
    randomness: Optional[FitRandomness] = None,
    device=None,
    sharded: bool = False,
    mesh=None,
    n_devices: Optional[int] = None,
    chunk_size: Optional[int] = None,
    chunk_iters: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 500,
    progress=None,
    nan_guard: bool = False,
    pipeline_stats: Optional[ChunkPipelineStats] = None,
) -> MetaKrigingResult:
    """Full spatial meta-kriging pipeline.

    y: (n, q) binary/binomial counts; x: (n, q, p) designs; coords:
    (n, d); coords_test: (t, d); x_test: (t, q, p); weight: binomial
    trials. Arrays may be numpy or tensors. ``device`` defaults to the
    CUDA device; ``randomness`` to :class:`TorchRandomness` (``seed``).
    ``chunk_size`` runs the K subsets that many at a time, to bound how
    many are resident at once (it must divide K; the draws are the
    unchunked run's). Everything computes in ``config.dtype``, under
    ``config.matmul_precision`` (the caller's settings are restored on
    return).

    The device mesh (parallel/executor.py): ``mesh`` passes one,
    ``n_devices`` builds one over the first that many devices
    (``make_mesh(n_devices, device=device)``: cards, or virtual CPU
    entries with ``device="cpu"``; not both), bare ``sharded=True``
    meshes every visible card. Under a mesh the K subsets are laid out
    over the entries (``fit_subsets_sharded``, or the chunked executor's
    per-entry blocks; a ragged partition runs its RaggedMeshPlan, derived
    once, whose ``pad_waste_frac`` the result reports), the grids are
    gathered onto ``mesh.home`` (a ``gather`` span in the run log; an
    all-gather over the process group on a multi-process mesh), and the
    prediction composition is row-split over the entries when the
    resample size divides over the mesh. On a one-entry mesh the whole
    pipeline is bitwise the unmeshed one.

    The subset fits run through the chunked executor
    (parallel/recovery.fit_subsets_chunked) when any of its knobs asks
    for it, as in the twin:

    - ``chunk_iters``: sweeps per chunk of the host loop (default
      ``checkpoint_every`` when another knob implies chunking);
    - ``checkpoint_path``: checkpoint every chunk; an interrupted call
      with the same arguments resumes bitwise. The files are the
      port's own (a twin checkpoint does not resume here). Under a
      multi-process mesh the checkpoint is the distributed format 8
      (parallel/checkpoint.py): every process writes only its rows to
      its own shard files, and each boundary is published as one
      two-phase-committed generation (``config.ckpt_commit_timeout_s``
      bounds the commit's barriers; a dead peer is a typed
      ``CkptCommitError``), so a killed process rolls the job back to
      the last committed generation, and a relaunch on the same
      topology, or elastically on fewer processes, resumes from it.
      ``checkpoint_path`` must then be on a filesystem every process
      shares;
    - ``progress``: callback(dict) after every chunk (phase, iteration,
      n_samples, running phi acceptance);
    - ``nan_guard``: raise parallel.recovery.SubsetNaNError naming the
      non-finite subsets before the checkpoint is overwritten;
    - ``pipeline_stats``: a utils.tracing.ChunkPipelineStats sink;
    - ``config.fault_policy="quarantine"``: retry and drop faulted
      subsets; the combine drops the dead ones
      (``subsets_dropped``, ``domains_dropped``) and fails below
      ``config.min_surviving_frac``;
    - ``config.partition_method="coherent"``: the Morton split padded
      onto the bucket ladder (``config.bucket_ladder``), one chunked fit
      per occupied bucket.

    On the chunked path ``config.chunk_pipeline`` picks the host loop:
    ``"sync"`` or ``"overlap"`` (chunk t's boundary runs while chunk t+1
    is queued, the checkpoint written by a background thread; the draws
    are bitwise the sync loop's), and ``config.watchdog`` puts each chunk
    and boundary under a deadline (a hang raises
    parallel.domains.ChunkTimeoutError). Neither implies chunking.

    Telemetry (smk_torch/obs), observational all of it (the draws are
    bitwise the same armed or not):

    - ``config.run_log_dir``: one JSONL run log per fit, every phase a
      span and every chunk, fault, checkpoint write and live-diagnostics
      read an event (``python -m smk_torch.obs summarize <log>``); its
      path is ``result.run_log_path``;
    - ``config.live_diagnostics``: the streaming split-R-hat and ESS at
      each chunk boundary (``live_rhat_max`` / ``live_ess_min`` in the
      progress dict); implies chunking;
    - ``config.profile_dir`` / ``profile_chunks``: a torch.profiler
      window over a chunk range (or ``SMK_PROFILE_DIR`` /
      ``SMK_PROFILE_CHUNKS``).

    ``config.adaptive_schedule="on"`` (with live diagnostics and the
    sync pipeline) freezes converged subsets, compacts the batch and
    spends the saved sweeps on the stragglers
    (parallel/schedule.py); ``result.frozen_at`` and
    ``chunks_saved_frac`` report it.
    """
    cfg = config or SMKConfig()
    check_ported(cfg)
    # L3 of the program store: the kernel libraries' build directory,
    # armed for the process (compile/xla_cache.py)
    maybe_enable_from_config(cfg)
    if n_devices is not None:
        if mesh is not None:
            # conflicting topology asks must not silently pick one
            raise ValueError(
                f"pass either mesh= or n_devices=, not both — mesh spans {mesh.size} "
                f"device(s) while n_devices={n_devices} asks for its own")
        mesh = make_mesh(n_devices, axis=cfg.mesh_axis, device=device)
    elif sharded and mesh is None:
        mesh = make_mesh(axis=cfg.mesh_axis, device=device)
    dev = mesh.home if mesh is not None else resolve_device(device)
    asked = (checkpoint_path is not None or chunk_iters is not None
             or progress is not None or nan_guard)
    run_log = None
    if cfg.run_log_dir:
        run_log = open_run_log(cfg.run_log_dir, name="fit_meta_kriging", meta={
            "n": int(y.shape[0]) if hasattr(y, "shape") else None,
            "n_subsets": cfg.n_subsets, "n_samples": cfg.n_samples,
            "cov_model": cfg.cov_model, "link": cfg.link})
    pstats = pipeline_stats
    if pstats is None and (run_log is not None or cfg.live_diagnostics):
        # an internal sink: the chunk events reach the run log through it
        pstats = ChunkPipelineStats()
    if run_log is not None:
        pstats.run_log = run_log
    chunked = dict(chunk_iters=chunk_iters or checkpoint_every,
                   checkpoint_path=checkpoint_path, progress=progress,
                   nan_guard=nan_guard, pipeline_stats=pstats)
    try:
        with matmul_precision(cfg.matmul_precision, dev), (
                run_log.span("fit_meta_kriging") if run_log is not None
                else contextlib.nullcontext()):
            return _fit(y, x, coords, coords_test, x_test, cfg, weight, seed, randomness, dev,
                        chunk_size, chunked, asked, run_log, mesh)
    finally:
        if run_log is not None:
            run_log.close(pipeline=pstats.aggregate())


def _fit(y, x, coords, coords_test, x_test, cfg, weight, seed, randomness, dev, chunk_size,
         chunked, asked, run_log, mesh=None):
    """``chunked``: the chunked executor's arguments; ``asked``: whether
    the caller set one of them; ``run_log``: the fit's run log or
    None; ``mesh``: the run's mesh or None."""
    dt = torch.float64 if cfg.dtype == "float64" else torch.float32
    y, x, coords, coords_test, x_test = (
        _as_tensor(a, dt, dev) for a in (y, x, coords, coords_test, x_test)
    )
    if y.dim() != 2:
        raise ValueError(
            f"y must be (n, q) success counts, got shape {tuple(y.shape)} — "
            "a single response is y[:, None]"
        )
    n, q = y.shape
    # tempering is validated at q = 1 only: warn where q is first known
    cfg.warn_if_tempered_multivariate(q)
    # the multiple-try workspace at the subset size the partition makes
    cfg.warn_if_mtm_workspace_large(-(-n // cfg.n_subsets))
    if x.dim() != 3 or tuple(x.shape[:2]) != (n, q):
        raise ValueError(f"x must be (n={n}, q={q}, p) designs, got shape {tuple(x.shape)}")
    if coords.dim() != 2 or coords.shape[0] != n:
        raise ValueError(f"coords must be (n={n}, d) locations, got shape {tuple(coords.shape)}")
    if coords_test.dim() != 2 or coords_test.shape[1] != coords.shape[1]:
        raise ValueError(
            f"coords_test must be (t, d={coords.shape[1]}) locations, got "
            f"shape {tuple(coords_test.shape)}"
        )
    p = x.shape[2]
    if tuple(x_test.shape) != (coords_test.shape[0], q, p):
        raise ValueError(
            f"x_test must be (t={coords_test.shape[0]}, q={q}, p={p}) "
            f"designs, got shape {tuple(x_test.shape)}"
        )
    rng = randomness if randomness is not None else TorchRandomness(seed, dev, dt)
    times = PhaseTimes()

    with phase_timer(times, "partition", dev, log=run_log):
        if cfg.partition_method == "coherent":
            part = coherent_partition(y, x, coords, cfg.n_subsets, ladder=cfg.bucket_ladder)
        else:
            part = random_partition(
                rng.permutation(n).to(dev), y, x, coords, cfg.n_subsets
            )
    ragged = isinstance(part, PaddedPartition)

    with phase_timer(times, "warm_start", dev, log=run_log):
        y_long, x_long = stacked_design(y, x)
        beta_init = glm_warm_start(
            y_long, x_long, weight=weight, link=cfg.link
        ).coef.reshape(q, p)

    model = SpatialGPSampler(cfg, weight=weight)
    # the ragged fit's device layout, derived once: the failure domains
    # and pad_waste_frac describe the layout the executor runs
    ragged_plan = None
    if mesh is not None and ragged:
        ragged_plan = plan_ragged_mesh([g.bucket for g in part.groups],
                                       [len(g.subset_ids) for g in part.groups], mesh.size)
    store = store_from_config(cfg, mesh)
    if store is not None:
        # L2 of the program store: the kernel libraries out of the store
        # (or into it) before the first launch, on either executor
        cuda_build.ensure(model.kernel_libraries(dt, dev), store)
    m = max(part.buckets) if ragged else part.subset_size
    shapes = sweep_shapes(cfg, part.n_subsets, m, q, p, coords_test.shape[0], weight)
    with phase_timer(times, "subset_fits", dev, log=run_log):
        # quarantine, ragged partitions and the streaming monitor live in
        # the chunked executor too
        if asked or cfg.fault_policy == "quarantine" or ragged or cfg.live_diagnostics:
            results = fit_subsets_chunked(
                model, part, coords_test, x_test, rng.sweep_noise(shapes), beta_init,
                chunk_size=chunk_size, mesh=mesh, **chunked,
            )
        elif mesh is not None:
            results = fit_subsets_sharded(
                model, part, coords_test, x_test, rng.sweep_noise(shapes), beta_init,
                mesh=mesh, chunk_size=chunk_size,
            )
        else:
            results = fit_subsets_vmap(
                model, part, coords_test, x_test, rng.sweep_noise(shapes), beta_init,
                chunk_size=chunk_size,
            )

    with phase_timer(times, "combine", dev, log=run_log):
        grids_par, grids_w = results.param_grid, results.w_grid
        if mesh is not None:
            # the grids, whole, on mesh.home: pure data movement (an
            # all-gather across processes), its own span of the run log
            with (run_log.span("gather", n_subsets=cfg.n_subsets) if run_log is not None
                  else contextlib.nullcontext()):
                grids_par = gather_grids(grids_par, mesh)
                grids_w = gather_grids(grids_w, mesh)
        # the degraded combine of a quarantined fit: subsets whose retry
        # ladder ran out ship non-finite grids and are dropped
        survival_mask = domain_of_subset = None
        subsets_dropped: tuple = ()
        domains_dropped: tuple = ()
        if cfg.fault_policy == "quarantine":
            failed = find_failed_subsets(results._replace(param_grid=grids_par,
                                                          w_grid=grids_w))
            survival_mask = np.ones(cfg.n_subsets, bool)
            survival_mask[failed] = False
            subsets_dropped = tuple(int(i) for i in failed)
            if ragged_plan is not None:
                dmap = FailureDomainMap.derive_ragged(ragged_plan, part, mesh)
            else:
                dmap = FailureDomainMap.derive(cfg.n_subsets, mesh)
            domain_of_subset = np.asarray(dmap.domain_of_subset, int)
            domains_dropped = tuple(
                int(d) for d in range(dmap.n_domains)
                if not survival_mask[dmap.subsets_of(d)].any()
            )
        param_grid, w_grid = combine(grids_par, grids_w, cfg, survival_mask, domain_of_subset)

    with phase_timer(times, "resample_predict", dev, log=run_log):
        n_grid = int(round((1.0 - 1.0 / cfg.n_quantiles) / cfg.interp_grid_step)) + 1
        index = rng.resample_index(cfg.resample_size, n_grid).to(dev)
        (sample_par, sample_w, p_samples, param_quant, w_quant,
         p_quant) = resample_predict(param_grid, w_grid, x_test, index, cfg, mesh=mesh)

    secs = times.as_dict()
    fit_s = secs.get("subset_fits", 0.0)
    pstats = chunked["pipeline_stats"]
    adaptive = getattr(pstats, "adaptive", None) if pstats is not None else None
    ess_total = float(torch.sum(torch.nan_to_num(results.w_ess, nan=0.0)))
    return MetaKrigingResult(
        param_grid=param_grid,
        w_grid=w_grid,
        sample_par=sample_par,
        sample_w=sample_w,
        p_samples=p_samples,
        param_quant=param_quant,
        w_quant=w_quant,
        p_quant=p_quant,
        subset_results=results,
        phi_accept_rate=results.phi_accept_rate,
        param_ess=results.param_ess,
        param_rhat=results.param_rhat,
        w_ess=results.w_ess,
        w_rhat=results.w_rhat,
        latent_ess_per_sec=ess_total / fit_s if fit_s > 0.0 else 0.0,
        phase_seconds=secs,
        subsets_dropped=subsets_dropped,
        domains_dropped=domains_dropped,
        pad_waste_frac=(ragged_plan.pad_waste_frac if ragged_plan is not None
                        else 0.0 if ragged else None),
        run_log_path=run_log.path if run_log is not None else None,
        frozen_at=(tuple(adaptive["frozen_at"]) if adaptive else None),
        chunks_saved_frac=(adaptive["chunks_saved_frac"] if adaptive else None),
    )
