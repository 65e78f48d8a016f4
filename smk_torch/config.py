"""Typed configuration for the PyTorch port — its own copy of
``smk_tpu/config.py`` with the same fields, defaults and validation, so
a config carries over field for field.

The port imports nothing of the JAX package, so the dataclasses live
here again. Field semantics are documented once, on the JAX twin; the
comments below note only what differs in the port. Knob values this
port does not implement yet are accepted by the dataclass (a config
stays valid in both packages) and rejected when a fit starts, by
:func:`check_ported`, with a ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
import numbers
import re

from smk_torch.compile.buckets import validate_ladder

COV_MODELS = ("exponential", "matern32", "matern52")
PARTITION_METHODS = ("random", "coherent")
LINKS = ("probit", "logit")
COMBINERS = ("wasserstein_mean", "weiszfeld_median")
PHI_PROPOSAL_FAMILIES = ("gaussian", "student_t", "mixture")
SUBSET_ENGINES = ("dense", "vecchia")
BUILD_DTYPES = ("float32", "bfloat16")
CHUNK_PIPELINES = ("sync", "overlap")
FAULT_POLICIES = ("abort", "quarantine")
ADAPTIVE_SCHEDULES = ("off", "on")


def _validate_chunk_range(spec: str) -> None:
    """``"a"`` or ``"a:b"`` with b > a — the rule of
    ``smk_tpu/obs/profiling.parse_chunk_range``."""
    s = str(spec).strip()
    if not s:
        return
    m = re.fullmatch(r"(\d+)(?::(\d+))?", s)
    if m is None:
        raise ValueError(
            f"profile chunk range {spec!r} is not 'start' or "
            "'start:stop' (half-open chunk indices)"
        )
    a = int(m.group(1))
    b = int(m.group(2)) if m.group(2) is not None else a + 1
    if b <= a:
        raise ValueError(
            f"profile chunk range {spec!r} is empty (stop <= start)"
        )


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Priors (reference R:63-64); see the JAX twin for each field."""

    phi_min: float = 3.0 / 0.75
    phi_max: float = 3.0 / 0.25
    a_prior: str = "invwishart"
    a_scale: float = 10.0
    iw_df: float = 0.0  # 0 = use q
    iw_scale: float = 0.1
    beta_scale: float = 100.0
    temper: str = "none"


@dataclasses.dataclass(frozen=True)
class SMKConfig:
    """Everything the reference hardcodes, as one frozen dataclass."""

    n_subsets: int = 20
    partition_method: str = "random"
    bucket_ladder: tuple = None
    n_samples: int = 5000
    burn_in_frac: float = 0.75
    n_chains: int = 1
    cov_model: str = "exponential"
    link: str = "probit"
    n_quantiles: int = 200
    resample_size: int = 1000
    interp_grid_step: float = 0.001
    combiner: str = "wasserstein_mean"
    weiszfeld_iters: int = 50
    weiszfeld_eps: float = 1e-8
    phi_step: float = 0.5
    phi_adapt: bool = True
    phi_target_accept: float = 0.43
    phi_adapt_rate: float = 0.5
    phi_update_every: int = 1
    phi_sampler: str = "conditional"
    phi_proposals: int = 1
    phi_proposal_family: str = "gaussian"
    factor_reuse: bool = True
    u_solver: str = "chol"
    cg_iters: int = 64
    cg_matvec_dtype: str = "float32"
    cg_precond: str = "jacobi"
    cg_precond_rank: int = 256
    # Fused correlation build. The values keep the JAX package's names
    # so a config carries over 1:1: "pallas" selects the hand-written
    # CUDA kernel (smk_torch/csrc/fused_corr.cu, through
    # ops/fused_build.py) on a CUDA tensor and its plain PyTorch
    # version on a CPU tensor; "off" is the distance-matrix build
    # (ops/distance.py + ops/kernels.py). There is no silent fall-back
    # from "pallas" to "off" on the card: a kernel that fails to build
    # or launch raises.
    fused_build: str = "off"
    subset_engine: str = "dense"
    n_neighbors: int = 16
    build_dtype: str = "float32"
    chunk_pipeline: str = "sync"
    fault_policy: str = "abort"
    fault_max_retries: int = 2
    min_surviving_frac: float = 0.5
    dist_init_timeout_s: float = 120.0
    dist_init_retries: int = 3
    ckpt_commit_timeout_s: float = 120.0
    watchdog: bool = False
    watchdog_min_deadline_s: float = 60.0
    watchdog_margin: float = 10.0
    coalesce_window_ms: float = 0.0
    compile_store_dir: str = None
    xla_cache_dir: str = None
    run_log_dir: str = None
    live_diagnostics: bool = False
    profile_dir: str = None
    profile_chunks: str = None
    adaptive_schedule: str = "off"
    target_rhat: float = 1.05
    target_ess: float = 100.0
    adapt_patience: int = 2
    min_samples_before_stop: int = 0
    adapt_max_extra_frac: float = 0.5
    chol_block_size: int = 0
    trisolve_block_size: int = 0
    krige_cache: bool = True
    pg_n_terms: int = 64
    jitter: float = 1e-5
    jitter_per_m: float = 2.5e-7
    mask_noise_var: float = 1e8
    dtype: str = "float32"
    # The jax.lax.Precision aliases map onto PyTorch's float32 matmul
    # settings, set for the duration of a fit (api.fit_meta_kriging) and
    # restored afterwards: "highest" and "float32" keep fp32 products in
    # full fp32 (TF32 off for cuBLAS and cuDNN, precision "highest");
    # "high" and "tensorfloat32" allow TF32 (precision "high", both TF32
    # flags on); "default" and "bfloat16" set precision "medium" (bf16
    # passes where the backend has them). On the CPU nothing is set: the
    # twin's CPU backend keeps fp32 products in full fp32 whatever the
    # precision.
    matmul_precision: str = "highest"
    mesh_axis: str = "subsets"
    priors: PriorConfig = dataclasses.field(default_factory=PriorConfig)

    _INT_FIELDS = (
        "n_subsets", "n_samples", "n_chains", "n_quantiles",
        "resample_size", "weiszfeld_iters", "phi_update_every",
        "cg_iters", "cg_precond_rank", "chol_block_size",
        "trisolve_block_size", "pg_n_terms", "phi_proposals",
        "fault_max_retries", "dist_init_retries",
        "adapt_patience", "min_samples_before_stop",
        "n_neighbors",
    )

    def __post_init__(self):
        for name in self._INT_FIELDS:
            v = getattr(self, name)
            if isinstance(v, bool):
                raise ValueError(f"{name} must be an integer, got {v!r}")
            if not isinstance(v, int):
                if not isinstance(v, numbers.Real):
                    raise ValueError(f"{name} must be an integer, got {v!r}")
                try:
                    ok = float(v) == int(v)
                except (ValueError, OverflowError):
                    ok = False
                if not ok:
                    raise ValueError(f"{name} must be an integer, got {v!r}")
                object.__setattr__(self, name, int(v))
        pri = self.priors
        if pri.a_prior not in ("normal", "invwishart"):
            raise ValueError("priors.a_prior must be 'normal' or 'invwishart'")
        if pri.temper not in ("none", "power"):
            raise ValueError("priors.temper must be 'none' or 'power'")
        if pri.iw_df < 0 or pri.iw_scale <= 0:
            raise ValueError(
                "priors.iw_df must be >= 0 (0 = use q) and iw_scale > 0"
            )
        if self.cov_model not in COV_MODELS:
            raise ValueError(f"cov_model must be one of {COV_MODELS}")
        if self.partition_method not in PARTITION_METHODS:
            raise ValueError(
                f"partition_method must be one of {PARTITION_METHODS}"
            )
        if self.bucket_ladder is not None:
            object.__setattr__(
                self, "bucket_ladder", validate_ladder(self.bucket_ladder)
            )
        if self.link not in LINKS:
            raise ValueError(f"link must be one of {LINKS}")
        if self.combiner not in COMBINERS:
            raise ValueError(f"combiner must be one of {COMBINERS}")
        if not 0.0 < self.burn_in_frac < 1.0:
            raise ValueError("burn_in_frac must be in (0, 1)")
        if self.u_solver not in ("chol", "cg"):
            raise ValueError("u_solver must be 'chol' or 'cg'")
        if self.cg_matvec_dtype not in ("float32", "bfloat16"):
            raise ValueError("cg_matvec_dtype must be 'float32' or 'bfloat16'")
        if self.cg_precond not in ("jacobi", "nystrom"):
            raise ValueError("cg_precond must be 'jacobi' or 'nystrom'")
        if self.cg_precond_rank < 1:
            raise ValueError("cg_precond_rank must be >= 1")
        if self.jitter <= 0 or self.jitter_per_m < 0:
            raise ValueError("jitter must be > 0 and jitter_per_m >= 0")
        if self.fused_build not in ("off", "pallas"):
            raise ValueError("fused_build must be 'off' or 'pallas'")
        if self.subset_engine not in SUBSET_ENGINES:
            raise ValueError(f"subset_engine must be one of {SUBSET_ENGINES}")
        if self.n_neighbors < 1:
            raise ValueError("n_neighbors must be >= 1")
        if self.build_dtype not in BUILD_DTYPES:
            raise ValueError(f"build_dtype must be one of {BUILD_DTYPES}")
        if self.build_dtype == "bfloat16" and self.fused_build != "off":
            raise ValueError(
                "build_dtype='bfloat16' requires fused_build='off' — "
                "the fused build kernel carries its own dtype story"
            )
        if self.subset_engine == "vecchia":
            if self.phi_sampler != "conditional":
                raise ValueError(
                    "subset_engine='vecchia' requires "
                    "phi_sampler='conditional'"
                )
            if self.phi_proposals != 1:
                raise ValueError("subset_engine='vecchia' requires phi_proposals=1")
            if self.fused_build != "off":
                raise ValueError(
                    "subset_engine='vecchia' requires fused_build='off'"
                )
            if self.u_solver != "chol":
                raise ValueError("subset_engine='vecchia' requires u_solver='chol'")
        if self.chunk_pipeline not in CHUNK_PIPELINES:
            raise ValueError(f"chunk_pipeline must be one of {CHUNK_PIPELINES}")
        if self.fault_policy not in FAULT_POLICIES:
            raise ValueError(f"fault_policy must be one of {FAULT_POLICIES}")
        if self.fault_max_retries < 0:
            raise ValueError("fault_max_retries must be >= 0")
        if not 0.0 < self.min_surviving_frac <= 1.0:
            raise ValueError("min_surviving_frac must be in (0, 1]")
        if self.dist_init_timeout_s <= 0:
            raise ValueError("dist_init_timeout_s must be > 0")
        if self.dist_init_retries < 0:
            raise ValueError("dist_init_retries must be >= 0")
        if self.ckpt_commit_timeout_s <= 0:
            raise ValueError("ckpt_commit_timeout_s must be > 0")
        if not isinstance(self.watchdog, bool):
            raise ValueError(f"watchdog must be a bool, got {self.watchdog!r}")
        if self.watchdog_min_deadline_s <= 0:
            raise ValueError("watchdog_min_deadline_s must be > 0")
        if self.watchdog_margin < 1.0:
            raise ValueError("watchdog_margin must be >= 1")
        if self.coalesce_window_ms < 0:
            raise ValueError("coalesce_window_ms must be >= 0")
        for name in (
            "compile_store_dir", "xla_cache_dir", "run_log_dir", "profile_dir",
        ):
            v = getattr(self, name)
            if v is not None and not isinstance(v, str):
                raise ValueError(
                    f"{name} must be a directory path string or None, got {v!r}"
                )
        if not isinstance(self.live_diagnostics, bool):
            raise ValueError(
                f"live_diagnostics must be a bool, got {self.live_diagnostics!r}"
            )
        if self.adaptive_schedule not in ADAPTIVE_SCHEDULES:
            raise ValueError(
                f"adaptive_schedule must be one of {ADAPTIVE_SCHEDULES}"
            )
        if self.adaptive_schedule != "off":
            if not self.live_diagnostics:
                raise ValueError(
                    "adaptive_schedule='on' requires live_diagnostics=True — freeze "
                    "decisions are pure functions of the streaming boundary "
                    "diagnostics (parallel/schedule.py)"
                )
            if self.chunk_pipeline != "sync":
                raise ValueError(
                    "adaptive_schedule='on' requires chunk_pipeline='sync' — schedule "
                    "decisions and active-set compaction happen with the device idle "
                    "at the committed boundary"
                )
        if self.target_rhat <= 1.0:
            raise ValueError(
                "target_rhat must be > 1 (split-R-hat converges to 1 from above)"
            )
        if self.target_ess < 0:
            raise ValueError("target_ess must be >= 0")
        if self.adapt_patience < 1:
            raise ValueError("adapt_patience must be >= 1")
        if self.min_samples_before_stop < 0:
            raise ValueError("min_samples_before_stop must be >= 0")
        if self.adapt_max_extra_frac < 0:
            raise ValueError("adapt_max_extra_frac must be >= 0")
        if self.profile_chunks is not None:
            if not isinstance(self.profile_chunks, str):
                raise ValueError(
                    "profile_chunks must be a 'start[:stop]' string or "
                    f"None, got {self.profile_chunks!r}"
                )
            _validate_chunk_range(self.profile_chunks)
        if self.chol_block_size < 0:
            raise ValueError("chol_block_size must be >= 0")
        if self.trisolve_block_size < 0:
            raise ValueError("trisolve_block_size must be >= 0")
        if self.phi_update_every < 1:
            raise ValueError("phi_update_every must be >= 1")
        if self.phi_sampler not in ("conditional", "collapsed"):
            raise ValueError("phi_sampler must be 'conditional' or 'collapsed'")
        if self.phi_proposals < 1:
            raise ValueError("phi_proposals must be >= 1")
        if self.phi_proposal_family not in PHI_PROPOSAL_FAMILIES:
            raise ValueError(
                f"phi_proposal_family must be one of {PHI_PROPOSAL_FAMILIES}"
            )
        if self.phi_proposals > 1 and self.phi_sampler != "collapsed":
            raise ValueError(
                "phi_proposals > 1 (multiple-try Metropolis) is "
                "implemented for phi_sampler='collapsed' only"
            )
        if not isinstance(self.factor_reuse, bool):
            raise ValueError(
                f"factor_reuse must be a bool, got {self.factor_reuse!r}"
            )
        if self.n_chains < 1:
            raise ValueError("n_chains must be >= 1")
        if not 0.0 < self.phi_target_accept < 1.0:
            raise ValueError("phi_target_accept must be in (0, 1)")
        if self.phi_step <= 0.0:
            raise ValueError("phi_step must be > 0 (log-scale adapted)")
        if self.phi_adapt_rate < 0.0:
            raise ValueError("phi_adapt_rate must be >= 0")
        if self.pg_n_terms < 1:
            raise ValueError("pg_n_terms must be >= 1")
        if self.dtype not in ("float32", "float64"):
            raise ValueError("dtype must be 'float32' or 'float64'")
        if self.matmul_precision not in (
            "default", "high", "highest", "bfloat16", "tensorfloat32",
            "float32",
        ):
            raise ValueError(
                f"unknown matmul_precision {self.matmul_precision!r}"
            )

    def warn_if_tempered_multivariate(self, q: int) -> None:
        """Warn when ``priors.temper='power'`` meets a multivariate
        (q >= 2) fit — the config itself never sees q, so the entry
        points that do (api.fit_meta_kriging, and through it the R
        front-end) call this once the response count is known.

        Evidence: SMK_QUALITY_r05.jsonl — all four q=2 cells fail the
        tempered-prior quality gate (meta-vs-full K gaps of 2-4
        full-posterior sd). With two responses the IW prior is
        load-bearing for identifying the coregionalization scale, and
        the 1/K-powered prior lets K drift high. Tempering is
        validated at q=1 only (SMK_QUALITY_r04.jsonl: K[0,0] gap
        1.9 -> 0.9 sd)."""
        if self.priors.temper == "power" and q >= 2:
            import warnings

            warnings.warn(
                "priors.temper='power' with q>=2 responses is known to "
                "over-correct: the 1/K-tempered IW prior "
                "under-identifies the coregionalization scale K "
                "(meta-vs-full gaps of 2-4 posterior sd, "
                "SMK_QUALITY_r05.jsonl). Tempering is validated for "
                "q=1 only — prefer priors.temper='none' for "
                "multivariate fits.",
                UserWarning,
                stacklevel=3,
            )

    def mtm_workspace_bytes(self, m: int) -> int:
        """Peak extra fp32 workspace of one multi-try phi update at
        subset size ``m``: the forward (J+1, m, m) correlation stack
        and its factor are live together (the reverse (J-1, m, m)
        batch allocates only after a barrier kills them, so the
        forward pair is the peak). Zero when phi_proposals == 1 —
        the sequential path's barrier-sequenced ~2 m^2 buffers are
        the pre-MTM status quo, not an MTM cost."""
        j = self.phi_proposals
        if j <= 1:
            return 0
        return 2 * (j + 1) * m * m * 4

    def warn_if_mtm_workspace_large(
        self, m: int, *, budget_bytes: int = 2 * 1024**3
    ) -> None:
        """Warn when the MTM proposal fan-out's batched workspace at
        subset size ``m`` exceeds ``budget_bytes`` (default 2 GiB —
        a conservative share of a 16 GB v5e once the carried
        (q, m, m) state and the K-vmap axis are accounted). Called by
        api.fit_meta_kriging once m is known; purely advisory (the
        fit proceeds — lower J, raise n_subsets, or chunk K)."""
        ws = self.mtm_workspace_bytes(m)
        if ws > budget_bytes:
            import warnings

            warnings.warn(
                f"phi_proposals={self.phi_proposals} at subset size "
                f"m={m} holds a ~{ws / 1e9:.1f} GB batched proposal "
                "workspace per component during each collapsed phi "
                "update (2(J+1) m^2 fp32 buffers live at once; see "
                "SMKConfig.mtm_workspace_bytes). With the K-vmapped "
                "executor this multiplies across concurrently "
                "updating subsets — consider a smaller "
                "phi_proposals, more/smaller subsets, or chunk_size "
                "to bound resident K.",
                UserWarning,
                stacklevel=3,
            )

    def effective_jitter(self, m: int) -> float:
        """Diagonal jitter for an m x m correlation factorization."""
        return max(self.jitter, self.jitter_per_m * m)

    @property
    def n_burn_in(self) -> int:
        return int(self.burn_in_frac * self.n_samples)

    @property
    def n_kept(self) -> int:
        return self.n_samples - self.n_burn_in


# (knob, predicate on the config, ROADMAP item that ports it). Checked
# in this order by check_ported; the first hit raises.
_UNPORTED = (
    ("compile_store_dir", lambda c: c.compile_store_dir is not None, "A10"),
    ("xla_cache_dir", lambda c: c.xla_cache_dir is not None, "A10"),
    ("coalesce_window_ms>0", lambda c: c.coalesce_window_ms > 0, "A11d"),
)


def check_ported(cfg: SMKConfig) -> None:
    """Raise ``NotImplementedError`` for a knob value this port does not
    implement yet, naming the ROADMAP item that ports it. Called when a
    fit starts: an unported knob is never silently ignored."""
    for knob, unported, item in _UNPORTED:
        if unported(cfg):
            raise NotImplementedError(
                f"SMKConfig {knob} is not ported to smk_torch yet "
                f"(ROADMAP {item}); the JAX package smk_tpu runs it"
            )
