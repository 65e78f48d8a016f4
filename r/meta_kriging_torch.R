# R front-end for the PyTorch/CUDA spatial meta-kriging package
# (smk_torch), for an NVIDIA GPU.
#
# The reference workflow (MetaKriging_BinaryResponse.R) is an R script
# whose inputs are free global variables (n, y.1, y.2, x.1, x.2,
# coords, weight, coords.test, x.test, n.core — SURVEY.md §1.1). This
# front-end keeps the R-facing contract but makes every input an
# explicit argument and adds the `backend=` switch: backend = "gpu"
# (or "cpu") dispatches the heavy numerics — per-subset Bayesian
# spatial probit GP MCMC, posterior combination, predictive kriging —
# to smk_torch via reticulate, on the CUDA device (or the CPU), while
# data assembly and diagnostics stay in R.
#
# It has the functions, arguments and returned list names of
# r/meta_kriging_tpu.R: an R user switches packages by sourcing the
# other file. What differs follows smk_torch's Python API: `backend`
# maps to the `device` argument of each call ("cuda" or "cpu"; "gpu"
# with no CUDA device fails with smk_torch's own error, never a quiet
# drop to the CPU), and `seed` is an integer keyword (smk_torch draws
# from its own seeded generators). smk.predict.serve takes `backend`
# too, since a serving engine lives on a device.
#
# Usage:
#   source("r/meta_kriging_torch.R")
#   fit <- meta_kriging_binary(
#     y = list(y.1, y.2),          # K binary/binomial response vectors
#     x = list(x.1, x.2),          # matching n x p design matrices
#     coords = coords,             # n x 2 coordinates
#     coords.test = coords.test,   # t x 2 prediction locations
#     x.test = list(xt.1, xt.2),   # t x p prediction designs
#     weight = 1,                  # binomial trial count
#     n.core = 20,                 # K subsets (reference hardcoded 20)
#     n.samples = 5000,            # MCMC budget (reference 100x50)
#     backend = "gpu",
#     combiner = "wasserstein_mean", # or "weiszfeld_median"
#     config.overrides = list(      # any SMKConfig field, e.g. the
#       u_solver = "cg",            # scaling-regime solver knobs
#       cg_iters = 8L, cg_precond = "nystrom"
#     )
#   )
#
# Returned list mirrors the reference script's outputs:
#   $result      combined parameter quantile grid   (R:123-127)
#   $result2     combined latent quantile grid      (R:129-133)
#   $SamplePar   resampled parameter draws          (R:145)
#   $Samplew     resampled latent draws             (R:146)
#   $p.sample    predictive probability draws       (R:156-161)
#   $param.quant / $w.quant / $p.quant  median + 95% CI (R:163-165)
#   $phi.accept  per-subset MH acceptance (diagnostic)
#   $ess         per-subset Geyer effective sample size per parameter
#                (K x n_params; columns named by $param.names); with
#                n_chains > 1 in config.overrides, summed over chains
#   $rhat        per-subset split-R-hat per parameter (K x n_params;
#                cross-chain when n_chains > 1) — values near 1 mean
#                converged (the reference offered only acceptance
#                printouts + traceplots, R:84,148-149)
#   $w.ess / $w.rhat  the same per predicted latent (K x t*q)
#   $ess.per.sec total latent ESS / subset-fit seconds (the headline
#                sampling-efficiency number)
#   $phases      wall-clock per pipeline phase

# smk_torch's device for a backend: the CUDA device ("gpu") or the CPU
.smk.device <- function(backend) {
  if (backend == "gpu") "cuda" else "cpu"
}

# a result field as an R value: tensors come home from the device
# first (a CUDA tensor has no numpy view); numpy arrays pass through
.smk.to_r <- function(a) {
  if (reticulate::py_has_attr(a, "cpu")) a <- a$detach()$cpu()$numpy()
  reticulate::py_to_r(reticulate::import("numpy")$asarray(a))
}

meta_kriging_binary <- function(y, x, coords, coords.test, x.test,
                                weight = 1, n.core = 20,
                                n.samples = 5000, burn.in = 0.75,
                                cov.model = "exponential",
                                combiner = "wasserstein_mean",
                                link = c("probit", "logit"),
                                k.prior = c("invwishart", "normal"),
                                phi.proposals = 1L,
                                phi.proposal.family = c("gaussian",
                                                        "student_t",
                                                        "mixture"),
                                fused.build = c("off", "pallas"),
                                subset.engine = c("dense", "vecchia"),
                                n.neighbors = 16L,
                                build.dtype = c("float32",
                                                "bfloat16"),
                                partition.method = c("random",
                                                     "coherent"),
                                bucket.ladder = NULL,
                                chunk.pipeline = c("sync", "overlap"),
                                adaptive.schedule = c("off", "on"),
                                target.rhat = 1.05,
                                target.ess = 100,
                                adapt.max.extra.frac = 0.5,
                                fault.policy = c("abort", "quarantine"),
                                fault.max.retries = 2L,
                                watchdog = FALSE,
                                dist.init.timeout.s = 120,
                                ckpt.commit.timeout.s = 120,
                                n.report = NULL,
                                checkpoint.path = NULL,
                                compile.store.dir = NULL,
                                run.log.dir = NULL,
                                n.devices = NULL,
                                backend = c("gpu", "cpu"),
                                seed = 0L,
                                python_path = NULL,
                                config.overrides = list()) {
  # k.prior: prior on the cross-covariance K = A A^T —
  # "invwishart" is the reference's own K.IW(q, 0.1 I)
  # (MetaKriging_BinaryResponse.R:64) and the default; "normal" is
  # the pure-conjugate N(0, a_scale^2)-rows-on-A alternative.
  # Prior tempering (config.overrides = list(priors =
  # smk$PriorConfig(temper = "power"))) is validated for SINGLE-
  # response fits only: at q >= 2 the 1/K-powered IW prior under-
  # identifies the coregionalization scale K — the Python backend
  # emits a warning when a q >= 2 fit is tempered; leave temper =
  # "none" (the default) for multivariate data.
  # phi.proposals / phi.proposal.family: the multi-try collapsed-phi
  # engine (SMKConfig.phi_proposals): J > 1 evaluates J candidate
  # range updates per move from ONE batched (J+1, m, m) Cholesky and
  # accepts by the multiple-try Metropolis ratio — the mixing lever
  # for slow-phi fits (Matern-3/2 above all). "student_t"/"mixture"
  # put proposal mass at several scales at once. phi.proposals > 1
  # requires the collapsed sampler (config.overrides = list(
  # phi_sampler = "collapsed")); the default 1/"gaussian" is the
  # classic single-try chain bit-exactly.
  # fused.build: "pallas" (the option keeps its name) routes every
  # dense correlation build (the multi-try candidate stacks, the
  # dense-path R rebuild, the kriging cross/test builds) through the
  # hand-written CUDA kernels that recompute distance on the fly from
  # the coordinates (smk_torch/csrc/fused_corr.cu) — the memory-
  # bandwidth lever for large subsets and phi.proposals > 1. "off"
  # (default) is the unfused torch chain bit-identically; "pallas"
  # matches it to fp32 tolerance only. On backend = "cpu" each
  # kernel's plain PyTorch version runs — correctness-preserving, for
  # validation; the bandwidth win the kernels exist for is the GPU's.
  # n.report: if set, progress is printed every n.report iterations
  # (the reference's n.report batch printouts, R:84) — the fit then
  # runs through the chunked executor. checkpoint.path: if set, the
  # fit checkpoints each chunk and an interrupted call resumes.
  # chunk.pipeline: the chunked executor's host loop. "sync"
  # (default) blocks between chunks for the progress/guard fetches
  # and the checkpoint write; "overlap" snapshots each chunk's
  # outputs with async device-to-host copies and dispatches the next
  # chunk FIRST, running those host steps (checkpoint writes on a
  # background thread) while the GPU computes — the draws are
  # bit-identical either way, so "overlap" is purely a throughput
  # lever for long checkpointed fits (a background write failure
  # warns and falls back to synchronous writes).
  # fault.policy: what one numerically failed subset does to the run.
  # "abort" (default) stops with an error naming the shards;
  # "quarantine" retries the sick subset from its last finite
  # chunk-start state with a fresh random stream (fault.max.retries
  # attempts, tightened proposal step each time), then DROPS it — the
  # combined posterior is built over the survivors, the dropped
  # subset indices are reported, and the fit errors only when fewer
  # than min_surviving_frac (config.overrides, default 0.5) of the
  # n.core subsets survive. Fault-free fits are bit-identical across
  # policies; see the README's "Fault tolerance" section.
  # watchdog: arm the chunked executor's per-chunk deadline guard
  # (smk_torch/parallel/domains.py) — a hung dispatch or stuck
  # collective becomes a typed ChunkTimeoutError naming the
  # implicated failure domains (processes/devices) instead of an
  # indefinite hang. Purely observational: draws are bit-identical
  # armed vs off. dist.init.timeout.s: the per-attempt timeout of
  # the process group's rendezvous (SMKConfig dist_init_timeout_s;
  # transient failures retry with exponential backoff,
  # dist_init_retries via config.overrides). With
  # fault.policy = "quarantine", a whole failure domain dying drops
  # only its subsets — the dropped domain indices are returned as
  # $domains.dropped and the combined posterior is built over the
  # survivors.
  # ckpt.commit.timeout.s: the distributed checkpoint's per-commit
  # deadline (SMKConfig ckpt_commit_timeout_s). Under a multi-process
  # mesh every chunk boundary is published as one two-phase-committed
  # GENERATION — each process lands its shard files, a cross-process
  # barrier confirms them, process 0 publishes the manifest; a dead
  # peer turns the commit into a typed error within this deadline
  # instead of a hang, and a relaunch resumes from the last COMMITTED
  # generation. The adaptive schedule's per-boundary agreement over
  # the processes runs under the same deadline. Pure coordination:
  # checkpoints written under one deadline resume under any other.
  # compile.store.dir: directory of the program store
  # (smk_torch/compile/): the built CUDA kernel libraries are stored
  # there, so every later fit — INCLUDING in a fresh R session —
  # loads them instead of running nvcc again. Draws are bit-identical
  # with the store on or off; a stale (different torch/CUDA/card) or
  # corrupt artifact is rebuilt with a warning, never mis-loaded.
  # Implies the chunked executor.
  # n.devices: lay the n.core subsets over a device mesh of the
  # first n.devices CUDA devices (the scale-out axis). Passed through
  # to the Python API's n_devices, which builds the mesh via the one
  # sanctioned constructor (smk_torch.parallel.executor.make_mesh);
  # the whole fit -> combine -> predict pipeline then stays
  # device-resident (the quantile grids are gathered onto the mesh's
  # home device, prediction runs row-split).
  # n.devices composes with every partition.method: equal-m
  # partitions need n.core divisible by n.devices, while
  # "coherent" (ragged) partitions need no
  # divisibility at all — the ragged-mesh planner bin-packs the
  # occupied bucket groups onto the mesh (K-pad clones on prefix
  # sub-meshes, small groups fused into super-batches) and reports
  # the mesh-induced row overhead as $pad.waste.frac, guaranteed
  # below min(1, max(0.25, 2/n.devices)). NULL (default) keeps the
  # single-device path bit-identically; on a 1-device mesh results
  # are also bit-identical to NULL — including the coherent path,
  # whose 1-device plan degenerates to the host ragged fit.
  # run.log.dir: directory for the structured per-fit run log
  # (smk_torch/obs/). When set, every fit appends one JSONL timeline
  # file there — phases as nested spans, every chunk/fault/
  # compile/checkpoint as an event — and the file path is returned
  # as $run.log.path; summarize it with
  #   python -m smk_torch.obs summarize <path>
  # Pure observability: the draws are bit-identical with the log on
  # or off.
  # partition.method: how rows are assigned to the n.core subsets.
  # "random" is the reference's uniform split bit-identically;
  # "coherent" is the Morton/Z-order SPATIAL split — each subset a
  # compact neighborhood, whose unequal subset sizes pad onto the
  # powers-of-sqrt(2) shape-bucket ladder so the fit builds one
  # program set per OCCUPIED bucket instead of one per distinct size.
  # bucket.ladder: optional explicit ladder (ascending integer
  # vector) for the coherent path; NULL = the automatic sqrt(2)
  # ladder covering the largest subset.
  # adaptive.schedule: per-subset early stopping. "off" (default) is
  # the fixed chunk schedule bit-identically. "on" freezes each
  # subset once its STREAMING cross-chain diagnostics clear
  # target.rhat AND target.ess for a patience window, compacts the
  # active set onto the next sqrt(2)-ladder rung, and regrants the
  # saved chunk budget to the slowest-mixing subsets (at most
  # adapt.max.extra.frac x n.samples extra draws per subset). Needs
  # n_chains >= 2 via config.overrides for real cross-chain R-hat.
  # Over a multi-process mesh every process holds the one schedule
  # over all n.core subsets. The fit returns $frozen.at (per-subset
  # freeze iteration, -1 = never froze) and $chunks.saved.frac
  # (fraction of the fixed schedule's subset-chunks NOT dispatched);
  # both NULL when "off".
  k.prior <- match.arg(k.prior)
  phi.proposal.family <- match.arg(phi.proposal.family)
  fused.build <- match.arg(fused.build)
  # subset.engine: "vecchia" swaps the dense (m, m) subset
  # factorization for the sparse Vecchia/NNGP precision — each site
  # conditions on its n.neighbors nearest Morton predecessors, so the
  # latent update runs in O(m * nn^3) flops and O(m * nn) memory
  # instead of O(m^3)/O(m^2); subset sizes the dense engine cannot
  # even dispatch become routine. The posterior is an approximation
  # that sharpens as n.neighbors grows (16 is the literature's
  # workhorse). "dense" (default) is the historical chain
  # bit-identically. build.dtype = "bfloat16" evaluates the
  # correlation build in bf16 and factors in fp32 (off by default;
  # gated to the unfused build).
  subset.engine <- match.arg(subset.engine)
  build.dtype <- match.arg(build.dtype)
  partition.method <- match.arg(partition.method)
  chunk.pipeline <- match.arg(chunk.pipeline)
  adaptive.schedule <- match.arg(adaptive.schedule)
  fault.policy <- match.arg(fault.policy)
  # link: the reference workflow is logit (spMvGLM binomial fit,
  # 1/(1+exp(-eta)) at MetaKriging_BinaryResponse.R:160); the default
  # here is the exact Albert–Chib probit sampler. Users porting the
  # reference side-by-side should pass link = "logit" — coefficient
  # scales differ between the links by ~1.7x.
  link <- match.arg(link)
  backend <- match.arg(backend)
  if (!requireNamespace("reticulate", quietly = TRUE)) {
    stop("the GPU backend (smk_torch) needs the 'reticulate' package")
  }
  if (!is.null(python_path)) reticulate::use_python(python_path)

  if (is.matrix(y) || is.numeric(y)) y <- list(y)
  if (is.matrix(x)) x <- list(x)
  if (is.matrix(x.test)) x.test <- list(x.test)
  q <- length(y)
  n <- length(y[[1]])
  p <- ncol(x[[1]])

  # stack to the framework's layouts: y (n, q); x (n, q, p);
  # x.test (t, q, p)
  y_arr <- sapply(y, as.numeric)                       # n x q
  x_arr <- aperm(simplify2array(x), c(1, 3, 2))        # n x q x p
  xt_arr <- aperm(simplify2array(x.test), c(1, 3, 2))  # t x q x p

  smk <- reticulate::import("smk_torch")

  # config.overrides: named list merged into the SMKConfig call —
  # exposes every typed field (solver knobs like u_solver / cg_iters /
  # cg_precond, jitter, matmul_precision, ...) without enumerating
  # them here. Plain R numerics are fine for the integer fields
  # (SMKConfig coerces whole-valued doubles — reticulate sends R
  # numerics as Python floats); e.g.
  # list(u_solver = "cg", cg_iters = 8, cg_precond = "nystrom")
  cfg_args <- utils::modifyList(list(
    n_subsets = as.integer(n.core),
    n_samples = as.integer(n.samples),
    burn_in_frac = burn.in,
    cov_model = cov.model,
    combiner = combiner,
    link = link,
    phi_proposals = as.integer(phi.proposals),
    phi_proposal_family = phi.proposal.family,
    fused_build = fused.build,
    subset_engine = subset.engine,
    n_neighbors = as.integer(n.neighbors),
    build_dtype = build.dtype,
    partition_method = partition.method,
    bucket_ladder = if (is.null(bucket.ladder)) NULL else
      as.integer(bucket.ladder),
    chunk_pipeline = chunk.pipeline,
    adaptive_schedule = adaptive.schedule,
    target_rhat = target.rhat,
    target_ess = target.ess,
    adapt_max_extra_frac = adapt.max.extra.frac,
    fault_policy = fault.policy,
    fault_max_retries = as.integer(fault.max.retries),
    watchdog = watchdog,
    dist_init_timeout_s = dist.init.timeout.s,
    ckpt_commit_timeout_s = ckpt.commit.timeout.s,
    compile_store_dir = compile.store.dir,
    run_log_dir = run.log.dir,
    priors = smk$PriorConfig(a_prior = k.prior)
  ), config.overrides)
  cfg <- do.call(smk$SMKConfig, cfg_args)
  extra <- list()
  if (!is.null(n.report)) {
    extra$chunk_iters <- as.integer(n.report)
    extra$progress <- function(info) {
      cat(sprintf(
        "smk [%s] iteration %d/%d  phi acceptance %.3f\n",
        info$phase, info$iteration, info$n_samples,
        info$phi_accept_rate
      ))
    }
  }
  if (!is.null(checkpoint.path)) {
    extra$checkpoint_path <- checkpoint.path
  }
  if (!is.null(n.devices)) {
    extra$n_devices <- as.integer(n.devices)
  }
  res <- do.call(smk$fit_meta_kriging, c(list(
    reticulate::np_array(y_arr, dtype = "float32"),
    reticulate::np_array(x_arr, dtype = "float32"),
    reticulate::np_array(coords, dtype = "float32"),
    reticulate::np_array(coords.test, dtype = "float32"),
    reticulate::np_array(xt_arr, dtype = "float32"),
    config = cfg,
    weight = as.integer(weight),
    seed = as.integer(seed),
    device = .smk.device(backend)
  ), extra))

  to_r <- .smk.to_r
  list(
    result = to_r(res$param_grid),
    result2 = to_r(res$w_grid),
    SamplePar = to_r(res$sample_par),
    Samplew = to_r(res$sample_w),
    p.sample = to_r(res$p_samples),
    param.quant = to_r(res$param_quant),
    w.quant = to_r(res$w_quant),
    p.quant = to_r(res$p_quant),
    phi.accept = to_r(res$phi_accept_rate),
    ess = to_r(res$param_ess),
    rhat = to_r(res$param_rhat),
    w.ess = to_r(res$w_ess),
    w.rhat = to_r(res$w_rhat),
    ess.per.sec = res$latent_ess_per_sec,
    phases = res$phase_seconds,
    # 0-based subset indices dropped under fault.policy =
    # "quarantine" (empty integer vector on a healthy run)
    subsets.dropped = as.integer(unlist(res$subsets_dropped)),
    # 0-based FAILURE-DOMAIN indices (processes/devices) that lost
    # every subset (empty on a healthy run)
    domains.dropped = as.integer(unlist(res$domains_dropped)),
    # path of the structured run log (NULL unless run.log.dir was set)
    run.log.path = res$run_log_path,
    # mesh-induced pad-row overhead of a ragged (coherent) fit:
    # 0 on the host ragged path, the ragged-mesh planner's
    # pad_waste_frac under n.devices (< min(1, max(0.25,
    # 2/n.devices))), NULL for equal-m partitions
    pad.waste.frac = res$pad_waste_frac,
    # adaptive schedule: per-subset freeze iteration (-1 = sampled
    # the full plan) and the fraction of the fixed schedule's
    # subset-chunks the scheduler did NOT dispatch; both NULL when
    # adaptive.schedule = "off"
    frozen.at = if (is.null(res$frozen_at)) NULL else
      as.integer(unlist(res$frozen_at)),
    chunks.saved.frac = res$chunks_saved_frac,
    param.names = unlist(
      reticulate::import("smk_torch.api")$param_names(as.integer(q), as.integer(p))
    )
  )
}

# Traceplot diagnostics of the combined posterior, mirroring the
# reference's plots (R:148-149): first parameter and first latent.
plot_smk_traces <- function(fit) {
  op <- par(mfrow = c(1, 2))
  on.exit(par(op))
  plot(fit$SamplePar[, 1], type = "l",
       main = "combined posterior: parameter 1", ylab = fit$param.names[1])
  plot(fit$Samplew[, 1], type = "l",
       main = "combined posterior: latent 1", ylab = "w*[1]")
}

# Serving pass-through (smk_torch/serve/): predict p(y=1) with
# credible intervals at arbitrary query locations from a frozen fit
# artifact (smk_torch.serve.save_artifact), through the batched
# prediction engine — a bucket ladder of captured programs, bounded
# admission, per-request deadlines, per-row NaN quarantine.
#
# artifact.path: path of the .npz bundle save_artifact wrote.
# coords.query: n_q x d matrix; x.query: list of q n_q x p design
#   matrices (same layout convention as x.test above).
# deadline.ms: per-request deadline budget in milliseconds (NULL =
#   the engine default). A wedged dispatch raises the typed Python
#   RequestTimeoutError within the deadline instead of hanging R.
# compile.store.dir: optional program store — a warm store serves
#   with zero nvcc runs.
# coalesce.window.ms: cross-request coalescing window — milliseconds
#   the engine may hold a request to pack it with concurrent ones into
#   one padded ladder dispatch (NULL/0 = off, the per-request path).
#   Deadline-aware: a request is never held past its budget, and held
#   time is reported via held.s.
# n.replicas: run N engine replicas (threads, one process) sharing
#   the program store behind a shedding front door (serve/fleet.py);
#   NULL/1 = a single engine.
# backend: the engine's device, "gpu" (the CUDA device) or "cpu".
# one engine per (artifact, store, backend) per R session: the
# engine's whole design is that warm-up (artifact load, device copy,
# the bucket ladder's programs) happens ONCE and requests are pure
# execution — rebuilding it per call would re-pay warm-up on every
# predict
.smk.serve.engines <- new.env(parent = emptyenv())

smk.predict.serve <- function(artifact.path, coords.query, x.query,
                              deadline.ms = NULL,
                              seed = 0,
                              compile.store.dir = NULL,
                              coalesce.window.ms = NULL,
                              n.replicas = NULL,
                              backend = c("gpu", "cpu")) {
  backend <- match.arg(backend)
  # the file's identity (mtime + size) rides the cache key: a
  # re-saved artifact at the same path must build a FRESH engine,
  # never silently serve the stale fit. The serving topology knobs
  # (coalescing window, replica count, device) ride it too — they
  # change which engine object must exist, not how a request is
  # phrased
  art_info <- file.info(artifact.path)
  eng_key <- paste0(
    artifact.path, "|",
    as.numeric(art_info$mtime), "|", art_info$size, "|",
    if (is.null(compile.store.dir)) "" else compile.store.dir, "|",
    if (is.null(coalesce.window.ms)) 0 else coalesce.window.ms, "|",
    if (is.null(n.replicas)) 1 else n.replicas, "|",
    backend
  )
  eng <- get0(eng_key, envir = .smk.serve.engines)
  if (is.null(eng)) {
    serve <- reticulate::import("smk_torch.serve")
    eng_args <- list(artifact.path, device = .smk.device(backend))
    if (!is.null(compile.store.dir)) {
      eng_args$compile_store_dir <- compile.store.dir
    }
    if (!is.null(coalesce.window.ms)) {
      eng_args$coalesce_window_ms <- coalesce.window.ms
    }
    if (!is.null(n.replicas) && n.replicas > 1) {
      eng_args$n_replicas <- as.integer(n.replicas)
      eng <- do.call(serve$ReplicaFleet, eng_args)
    } else {
      eng <- do.call(serve$PredictionEngine, eng_args)
    }
    # evict engines superseded by a re-save of the same artifact at
    # this (path, store, backend) — their key differs only in
    # mtime/size, and without eviction a long-lived session (e.g. a
    # Shiny server that periodically re-exports the fit) pins one full
    # engine — device arrays + bucket programs — per re-export, forever
    store_sfx <- paste0(
      "|", if (is.null(compile.store.dir)) "" else compile.store.dir,
      "|", if (is.null(coalesce.window.ms)) 0 else coalesce.window.ms,
      "|", if (is.null(n.replicas)) 1 else n.replicas,
      "|", backend
    )
    stale <- Filter(
      function(k) {
        k != eng_key &&
          startsWith(k, paste0(artifact.path, "|")) &&
          endsWith(k, store_sfx)
      },
      ls(envir = .smk.serve.engines)
    )
    if (length(stale)) rm(list = stale, envir = .smk.serve.engines)
    assign(eng_key, eng, envir = .smk.serve.engines)
  }
  if (is.matrix(x.query)) x.query <- list(x.query)
  xq_arr <- aperm(simplify2array(x.query), c(1, 3, 2))
  args <- list(
    reticulate::np_array(coords.query, dtype = "float32"),
    reticulate::np_array(xq_arr, dtype = "float32"),
    seed = as.integer(seed)
  )
  if (!is.null(deadline.ms)) {
    args$deadline_s <- deadline.ms / 1000
  }
  res <- do.call(eng$predict, args)
  to_r <- .smk.to_r
  list(
    p.quant = to_r(res$p_quant),
    # per-row quarantine mask of the typed PARTIAL response: TRUE
    # rows came back non-finite and must not be used
    rows.degraded = as.logical(to_r(res$rows_degraded)),
    buckets = as.integer(unlist(res$buckets)),
    request.id = res$request_id,
    latency.s = res$latency_s,
    # time the coalescer held this request before dispatch (0 when
    # coalesce.window.ms is off). latency.s includes it.
    held.s = res$held_s,
    health = eng$health()
  )
}

# ---------------------------------------------------------------------------
# Live fleet: streaming ingest + incremental dirty-group re-fits
# ---------------------------------------------------------------------------
# smk.live.fit opens a LiveFit — the growable dataset, its Morton-
# coherent partition, and the generation directory the fleet serves
# from — and runs the initial fit (publishes generation 0) on the
# backend's device.
# smk.ingest appends a batch of new observations: each row routes to
# its Morton subset deterministically, only the touched subsets are
# marked dirty, and NOTHING republishes (the fleet keeps serving).
# smk.refit re-fits ONLY the dirty subsets warm-started from the
# carried combined posterior, splices them into the untouched
# subsets' bitwise-carried draws, re-runs the combiner, and publishes
# the next generation ($generation on the result; $refit.speedup is
# the full-fit wall over this dirty-only wall at the SAME per-subset
# MCMC schedule — a like-for-like ratio). Swap a serving engine onto
# the new generation with smk.predict.serve against the new
# artifact, or via the Python API's engine$swap_artifact.
# One live fit per gen.dir per R session (the partition, router and
# carried posteriors live on the handle).
.smk.live.fits <- new.env(parent = emptyenv())

smk.live.fit <- function(gen.dir, y, x, coords, coords.test, x.test,
                         weight = 1, n.core = 20,
                         n.samples = 5000, burn.in = 0.75,
                         cov.model = "exponential",
                         combiner = "wasserstein_mean",
                         link = c("probit", "logit"),
                         bucket.ladder = NULL,
                         run.log.dir = NULL,
                         backend = c("gpu", "cpu"),
                         seed = 0L,
                         config.overrides = list()) {
  link <- match.arg(link)
  backend <- match.arg(backend)
  if (!requireNamespace("reticulate", quietly = TRUE)) {
    stop("the GPU backend (smk_torch) needs the 'reticulate' package")
  }
  if (is.matrix(y) || is.numeric(y)) y <- list(y)
  if (is.matrix(x)) x <- list(x)
  if (is.matrix(x.test)) x.test <- list(x.test)
  y_arr <- sapply(y, as.numeric)
  x_arr <- aperm(simplify2array(x), c(1, 3, 2))
  xt_arr <- aperm(simplify2array(x.test), c(1, 3, 2))

  smk <- reticulate::import("smk_torch")
  serve <- reticulate::import("smk_torch.serve")
  cfg_args <- utils::modifyList(list(
    n_subsets = as.integer(n.core),
    n_samples = as.integer(n.samples),
    burn_in_frac = burn.in,
    cov_model = cov.model,
    combiner = combiner,
    link = link,
    # the ingest router IS the coherent partition's Morton code
    # arithmetic — LiveFit refuses any other partition.method
    partition_method = "coherent",
    bucket_ladder = if (is.null(bucket.ladder)) NULL else
      as.integer(bucket.ladder),
    run_log_dir = run.log.dir
  ), config.overrides)
  cfg <- do.call(smk$SMKConfig, cfg_args)
  live <- serve$LiveFit(
    gen.dir, config = cfg,
    coords_test = reticulate::np_array(coords.test, dtype = "float64"),
    x_test = reticulate::np_array(xt_arr, dtype = "float64"),
    weight = as.integer(weight),
    device = .smk.device(backend)
  )
  manifest <- live$fit(
    as.integer(seed),
    reticulate::np_array(y_arr, dtype = "float64"),
    reticulate::np_array(x_arr, dtype = "float64"),
    reticulate::np_array(coords, dtype = "float64")
  )
  assign(gen.dir, live, envir = .smk.live.fits)
  list(
    generation = as.integer(manifest$generation),
    artifact = manifest$artifact,
    n.rows = live$n_rows,
    subset.sizes = as.integer(unlist(live$subset_sizes)),
    gen.dir = gen.dir
  )
}

.smk.live.get <- function(gen.dir) {
  live <- get0(gen.dir, envir = .smk.live.fits)
  if (is.null(live)) {
    stop(sprintf(
      "no live fit open for '%s' in this session — call smk.live.fit first",
      gen.dir
    ))
  }
  live
}

smk.ingest <- function(gen.dir, y.new, x.new = NULL, coords.new) {
  live <- .smk.live.get(gen.dir)
  if (is.matrix(y.new) || is.numeric(y.new)) y.new <- list(y.new)
  y_arr <- sapply(y.new, as.numeric)
  args <- list(
    reticulate::np_array(y_arr, dtype = "float64"),
    coords_new = reticulate::np_array(coords.new, dtype = "float64")
  )
  if (!is.null(x.new)) {
    if (is.matrix(x.new)) x.new <- list(x.new)
    xb_arr <- aperm(simplify2array(x.new), c(1, 3, 2))
    args$x_new <- reticulate::np_array(xb_arr, dtype = "float64")
  }
  receipt <- do.call(live$ingest, args)
  list(
    n.rows = as.integer(receipt$n_rows),
    routed.subsets = as.integer(unlist(receipt$routed_subsets)),
    dirty.subsets = as.integer(unlist(receipt$dirty_subsets)),
    dirty.group.frac = receipt$dirty_group_frac,
    # the generation STILL being served — ingest never republishes
    generation = as.integer(receipt$generation)
  )
}

smk.refit <- function(gen.dir, full = FALSE, seed = 1L) {
  live <- .smk.live.get(gen.dir)
  report <- live$refit(
    as.integer(seed), full = isTRUE(full)
  )
  list(
    generation = if (is.null(report$generation)) NULL else
      as.integer(report$generation),
    refit.subsets = as.integer(unlist(report$refit_subsets)),
    reused.subsets = as.integer(unlist(report$reused_subsets)),
    dirty.group.frac = report$dirty_group_frac,
    refit.wall.s = report$refit_wall_s,
    # full-fit wall over this dirty-only wall, same MCMC schedule on
    # both sides (matched convergence floor); NULL on a full refit
    refit.speedup = report$refit_speedup,
    rhat.max = report$param_rhat_max,
    skipped = isTRUE(report$skipped)
  )
}
