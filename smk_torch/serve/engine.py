"""The batched prediction engine — twin of the per-request path of
``smk_tpu/serve/engine.py``: one engine wraps one frozen
:class:`~smk_torch.serve.artifact.FitArtifact` and serves
``predict(coords_query, x_query)`` — p(y=1) with credible intervals at
arbitrary query locations — on the card, with the twin's failure
semantics:

- **Bucket ladder**: a request is cut into slices of at most
  ``max(buckets)`` rows, each padded to the smallest bucket that holds it
  (compile/buckets.slice_plan). Pad rows repeat the slice's first query;
  the composition draw is row-independent, so they never perturb a real
  row. Each bucket's predict and guard programs come from an in-process
  table (the program store is ROADMAP A10), and ``warm=True`` runs every
  bucket once at construction so the first request finds cuBLAS and
  cuSOLVER handles, loaded modules and allocator blocks in place.
- **Admission control**: a bounded waiting room (a typed
  :class:`QueueFullError` at once when it is full) and an in-flight gate.
- **Deadlines**: every request carries a budget; queue waits spend from
  it, and the dispatch and the guard run under
  :func:`~smk_torch.serve.deadline.run_under_deadline`, so a wedged
  program becomes a typed ``RequestTimeoutError`` and the engine keeps
  serving. The response's device-to-host copy happens inside the guard's
  deadline: that fetch is where the host waits for the device.
- **Graceful degradation**: a separate guard program checks per-row
  finiteness on the device; non-finite rows come back in a typed partial
  response (``rows_degraded``; healthy rows bitwise those of an
  uninjected engine), and a streak of guard trips turns :meth:`health`
  to ``"degraded"``.

The composition noise of a slice is drawn by ``noise(seed, shape,
dtype, device)`` with the slice's seed (the request's ``seed`` plus the
slice's first row), by default from a ``torch.Generator`` on the
engine's device (the twin draws ``jax.random.normal(key(seed))``; tests
inject those numbers). The same artifact, batch and seed give the same
response bit for bit. The composition runs in float64
(api._krige_predict_core), so no process-global TF32 setting reaches
it and concurrent dispatches need no shared state.

The engine's artifact and device constants live in one immutable
:class:`_Generation` snapshot that each request captures once. Not
ported yet: ``swap_artifact`` (ROADMAP A11c) and cross-request
coalescing (``coalesce_window_ms > 0``, A11d); ``compile_store_dir`` is
A10. Each raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from smk_torch.compile.buckets import slice_plan
from smk_torch.device import resolve_device
from smk_torch.ops.quantiles import credible_probs, credible_summary
from smk_torch.serve.artifact import FitArtifact, load_artifact
from smk_torch.serve.deadline import (
    DeadlineBudget,
    RequestTimeoutError,
    run_under_deadline,
)
from smk_torch.utils.tracing import ChunkPipelineStats

DEFAULT_BUCKETS = (8, 32, 128)

# consecutive guard-tripped requests before the engine reports
# "degraded" (one bad row must not flip a health probe; a streak is a
# real signal)
DEFAULT_DEGRADED_THRESHOLD = 3

# the deadline of the warm-up dispatches: warm() pays the first-call
# costs by design, but even it is a bounded wait
_WARM_DEADLINE_S = 600.0

# (seed, shape, dtype, device) -> standard normals of ``shape``
Noise = Callable[[int, tuple, torch.dtype, torch.device], torch.Tensor]


def torch_noise(seed: int, shape: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The default composition noise: standard normals from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


class _Generation(NamedTuple):
    """One immutable serving generation: the artifact and its constants
    on the device. A request captures it at admission and never reads
    engine state mid-flight."""

    gen_id: int
    artifact: FitArtifact
    const: tuple


class QueueFullError(RuntimeError):
    """The engine's bounded waiting room is full: the request is shed at
    once (typed, no wait)."""

    def __init__(self, max_queue: int):
        self.max_queue = int(max_queue)
        super().__init__(
            f"serve queue full ({max_queue} waiting) — request shed; "
            "retry with backoff or raise max_queue"
        )


class EngineDrainingError(RuntimeError):
    """The engine is draining: new requests are rejected typed; those in
    flight complete."""


class PredictResponse(NamedTuple):
    """One served prediction (possibly partial), as numpy arrays.

    ``p_quant`` (3, n, q): [median, 2.5%, 97.5%] per query row;
    ``rows_degraded`` (n,) bool: rows whose prediction came back
    non-finite (their ``p_quant`` entries are whatever the device
    produced); healthy rows are bitwise those of a fault-free engine.
    ``p_samples`` (S, n, q) only with ``include_samples=True``.
    ``buckets``: the bucket of each micro-batch slice. ``latency_s``:
    admission to response. ``held_s``: 0.0 (no coalescing)."""

    p_quant: np.ndarray
    rows_degraded: np.ndarray
    p_samples: Optional[np.ndarray]
    buckets: tuple
    request_id: str
    latency_s: float
    held_s: float = 0.0

    @property
    def degraded(self) -> bool:
        return bool(self.rows_degraded.any())


def _invoke_program(prog, prog_key, *args):
    """The one program-call seam of the engine: every predict and guard
    call goes through here, only from inside a ``run_under_deadline``
    job. The injectors of smk_torch/testing/faults.py (``stall_predict``,
    ``inject_predict_nan``) wrap it while armed; ``prog_key[0]`` names the
    program kind, so they target predict calls and never the guard."""
    return prog(*args)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` with no synchronising copy: through
    pinned memory and an asynchronous copy on the card."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class PredictionEngine:
    """Serve one fit artifact (see the module docstring).

    ``artifact``: a :class:`FitArtifact` or a path to one. ``buckets``:
    the query-batch ladder. ``max_queue`` / ``max_in_flight``: admission
    bounds. ``default_deadline_s``: a request's budget when it carries
    none. ``warm``: run every bucket's programs at construction (the
    production default; ``warm=False`` leaves the first-call costs to the
    first request). ``run_log_dir``: one serve-session run log, each
    request a ``request`` span over ``bucket`` → ``dispatch`` / ``guard``
    spans. ``device``: where to serve (default: the CUDA device; pass
    ``"cpu"`` for the plain path). ``noise``: the composition noise
    (:data:`Noise`, default :func:`torch_noise`). ``include_samples``:
    return the draws too. ``pipeline_stats``: a
    utils.tracing.ChunkPipelineStats sink for the program records.
    ``compile_store_dir`` (ROADMAP A10) and ``coalesce_window_ms > 0``
    (A11d) raise ``NotImplementedError``."""

    def __init__(
        self,
        artifact,
        *,
        buckets=DEFAULT_BUCKETS,
        max_queue: int = 16,
        max_in_flight: int = 1,
        default_deadline_s: float = 30.0,
        coalesce_window_ms: float = 0.0,
        degraded_threshold: int = DEFAULT_DEGRADED_THRESHOLD,
        compile_store_dir: Optional[str] = None,
        run_log_dir: Optional[str] = None,
        warm: bool = True,
        include_samples: bool = False,
        pipeline_stats=None,
        device=None,
        noise: Optional[Noise] = None,
    ):
        if compile_store_dir:
            raise NotImplementedError(
                "PredictionEngine compile_store_dir is not ported to smk_torch "
                "yet (ROADMAP A10); the JAX package smk_tpu runs it"
            )
        if coalesce_window_ms < 0:
            raise ValueError(
                "coalesce_window_ms must be >= 0 (0 disables "
                "cross-request coalescing)"
            )
        if coalesce_window_ms > 0:
            raise NotImplementedError(
                "PredictionEngine coalesce_window_ms>0 is not ported to "
                "smk_torch yet (ROADMAP A11d); the JAX package smk_tpu runs it"
            )
        if isinstance(artifact, (str, bytes)) or hasattr(artifact, "__fspath__"):
            artifact = load_artifact(artifact)
        if not isinstance(artifact, FitArtifact):
            raise TypeError("artifact must be a FitArtifact or a path to one")
        bs = tuple(sorted({int(b) for b in buckets}))
        if not bs or bs[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.buckets = bs
        if max_queue < 1 or max_in_flight < 1:
            raise ValueError("max_queue and max_in_flight must be >= 1")
        self.max_queue = int(max_queue)
        self.max_in_flight = int(max_in_flight)
        self.default_deadline_s = float(default_deadline_s)
        self.degraded_threshold = int(degraded_threshold)
        self.include_samples = bool(include_samples)
        self.coalesce_window_ms = float(coalesce_window_ms)
        self.device = resolve_device(device)
        self._noise = noise if noise is not None else torch_noise
        self._queue_sem = threading.BoundedSemaphore(self.max_queue)
        self._inflight = threading.BoundedSemaphore(self.max_in_flight)
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._state = "ready"
        self._warm = False
        self._consecutive_trips = 0
        self._stats = {
            "requests_served": 0,
            "requests_shed": 0,
            "requests_timed_out": 0,
            "requests_rejected": 0,
            "requests_degraded": 0,
            "rows_degraded": 0,
            # padded bucket dispatches issued (one per micro-batch slice)
            "dispatches": 0,
            # generation rollovers (swap_artifact, ROADMAP A11c): 0
            "generation_swaps": 0,
        }
        self.pstats = pipeline_stats if pipeline_stats is not None else ChunkPipelineStats()
        self._program_table: dict = {}
        self.run_log = None
        if run_log_dir:
            from smk_torch.obs.events import open_run_log

            self.run_log = open_run_log(
                run_log_dir, name="serve",
                meta={
                    "n_draws": artifact.n_draws,
                    "n_anchor": artifact.n_anchor,
                    "q": artifact.q,
                    "buckets": list(bs),
                    "config_digest": artifact.config_digest,
                    "device": str(self.device),
                },
            )
        self._dtype = torch.float32 if artifact.sample_w.dtype == np.float32 else torch.float64
        # the credible summary's probabilities, on the device once
        self._probs = credible_probs(self._dtype, self.device)
        self._gen = self._make_generation(artifact, 0)
        if warm:
            self.warm()

    # -- generations -------------------------------------------------

    def _make_generation(self, artifact: FitArtifact, gen_id: int) -> _Generation:
        t, q, p, s = artifact.n_anchor, artifact.q, artifact.p, artifact.n_draws

        def put(a):
            return torch.as_tensor(np.asarray(a), dtype=self._dtype).to(self.device)

        const = (
            put(artifact.chol_tt),
            put(artifact.sample_w.reshape(s, t, q)),
            put(artifact.sample_par[:, : q * p].reshape(s, q, p)),
            put(artifact.phi),
            put(artifact.coords_test),
        )
        return _Generation(gen_id=int(gen_id), artifact=artifact, const=const)

    @property
    def artifact(self) -> FitArtifact:
        return self._gen.artifact

    @property
    def generation(self) -> int:
        return self._gen.gen_id

    # -- programs ----------------------------------------------------

    def _predict_key(self, u: int, a=None) -> tuple:
        a = a if a is not None else self.artifact
        return (
            "serve_predict", int(u), a.n_draws, a.n_anchor, a.q,
            a.p, a.coord_dim, str(np.dtype(a.sample_w.dtype)), a.cov_model, a.link,
            a.serve_digest(),
        )

    def _guard_key(self, u: int, a=None) -> tuple:
        a = a if a is not None else self.artifact
        return (
            "serve_guard", int(u), a.n_draws, a.q,
            str(np.dtype(a.sample_w.dtype)), a.serve_digest(),
        )

    def _build_predict(self, u: int, a: FitArtifact):
        from smk_torch.api import _krige_predict_core

        s, q = a.n_draws, a.q
        cov_model, link, var_floor = a.cov_model, a.link, a.var_floor()
        noise, dt, dev, probs = self._noise, self._dtype, self.device, self._probs

        def fn(chol_tt, w_test, betas, phi, coords_test, coords_q, x_q, seed):
            eps = noise(seed, (s, u, q), dt, dev)
            ps = _krige_predict_core(
                chol_tt, w_test, betas, phi, coords_test, coords_q, x_q, eps,
                cov_model=cov_model, link=link, var_floor=var_floor,
            )
            pq = credible_summary(ps.reshape(s, -1), probs).reshape(3, u, q)
            return ps, pq

        return fn

    @staticmethod
    def _build_guard(u: int):
        def fn(ps):
            # per-row finiteness of the (S, u, q) draws: a separate small
            # program, u bools home per slice
            return torch.isfinite(ps).all(dim=2).all(dim=0)

        return fn

    def _program(self, key: tuple, build):
        """The program of ``key`` from the in-process table, built on
        first use; recorded in ``pstats`` as "fresh" when built and "l1"
        when reused (the first record of a key stands)."""
        with self._lock:
            fn = self._program_table.get(key)
            fresh = fn is None
            if fresh:
                fn = self._program_table[key] = build()
        self.pstats.record_program(key=key, source="fresh" if fresh else "l1")
        return fn

    def _programs(self, u: int, a=None):
        """(predict, guard) of bucket ``u`` for artifact ``a`` (default:
        the current generation's)."""
        a = a if a is not None else self.artifact
        pred = self._program(self._predict_key(u, a), lambda: self._build_predict(u, a))
        guard = self._program(self._guard_key(u, a), lambda: self._build_guard(u))
        return pred, guard

    def warm(self) -> dict:
        """Build every bucket's predict and guard and run each once on
        finite dummy inputs (pad-style rows at the first anchor, zero
        designs), under a bounded deadline, so the first request meets
        nothing cold. Returns the program summary."""
        a = self.artifact
        budget = DeadlineBudget(_WARM_DEADLINE_S)
        for u in self.buckets:
            pred, guard = self._programs(u)
            coords_q = np.repeat(np.asarray(a.coords_test[:1], np.float32), u, axis=0)
            x_q = np.zeros((u, a.q, a.p), np.float32)
            pkey, gkey = self._predict_key(u), self._guard_key(u)

            def worker(pred=pred, guard=guard, coords_q=coords_q, x_q=x_q, pkey=pkey,
                       gkey=gkey):
                cq = _upload(coords_q, self.device).to(self._dtype)
                xq = _upload(x_q, self.device).to(self._dtype)
                ps, pq = _invoke_program(pred, pkey, *self._gen.const, cq, xq, 0)
                mask = _invoke_program(guard, gkey, ps)
                return mask.cpu(), pq.cpu()

            run_under_deadline(worker, budget, label=f"warmup/bucket{u}", phase="dispatch",
                               run_log=self.run_log, device=self.device)
        self._warm = True
        if self.run_log is not None:
            self.run_log.event("warm", buckets=list(self.buckets),
                               sources=self.program_summary())
        return self.program_summary()

    def program_summary(self) -> dict:
        return self.pstats.program_summary()

    # -- admission and serving ----------------------------------------

    def _count(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._stats[field] += n

    def _note_guard(self, n_degraded: int) -> None:
        with self._lock:
            if n_degraded > 0:
                self._stats["requests_degraded"] += 1
                self._stats["rows_degraded"] += int(n_degraded)
                self._consecutive_trips += 1
                if (self._consecutive_trips >= self.degraded_threshold
                        and self._state == "ready"):
                    self._state = "degraded"
                    if self.run_log is not None:
                        self.run_log.event("health", state="degraded",
                                           consecutive_trips=self._consecutive_trips)
            else:
                self._consecutive_trips = 0
                if self._state == "degraded":
                    self._state = "ready"
                    if self.run_log is not None:
                        self.run_log.event("health", state="ready")

    def predict(
        self,
        coords_query,
        x_query,
        *,
        deadline_s: Optional[float] = None,
        seed: int = 0,
        request_id: Optional[str] = None,
    ) -> PredictResponse:
        """Serve one query batch; see :class:`PredictResponse`.

        The same (artifact, query batch, seed) returns the same response
        bit for bit. Raises :class:`~smk_torch.api.QueryValidationError`
        before any dispatch, :class:`QueueFullError` /
        :class:`~smk_torch.serve.deadline.RequestTimeoutError` /
        :class:`EngineDrainingError` per the admission contract."""
        from smk_torch.api import validate_query_batch

        if self._state == "draining":
            self._count("requests_rejected")
            raise EngineDrainingError("engine is draining — no new requests")
        # the request is served from this one snapshot
        gen = self._gen
        a = gen.artifact
        cq, xq = validate_query_batch(coords_query, x_query, d=a.coord_dim, q=a.q, p=a.p)
        rid = request_id or f"r{next(self._ids)}"
        budget = DeadlineBudget(
            deadline_s if deadline_s is not None else self.default_deadline_s
        )
        # a zero-wait poll: a full waiting room sheds at once
        if not self._queue_sem.acquire(blocking=False):
            self._count("requests_shed")
            raise QueueFullError(self.max_queue)
        try:
            if not self._inflight.acquire(timeout=budget.remaining()):
                self._count("requests_timed_out")
                raise RequestTimeoutError(rid, "queued", budget.total_s)
        finally:
            self._queue_sem.release()
        try:
            return self._serve(cq, xq, rid, int(seed), budget, gen)
        except RequestTimeoutError:
            # the overrunning worker is abandoned (it holds no locks) and
            # the slot frees below: the next request dispatches afresh
            self._count("requests_timed_out")
            raise
        finally:
            self._inflight.release()

    def _serve(self, cq, xq, rid, seed, budget, gen=None) -> PredictResponse:
        gen = gen if gen is not None else self._gen
        n = cq.shape[0]
        log = self.run_log
        span = (log.span("request", id=rid, n=int(n), queued_s=round(budget.elapsed(), 6))
                if log is not None else contextlib.nullcontext())
        pq_parts, ps_parts, mask_parts, used = [], [], [], []
        with span:
            for lo, hi, u in slice_plan(n, self.buckets):
                if budget.expired():
                    # a slice bound to overrun is shed before the device
                    # is touched
                    raise RequestTimeoutError(rid, "dispatch", budget.total_s)
                used.append(u)
                bspan = (log.span("bucket", bucket=u, rows=int(hi - lo))
                         if log is not None else contextlib.nullcontext())
                with bspan:
                    pqp, psp, maskp = self._dispatch_slice(
                        cq[lo:hi], xq[lo:hi], u, rid, seed + lo, budget, gen)
                pq_parts.append(pqp)
                mask_parts.append(maskp)
                if psp is not None:
                    ps_parts.append(psp)
        rows_degraded = ~np.concatenate(mask_parts)
        self._note_guard(int(rows_degraded.sum()))
        self._count("requests_served")
        return PredictResponse(
            p_quant=np.concatenate(pq_parts, axis=1),
            rows_degraded=rows_degraded,
            p_samples=np.concatenate(ps_parts, axis=1) if ps_parts else None,
            buckets=tuple(used),
            request_id=rid,
            latency_s=budget.elapsed(),
        )

    def _dispatch_slice(self, sl_c, sl_x, u, rid, seed, budget, gen=None):
        """One micro-batch slice through its bucket: pad, dispatch, guard,
        every device wait under the request's deadline. Pad rows repeat
        the slice's first query with a zero design (finite, sliced away
        before the response). Constants and program keys come from the
        request's generation ``gen``."""
        gen = gen if gen is not None else self._gen
        a = gen.artifact
        log = self.run_log
        n_sl = sl_c.shape[0]
        pad = u - n_sl
        if pad:
            sl_c = np.concatenate([sl_c, np.repeat(sl_c[:1], pad, axis=0)])
            sl_x = np.concatenate([sl_x, np.zeros((pad,) + sl_x.shape[1:], sl_x.dtype)])
        pred, guard = self._programs(u, a)
        label = f"{rid}/bucket{u}"
        pkey, gkey = self._predict_key(u, a), self._guard_key(u, a)
        const = gen.const
        seed_u32 = seed & 0xFFFFFFFF
        dev, dt = self.device, self._dtype

        def dispatch_worker():
            cq = _upload(np.ascontiguousarray(sl_c), dev).to(dt)
            xq = _upload(np.ascontiguousarray(sl_x), dev).to(dt)
            return _invoke_program(pred, pkey, *const, cq, xq, seed_u32)

        dspan = log.span("dispatch", bucket=u) if log is not None else contextlib.nullcontext()
        self._count("dispatches")
        with dspan:
            ps, pq = run_under_deadline(dispatch_worker, budget, label=label,
                                        phase="dispatch", run_log=log, device=dev)

        include_samples = self.include_samples

        def guard_worker():
            mask = _invoke_program(guard, gkey, ps).cpu().numpy()
            # the response's copy home, inside the deadline: the fetch is
            # where the host waits for the device, so a wedged device
            # surfaces here as a typed timeout
            pq_np = pq.cpu().numpy()
            ps_np = ps.cpu().numpy() if include_samples else None
            return mask, pq_np, ps_np

        gspan = log.span("guard", bucket=u) if log is not None else contextlib.nullcontext()
        with gspan:
            mask, pq_np, ps_np = run_under_deadline(guard_worker, budget, label=label,
                                                    phase="guard", run_log=log, device=dev)
        return (
            pq_np[:, :n_sl],
            ps_np[:, :n_sl] if ps_np is not None else None,
            mask[:n_sl],
        )

    # -- health ------------------------------------------------------

    def health(self) -> dict:
        """Liveness and readiness for external probes: ``state`` in
        {"ready", "degraded", "draining"} and the admission and
        degradation counters. No device work."""
        with self._lock:
            out = dict(self._stats)
            out["state"] = self._state
            out["ready"] = self._state == "ready"
            out["warm"] = self._warm
            out["generation"] = self._gen.gen_id
            out["consecutive_guard_trips"] = self._consecutive_trips
            out["buckets"] = list(self.buckets)
            out["max_queue"] = self.max_queue
            out["max_in_flight"] = self.max_in_flight
            out["coalesce_window_ms"] = self.coalesce_window_ms
        return out

    def drain(self) -> None:
        """Enter draining: new requests are rejected typed
        (:class:`EngineDrainingError`); those in flight finish."""
        with self._lock:
            self._state = "draining"
        if self.run_log is not None:
            self.run_log.event("health", state="draining")

    def close(self) -> None:
        self.drain()
        if self.run_log is not None:
            self.run_log.close(serve=self.health())
            self.run_log = None

    def __enter__(self) -> "PredictionEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
