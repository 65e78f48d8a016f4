"""Replica fleet — twin of ``smk_tpu/serve/fleet.py``: N prediction
engines behind one shedding front door, in one process, all on the one
card.

- **Routing**: round-robin over the replicas, falling through to the
  next when one's waiting room is full, so per-replica admission
  control becomes fleet-level load balancing.
- **Shedding**: when every replica sheds, the fleet raises the typed
  :class:`FleetSaturatedError` (a ``QueueFullError``, so a caller's
  backoff applies unchanged); every fall-through is a zero-wait poll.
- **Health**: :meth:`ReplicaFleet.health` is "ready" while any replica
  is ready, with the replicas' counters summed.
- **Rollover**: :meth:`ReplicaFleet.swap_artifact` hot-swaps the
  replicas one after another onto a new generation.

The replicas share one artifact object; each puts its own constants on
the device. Every other engine keyword is forwarded to each replica.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Optional

from smk_torch.serve.artifact import FitArtifact, load_artifact
from smk_torch.serve.engine import (
    EngineDrainingError,
    PredictionEngine,
    PredictResponse,
    QueueFullError,
)


class FleetSaturatedError(QueueFullError):
    """Every replica's waiting room is full: the request is shed at the
    fleet's front door at once."""

    def __init__(self, n_replicas: int, max_queue: int):
        self.n_replicas = int(n_replicas)
        self.max_queue = int(max_queue)
        RuntimeError.__init__(
            self,
            f"all {n_replicas} replicas shed ({max_queue} waiting "
            "each) — request shed at the fleet front door; retry "
            "with backoff or raise n_replicas/max_queue"
        )


class ReplicaFleet:
    """N engine replicas behind one shedding front door.

    ``artifact``: a :class:`FitArtifact` or a path (loaded once and
    shared). ``n_replicas``: the engine count. ``run_log_dir``: the
    fleet's own run log (``replica`` spans for spin-up, shed and
    saturation events, routing counters). Every other keyword goes to
    each :class:`PredictionEngine` (``compile_store_dir`` among them:
    each replica captures its own graphs, compile/programs.py)."""

    def __init__(self, artifact, *, n_replicas: int = 2,
                 run_log_dir: Optional[str] = None, **engine_kwargs):
        if int(n_replicas) < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = int(n_replicas)
        if isinstance(artifact, (str, bytes)) or hasattr(artifact, "__fspath__"):
            artifact = load_artifact(artifact)
        if not isinstance(artifact, FitArtifact):
            raise TypeError("artifact must be a FitArtifact or a path to one")
        self.artifact = artifact
        self.run_log = None
        if run_log_dir:
            from smk_torch.obs.events import open_run_log

            self.run_log = open_run_log(
                run_log_dir, name="fleet",
                meta={"n_replicas": self.n_replicas,
                      "config_digest": artifact.config_digest},
            )
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._rr = itertools.count()
        self._stats = {
            "requests_routed": 0,
            "requests_shed_fleet": 0,
            "replica_fallthroughs": 0,
        }
        self._engines = []
        for i in range(self.n_replicas):
            span = (self.run_log.span("replica", replica=i) if self.run_log is not None
                    else contextlib.nullcontext())
            with span:
                eng = PredictionEngine(artifact, **engine_kwargs)
            self._engines.append(eng)
            if self.run_log is not None:
                self.run_log.event("replica", replica=i, action="up",
                                   sources=eng.program_summary())

    @property
    def engines(self) -> tuple:
        return tuple(self._engines)

    def _count(self, field: str, n: int = 1) -> None:
        with self._lock:
            self._stats[field] += n

    def predict(self, coords_query, x_query, *, deadline_s: Optional[float] = None,
                seed: int = 0, request_id: Optional[str] = None) -> PredictResponse:
        """Route one request to the first replica (round-robin start)
        whose waiting room admits it; all shed raises
        :class:`FleetSaturatedError`, all draining
        :class:`EngineDrainingError`. The response depends on (artifact,
        query, seed), never on which replica served it."""
        rid = request_id or f"f{next(self._ids)}"
        start = next(self._rr) % self.n_replicas
        draining = 0
        for k in range(self.n_replicas):
            idx = (start + k) % self.n_replicas
            try:
                resp = self._engines[idx].predict(
                    coords_query, x_query, deadline_s=deadline_s, seed=seed,
                    request_id=rid,
                )
            except QueueFullError:
                # a zero-wait shed: on to the next replica
                self._count("replica_fallthroughs")
                if self.run_log is not None:
                    self.run_log.event("replica", replica=idx, action="shed",
                                       request_id=rid)
                continue
            except EngineDrainingError:
                draining += 1
                continue
            self._count("requests_routed")
            if self.run_log is not None:
                self.run_log.counter("fleet_requests_routed", 1)
            return resp
        if draining == self.n_replicas:
            raise EngineDrainingError("all replicas draining — no new requests")
        self._count("requests_shed_fleet")
        if self.run_log is not None:
            self.run_log.event("fleet_saturated", request_id=rid,
                               n_replicas=self.n_replicas)
            self.run_log.counter("fleet_requests_shed", 1)
        raise FleetSaturatedError(self.n_replicas, self._engines[0].max_queue)

    def swap_artifact(self, artifact, *, generation=None) -> dict:
        """Hot-swap every replica onto a new generation with no request
        dropped. ``artifact`` (a FitArtifact or a path) is loaded once
        and shared; the replicas swap in sequence, so mid-rollover the
        fleet briefly serves two generations, each response from one.
        Returns ``{"generation", "replicas"}``."""
        if isinstance(artifact, (str, bytes)) or hasattr(artifact, "__fspath__"):
            artifact = load_artifact(artifact)
        if not isinstance(artifact, FitArtifact):
            raise TypeError("artifact must be a FitArtifact or a path to one")
        out = None
        for eng in self._engines:
            out = eng.swap_artifact(artifact, generation=generation)
        self.artifact = artifact
        gen = out["generation"] if out else generation
        if self.run_log is not None:
            self.run_log.event("generation_swap", generation=gen, n_replicas=self.n_replicas)
        return {"generation": gen, "replicas": self.n_replicas}

    def health(self) -> dict:
        """"ready" while any replica is ready, "draining" when all are,
        else "degraded"; each replica's snapshot and the numeric counters
        summed over the replicas (``totals``)."""
        reps = [e.health() for e in self._engines]
        states = [r["state"] for r in reps]
        if any(s == "ready" for s in states):
            state = "ready"
        elif all(s == "draining" for s in states):
            state = "draining"
        else:
            state = "degraded"
        summed: dict = {}
        for r in reps:
            for k, v in r.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    summed[k] = summed.get(k, 0) + v
        summed.pop("coalesce_window_ms", None)
        with self._lock:
            out = dict(self._stats)
        out.update(state=state, ready=state == "ready", n_replicas=self.n_replicas,
                   replicas=reps, totals=summed)
        return out

    def drain(self) -> None:
        for eng in self._engines:
            eng.drain()

    def close(self) -> None:
        for eng in self._engines:
            eng.close()
        if self.run_log is not None:
            self.run_log.close(fleet=self.health())
            self.run_log = None

    def __enter__(self) -> "ReplicaFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
