"""Kriging as a service — twin of ``smk_tpu/serve/``: the batched
prediction engine over a frozen fit artifact (bucket ladder, bounded
admission with typed shedding, per-request deadlines, per-row NaN
quarantine with health states) and the replica fleet. See
serve/engine.py for the contract. Generation publication, live ingest
and ``swap_artifact`` are ROADMAP A11c; cross-request coalescing is
A11d."""

from smk_torch.serve.artifact import (
    ArtifactError,
    FitArtifact,
    load_artifact,
    save_artifact,
)
from smk_torch.serve.deadline import (
    DeadlineBudget,
    RequestTimeoutError,
    run_under_deadline,
)
from smk_torch.serve.engine import (
    EngineDrainingError,
    PredictionEngine,
    PredictResponse,
    QueueFullError,
)
from smk_torch.serve.fleet import FleetSaturatedError, ReplicaFleet

__all__ = [
    "ArtifactError",
    "FitArtifact",
    "load_artifact",
    "save_artifact",
    "DeadlineBudget",
    "RequestTimeoutError",
    "run_under_deadline",
    "EngineDrainingError",
    "PredictionEngine",
    "PredictResponse",
    "QueueFullError",
    "FleetSaturatedError",
    "ReplicaFleet",
]
