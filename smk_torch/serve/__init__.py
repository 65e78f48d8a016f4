"""Kriging as a service — twin of ``smk_tpu/serve/``: the batched
prediction engine over a frozen fit artifact (bucket ladder, bounded
admission with typed shedding, per-request deadlines, per-row NaN
quarantine with health states, cross-request coalescing), the replica
fleet, generation publication with hot swaps, and the live fit that
ingests new rows and re-fits only the subsets they land in. See
serve/engine.py and serve/ingest.py for the contracts."""

from smk_torch.serve.artifact import (
    GENERATION_MANIFEST,
    ArtifactError,
    FitArtifact,
    GenerationError,
    commit_generation,
    current_generation,
    generation_artifact_name,
    land_generation,
    load_artifact,
    load_current_generation,
    orphan_generations,
    publish_generation,
    save_artifact,
)
from smk_torch.serve.coalesce import RequestCoalescer
from smk_torch.serve.deadline import (
    DeadlineBudget,
    RequestTimeoutError,
    run_under_deadline,
)
from smk_torch.serve.engine import (
    ArtifactSwapError,
    EngineDrainingError,
    PredictionEngine,
    PredictResponse,
    QueueFullError,
    hash_row_noise,
)
from smk_torch.serve.fleet import FleetSaturatedError, ReplicaFleet
from smk_torch.serve.ingest import (
    IngestError,
    IngestReceipt,
    LiveFit,
    MortonRouter,
    RefitReport,
)

__all__ = [
    "GENERATION_MANIFEST",
    "ArtifactError",
    "FitArtifact",
    "GenerationError",
    "commit_generation",
    "current_generation",
    "generation_artifact_name",
    "land_generation",
    "load_artifact",
    "load_current_generation",
    "orphan_generations",
    "publish_generation",
    "save_artifact",
    "RequestCoalescer",
    "DeadlineBudget",
    "RequestTimeoutError",
    "run_under_deadline",
    "ArtifactSwapError",
    "EngineDrainingError",
    "PredictionEngine",
    "PredictResponse",
    "QueueFullError",
    "hash_row_noise",
    "FleetSaturatedError",
    "ReplicaFleet",
    "IngestError",
    "IngestReceipt",
    "LiveFit",
    "MortonRouter",
    "RefitReport",
]
