"""Parallel layer of the port — twin of ``smk_tpu/parallel``: the
partitioners, the K-subset fan-out over a device mesh (the chunked
executor with its checkpoints, quarantine, watchdog and adaptive
schedule) and the posterior combiners."""

from smk_torch.parallel.partition import (
    BucketGroup,
    PaddedPartition,
    Partition,
    coherent_assignments,
    coherent_partition,
    padded_partition,
    partition_from_indices,
    random_partition,
)
from smk_torch.parallel.executor import (
    fit_subsets_sharded,
    fit_subsets_vmap,
    make_mesh,
)
from smk_torch.parallel.combine import (
    DomainSurvivalError,
    SubsetSurvivalError,
    apply_survival_mask,
    combine_quantile_grids,
    wasserstein_barycenter,
    weiszfeld_median,
)
from smk_torch.parallel.domains import (
    ChunkTimeoutError,
    ChunkWatchdog,
    FailureDomainMap,
)
from smk_torch.parallel.recovery import (
    SubsetNaNError,
    find_failed_subsets,
    fit_subsets_checkpointed,
    fit_subsets_chunked,
    rerun_subsets,
)

__all__ = [
    "random_partition",
    "Partition",
    "BucketGroup",
    "PaddedPartition",
    "coherent_assignments",
    "coherent_partition",
    "padded_partition",
    "partition_from_indices",
    "fit_subsets_vmap",
    "fit_subsets_sharded",
    "fit_subsets_checkpointed",
    "fit_subsets_chunked",
    "find_failed_subsets",
    "rerun_subsets",
    "SubsetNaNError",
    "SubsetSurvivalError",
    "DomainSurvivalError",
    "ChunkTimeoutError",
    "ChunkWatchdog",
    "FailureDomainMap",
    "apply_survival_mask",
    "make_mesh",
    "wasserstein_barycenter",
    "weiszfeld_median",
    "combine_quantile_grids",
]
