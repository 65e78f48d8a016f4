"""smk_torch — the PyTorch/CUDA port of smk_tpu (spatial meta-kriging
for binary responses), for one NVIDIA H100.

The JAX package ``smk_tpu`` is the reference; this package imports none
of it and no JAX. Each module keeps its twin's relative path and public
names (``smk_torch/ops/chol.py`` <-> ``smk_tpu/ops/chol.py``), and each
package re-exports its twin's ``__all__`` (a name with no counterpart
stands in that package's ``NOT_PORTED`` with the reason). The TPU's
Pallas correlation-build kernel is a hand-written CUDA kernel here
(``csrc/fused_corr.cu``, bound in ``ops/fused_build.py``).

The top-level names load on first use, so that ``python -m
smk_torch.analysis.lint`` imports no torch.
"""

import importlib

# name -> the module that defines it
_EXPORTS = {
    "SMKConfig": "smk_torch.config",
    "PriorConfig": "smk_torch.config",
    "MetaKrigingResult": "smk_torch.api",
    "PredictAtResult": "smk_torch.api",
    "QueryValidationError": "smk_torch.api",
    "fit_meta_kriging": "smk_torch.api",
    "predict_at": "smk_torch.api",
    "predict_probability": "smk_torch.api",
    "prediction_factors": "smk_torch.api",
    "validate_query_batch": "smk_torch.api",
    "random_partition": "smk_torch.parallel.partition",
    "Partition": "smk_torch.parallel.partition",
    "PaddedPartition": "smk_torch.parallel.partition",
    "coherent_partition": "smk_torch.parallel.partition",
    "padded_partition": "smk_torch.parallel.partition",
    "SubsetSurvivalError": "smk_torch.parallel.combine",
    "DomainSurvivalError": "smk_torch.parallel.combine",
    "ChunkTimeoutError": "smk_torch.parallel.domains",
    "ChunkWatchdog": "smk_torch.parallel.domains",
    "FailureDomainMap": "smk_torch.parallel.domains",
    "apply_survival_mask": "smk_torch.parallel.combine",
    "wasserstein_barycenter": "smk_torch.parallel.combine",
    "weiszfeld_median": "smk_torch.parallel.combine",
    "combine_quantile_grids": "smk_torch.parallel.combine",
    "SpatialGPSampler": "smk_torch.models.probit_gp",
    "SpatialProbitGP": "smk_torch.models.probit_gp",
    "SamplerState": "smk_torch.models.probit_gp",
    "SubsetResult": "smk_torch.models.probit_gp",
    "SubsetNaNError": "smk_torch.parallel.recovery",
    "find_failed_subsets": "smk_torch.parallel.recovery",
    "rerun_subsets": "smk_torch.parallel.recovery",
    # the port's own: the randomness of a fit (no JAX key to pass)
    "FitRandomness": "smk_torch.api",
    "TorchRandomness": "smk_torch.api",
    "param_names": "smk_torch.api",
}

__all__ = list(_EXPORTS)

# The twin's names with no counterpart here, each with its reason.
NOT_PORTED = {
    "debug_nans": "scopes JAX's jax_debug_nans flag; torch has no per-op NaN trap for "
    "forward code (anomaly mode checks autograd's backward only), and the port's NaN "
    "checks are SMKConfig.nan_guard and fault_policy='quarantine'",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module 'smk_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
