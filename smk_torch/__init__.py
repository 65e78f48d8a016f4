"""smk_torch — the PyTorch/CUDA port of smk_tpu (spatial meta-kriging
for binary responses), for one NVIDIA H100.

The JAX package ``smk_tpu`` is the reference; this package imports none
of it and no JAX. Each module keeps its twin's relative path and public
names (``smk_torch/ops/chol.py`` <-> ``smk_tpu/ops/chol.py``). The
TPU's Pallas correlation-build kernel is a hand-written CUDA kernel
here (``csrc/fused_corr.cu``, bound in ``ops/fused_build.py``).
"""

from smk_torch.api import (
    FitRandomness,
    MetaKrigingResult,
    PredictAtResult,
    QueryValidationError,
    TorchRandomness,
    fit_meta_kriging,
    param_names,
    predict_at,
    predict_probability,
    prediction_factors,
    validate_query_batch,
)
from smk_torch.config import PriorConfig, SMKConfig

__all__ = [
    "FitRandomness",
    "MetaKrigingResult",
    "PredictAtResult",
    "PriorConfig",
    "QueryValidationError",
    "SMKConfig",
    "TorchRandomness",
    "fit_meta_kriging",
    "param_names",
    "predict_at",
    "predict_probability",
    "prediction_factors",
    "validate_query_batch",
]
