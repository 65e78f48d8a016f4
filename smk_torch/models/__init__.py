"""Model layer of the port — twin of ``smk_tpu/models``: the per-subset
Bayesian spatial GP sampler (probit and logit)."""

from smk_torch.models.probit_gp import (
    SamplerState,
    SpatialGPSampler,
    SpatialProbitGP,
    SubsetData,
    SubsetResult,
)

__all__ = ["SpatialGPSampler", "SpatialProbitGP", "SubsetData", "SamplerState", "SubsetResult"]
