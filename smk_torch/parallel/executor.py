"""The K-subset fan-out — twin of the unmeshed path of
``smk_tpu/parallel/executor.py``. JAX vmaps the one-subset sampler over
K; here the sampler is already batched over a leading K axis, so the
fan-out is one run over the stacked subsets, each subset drawing its
randomness from its own generator."""

from __future__ import annotations

from typing import Optional

import torch

from smk_torch.models.probit_gp import (
    NoiseSource,
    SpatialGPSampler,
    SubsetData,
    SubsetResult,
    subset_generators,
)
from smk_torch.parallel.partition import Partition


def stacked_subset_data(
    part: Partition, coords_test: torch.Tensor, x_test: torch.Tensor
) -> SubsetData:
    return SubsetData(
        coords=part.coords, x=part.x, y=part.y, mask=part.mask,
        coords_test=coords_test, x_test=x_test,
    )


# twin name of the per-subset key split: one generator per subset
subset_chain_keys = subset_generators


def init_subset_states(model: SpatialGPSampler, data: SubsetData, beta_init):
    """Initial states of all K subsets (one batched call)."""
    return model.init_state(data, beta_init)


def fit_subsets_vmap(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
) -> SubsetResult:
    """Run all K subset samplers as one batched run. ``noise`` defaults
    to one generator per subset (SpatialGPSampler.run)."""
    data = stacked_subset_data(part, coords_test, x_test)
    init = init_subset_states(model, data, beta_init)
    return model.run(data, init, noise)
