"""The K-subset fan-out — twin of the unmeshed path of
``smk_tpu/parallel/executor.py``. JAX vmaps the one-subset sampler over
K (and over the chains); here the sampler is already batched over a
leading axis of K * n_chains rows, subset-major, so the fan-out is one
run over the stacked subsets, or one run per chunk of subsets, each row
drawing its randomness from its own generator."""

from __future__ import annotations

from typing import List, Optional

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


def subset_chain_keys(seed: int, k: int, n_chains: int, device) -> List[torch.Generator]:
    """Per-(subset, chain) generators, K * n_chains of them, subset-major
    (row k * n_chains + c): the twin's ``split(key, k * n_chains)``
    reshaped to (k, n_chains), flattened. One per subset at one chain."""
    return subset_generators(seed, k * n_chains, device)


def init_subset_states(model: SpatialGPSampler, data: SubsetData, beta_init, consts=None):
    """Initial states of all K * n_chains rows (one batched call on the
    chain data: a subset's chains share its data and start alike).
    ``consts``: the sampler's geometry of that chain data, if built."""
    return model.init_state(model.chain_data(data), beta_init, consts=consts)


def _run(model: SpatialGPSampler, data: SubsetData, beta_init, noise) -> SubsetResult:
    """Init and run of the stacked subsets ``data`` over one build of the
    sampler's geometry, which init and both scans share."""
    consts = model._consts(model.chain_data(data))
    state = init_subset_states(model, data, beta_init, consts)
    return model.run(data, state, noise, consts=consts)


def _chunk_noise(noise, lo: int, hi: int):
    subset = getattr(noise, "subset", None)
    if subset is None:
        raise ValueError(
            "chunk_size needs a noise source with subset(lo, hi) (as "
            "GeneratorNoise has), so that each chunk draws its own rows"
        )
    return subset(lo, hi)


def fit_subsets_vmap(
    model: SpatialGPSampler,
    part: Partition,
    coords_test: torch.Tensor,
    x_test: torch.Tensor,
    noise: Optional[NoiseSource] = None,
    beta_init: Optional[torch.Tensor] = None,
    *,
    chunk_size: Optional[int] = None,
) -> SubsetResult:
    """Run all K subset samplers (each with its n_chains chains) as one
    batched run. ``noise`` defaults to one generator per (subset, chain)
    row (SpatialGPSampler.run). ``chunk_size`` runs the subsets in
    chunks of that many, one after the other, to bound how many are
    resident at once (a multiple-try or multi-chain fit); each chunk
    draws its rows' own noise, so the result is the unchunked run's.
    ``run`` takes both one chain and several (the twin's ``subset_runner``
    picks ``run`` or ``run_chains``)."""
    data = stacked_subset_data(part, coords_test, x_test)
    k = part.n_subsets
    if chunk_size is None or chunk_size >= k:
        return _run(model, data, beta_init, noise)
    if k % chunk_size != 0:
        raise ValueError(f"chunk_size {chunk_size} must divide K={k}")
    c = model.config.n_chains
    if noise is None:
        noise = model.default_noise(data)
    results, guards = [], []
    for lo in range(0, k, chunk_size):
        hi = lo + chunk_size
        d = data._replace(coords=data.coords[lo:hi], x=data.x[lo:hi],
                          y=data.y[lo:hi], mask=data.mask[lo:hi])
        model.guard_rejects = None
        results.append(_run(model, d, beta_init, _chunk_noise(noise, lo * c, hi * c)))
        guards.append(model.guard_rejects)
    model.guard_rejects = None if guards[0] is None else torch.cat(guards)
    return SubsetResult(*(torch.cat(f) for f in zip(*results)))
