"""State carried across from the JAX package: its arrays (as numpy, or
anything ``np.asarray`` takes) into the port's objects.

A JAX fit's sampler state, factor cache, partition and subset grids can
be picked up by the port — to continue a chain on the card, or to
combine and predict from a JAX fit (api.combine / api.resample_predict). The JAX
PRNG key has no counterpart: the port's randomness comes from its own
generators, seeded anew.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from smk_torch.models.probit_gp import SamplerState, subset_generators
from smk_torch.ops.factor_cache import FactorCache, empty_counter
from smk_torch.parallel.partition import Partition

_STATE_FIELDS = (
    "beta", "u", "a", "phi", "chol_r", "phi_accept", "phi_log_step",
)


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def _tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` as a tensor on ``device``: float64 arrays stay float64 (a
    JAX fit under jax_enable_x64), other floats become float32."""
    a = np.array(a, copy=True)
    if dtype is None:
        dtype = torch.float64 if a.dtype == np.float64 else torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def sampler_state_from_numpy(
    state, *, seed: int = 0, device="cpu"
) -> Tuple[SamplerState, List[torch.Generator]]:
    """A K-stacked JAX ``SamplerState`` (a NamedTuple or a dict of its
    arrays, leading K axis on every field; a multi-chain state has a
    leading (K, C)) as the port's SamplerState, K*C rows subset-major
    (row k*C + c), plus one generator per row seeded from ``seed`` in
    place of the JAX key. ``chol_r`` is carried with whatever trailing
    shape it has: the dense factor (q, m, m), or under the Vecchia
    engine the packed coefficients (q, m, nn+1)."""
    out = SamplerState(
        **{f: _tensor(_field(state, f), device) for f in _STATE_FIELDS}
    )
    if out.beta.dim() == 4:  # (K, C, q, p): chains -> K*C rows
        out = SamplerState(*(t.reshape((-1,) + t.shape[2:]) for t in out))
    if out.beta.dim() != 3:
        raise ValueError(
            "sampler state must carry a leading K (subset) axis: beta is "
            f"{tuple(out.beta.shape)}, expected (K, q, p) or (K, C, q, p)"
        )
    return out, subset_generators(seed, out.beta.shape[0], device)


def factor_cache_from_numpy(cache, *, device="cpu") -> FactorCache:
    """A K-stacked JAX ``FactorCache`` (or a dict of its arrays; None
    fields stay None) as the port's. A bf16 ``r_mv`` comes out of JAX
    as an ml_dtypes bfloat16 array, which ``torch.as_tensor`` does not
    take: it goes through float32, exact both ways. The counters start
    at zero, as at a scan entry."""

    def arr(name):
        a = _field(cache, name)
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return _tensor(a.astype(np.float32), device).to(torch.bfloat16)
        return _tensor(a, device)

    return FactorCache(
        r_mv=arr("r_mv"), nys_z=arr("nys_z"), chol_inv=arr("chol_inv"),
        krige_w=arr("krige_w"), krige_chol=arr("krige_chol"),
        n_chol=empty_counter(), n_chol_calls=empty_counter(),
    )


def partition_from_numpy(part, *, device="cpu") -> Partition:
    """A JAX ``Partition`` (or a dict of its arrays) as the port's."""
    return Partition(
        y=_tensor(_field(part, "y"), device),
        x=_tensor(_field(part, "x"), device),
        coords=_tensor(_field(part, "coords"), device),
        mask=_tensor(_field(part, "mask"), device),
        index=_tensor(_field(part, "index"), device, torch.long),
    )


def grids_from_numpy(
    param_grid, w_grid, *, device="cpu"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, n_q, d) subset quantile grids of a JAX fit
    (``SubsetResult.param_grid`` / ``w_grid``) as tensors, ready for
    api.combine."""
    pg, wg = _tensor(param_grid, device), _tensor(w_grid, device)
    if pg.dim() != 3 or wg.dim() != 3 or pg.shape[:2] != wg.shape[:2]:
        raise ValueError(
            "expected (K, n_q, d) subset grids with matching (K, n_q), got "
            f"{tuple(pg.shape)} and {tuple(wg.shape)}"
        )
    return pg, wg


def meta_kriging_result_from_numpy(result, *, device="cpu"):
    """A JAX ``MetaKrigingResult`` (or a dict of its fields) as the
    port's :class:`~smk_torch.api.MetaKrigingResult`: every array as a
    tensor on ``device``, ``subset_results`` as the port's SubsetResult,
    the scalars and tuples as they are — so the port can predict at new
    sites from, or save a serving artifact of, a JAX fit."""
    from smk_torch.api import MetaKrigingResult
    from smk_torch.models.probit_gp import SubsetResult

    def conv(value):
        if value is None or isinstance(value, (str, float, int, tuple, dict)):
            return value
        return _tensor(value, device)

    subsets = _field(result, "subset_results")
    fields = {f: conv(_field(result, f)) for f in MetaKrigingResult._fields
              if f != "subset_results"}
    fields["subset_results"] = SubsetResult(
        **{f: _tensor(_field(subsets, f), device) for f in SubsetResult._fields})
    return MetaKrigingResult(**fields)
