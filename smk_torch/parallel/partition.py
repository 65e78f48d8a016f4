"""The random equal-m partition — twin of ``random_partition`` and
``partition_from_indices`` in ``smk_tpu/parallel/partition.py``.

The split takes its permutation as an argument: the default comes from
a ``torch.Generator`` (:func:`random_permutation`); the tests pass the
JAX package's own permutation to hold the two packages row for row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Partition(NamedTuple):
    """Stacked K-subset views of the data (leading axis = subsets)."""

    y: torch.Tensor  # (K, m, q)
    x: torch.Tensor  # (K, m, q, p)
    coords: torch.Tensor  # (K, m, d)
    mask: torch.Tensor  # (K, m) 1.0 real / 0.0 pad
    index: torch.Tensor  # (K, m) original row index, -1 for pad

    @property
    def n_subsets(self) -> int:
        return self.y.shape[0]

    @property
    def subset_size(self) -> int:
        return self.y.shape[1]


def random_permutation(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """A uniform random permutation of range(n)."""
    return torch.randperm(n, generator=generator, device=device)


def random_partition(
    perm: torch.Tensor,
    y: torch.Tensor,
    x: torch.Tensor,
    coords: torch.Tensor,
    n_subsets: int,
) -> Partition:
    """Disjoint split of (y, x, coords) into K padded subsets along the
    permutation ``perm`` of range(n): subset size m = ceil(n / K), the
    n..K*m tail is padding."""
    n = y.shape[0]
    k = int(n_subsets)
    m = -(-n // k)
    pad = torch.full((k * m - n,), -1, dtype=torch.long, device=perm.device)
    index = torch.cat([perm.to(torch.long), pad]).reshape(k, m)
    return partition_from_indices(y, x, coords, index)


def partition_from_indices(
    y: torch.Tensor, x: torch.Tensor, coords: torch.Tensor, index: torch.Tensor
) -> Partition:
    """A (K, m) row-index layout (-1 = pad) gathered into a Partition,
    with the pad-row identity every consumer shares: pad rows carry
    mask 0, zeroed y/x, and distinct far-away pseudo-coordinates so no
    subset correlation matrix holds duplicate points."""
    k, m = index.shape
    index = index.to(torch.long)
    mask = (index >= 0).to(coords.dtype)
    safe = torch.clamp(index, min=0)
    y_p = y[safe] * mask[..., None].to(y.dtype)
    x_p = x[safe] * mask[..., None, None].to(x.dtype)
    coords_p = coords[safe]
    span = torch.max(coords) - torch.min(coords) + 1.0
    far = torch.max(coords) + span
    d = coords.shape[-1]
    offsets = (
        torch.arange(m, dtype=coords.dtype, device=coords.device)[None, :, None]
        * torch.ones((1, 1, d), dtype=coords.dtype, device=coords.device)
        * span
        * 0.01
    )
    coords_p = torch.where(mask[..., None] > 0, coords_p, far + offsets)
    return Partition(y=y_p, x=x_p, coords=coords_p, mask=mask, index=index)
