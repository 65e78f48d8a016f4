"""Partitioners — twin of ``smk_tpu/parallel/partition.py``: the random
equal-m split, and the ragged layer (unequal subsets padded onto the
√2 bucket ladder of compile/buckets.py, one equal-m group per occupied
rung, and the coherent Morton partitioner that makes such subsets).

The random split takes its permutation as an argument: the default
comes from a ``torch.Generator`` (:func:`random_permutation`); the
tests pass the JAX package's own permutation to hold the two packages
row for row. The ragged layer is deterministic host-side numpy (index
arithmetic done once per fit); only the gathered rows are tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from smk_torch.compile.buckets import (
    bucket_for,
    bucket_ladder,
    pad_accounting,
    validate_ladder,
)


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


class BucketGroup(NamedTuple):
    """One occupied bucket of a ragged partition: the subsets whose
    padded size is ``bucket``, stacked as an ordinary equal-m
    :class:`Partition`."""

    bucket: int
    subset_ids: Tuple[int, ...]  # original subset index per row
    part: Partition


class PaddedPartition(NamedTuple):
    """A ragged K-subset partition padded onto a bucket ladder: true
    sizes ``sizes[k]``, each subset padded up to the smallest rung that
    holds it (compile/buckets.bucket_for) with the shared pad-row
    identity, grouped by bucket into equal-m :class:`BucketGroup`
    stacks (ascending bucket order; original subset order within a
    group)."""

    groups: Tuple[BucketGroup, ...]
    sizes: Tuple[int, ...]  # true n_k per original subset
    ladder: Tuple[int, ...]

    @property
    def n_subsets(self) -> int:
        return len(self.sizes)

    @property
    def buckets(self) -> Tuple[int, ...]:
        """Occupied buckets, ascending."""
        return tuple(g.bucket for g in self.groups)

    @property
    def bucket_of_subset(self) -> Tuple[int, ...]:
        """Padded size per original subset index."""
        out = [0] * self.n_subsets
        for g in self.groups:
            for j in g.subset_ids:
                out[j] = g.bucket
        return tuple(out)

    def pad_summary(self) -> dict:
        """compile/buckets.pad_accounting over the whole partition."""
        return pad_accounting(self.sizes, self.bucket_of_subset)


def padded_partition(
    y: torch.Tensor,
    x: torch.Tensor,
    coords: torch.Tensor,
    assignments: Sequence[np.ndarray],
    *,
    ladder: Optional[Sequence[int]] = None,
) -> PaddedPartition:
    """A :class:`PaddedPartition` from explicit per-subset row
    assignments (disjoint 1-D row-index arrays of unequal lengths).
    Each subset pads up to ``bucket_for(n_k, ladder)`` with the pad
    identity of :func:`partition_from_indices`. ``ladder`` defaults to
    the √2 ladder covering the largest subset; an explicit ladder that
    tops out below the largest subset is an error, never a truncation.

    The indices are checked before the gather, which would otherwise
    wrap a negative index (or make it a pad row) and fail late on one
    past the end: non-integer, out-of-range and repeated indices raise
    ``ValueError``."""
    sizes = tuple(int(np.asarray(a).shape[0]) for a in assignments)
    if not sizes:
        raise ValueError("assignments must name at least one subset")
    if any(s < 1 for s in sizes):
        raise ValueError(f"every subset needs at least one row, got sizes {sizes}")
    n_rows = int(y.shape[0])
    flat = np.concatenate([np.asarray(a).reshape(-1) for a in assignments])
    if not np.issubdtype(flat.dtype, np.integer):
        raise ValueError(f"assignments must be integer row indices, got dtype {flat.dtype}")
    if flat.size and (flat.min() < 0 or flat.max() >= n_rows):
        bad = flat[(flat < 0) | (flat >= n_rows)][:8]
        raise ValueError(
            f"assignment row indices must lie in [0, n={n_rows}); "
            f"got {bad.tolist()} — 1-based or negative indices "
            "would be silently clamped/dropped by the padded gather"
        )
    if np.unique(flat).size != flat.size:
        dup = flat[np.bincount(flat, minlength=n_rows)[flat] > 1][:8]
        raise ValueError(
            "assignments must be DISJOINT subsets — row indices "
            f"{sorted(set(dup.tolist()))} appear in more than one "
            "subset (or twice in one)"
        )
    lad = bucket_ladder(max(sizes)) if ladder is None else validate_ladder(ladder)
    buckets = [bucket_for(s, lad) for s in sizes]
    by_bucket: dict = {}
    for j, b in enumerate(buckets):
        by_bucket.setdefault(b, []).append(j)
    groups = []
    for b in sorted(by_bucket):
        ids = by_bucket[b]
        index = np.full((len(ids), b), -1, np.int64)
        for row, j in enumerate(ids):
            a = np.asarray(assignments[j]).reshape(-1)
            index[row, : a.shape[0]] = a
        part = partition_from_indices(y, x, coords, torch.as_tensor(index, device=coords.device))
        groups.append(BucketGroup(bucket=int(b), subset_ids=tuple(ids), part=part))
    return PaddedPartition(groups=tuple(groups), sizes=sizes, ladder=lad)


# quantization depth of the Morton curve: 16 bits per dimension (the
# twin's MORTON_BITS, which its ingest router shares)
MORTON_BITS = 16


def morton_codes(coords, *, lo, span, bits: int = MORTON_BITS) -> np.ndarray:
    """Interleaved-bit Morton (Z-order) codes (uint64) of ``coords``
    (n, d) under the fixed quantization frame ``(lo, span, bits)``.
    Coordinates outside the frame clip onto its boundary."""
    c = np.asarray(coords, np.float64)
    lo = np.asarray(lo, np.float64)
    span = np.asarray(span, np.float64)
    n, d = c.shape
    frac = np.clip((c - lo) / span, 0.0, 1.0)
    quant = np.minimum((frac * (2**bits - 1)).astype(np.uint64), 2**bits - 1)
    code = np.zeros(n, np.uint64)
    for b in range(bits):
        for j in range(d):
            code |= ((quant[:, j] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d + j)
    return code


def coherent_assignments(coords, n_subsets: int, *, cell_bits: Optional[int] = None) -> list:
    """Spatially coherent subset assignments: rows sorted (stably) by
    the Morton codes of their coordinates, in the data's own frame, and
    cut into ``n_subsets`` contiguous runs, each cut snapped to the
    nearest coarse-cell boundary (points sharing the top ``cell_bits``
    bits per dimension stay together), so the sizes are unequal. A cut
    whose nearest boundary lies more than a quarter of an ideal subset
    away falls back to the equal split point, which keeps every size
    within ±50 % of n/K (up to the ±1 of integer targets). Deterministic
    numpy; returns K index arrays."""
    c = np.asarray(coords, np.float64)
    if c.ndim != 2:
        raise ValueError(f"coords must be (n, d), got shape {c.shape}")
    n, d = c.shape
    k = int(n_subsets)
    if k < 1 or k > n:
        raise ValueError(f"n_subsets must be in [1, n={n}], got {k}")
    lo = c.min(axis=0)
    span = c.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    code = morton_codes(c, lo=lo, span=span)
    order = np.argsort(code, kind="stable")
    bits = MORTON_BITS
    if k == 1:
        return [order]
    if cell_bits is None:
        # coarse cells a few levels finer than the subset count: each
        # subset spans several cells, so a snap moves a cut by a cell
        cell_bits = max(1, int(np.ceil(np.log2(max(k, 2)) / d)) + 2)
    cell_bits = min(cell_bits, bits)
    coarse = code[order] >> np.uint64(d * (bits - cell_bits))
    changes = np.flatnonzero(coarse[1:] != coarse[:-1]) + 1  # valid cut points
    cuts = []
    ideal = n / k
    for i in range(1, k):
        target = int(round(i * ideal))
        best = target
        if changes.size:
            pos = np.searchsorted(changes, target)
            cands = [int(changes[j]) for j in (pos - 1, pos) if 0 <= j < changes.size]
            best = min(cands, key=lambda cx: abs(cx - target))
            if abs(best - target) > ideal / 4:
                best = target  # an oversized cell: split it
        cuts.append(best)
    # strictly increasing cuts, every subset non-empty
    fixed = []
    prev = 0
    for i, cpos in enumerate(cuts):
        fixed.append(min(max(cpos, prev + 1), n - (k - 1 - i)))
        prev = fixed[-1]
    return np.split(order, fixed)


def coherent_partition(
    y: torch.Tensor,
    x: torch.Tensor,
    coords: torch.Tensor,
    n_subsets: int,
    *,
    ladder: Optional[Sequence[int]] = None,
) -> PaddedPartition:
    """Spatially coherent disjoint split of (y, x, coords) into K
    bucket-padded subsets: :func:`coherent_assignments` through
    :func:`padded_partition`. The twin takes a PRNG key first and
    ignores it (the split is a function of the coordinates alone); the
    port, which has no keys, takes none."""
    return padded_partition(
        y, x, coords, coherent_assignments(coords.cpu().numpy(), n_subsets), ladder=ladder
    )
