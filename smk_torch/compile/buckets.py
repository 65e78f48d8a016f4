"""Shape-bucket ladder math — the port's own copy of the pure size
arithmetic in ``smk_tpu/compile/buckets.py`` (the port imports nothing
of the JAX package): the √2 ladder of padded subset sizes, the bucket
a size falls into, ladder validation and pad accounting.

A ragged partition (``parallel/partition.padded_partition``) pads each
subset up to the smallest ladder rung that holds it, so a fit runs one
equal-m group per occupied rung instead of one per distinct size.
Consecutive rungs differ by ~41 % (integer rounding stretches the worst
small-rung gap to 16/11), so a subset's pad rows stay below ~0.46 of
its real rows, and [min_bucket, max] needs only 2·log2(max/min) rungs.
A size that is a rung takes its exact-size bucket, with no pad rows.

The same ladder over the subset axis (:func:`k_ladder`,
:func:`compaction_rung`) sizes the adaptive schedule's compacted
dispatch groups (parallel/schedule.py), and a query-batch ladder
(:func:`slice_plan`) the serving engine's micro-batches
(serve/engine.py). :func:`plan_ragged_mesh` bin-packs a ragged fit's
bucket groups onto a device mesh (:class:`RaggedMeshPlan`).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

# the default smallest m-axis bucket: tiny subsets pad up to at least
# this many rows (the twin's MIN_BUCKET)
MIN_BUCKET = 8


def bucket_ladder(max_size: int, *, min_bucket: int = MIN_BUCKET) -> Tuple[int, ...]:
    """Ascending powers-of-√2 rungs covering ``[min_bucket, max_size]``:
    ``round(2 ** (i / 2))`` for integer i, deduplicated and strictly
    increasing, extended until one rung holds ``max_size``."""
    if max_size < 1:
        raise ValueError(f"max_size must be >= 1, got {max_size}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be >= 1, got {min_bucket}")
    rungs: List[int] = []
    i = max(0, math.ceil(2 * math.log2(min_bucket)) - 1)
    while True:
        r = int(round(2 ** (i / 2)))
        if r >= min_bucket and (not rungs or r > rungs[-1]):
            rungs.append(r)
            if r >= max_size:
                break
        i += 1
    return tuple(rungs)


def select_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that holds ``n`` rows, or the largest bucket
    when none does (the serving cap; the m-axis partition uses
    :func:`bucket_for`, which refuses overflow). ``buckets`` ascends."""
    for b in buckets:
        if b >= n:
            return int(b)
    return int(buckets[-1])


def bucket_for(n: int, ladder: Sequence[int]) -> int:
    """The smallest ladder rung holding ``n`` rows; a ``ValueError`` if
    the ladder tops out below ``n`` (a subset is never truncated to fit
    a bucket)."""
    if n < 1:
        raise ValueError(f"subset size must be >= 1, got {n}")
    for b in ladder:
        if b >= n:
            return int(b)
    raise ValueError(
        f"no ladder rung holds {n} rows (ladder max "
        f"{int(ladder[-1])}) — extend bucket_ladder / "
        "config.bucket_ladder to cover the largest subset"
    )


def slice_plan(n: int, buckets: Sequence[int]) -> List[Tuple[int, int, int]]:
    """Micro-batch plan of one ``n``-row request over an ascending bucket
    ladder: ``[(start, stop, bucket), ...]`` — slices of at most
    ``max(buckets)`` rows, each padded up to the smallest bucket that
    holds it (the serving engine's dispatch loop)."""
    cap = int(buckets[-1])
    return [
        (lo, min(lo + cap, n), select_bucket(min(lo + cap, n) - lo, buckets))
        for lo in range(0, n, cap)
    ]


def validate_ladder(ladder) -> Tuple[int, ...]:
    """An explicit ladder (``SMKConfig.bucket_ladder``) as a tuple of
    positive, strictly ascending ints; a bare scalar is a one-rung
    ladder. Anything else is a ``ValueError``."""
    if isinstance(ladder, (int, float)) and not isinstance(ladder, bool):
        ladder = (ladder,)
    if isinstance(ladder, (str, bytes)):
        raise ValueError(
            "bucket ladder must be a sequence of ascending positive "
            f"ints (or one int), got {ladder!r}"
        )
    try:
        out = tuple(int(b) for b in ladder)
    except (TypeError, ValueError) as e:
        raise ValueError(
            "bucket ladder must be a sequence of ascending positive "
            f"ints (or one int), got {ladder!r}"
        ) from e
    if not out:
        raise ValueError("bucket ladder must not be empty")
    if any(b < 1 for b in out):
        raise ValueError(f"bucket ladder entries must be >= 1: {out}")
    if any(b2 <= b1 for b1, b2 in zip(out, out[1:])):
        raise ValueError(f"bucket ladder must be strictly ascending: {out}")
    return out


def pad_accounting(sizes: Sequence[int], buckets: Sequence[int]) -> Dict[str, object]:
    """Padding overhead of a ragged partition: ``sizes[k]`` real rows
    padded to ``buckets[k]`` rows. ``pad_frac`` is pad rows over padded
    rows, rounded to 6 digits."""
    if len(sizes) != len(buckets):
        raise ValueError(f"{len(sizes)} sizes vs {len(buckets)} buckets")
    real = int(sum(int(s) for s in sizes))
    padded = int(sum(int(b) for b in buckets))
    if any(s > b for s, b in zip(sizes, buckets)):
        raise ValueError("a subset exceeds its bucket")
    return {
        "real_rows": real,
        "padded_rows": padded,
        "pad_rows": padded - real,
        "pad_frac": round((padded - real) / padded, 6) if padded else 0.0,
        "occupied_buckets": sorted({int(b) for b in buckets}),
    }


def k_ladder(max_k: int) -> Tuple[int, ...]:
    """The K-axis compaction ladder of the adaptive schedule: √2 rungs
    from one subset up to the run's K, the top rung clamped to K, so the
    uncompacted dispatch group is always a rung (the twin's
    ``k_ladder``)."""
    rungs = [min(int(r), int(max_k)) for r in bucket_ladder(max_k, min_bucket=1)]
    out: List[int] = []
    for r in rungs:
        if not out or r > out[-1]:
            out.append(r)
    return tuple(out)


def compaction_rung(n_active: int, k: int, n_devices: int = 1) -> int:
    """Dispatch-group size for ``n_active`` live subsets of a K-subset
    adaptive run: the smallest :func:`k_ladder` rung holding them,
    rounded up to a multiple of ``n_devices`` and capped at K. The gap
    ``rung - n_active`` is padded with clones of the first live subset,
    whose draws the executor drops."""
    if not 1 <= n_active <= k:
        raise ValueError(f"n_active must be in [1, {k}], got {n_active}")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if k % n_devices != 0:
        raise ValueError(
            f"K={k} not divisible by n_devices={n_devices} — the "
            "uncompacted run would already violate the layout oracle"
        )
    rung = bucket_for(n_active, k_ladder(k))
    return min(ceil_to_multiple(rung, n_devices), k)


def ceil_to_multiple(n: int, multiple: int) -> int:
    """``n`` rounded up to a multiple of ``multiple``."""
    if n < 0 or multiple < 1:
        raise ValueError(
            f"ceil_to_multiple needs n >= 0 and multiple >= 1, got "
            f"n={n}, multiple={multiple}"
        )
    return ((n + multiple - 1) // multiple) * multiple


class RaggedMeshEntry(NamedTuple):
    """One executable unit of a :class:`RaggedMeshPlan` (twin's): a single
    bucket group with K padded up to a device multiple, or several
    sub-device-count groups fused into one super-batch. ``group_ids``
    index the source ``PaddedPartition.groups``; ``buckets``/``ks`` are
    the members' buckets and real subset counts. The entry runs at
    ``bucket`` (the largest member's; smaller members are re-padded on
    the m axis) with ``padded_k`` subsets over an ``n_devices``-long
    prefix sub-mesh; subsets ``[k_real:padded_k]`` are pad clones whose
    results the executor drops at the stitch."""

    group_ids: Tuple[int, ...]
    buckets: Tuple[int, ...]
    ks: Tuple[int, ...]
    bucket: int
    k_real: int
    padded_k: int
    n_devices: int

    @property
    def per_device(self) -> int:
        return self.padded_k // self.n_devices

    @property
    def pad_k(self) -> int:
        return self.padded_k - self.k_real

    @property
    def fused(self) -> bool:
        return len(self.group_ids) > 1

    @property
    def pad_mask(self) -> Tuple[bool, ...]:
        """True for real subset slots, False for K-pad clones."""
        return (True,) * self.k_real + (False,) * self.pad_k

    @property
    def real_rows(self) -> int:
        """The host path's padded rows of the member groups."""
        return sum(k * b for k, b in zip(self.ks, self.buckets))

    @property
    def padded_rows(self) -> int:
        return self.padded_k * self.bucket


class RaggedMeshPlan(NamedTuple):
    """The device layout of a ragged fit on a mesh: one
    :class:`RaggedMeshEntry` per executable unit, in ascending bucket
    order. ``pad_waste_frac`` is the waste the mesh adds over the host
    ragged path, ``1 - sum(k_g * b_g) / sum(padded_k_e * bucket_e)``,
    below ``waste_bound`` by construction."""

    entries: Tuple[RaggedMeshEntry, ...]
    n_devices: int
    fuse_max_rows_frac: float

    @property
    def pad_waste_frac(self) -> float:
        real = sum(e.real_rows for e in self.entries)
        padded = sum(e.padded_rows for e in self.entries)
        return round(1.0 - real / padded, 6) if padded else 0.0

    @property
    def waste_bound(self) -> float:
        """Fused entries waste at most ``fuse_max_rows_frac`` of their rows
        and K-padded ones less than ``2 / n_devices`` (capped at 1.0)."""
        return min(1.0, max(self.fuse_max_rows_frac, 2.0 / self.n_devices))

    def entry_of_group(self, group_id: int) -> int:
        for i, e in enumerate(self.entries):
            if group_id in e.group_ids:
                return i
        raise KeyError(f"group {group_id} not in plan")

    def summary(self) -> Dict[str, object]:
        return {
            "n_entries": len(self.entries),
            "n_devices": self.n_devices,
            "pad_waste_frac": self.pad_waste_frac,
            "waste_bound": round(self.waste_bound, 6),
            "entries": [
                {"group_ids": list(e.group_ids), "bucket": e.bucket, "k_real": e.k_real,
                 "padded_k": e.padded_k, "n_devices": e.n_devices, "fused": e.fused}
                for e in self.entries
            ],
        }


def _k_layout(k: int, n_devices: int) -> Tuple[int, int]:
    """(padded_k, n_sub) for one group of ``k >= n_devices`` subsets: the
    fewest subsets per device first, then the fewest devices that cover
    ``k`` at that count (k = 9 on 8 devices runs 2 a device on 5)."""
    per_dev = -(-k // n_devices)
    n_sub = -(-k // per_dev)
    return per_dev * n_sub, n_sub


def plan_ragged_mesh(group_buckets: Sequence[int], group_ks: Sequence[int], n_devices: int, *,
                     fuse_max_rows_frac: float = 0.25) -> RaggedMeshPlan:
    """Bin-pack a ragged partition's bucket groups (ascending buckets,
    ``group_ks`` their real subset counts) onto a 1-D mesh of
    ``n_devices`` (the twin's rules):

    - a group with ``k >= n_devices`` is its own entry, K padded by
      :func:`_k_layout`;
    - smaller groups fuse greedily, in bucket order, while the fused K
      stays <= ``n_devices`` and the m-axis re-pad waste stays <=
      ``fuse_max_rows_frac``; a fused entry runs one subset a device on a
      ``k_real``-device sub-mesh with no K pad;
    - on one device every rule is the identity: one entry per group, no
      fusion, no pads (the plan IS the host ragged path).

    Every entry satisfies the executor's layout oracle."""
    if len(group_buckets) != len(group_ks):
        raise ValueError(f"{len(group_buckets)} buckets vs {len(group_ks)} ks")
    if not group_buckets:
        raise ValueError("plan_ragged_mesh needs at least one group")
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if not 0.0 <= fuse_max_rows_frac < 1.0:
        raise ValueError(f"fuse_max_rows_frac must be in [0, 1), got {fuse_max_rows_frac}")
    bs = [int(b) for b in group_buckets]
    ks = [int(k) for k in group_ks]
    if any(k < 1 for k in ks):
        raise ValueError(f"group subset counts must be >= 1: {ks}")
    if any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
        raise ValueError(
            f"group buckets must be strictly ascending (the PaddedPartition invariant): {bs}")

    entries: List[RaggedMeshEntry] = []
    open_ids: List[int] = []  # a fusion batch of small groups, pending

    def close_open() -> None:
        if not open_ids:
            return
        mb = [bs[g] for g in open_ids]
        mk = [ks[g] for g in open_ids]
        k_real = sum(mk)
        entries.append(RaggedMeshEntry(group_ids=tuple(open_ids), buckets=tuple(mb),
                                       ks=tuple(mk), bucket=mb[-1], k_real=k_real,
                                       padded_k=k_real, n_devices=k_real))
        open_ids.clear()

    for g, (b, k) in enumerate(zip(bs, ks)):
        if k >= n_devices:
            close_open()
            padded_k, n_sub = _k_layout(k, n_devices)
            entries.append(RaggedMeshEntry(group_ids=(g,), buckets=(b,), ks=(k,), bucket=b,
                                           k_real=k, padded_k=padded_k, n_devices=n_sub))
            continue
        if open_ids:
            cand = open_ids + [g]
            ck = sum(ks[i] for i in cand)
            # ascending buckets: fusing re-pads every member up to this bucket
            waste = 1.0 - sum(ks[i] * bs[i] for i in cand) / (ck * b)
            if ck > n_devices or waste > fuse_max_rows_frac:
                close_open()
        open_ids.append(g)
    close_open()

    ebs = [e.bucket for e in entries]
    if any(b2 <= b1 for b1, b2 in zip(ebs, ebs[1:])):
        raise AssertionError(f"plan entry buckets not ascending: {ebs}")
    from smk_torch.parallel.executor import require_divisible_layout

    for e in entries:
        require_divisible_layout(e.padded_k, e.n_devices, what=f"plan entry bucket={e.bucket}")
    return RaggedMeshPlan(entries=tuple(entries), n_devices=int(n_devices),
                          fuse_max_rows_frac=float(fuse_max_rows_frac))
