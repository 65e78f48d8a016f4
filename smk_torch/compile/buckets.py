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
(serve/engine.py).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

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
