"""Deterministic fault injection — the part of
``smk_tpu/testing/faults.py`` the port's tests and chip smoke need:
:func:`inject_subset_nan` and :func:`corrupt_segment`.

:func:`inject_subset_nan` wraps the chunked executor's one-chunk seam
(``parallel/recovery._run_chunk``) while an injection is armed and puts
the seam back when the last one disarms, so a fit outside the context
runs the executor untouched. A fault fires at exactly the configured
chunk (no clock, no randomness): the chunk whose sweeps cover the
iteration returns its carried state with the subset's latent u set to
NaN — the twin's ``_poison`` — and travels the real guard, quarantine
and drop path. For tests and probes only, as the twin's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np

from smk_torch.parallel import recovery as _recovery
from smk_torch.utils.checkpoint import segment_path


@dataclass
class SubsetNaNInjection:
    """Arming state of :func:`inject_subset_nan`, and the handle it
    yields (``fires`` counts the strikes). ``skip_fires`` window hits
    pass untouched before the first strike."""

    subset: int
    at_iteration: int
    max_fires: int = 1
    skip_fires: int = 0
    fires: int = 0
    skipped: int = 0
    fired_at: list = field(default_factory=list)


_arm_lock = threading.Lock()
_active_nan: list = []
_real_run_chunk = None


def _poison(state, subset: int, n_chains: int):
    """NaN every chain of ``subset``'s latent u (a small leaf the
    boundary guard covers)."""
    u = state.u.clone()
    u[subset * n_chains:(subset + 1) * n_chains] = float("nan")
    return state._replace(u=u)


def _injecting_run_chunk(model, kind, pieces, state, start, n):
    state, draws = _real_run_chunk(model, kind, pieces, state, start, n)
    hits = []
    for inj in list(_active_nan):
        if not start <= inj.at_iteration < start + n or inj.fires >= inj.max_fires:
            continue
        if inj.skipped < inj.skip_fires:
            inj.skipped += 1
            continue
        inj.fires += 1
        inj.fired_at.append(start)
        hits.append(inj.subset)
    for j in hits:
        state = _poison(state, j, model.config.n_chains)
    return state, draws


@contextmanager
def inject_subset_nan(subset: int, at_iteration: int, max_fires: int = 1,
                      skip_fires: int = 0):
    """Arm a subset-NaN injection: the chunk whose sweeps cover
    ``at_iteration`` returns its state with subset ``subset`` (a row of
    the fit's partition, or of a ragged fit's bucket group) poisoned,
    ``max_fires`` times after letting ``skip_fires`` window hits
    through. A quarantine retry replays the window, so ``max_fires=1``
    lets the first retry succeed and a large value exhausts the ladder.
    Injections nest. Yields the injection record."""
    global _real_run_chunk
    inj = SubsetNaNInjection(subset=int(subset), at_iteration=int(at_iteration),
                             max_fires=int(max_fires), skip_fires=int(skip_fires))
    with _arm_lock:
        if not _active_nan:
            _real_run_chunk = _recovery._run_chunk
            _recovery._run_chunk = _injecting_run_chunk
        _active_nan.append(inj)
    try:
        yield inj
    finally:
        with _arm_lock:
            _active_nan.remove(inj)
            if not _active_nan:
                _recovery._run_chunk = _real_run_chunk
                _real_run_chunk = None


def corrupt_segment(path: str, index: int, mode: str = "bitflip") -> str:
    """Damage draw segment ``index`` of the checkpoint at ``path``:
    ``"truncate"`` keeps the first half of the file; ``"bitflip"`` flips
    one bit in the middle of the param payload and rewrites the file
    with the stale checksum, which only the checksum can catch. Returns
    the segment's path."""
    seg = segment_path(path, index)
    if mode == "truncate":
        with open(seg, "rb") as f:
            data = f.read()
        with open(seg, "wb") as f:
            f.write(data[: len(data) // 2])
    elif mode == "bitflip":
        with np.load(seg) as d:
            arrays = {k: d[k] for k in d.files}
        param = arrays["param"]
        raw = bytearray(param.tobytes())
        raw[len(raw) // 2] ^= 0x40
        arrays["param"] = np.frombuffer(bytes(raw), param.dtype).reshape(param.shape)
        with open(seg, "wb") as f:
            np.savez(f, **arrays)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return seg

