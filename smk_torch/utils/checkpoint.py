"""Checkpoint files — twin of ``smk_tpu/utils/checkpoint.py``: a tree of
arrays (NamedTuples, dicts, lists and tuples of tensors or numpy
arrays) as one ``.npz``, the named sidecars, and the chunked
executor's draw segments with their payload checksums.

Every file is written to ``<path>.tmp`` and published with
``os.replace``, so a kill at any instant leaves the previous file or
the new one, never a torn one (the twin's SMK113 discipline;
tests/test_torch_recovery.py holds this package to it). Leaves come
back as numpy arrays. The files are the port's own: the twin stores
its PRNG keys where the port stores its noise snapshot, so neither
package resumes the other's checkpoint. The background writer of the
overlap pipeline is ROADMAP A8b.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, List, Tuple

import numpy as np
import torch


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure string) of ``tree``. Dicts flatten in sorted
    key order (as jax's pytrees); None is a node without leaves."""
    leaves: List[Any] = []

    def walk(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ",".join(f"{k!r}:{walk(node[k])}" for k in keys) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            inner = ",".join(f"{f}={walk(getattr(node, f))}" for f in node._fields)
            return f"{type(node).__name__}({inner})"
        if isinstance(node, (list, tuple)):
            inner = ",".join(walk(c) for c in node)
            return ("[" + inner + "]") if isinstance(node, list) else ("(" + inner + ")")
        leaves.append(node)
        return "*"

    return leaves, walk(tree)


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` in the structure of ``like`` (the inverse of
    :func:`_flatten`)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            out = [build(c) for c in node]
            return out if isinstance(node, list) else tuple(out)
        return next(it)

    return build(like)


def to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as a numpy array (a tensor is fetched from its device)."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> int:
    """Save a tree of arrays to ``path`` (.npz), atomically; returns the
    bytes written. The structure string rides along and is checked on
    load."""
    leaves, structure = _flatten(tree)
    arrays = {f"leaf_{i}": to_numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    return _atomic_savez(path, arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Load arrays saved by :func:`save_pytree` into the structure of
    ``like`` (which supplies the structure and the leaf count; dtypes
    and shapes come from the file)."""
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        saved = (json.loads(bytes(data["__treedef__"]).decode())
                 if "__treedef__" in data.files else None)
    like_leaves, structure = _flatten(like)
    if len(like_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, expected {len(like_leaves)}"
        )
    if saved is not None and saved != structure:
        raise ValueError(
            f"checkpoint structure mismatch:\n  saved:    {saved}\n  expected: {structure}"
        )
    return _unflatten(like, leaves)


def _atomic_savez(path: str, arrays: dict) -> int:
    """np.savez ``arrays`` to ``path`` through a temp file and
    ``os.replace``; returns the bytes written."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    size = os.path.getsize(tmp)
    os.replace(tmp, path)
    return size


def sidecar_path(path: str, name: str) -> str:
    """On-disk name of the ``name`` sidecar of the manifest at ``path``."""
    return f"{path}.{name}.npz"


def save_sidecar(path: str, name: str, arrays: dict) -> int:
    """Atomically write a dict of arrays as the ``name`` sidecar of the
    manifest at ``path``; returns the bytes written."""
    return _atomic_savez(sidecar_path(path, name),
                         {k: to_numpy(v) for k, v in arrays.items()})


def load_sidecar(path: str, name: str) -> dict:
    """A sidecar written by :func:`save_sidecar`, as a dict of numpy
    arrays. Raises FileNotFoundError when absent."""
    with np.load(sidecar_path(path, name)) as data:
        return {k: data[k].copy() for k in data.files}


def segment_path(path: str, index: int) -> str:
    """On-disk name of draw segment ``index`` of the checkpoint whose
    manifest is ``path`` (deterministic: a resumed run overwrites an
    orphan a killed run left at the same index)."""
    return f"{path}.seg{index:05d}.npz"


def segment_checksum(param_draws: np.ndarray, w_draws: np.ndarray, start: int,
                     stop: int) -> int:
    """CRC32 over a segment's payload bytes and its recorded range."""
    h = zlib.crc32(np.asarray([start, stop], np.int64).tobytes())
    h = zlib.crc32(np.ascontiguousarray(param_draws).tobytes(), h)
    return zlib.crc32(np.ascontiguousarray(w_draws).tobytes(), h)


def save_segment(path: str, index: int, param_draws, w_draws, start: int,
                 stop: int) -> int:
    """Write one draw segment (the kept draws of filled iterations
    [start, stop)), stamped with its checksum. Atomic; returns the
    bytes written."""
    param_draws = to_numpy(param_draws)
    w_draws = to_numpy(w_draws)
    return _atomic_savez(
        segment_path(path, index),
        {
            "param": param_draws,
            "w": w_draws,
            "start": np.asarray([start], np.int64),
            "stop": np.asarray([stop], np.int64),
            "crc": np.asarray([segment_checksum(param_draws, w_draws, start, stop)],
                              np.uint32),
        },
    )


def load_segment(path: str, index: int) -> dict:
    """One draw segment written by :func:`save_segment`, its checksum
    verified. Raises ValueError on a mismatch (and whatever np.load
    raises on a truncated file)."""
    seg = segment_path(path, index)
    with np.load(seg) as data:
        out = {
            "param": data["param"],
            "w": data["w"],
            "start": int(data["start"][0]),
            "stop": int(data["stop"][0]),
        }
        if "crc" in data.files:
            want = int(data["crc"][0])
            got = segment_checksum(out["param"], out["w"], out["start"], out["stop"])
            if got != want:
                raise ValueError(
                    f"draw segment {seg} failed its integrity checksum (stored "
                    f"{want:#010x}, recomputed {got:#010x}) — the file is corrupt"
                )
    return out
