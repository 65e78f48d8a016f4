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
package resumes the other's checkpoint.

:class:`BackgroundWriter` runs those writes on one thread in submission
order: the ``chunk_pipeline="overlap"`` half that takes the checkpoint
off the host loop (parallel/recovery.py).
"""

from __future__ import annotations

import json
import os
import queue
import threading
import warnings
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from smk_torch.utils.tracing import monotonic

# How long close() waits for the queued writes, then for the thread to
# exit, before it warns and abandons the daemon thread: the exit path
# never hangs on a wedged filesystem. The full rewrites of a normal
# completion run inline (ensure_synced) before close().
_CLOSE_TIMEOUT_S = 60.0


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


class BackgroundWriter:
    """One background thread that runs write jobs in submission order
    (twin of ``BackgroundWriter`` in ``smk_tpu/utils/checkpoint.py``).

    The overlap pipeline submits each boundary's segment and manifest
    here and goes back to dispatching. One thread and a FIFO queue keep
    the order, and every write keeps its temp file and ``os.replace``,
    so a kill at any instant leaves the previous manifest or the new
    one. The first job that fails records its exception and every
    later job is skipped (running job t+1 after job t failed could
    publish a manifest whose segment never landed); the executor sees
    ``error`` at its next boundary and degrades to inline writes.

    A job that fails at the final boundary has no next boundary, so
    ``close`` warns about an error nobody acknowledged
    (:meth:`acknowledge_error`); a normal completion drains, acknowledges
    and rewrites a full checkpoint inline
    (``parallel/recovery._SegmentedCheckpoint.ensure_synced``).

    ``submit`` returns the job's number and :meth:`wait_done` waits for
    it to have run or been skipped: the executor's staging buffers are
    reused only once the job that reads them is done.
    """

    def __init__(self, name: str = "smk-ckpt-writer"):
        self._q: queue.Queue = queue.Queue()
        self._error: Optional[BaseException] = None
        self._error_acked = False
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._started = False
        self._closed = False
        self._submitted = 0
        self._done = 0
        self._done_cv = threading.Condition()

    @property
    def error(self) -> Optional[BaseException]:
        """The first exception a job raised, or None. Stays set: a
        writer that failed once runs no other job."""
        return self._error

    def acknowledge_error(self) -> Optional[BaseException]:
        """Mark the recorded error as surfaced (the degrade and recovery
        paths call this) and return it. ``close`` warns about an error
        nobody acknowledged."""
        if self._error is not None:
            self._error_acked = True
        return self._error

    def submit(self, job: Callable[[], None]) -> int:
        """Queue ``job``; returns its number (1, 2, ... per writer)."""
        if self._closed:
            raise RuntimeError("BackgroundWriter is closed")
        if not self._started:
            self._thread.start()
            self._started = True
        self._submitted += 1
        self._q.put(job)
        return self._submitted

    def wait_done(self, seq: int) -> None:
        """Block until job ``seq`` (a number :meth:`submit` returned) and
        every job before it has run or been skipped. Unbounded, as
        :meth:`flush`: the caller is about to reuse what the job reads."""
        with self._done_cv:
            while self._done < seq:
                self._done_cv.wait(timeout=1.0)

    def flush(self) -> None:
        """Block until every submitted job has run (or been skipped after
        an error). Does not raise: check ``error``. Unbounded by
        contract: the caller is about to read or rewrite what the
        pending jobs write, and a deadline here would trade a visible
        hang for a torn checkpoint. :meth:`close` is the bounded exit."""
        if self._started:
            # smklint: disable=SMK111 -- the drain is unbounded by contract (a deadline here trades a visible hang for a torn checkpoint); close() is the bounded exit
            self._q.join()

    def _drain_bounded(self, timeout_s: float) -> bool:
        """Wait up to ``timeout_s`` for every submitted job; True when
        drained."""
        deadline = monotonic() + timeout_s
        with self._done_cv:
            while self._done < self._submitted:
                left = deadline - monotonic()
                if left <= 0:
                    return False
                self._done_cv.wait(timeout=min(left, 0.05))
        return True

    def close(self) -> None:
        """Drain (boundedly) and stop the thread. Idempotent. Warns when
        a job failed and nothing surfaced the error, and when a wedged
        write keeps the queue from draining within ``_CLOSE_TIMEOUT_S``
        (the daemon thread is then abandoned; an abandoned write still
        lands whole or not at all)."""
        if self._closed:
            return
        self._closed = True
        if self._started:
            drained = self._drain_bounded(_CLOSE_TIMEOUT_S)
            self._q.put(None)
            if drained:
                self._thread.join(timeout=_CLOSE_TIMEOUT_S)
            if not drained or self._thread.is_alive():
                warnings.warn(
                    "background checkpoint writer did not drain within "
                    f"{_CLOSE_TIMEOUT_S:.0f}s (a wedged filesystem write?); abandoning "
                    "the daemon thread — the checkpoint may be missing its final "
                    "boundary (every write is atomic, so no file is torn)",
                    RuntimeWarning, stacklevel=2,
                )
        if self._error is not None and not self._error_acked:
            self._error_acked = True
            warnings.warn(
                f"background checkpoint writer failed ({self._error!r}) and the run "
                "ended before any boundary could surface it — the checkpoint on disk "
                "may be missing its final boundary (earlier writes are consistent: "
                "the writer skips every job after a failure); re-run or resume to "
                "re-establish it",
                RuntimeWarning, stacklevel=2,
            )

    def _loop(self) -> None:
        while True:
            try:
                # bounded wake-ups: the thread never waits forever on a
                # job (or the sentinel) that does not come
                job = self._q.get(timeout=1.0)
            except queue.Empty:
                continue
            if job is None:
                self._q.task_done()
                break
            try:
                if self._error is None:
                    job()
            except BaseException as e:  # surfaced at the next boundary
                self._error = e
            finally:
                with self._done_cv:
                    self._done += 1
                    self._done_cv.notify_all()
                self._q.task_done()
