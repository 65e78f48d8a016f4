"""Append-atomic JSONL records — twin of ``smk_tpu/obs/reporter.py``
(stdlib only).

- **flush per record**: every record is flushed the moment it is
  written (and the file fsync'd on close), so a killed process loses at
  most the record it was writing;
- **torn-line safety**: :func:`read_jsonl` skips a torn trailing line
  (the half-written record a kill leaves) instead of failing on the
  whole file.

The run log (obs/events.py) writes through this from inside the chunked
executor's host loop.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Any, Dict, Iterable, List


def _json_safe(obj):
    """Strict-JSON value coercion: non-finite floats become null.
    NaN is routine telemetry (a live ESS before two batches exist, a
    single-chain R-hat before its second half fills), but a bare
    ``NaN`` token is not valid JSON and breaks every non-Python
    consumer (jq et al.) — null is the one spelling of "unavailable"
    both sides agree on."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


class JsonlWriter:
    """Append-only JSONL file handle: one ``json.dumps`` line per
    record — STRICT JSON (non-finite floats serialized as null, see
    :func:`_json_safe`) — flushed per record, thread-safe (the
    overlap pipeline's background checkpoint writer and the caller
    thread both emit run log events). ``append=False`` truncates;
    ``append=True`` extends an existing file."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        # flush-per-record and read_jsonl's torn-line tolerance are the
        # atomicity model: a temp file and rename would break tailing
        self._f = open(path, "a" if append else "w", encoding="utf-8")
        self._lock = threading.Lock()
        self._closed = False

    def write(self, record: Dict[str, Any]) -> None:
        """Write one record as one line and flush it to the OS — a
        kill after this returns can only tear a LATER record."""
        line = json.dumps(_json_safe(record), allow_nan=False) + "\n"
        with self._lock:
            if self._closed:
                raise ValueError(
                    f"JsonlWriter({self.path!r}) is closed"
                )
            self._f.write(line)
            self._f.flush()

    def close(self, *, fsync: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._f.flush()
                if fsync:
                    os.fsync(self._f.fileno())
            finally:
                self._f.close()

    def __enter__(self) -> "JsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_records(
    path: str, records: Iterable[Dict[str, Any]]
) -> None:
    """Truncate ``path`` and write every record, flushed per record."""
    with JsonlWriter(path) as w:
        for r in records:
            w.write(r)


def read_jsonl(
    path: str, *, strict: bool = False
) -> List[Dict[str, Any]]:
    """Every complete record in a JSONL file. A torn trailing line —
    the crash-truncation residue flush-per-record bounds to at most
    one — is skipped silently; a malformed line ANYWHERE ELSE means
    the file was not written by this module's contract and raises
    (``strict=True`` raises on the trailing line too)."""
    out: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1 and not strict:
                continue  # torn trailing record: the documented loss
            raise ValueError(
                f"{path}:{i + 1}: malformed JSONL record ({e})"
            ) from e
    return out
