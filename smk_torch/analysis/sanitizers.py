"""Runtime sanitizers — smklint's layer 2, twin of
``smk_tpu/analysis/sanitizers.py`` (the same public names).

Two context managers turn hot-path invariants from conventions into
checks that fail loudly:

- :func:`recompile_guard` counts the port's compile events and raises
  :class:`RecompileError` when a declared-stable region compiles more
  than its budget. A compile event is an ``nvcc`` run
  (ops/cuda_build.build), or a program that compile/programs.get_program
  builds for an L1 miss: on the card that program's CUDA-graph capture
  (``GraphProgram._capture``, precompile's captures included) is the
  event, and on the CPU, where nothing is captured, the L1 build is. A
  build and then its capture on the card are one event.
- :func:`transfer_guard_strict` arms torch's CUDA sync debug mode
  (``torch.cuda.set_sync_debug_mode("error")``) and opens a
  sanctioned-transfer ledger: every deliberate device<->host copy or
  wait of the chunk loop runs under :func:`explicit_d2h` /
  :func:`explicit_h2d` / :func:`explicit_wait` and is recorded with a
  tag and a direction; any other synchronising call raises.

What torch's sync debug mode flags is not what JAX's transfer guard
flags. It flags the calls that block the host on the device: ``.item()``,
``.tolist()``, a blocking ``.cpu()`` / ``.to("cpu")``, a blocking copy
from pageable host memory onto the card (``torch.tensor(x,
device=...)``), ``torch.cuda.synchronize`` and ``nonzero``. It does not
flag an event wait, nor a non-blocking copy into pinned memory: the
chunk loop's boundary copies (pinned staging behind an event) raise
nothing, and the tag at the twin's site is their record — the twin's
CPU situation exactly. It does not tell the two directions apart, so
``d2h`` and ``h2d`` arm one mode, the stricter of the two, and the
ledger records each entry's direction. The mode is process-wide, not
per thread: an ``explicit_*`` scope drops it to 0 while any scope is
open (a count under the ledger's lock), and the last scope to close
puts the region's mode back — so a background writer's scope never
re-arms or disarms the mode under the main thread's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

# One process-wide monotone compile counter; guards read deltas. The
# lock is for the counter only — nothing stops two guards from
# overlapping across threads.
_compile_lock = threading.Lock()
_compile_count = 0


def note_compile() -> None:
    """Count one compile event (an nvcc run, a capture or a CPU L1
    build); called by ops/cuda_build and compile/programs."""
    global _compile_count
    with _compile_lock:
        _compile_count += 1


def compile_count() -> int:
    """Process-wide count of compile events (monotone; guards read
    deltas)."""
    with _compile_lock:
        return _compile_count


class RecompileError(RuntimeError):
    """A declared-stable hot path triggered more compile events than
    its budget allows."""

    def __init__(self, label: str, compiles: int, max_compiles: int):
        self.label = label
        self.compiles = compiles
        self.max_compiles = max_compiles
        super().__init__(
            f"{label}: {compiles} compile event(s) (nvcc runs, CUDA-graph "
            f"captures or L1 program builds) observed but at most "
            f"{max_compiles} allowed — a shape/dtype/static-arg "
            "perturbation is defeating the program cache; bucket the "
            "shapes or widen the declared budget deliberately"
        )


class RecompileGuard:
    """Handle yielded by :func:`recompile_guard` — live compile
    telemetry for the enclosed region."""

    def __init__(self, label: str, max_compiles: int):
        self.label = label
        self.max_compiles = max_compiles
        self._start = compile_count()

    @property
    def compiles(self) -> int:
        return compile_count() - self._start

    def check(self) -> int:
        """Raise now (not at exit) if the budget is already blown;
        returns the current count otherwise."""
        n = self.compiles
        if n > self.max_compiles:
            raise RecompileError(self.label, n, self.max_compiles)
        return n


@contextmanager
def recompile_guard(
    max_compiles: int = 0, label: str = "declared-stable hot path"
):
    """Fail if the enclosed region triggers more than ``max_compiles``
    compile events.

    ``max_compiles=0`` (default) declares the region fully warm: any
    nvcc run, capture or L1 build is a regression. Counting is
    process-wide, so don't run two compiling workloads concurrently
    under separate guards and expect per-guard attribution.
    """
    guard = RecompileGuard(label, max_compiles)
    yield guard
    guard.check()


# ---------------------------------------------------------------------------
# transfer discipline
# ---------------------------------------------------------------------------


@dataclass
class TransferLedger:
    """Sanctioned-transfer record for one strict region: (tag, nbytes)
    per :func:`explicit_d2h`/:func:`explicit_h2d`/:func:`explicit_wait`
    entry, and each entry's direction ("d2h", "h2d" or "wait") in
    ``directions``. ``nbytes`` is the caller's accounting, -1 when
    unknown."""

    entries: List[Tuple[str, int]] = field(default_factory=list)
    directions: List[str] = field(default_factory=list)
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    def record(self, tag: str, nbytes: int, direction: str = "d2h") -> None:
        with self._lock:
            self.entries.append((tag, nbytes))
            self.directions.append(direction)

    @property
    def tags(self):
        with self._lock:
            return {t for t, _ in self.entries}

    def bytes_for(self, tag: str) -> int:
        with self._lock:
            return sum(n for t, n in self.entries if t == tag and n > 0)

    def count(self, tag: str) -> int:
        with self._lock:
            return sum(1 for t, _ in self.entries if t == tag)


# Sanctioned sites run on both the caller thread and the background
# checkpoint writer thread, and the overlap pipeline interleaves them —
# so the active ledger, the armed mode and the count of open scopes are
# process-global, guarded by one lock.
_state_lock = threading.Lock()
_active_ledger: Optional[TransferLedger] = None
_armed_mode: int = 0  # the region's sync debug mode (0 when unarmed)
_open_scopes = 0

_LEVELS = {"allow": 0, "log": 1, "disallow": 2}


@contextmanager
def _sanctioned(tag: str, nbytes: int, direction: str):
    global _open_scopes
    with _state_lock:
        ledger = _active_ledger
        if ledger is not None:
            _open_scopes += 1
            if _open_scopes == 1 and _armed_mode:
                torch.cuda.set_sync_debug_mode(0)
    if ledger is None:
        # outside a strict region: a no-op — a mode the caller armed
        # directly (without the ledger) is respected, not downgraded
        yield
        return
    ledger.record(tag, nbytes, direction)
    try:
        yield
    finally:
        with _state_lock:
            _open_scopes -= 1
            if _open_scopes == 0 and _armed_mode and _active_ledger is ledger:
                torch.cuda.set_sync_debug_mode(_armed_mode)


def explicit_d2h(tag: str, nbytes: int = -1):
    """Declare the enclosed device->host copy sanctioned: inside
    :func:`transfer_guard_strict` record (tag, nbytes, "d2h") and drop
    the sync debug mode for the scope; outside a strict region a
    no-op."""
    return _sanctioned(tag, nbytes, "d2h")


def explicit_h2d(tag: str, nbytes: int = -1):
    """Host->device counterpart of :func:`explicit_d2h` (resume paths
    feeding checkpointed numpy back to the device)."""
    return _sanctioned(tag, nbytes, "h2d")


def explicit_wait(tag: str):
    """A sanctioned wait with no transfer (the twin's
    ``block_until_ready``: utils/tracing.device_sync), counted apart
    from the transfers (direction "wait")."""
    return _sanctioned(tag, -1, "wait")


def _mode_for(d2h: str, h2d: str) -> int:
    for name, v in (("d2h", d2h), ("h2d", h2d)):
        if v not in _LEVELS:
            raise ValueError(
                f"{name}={v!r}: expected one of {sorted(_LEVELS)}")
    # torch's sync debug mode does not tell the directions apart: the
    # stricter of the two is armed
    return max(_LEVELS[d2h], _LEVELS[h2d])


@contextmanager
def transfer_guard_strict(
    d2h: str = "disallow", h2d: str = "disallow"
):
    """Pin that the enclosed region performs only *explicit*
    synchronising device transfers.

    On the card, arms ``torch.cuda.set_sync_debug_mode``: "error" when
    either direction is ``"disallow"``, "warn" for ``"log"``, nothing
    when both are ``"allow"``; the previous mode is restored on exit,
    after an exception too. A failure to arm raises. Yields a
    :class:`TransferLedger` that every :func:`explicit_d2h` /
    :func:`explicit_h2d` / :func:`explicit_wait` site records into.
    Without a card only the ledger runs (nothing to arm): assert on its
    tags and bytes.

    Not reentrant across concurrent regions: one ledger is active at a
    time (process-global so the background checkpoint writer's
    sanctioned copies are ledgered too); a nested region restores the
    outer one on exit.
    """
    global _active_ledger, _armed_mode
    mode = _mode_for(d2h, h2d)
    arm = torch.cuda.is_available() and mode > 0
    ledger = TransferLedger()
    with _state_lock:
        prev = (_active_ledger, _armed_mode)
        prev_mode = torch.cuda.get_sync_debug_mode() if arm else 0
        if arm:
            torch.cuda.set_sync_debug_mode(mode)
            if torch.cuda.get_sync_debug_mode() != mode:
                raise RuntimeError(
                    f"could not arm torch's CUDA sync debug mode {mode}")
        _active_ledger = ledger
        _armed_mode = mode if arm else 0
    try:
        yield ledger
    finally:
        with _state_lock:
            _active_ledger, _armed_mode = prev
            if arm:
                torch.cuda.set_sync_debug_mode(prev_mode)
