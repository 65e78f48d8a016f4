"""Phase timing — twin of ``PhaseTimes`` and ``phase_timer`` in
``smk_tpu/utils/tracing.py``. A phase ends with a sync of the device's
stream (as the twin's ``device_sync``), so its wall time covers the
work and not only its enqueueing."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch

from smk_torch.device import sync


@dataclass
class PhaseTimes:
    seconds: Dict[str, float] = field(default_factory=dict)

    def record(self, name: str, secs: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + secs

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)


@contextlib.contextmanager
def phase_timer(
    times: PhaseTimes, name: str, device: Optional[torch.device] = None
) -> Iterator[None]:
    """Time a phase; on a CUDA ``device`` the phase ends with a stream
    sync."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if device is not None:
            sync(device)
        times.record(name, time.perf_counter() - start)
