"""Device-memory watermarks — twin of ``smk_tpu/obs/memory.py``,
through ``torch.cuda.memory_stats``.

The chunked executor samples these at every chunk boundary (a host read
of the caching allocator's counters: no device work, no transfer). On
the CPU, or where the probe fails, they are None and the telemetry
leaves the fields out.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """``{"bytes_in_use", "peak_bytes_in_use"}`` of the CUDA ``device``
    (default: the current card) from the caching allocator, or None on
    the CPU, with no card, or when the probe fails."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
    except Exception:
        return None
    if not stats:
        return None
    out: Dict[str, int] = {}
    for key, src in (("bytes_in_use", "allocated_bytes.all.current"),
                     ("peak_bytes_in_use", "allocated_bytes.all.peak")):
        v = stats.get(src)
        if v is not None:
            out[key] = int(v)
    return out or None


def hbm_watermark(device=None) -> Dict[str, Any]:
    """Always a dict: ``{"available": False}`` where no stats exist,
    else the stats and ``available=True``."""
    stats = device_memory_stats(device)
    if stats is None:
        return {"available": False}
    return {"available": True, **stats}
