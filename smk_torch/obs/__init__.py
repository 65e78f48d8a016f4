"""Run telemetry — twin of ``smk_tpu/obs``:

- :mod:`smk_torch.obs.events` — nested spans, events and counters in a
  per-fit append-only JSONL run log (``SMKConfig.run_log_dir``);
- :mod:`smk_torch.obs.streaming` — streaming split-R-hat and
  batch-means ESS on the device, read at chunk boundaries
  (``SMKConfig.live_diagnostics``);
- :mod:`smk_torch.obs.memory` — device-memory watermarks per boundary;
- :mod:`smk_torch.obs.profiling` — a ``torch.profiler`` window over a
  chunk range (``SMKConfig.profile_dir`` / ``profile_chunks``) and
  Chrome-trace summaries.

CLI: ``python -m smk_torch.obs summarize <run.jsonl> [--json]``
(:mod:`smk_torch.obs.summarize`). Arming any of it leaves the draws
bitwise unchanged.
"""

from smk_torch.obs.events import RunLog, open_run_log
from smk_torch.obs.memory import device_memory_stats, hbm_watermark
from smk_torch.obs.reporter import JsonlWriter, read_jsonl, write_records

__all__ = [
    "RunLog",
    "open_run_log",
    "device_memory_stats",
    "hbm_watermark",
    "JsonlWriter",
    "read_jsonl",
    "write_records",
]
