"""Run telemetry — twin of ``smk_tpu/obs``:

- :func:`record_spans` — the program's spans inside a fit, held in
  memory (utils/tracing.SpanRecorder): the API phases, each sweep, its
  noise draw and stages (``smk.latent``, ``smk.beta``, ``smk.phi``,
  ``smk.u_draw``, ``smk.a``, ``smk.krige``), every correlation build
  (``smk.build``) and factorization (``smk.factor``), and the counters
  ``factor_mm`` and ``noise_rows_batched`` / ``noise_rows_rowwise``
  (the rows drawn by the sweep noise kernel or row by row). An operator arms it with ``with record_spans() as
  rec:`` around any calls (``rec.export()`` lays the spans on a
  torch.profiler trace's Unix clock, ``rec.totals()`` sums them by
  name), or per fit with ``SMKConfig.run_log_dir``, whose log then ends
  with one ``span_total`` record a span name;
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
from smk_torch.utils.tracing import record_spans

__all__ = [
    "RunLog",
    "open_run_log",
    "device_memory_stats",
    "hbm_watermark",
    "JsonlWriter",
    "read_jsonl",
    "write_records",
    "record_spans",
]
