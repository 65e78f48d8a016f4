"""The config digest of the program store — the one piece of the twin's
``smk_tpu/compile/programs.py`` the port has so far (the bucket keys and
the store are ROADMAP A10).

:func:`config_digest` hashes the ``repr`` of the port's own
:class:`~smk_torch.config.SMKConfig` with the fields that change no
computation normalized out, as the twin hashes its config. It is the
port's digest: it names a port fit (a serving artifact's provenance,
serve/artifact.py). It equals the twin's digest of the same settings
only while the two configs' reprs agree, and nothing relies on that.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

# Config fields that change no computation (scheduling, fault handling,
# checkpointing, observability, caches), normalized out of the digest:
# the twin's set.
_DIGEST_NEUTRAL = dict(
    chunk_pipeline="sync",
    fault_policy="abort",
    fault_max_retries=2,
    min_surviving_frac=0.5,
    compile_store_dir=None,
    xla_cache_dir=None,
    run_log_dir=None,
    live_diagnostics=False,
    profile_dir=None,
    profile_chunks=None,
    watchdog=False,
    watchdog_min_deadline_s=60.0,
    watchdog_margin=10.0,
    dist_init_timeout_s=120.0,
    dist_init_retries=3,
    ckpt_commit_timeout_s=120.0,
    partition_method="random",
    bucket_ladder=None,
    coalesce_window_ms=0.0,
    adaptive_schedule="off",
    target_rhat=1.05,
    target_ess=100.0,
    adapt_patience=2,
    min_samples_before_stop=0,
    adapt_max_extra_frac=0.5,
)


@functools.lru_cache(maxsize=256)
def config_digest(cfg) -> str:
    """12 hex digits of the sha256 of the config's ``repr`` with the
    neutral fields at their defaults: two configs with the same digest
    compute the same thing at equal shapes. Memoized (the config is a
    frozen dataclass)."""
    neutral = dataclasses.replace(cfg, **_DIGEST_NEUTRAL)
    return hashlib.sha256(repr(neutral).encode()).hexdigest()[:12]
