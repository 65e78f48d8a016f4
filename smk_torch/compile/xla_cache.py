"""L3 of the program store: the persistent build directory of the
port's kernel libraries (twin of ``smk_tpu/compile/xla_cache.py``).

The twin arms jax's persistent XLA compilation cache. The port's
counterpart is the directory ``ops/cuda_build.py`` builds its
``libfused_corr*.so`` libraries into and loads them from: source to
machine code, each library under a digest of its source and flags, so a
warm directory turns an ``nvcc`` run into a ``dlopen``. This module is
the one owner that arms it for the process (jax's config is
process-wide, and so is this setting).

Unarmed, ``cuda_build.build_dir`` resolves as it always has:
``SMK_TORCH_BUILD_DIR``, else ``build/smk_torch/`` beside the package.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

_ARMED: Optional[str] = None


def default_cache_dir() -> str:
    """Per-user path under the system tempdir (a world-shared name could
    be squatted, or pre-filled with libraries by another user)."""
    return os.path.join(tempfile.gettempdir(), f"smk_torch_build_{os.getuid()}")


def enable_persistent_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Arm the persistent build directory for this process.

    Resolution: an explicit ``cache_dir``, else ``SMK_TORCH_BUILD_DIR``,
    else :func:`default_cache_dir`. A directory that cannot be created
    leaves the process unarmed (returns None): the cache is an
    accelerator, never a dependency. Returns the armed directory."""
    global _ARMED
    resolved = cache_dir or os.environ.get("SMK_TORCH_BUILD_DIR") or default_cache_dir()
    try:
        os.makedirs(resolved, exist_ok=True)
    except OSError:
        return None
    _ARMED = str(resolved)
    return _ARMED


def armed_dir() -> Optional[str]:
    """The armed directory, or None."""
    return _ARMED


def persistent_cache_enabled() -> bool:
    """Whether the build directory was armed in this process: the bit
    that tells ``program_source="l3"`` from ``"fresh"`` for a program
    that launches no kernel library."""
    return _ARMED is not None


def maybe_enable_from_config(cfg) -> Optional[str]:
    """Arm L3 when ``SMKConfig.xla_cache_dir`` is set (called once per
    fit; re-arming with the same directory is idempotent)."""
    d = getattr(cfg, "xla_cache_dir", None)
    if not d:
        return None
    return enable_persistent_cache(d)
