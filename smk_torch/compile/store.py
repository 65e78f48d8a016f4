"""L2 of the program store: the port's built kernel libraries on disk
(twin of ``smk_tpu/compile/store.py``).

The twin persists serialized XLA executables. A CUDA graph cannot be
serialized, so what outlives a process here is the machine code the
graphs launch: the ``libfused_corr*.so`` libraries that
``ops/cuda_build.py`` compiles with ``nvcc``. A warm store lets a fresh
process skip every ``nvcc`` run and only capture its graphs.

Integrity contract (the twin's):

- each artifact is stored under its key, the library name and the
  digest of its source and flags (``cuda_build.library_path``), and
  holds the key inside, so a filename hash collision can never hand
  back the wrong library;
- an environment fingerprint (torch version, ``torch.version.cuda``,
  the nvcc version, the device name and capability, the store format)
  is compared on every load: a mismatch is a warned miss, and the
  library is rebuilt and overwritten, never loaded;
- a corrupt, truncated or unreadable artifact is a warned miss;
- writes go to a temporary file and then ``os.replace``, so a killed
  process strands at worst a ``.tmp`` orphan;
- a directory that cannot be created warns and acts as all-miss.

Artifacts are pickle files, read only from the directory the caller's
own config names (``SMKConfig.compile_store_dir``): treat it with the
trust of the checkpoints beside it.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
import subprocess
import warnings
from typing import Any, Optional

STORE_FORMAT = 1
_SUFFIX = ".smklib"


@functools.lru_cache(maxsize=1)
def _nvcc_version() -> Optional[str]:
    """The last line of ``nvcc --version`` (its release), or None when
    there is no nvcc."""
    from smk_torch.ops import cuda_build

    try:
        out = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except Exception:
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else None


def env_fingerprint() -> dict:
    """Everything a built library is only valid under. Any drift makes
    an artifact stale: rebuilt, never loaded."""
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        cap = ".".join(str(v) for v in torch.cuda.get_device_capability(0))
    else:
        name, cap = "none", "none"
    return {
        "format": STORE_FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": _nvcc_version(),
        "device_name": name,
        "capability": cap,
    }


class ProgramStore:
    """On-disk library store rooted at one directory. ``load`` returns
    an artifact's bytes, ``save`` persists them (see the module
    docstring)."""

    def __init__(self, root: str):
        self.root = str(root)
        try:
            os.makedirs(self.root, exist_ok=True)
        except OSError as e:
            warnings.warn(
                f"compile store: could not create store directory {self.root} ({e!r}); "
                "the store will not serve or persist libraries this run",
                RuntimeWarning, stacklevel=2,
            )

    def path_for(self, key: Any) -> str:
        h = hashlib.sha256(repr(key).encode()).hexdigest()[:32]
        return os.path.join(self.root, h + _SUFFIX)

    def has(self, key: Any) -> bool:
        return os.path.exists(self.path_for(key))

    def load(self, key: Any) -> Optional[bytes]:
        """The stored bytes of ``key``, or None on any miss (absent,
        stale fingerprint, corrupt); a miss warns when there was an
        artifact, so an operator sees why a warm deployment builds."""
        path = self.path_for(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            if (not isinstance(blob, dict) or blob.get("format") != STORE_FORMAT
                    or blob.get("key") != repr(key)
                    or not isinstance(blob.get("payload"), bytes)):
                raise ValueError("artifact format/key mismatch")
            if hashlib.sha256(blob["payload"]).hexdigest() != blob.get("sha256"):
                raise ValueError("payload checksum mismatch")
        except Exception as e:
            warnings.warn(
                f"compile store: artifact {path} is corrupt or unreadable ({e!r}); "
                "rebuilding the library (the stale file will be overwritten)",
                RuntimeWarning, stacklevel=2,
            )
            return None
        fp = env_fingerprint()
        if blob.get("fingerprint") != fp:
            warnings.warn(
                f"compile store: artifact {path} was built under a different environment "
                f"({blob.get('fingerprint')!r} vs {fp!r}); rebuilding instead of loading "
                "a possibly incompatible library",
                RuntimeWarning, stacklevel=2,
            )
            return None
        return blob["payload"]

    def save(self, key: Any, payload: bytes) -> Optional[str]:
        """Persist ``payload`` under ``key`` (atomic rename). Failures warn
        and return None: a read-only store must not kill the run that
        tried to warm it."""
        path = self.path_for(key)
        tmp = path + f".tmp.{os.getpid()}"
        try:
            blob = {
                "format": STORE_FORMAT,
                "fingerprint": env_fingerprint(),
                "key": repr(key),
                "sha256": hashlib.sha256(payload).hexdigest(),
                "payload": bytes(payload),
            }
            with open(tmp, "wb") as f:
                pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
            return path
        except Exception as e:
            warnings.warn(
                f"compile store: could not persist library to {path} ({e!r}); the "
                "library in the build directory is unaffected",
                RuntimeWarning, stacklevel=2,
            )
            return None
