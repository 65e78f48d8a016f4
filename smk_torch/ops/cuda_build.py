"""Build and load the port's hand-written CUDA kernels.

Each library compiles one ``smk_torch/csrc/*.cu`` source with ``nvcc``
into a shared library with a plain C entry point, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes); a source may
be built into several libraries under different macros (the float32 and
float64 correlation builds). Libraries are built at first use, from the
sources in the package, into ``build/smk_torch/`` beside the package (a
directory ``.gitignore`` lists; override with ``SMK_TORCH_BUILD_DIR``),
under a name that carries a digest of the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
:func:`build` starts one ``nvcc`` per library, all at once.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

# library name -> (source file under smk_torch/csrc, its own nvcc flags):
# the correlation build's float32 and float64 entry points are one
# source built twice, so that the two builds run side by side
SOURCES = {
    "fused_corr": ("fused_corr.cu", ()),
    "fused_corr_f64": ("fused_corr.cu", ("-DSMK_FUSED_CORR_F64",)),
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# a plain-C source builds in seconds; anything near this is a hung nvcc
BUILD_TIMEOUT_S = 600

_LOADED: Dict[str, ctypes.CDLL] = {}


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    env = os.environ.get("SMK_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "smk_torch"


def nvcc_path() -> str:
    """The CUDA toolkit's nvcc: on PATH, else under the toolkit root
    PyTorch itself resolves (CUDA_HOME / CUDA_PATH / the default
    install location)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels of smk_torch cannot be built"
    )


def library_path(name: str) -> Path:
    source, flags = SOURCES[name]
    digest = hashlib.sha256(
        (csrc_dir() / source).read_bytes() + " ".join(NVCC_FLAGS + flags).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named library that is not built yet, one ``nvcc``
    per library, all started together. Returns, per library, the wall
    seconds of its build (0.0 when it was already built) and the
    assembler's report (``-Xptxas -v``: registers, shared memory,
    spills). Raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        source, flags = SOURCES[name]
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp),
               str(csrc_dir() / source)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ),
            tmp, target, time.perf_counter(),
        )
    failures = []
    for name, (proc, tmp, target, start) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            failures.append(f"{name}: nvcc ran over {BUILD_TIMEOUT_S} s\n{stdout}{stderr}")
            continue
        secs = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": secs, "ptxas": stderr}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first when missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
