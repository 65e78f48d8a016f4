"""Build and load the port's hand-written CUDA kernels.

Each library compiles one ``smk_torch/csrc/*.cu`` source with ``nvcc``
into a shared library with a plain C entry point, loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes); a source may
be built into several libraries under different macros (the float32 and
float64 correlation builds). Libraries are built at first use, from the
sources in the package, under a name that carries a digest of the source
and the flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. :func:`build` starts one ``nvcc`` per library, all at
once.

Where a library comes from is the program store's three levels
(compile/): with a ``store`` (``SMKConfig.compile_store_dir``,
compile/store.ProgramStore) a library is copied out of the store when it
holds it (L2), else found in the build directory (L3), else compiled
with ``nvcc`` and then saved to the store. The build directory is the
one compile/xla_cache arms (``SMKConfig.xla_cache_dir``), else
``SMK_TORCH_BUILD_DIR``, else ``build/smk_torch/`` beside the package (a
directory ``.gitignore`` lists). :data:`ORIGIN` records, per library,
where this process got it.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

from smk_torch.analysis.sanitizers import note_compile
from smk_torch.utils.tracing import monotonic

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
# library name -> where this process got it: "l2" (copied out of the
# store), "l3" (found in the build directory) or "fresh" (nvcc ran)
ORIGIN: Dict[str, str] = {}
# nvcc runs of this process, per library
NVCC_RUNS: Dict[str, int] = {}


def csrc_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "csrc"


def build_dir() -> Path:
    from smk_torch.compile import xla_cache

    armed = xla_cache.armed_dir()
    if armed:
        return Path(armed)
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


def library_digest(name: str) -> str:
    """16 hex digits of the sha256 of the library's source and flags."""
    source, flags = SOURCES[name]
    return hashlib.sha256(
        (csrc_dir() / source).read_bytes() + " ".join(NVCC_FLAGS + flags).encode()
    ).hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{library_digest(name)}.so"


def store_key(name: str) -> tuple:
    """The library's key in the program store: its name and digest."""
    return ("cuda_library", name, library_digest(name))


def _from_store(name: str, store) -> bool:
    """Copy ``name`` out of ``store`` into the build directory (atomic);
    False on a miss (the store warns when an artifact was unusable)."""
    payload = store.load(store_key(name))
    if payload is None:
        return False
    target = library_path(name)
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, target)
    return True


def _compile_cmd(name: str, out: Path) -> list:
    source, flags = SOURCES[name]
    return [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(out), str(csrc_dir() / source)]


def build(names: Optional[Iterable[str]] = None, store=None) -> Dict[str, dict]:
    """Make every named library available: from ``store`` when it holds
    it, else from the build directory, else compiled, one ``nvcc`` per
    library, all started together, and then saved to ``store``. Returns,
    per library, the wall seconds of its build (0.0 when none ran), the
    assembler's report (``-Xptxas -v``: registers, shared memory,
    spills) and its ``origin`` (:data:`ORIGIN`). Raises with the
    compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if store is not None and _from_store(name, store):
            ORIGIN.setdefault(name, "l2")
            report[name] = {"seconds": 0.0, "ptxas": "", "origin": "l2"}
            continue
        if target.exists():
            ORIGIN.setdefault(name, "l3")
            if store is not None and not store.has(store_key(name)):
                store.save(store_key(name), target.read_bytes())
            report[name] = {"seconds": 0.0, "ptxas": "", "origin": "l3"}
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _compile_cmd(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            ),
            tmp, target, monotonic(),
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
        secs = monotonic() - start
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, target)
        ORIGIN[name] = "fresh"
        NVCC_RUNS[name] = NVCC_RUNS.get(name, 0) + 1
        note_compile()
        if store is not None:
            store.save(store_key(name), target.read_bytes())
        report[name] = {"seconds": secs, "ptxas": stderr, "origin": "fresh"}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def ensure(names: Iterable[str], store=None) -> Dict[str, str]:
    """Where this process got each of ``names`` (:data:`ORIGIN`), making
    each available first (:func:`build`) if this process has not yet.
    A library already had is not looked up again, though a ``store``
    that lacks it is filled from the build directory."""
    todo = [n for n in names if n not in ORIGIN]
    if todo:
        build(todo, store=store)
    if store is not None:
        for n in names:
            path = library_path(n)
            if not store.has(store_key(n)) and path.exists():
                store.save(store_key(n), path.read_bytes())
    return {n: ORIGIN[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first when missing."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        ORIGIN.setdefault(name, "l3")
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
