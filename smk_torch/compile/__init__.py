"""smk_torch.compile: the shape-bucket ladder and the three-level
program store (twin of ``smk_tpu/compile/``).

- **L1, always on** (``programs.get_program``): the owner's (a
  sampler's, an engine's) FIFO table of programs, keyed by the twin's
  bucket keys, ``L1_CACHE_MAX = 32`` entries. On the card a chunk or
  serving program is a captured ``torch.cuda.CUDAGraph`` with its static
  input and output buffers, replayed per call; on the CPU, which the
  caller must ask for, it is the same static-buffer program run
  directly, with no capture. A CUDA graph cannot be serialized, so every
  process captures its own.
- **L2, ``SMKConfig.compile_store_dir``** (``store.ProgramStore``): the
  port's built kernel libraries (``libfused_corr*.so``), which are what
  can outlive a process, under the twin's integrity contract (key inside
  the artifact, environment fingerprint, warned misses, atomic writes).
  With a warm store a fresh process runs no nvcc and only captures.
- **L3, ``SMKConfig.xla_cache_dir``** (``xla_cache``): the directory
  ``ops/cuda_build.py`` builds into and loads from, the port's
  persistent compile cache (source to machine code, keyed by digest),
  armed per process by ``xla_cache.enable_persistent_cache``. Unarmed,
  it is ``SMK_TORCH_BUILD_DIR`` or ``build/smk_torch/``.

``warmup.precompile`` acquires and captures every program of a chunked
fit ahead of time, on a device mesh too (``mesh=``, or ``mesh_spec=``
through ``warmup.mesh_from_spec``); a mesh's programs are keyed under
its ``topology_fingerprint``. ``buckets.plan_ragged_mesh`` lays a ragged
fit's bucket groups over a mesh.
"""

from smk_torch.compile.buckets import (
    MIN_BUCKET,
    RaggedMeshEntry,
    RaggedMeshPlan,
    bucket_for,
    bucket_ladder,
    pad_accounting,
    plan_ragged_mesh,
    select_bucket,
    slice_plan,
    validate_ladder,
)
from smk_torch.compile.programs import (
    L1_CACHE_MAX,
    GraphProgram,
    aux_bucket_key,
    chunk_bucket_key,
    config_digest,
    get_program,
    store_from_config,
    topology_fingerprint,
)
from smk_torch.compile.store import STORE_FORMAT, ProgramStore, env_fingerprint
from smk_torch.compile.warmup import MeshSpecError, chunk_plan_lengths, mesh_from_spec, precompile
from smk_torch.compile.xla_cache import (
    default_cache_dir,
    enable_persistent_cache,
    maybe_enable_from_config,
    persistent_cache_enabled,
)

__all__ = [
    "MIN_BUCKET",
    "RaggedMeshEntry",
    "RaggedMeshPlan",
    "plan_ragged_mesh",
    "bucket_for",
    "bucket_ladder",
    "pad_accounting",
    "select_bucket",
    "slice_plan",
    "validate_ladder",
    "L1_CACHE_MAX",
    "GraphProgram",
    "aux_bucket_key",
    "chunk_bucket_key",
    "config_digest",
    "get_program",
    "store_from_config",
    "topology_fingerprint",
    "STORE_FORMAT",
    "ProgramStore",
    "env_fingerprint",
    "MeshSpecError",
    "chunk_plan_lengths",
    "mesh_from_spec",
    "precompile",
    "default_cache_dir",
    "enable_persistent_cache",
    "maybe_enable_from_config",
    "persistent_cache_enabled",
]
