"""Auxiliary subsystems of the port — twin of ``smk_tpu/utils``:
diagnostics, checkpointing, tracing."""

from smk_torch.utils.checkpoint import load_pytree, save_pytree
from smk_torch.utils.diagnostics import effective_sample_size, rhat, split_rhat
from smk_torch.utils.tracing import PhaseTimes, device_sync, phase_timer

__all__ = [
    "effective_sample_size",
    "rhat",
    "split_rhat",
    "save_pytree",
    "load_pytree",
    "phase_timer",
    "PhaseTimes",
    "device_sync",
]

# The twin's names with no counterpart here, each with its reason.
_SCOPES = ("jax.named_scope labels for XLA profiles; the port's profiler window labels "
           "its chunks with torch.profiler.record_function (obs/profiling.chunk_scope), "
           "and each CUDA kernel appears under its own name in a trace")
NOT_PORTED = {
    "fused_build_scope": _SCOPES,
    "FUSED_BUILD_SCOPE": _SCOPES,
    "mtm_chol_scope": _SCOPES,
    "MTM_CHOL_SCOPE": _SCOPES,
}
