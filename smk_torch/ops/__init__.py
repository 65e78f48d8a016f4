"""Core numerics of the port — twin of ``smk_tpu/ops``: distances,
correlations, the fused correlation builds (the hand-written CUDA
kernel of ``csrc/fused_corr.cu``, bound in ``fused_build.py``, in
place of the twin's Pallas kernel), Cholesky solves, the truncated
normal, the GLM warm start and the quantile grids."""

from smk_torch.ops.chol import chol_logdet, chol_solve, jittered_cholesky, tri_solve
from smk_torch.ops.distance import cross_distance, pairwise_distance
from smk_torch.ops.fused_build import (
    fused_correlation,
    fused_correlation_stack,
    fused_cross_correlation,
    fused_masked_correlation_stack,
    fused_masked_shifted_build,
)
from smk_torch.ops.glm import glm_warm_start, irls_glm
from smk_torch.ops.kernels import CORRELATION_FNS, correlation
from smk_torch.ops.quantiles import (
    credible_summary,
    interp_quantile_grid,
    inverse_cdf_resample,
    quantile_grid,
)
from smk_torch.ops.truncnorm import sample_albert_chib_latent, truncated_normal

__all__ = [
    "pairwise_distance",
    "cross_distance",
    "correlation",
    "CORRELATION_FNS",
    "fused_correlation",
    "fused_correlation_stack",
    "fused_cross_correlation",
    "fused_masked_correlation_stack",
    "fused_masked_shifted_build",
    "jittered_cholesky",
    "chol_solve",
    "chol_logdet",
    "tri_solve",
    "truncated_normal",
    "sample_albert_chib_latent",
    "irls_glm",
    "glm_warm_start",
    "quantile_grid",
    "interp_quantile_grid",
    "inverse_cdf_resample",
    "credible_summary",
]

# The twin's names with no counterpart here, each with its reason.
NOT_PORTED = {
    "pallas_available": "the route is the tensor's device, not a probe: a CUDA tensor "
    "launches the hand-written kernel (built by ops/cuda_build), a CPU tensor takes "
    "the plain PyTorch version; there is no Pallas backend to ask about",
}
