"""Pairwise Euclidean distance matrices — twin of
``smk_tpu/ops/distance.py``: the norm-trick build the unfused
(``fused_build="off"``) path precomputes once per subset. The fused
path (ops/fused_build.py) never calls these."""

from __future__ import annotations

import torch


def cross_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense (..., ma, mb) distances between (..., ma, d) and (..., mb, d)
    by ||a||^2 + ||b||^2 - 2 a.b, clamped at 0 before the sqrt. The
    matmul runs in full fp32 (TF32 is off in the port, as
    ``precision="highest"`` is in the twin)."""
    a2 = torch.sum(a * a, dim=-1)[..., :, None]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    sq = a2 + b2 - 2.0 * torch.matmul(a, b.transpose(-1, -2))
    return torch.sqrt(torch.clamp(sq, min=0.0))


def pairwise_distance(coords: torch.Tensor) -> torch.Tensor:
    """Dense (..., m, m) distances from (..., m, d) coords, symmetrised,
    with an exact-zero diagonal."""
    d = cross_distance(coords, coords)
    d = 0.5 * (d + d.transpose(-1, -2))
    m = coords.shape[-2]
    eye = torch.eye(m, dtype=d.dtype, device=d.device)
    return d * (1.0 - eye)
