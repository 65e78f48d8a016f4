"""Fused correlation build — the port of ``smk_tpu/ops/pallas_build.py``.

Three hand-written CUDA kernels (``smk_torch/csrc/fused_corr.cu``)
compute what the TPU kernel ``_corr_kernel`` computes: per pair, the
direct squared coordinate differences summed over d, the sqrt, an
optional exact-zero diagonal, ``CORRELATION_FNS[model]``, the optional
pad-row identity R~ = M R M + (I - M) and an optional + diag(shift) —
emitted straight into a contiguous fp32 (K, s, ma, mb) tensor, with no
(m, m) distance matrix in device memory. The cross build can also take
a row mask, multiplied into its rows as they are stored. Every cross
build and every unmasked square build of at most ``NARROW_MAX_M`` rows
(the kriging cross build and test stack) runs the narrow kernel
(layout 2: whole rows, no shared memory); masked builds and wider
square ones run the symmetric kernel (layout 1: one half of the tile
pairs computed, the mirror stored from it). :func:`kernel_layout`
makes that choice, for float32 and float64 builds alike
(``SMKConfig.dtype="float64"``; the TPU kernel takes its dtype from the
coordinates): each kernel is built for both types, the float64 ones
into a library of their own (C entry point ``smk_fused_corr_f64``).
The tile kernel (layout 0), the port's first, is launched by no entry
point at either type: the other two are held against it bit for bit.
Any other dtype raises.

Five entry points wrap it, as in the twin: :func:`fused_correlation`,
:func:`fused_correlation_stack`, :func:`fused_masked_correlation_stack`,
:func:`fused_cross_correlation` and :func:`fused_masked_shifted_build`.
Each accepts the JAX shapes ((m, d) coords, (s,) phis -> (s, m, m)) and
an optional leading K axis on coords, phis, mask and shift (coords
without it are shared across K).

Dispatch is by the device of the tensors: on a CUDA tensor the wrapper
launches the kernel or raises (there is no fall-back); on a CPU tensor
it runs the plain PyTorch version, :func:`plain_build`, which is also
what ``chip_smoke.py`` holds the kernel against on the card.
``LAUNCHES`` counts kernel launches per entry point, ``LAYOUT_LAUNCHES``
the same launches per kernel and type (:func:`launch_key`), and
``PLAIN_CALLS`` the plain version's calls, so a run can show which path
it took.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from smk_torch.ops import cuda_build
from smk_torch.ops.kernels import CORRELATION_FNS

ENTRY_POINTS = (
    "fused_correlation",
    "fused_correlation_stack",
    "fused_masked_correlation_stack",
    "fused_cross_correlation",
    "fused_masked_shifted_build",
)
LAUNCHES: Dict[str, int] = dict.fromkeys(ENTRY_POINTS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(ENTRY_POINTS, 0)

# output tile edge of the float32 symmetric kernel (csrc/fused_corr.cu
# SymTiles<float>); the double one uses 32, as the tile kernel does
TILE = 64
# the kernel a build launches (the C entry points' `layout` argument)
TILED, SYMMETRIC, NARROW = 0, 1, 2
# the same kernels built for double: keys of LAYOUT_LAUNCHES, never a
# `layout` argument (launch_key)
TILED_F64, SYMMETRIC_F64, NARROW_F64 = 3, 4, 5
LAYOUT_LAUNCHES: Dict[int, int] = dict.fromkeys(
    (TILED, SYMMETRIC, NARROW, TILED_F64, SYMMETRIC_F64, NARROW_F64), 0)
# the widest square build the narrow kernel takes: it computes every
# element, where the symmetric kernel computes one half
NARROW_MAX_M = 256
_MAX_D = 8
_MODEL_IDS = {"exponential": 0, "matern32": 1, "matern52": 2}


def reset_counts() -> None:
    """Set every launch and plain-call count to 0."""
    for name in ENTRY_POINTS:
        LAUNCHES[name] = 0
        PLAIN_CALLS[name] = 0
    for layout in LAYOUT_LAUNCHES:
        LAYOUT_LAUNCHES[layout] = 0


def bind_kernel(lib):
    """The C entry point ``smk_fused_corr`` of a built ``fused_corr``
    library, with its ctypes signature: seven pointers (ca, cb, phis,
    mask, shift, row_mask, out), K, S, MA, MB, D, the two K strides,
    model, masked, shifted, row_masked, zero_diag, layout and the
    stream."""
    fn = lib.smk_fused_corr
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 5 + [ll, ll] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def bind_kernel_f64(lib):
    """The float64 C entry point ``smk_fused_corr_f64`` of a built
    ``fused_corr_f64`` library: the arguments of :func:`bind_kernel`."""
    fn = lib.smk_fused_corr_f64
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 7 + [i] * 5 + [ll, ll] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _kernel(dtype=torch.float32):
    if dtype == torch.float64:
        return bind_kernel_f64(cuda_build.load("fused_corr_f64"))
    return bind_kernel(cuda_build.load("fused_corr"))


def launch_key(layout: int, dtype) -> int:
    """The LAYOUT_LAUNCHES key of a launch of kernel ``layout`` on
    ``dtype`` coordinates: the layout at float32, its *_F64 key at
    float64."""
    return layout + TILED_F64 if dtype == torch.float64 else layout


def plain_build(
    coords_a: torch.Tensor,
    coords_b: torch.Tensor,
    phis: torch.Tensor,
    model: str,
    *,
    mask: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    zero_diag: bool = False,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in PyTorch ops, on batched operands:
    coords_a (K, ma, d); coords_b (K or 1, mb, d); phis (K, s);
    mask/shift/row_mask (K, ma). Returns (K, s, ma, mb). Same per-pair
    arithmetic as the kernel and as the TPU kernel (differences summed
    in d order, no norm trick); the row mask multiplies the finished
    rows, as the sampler did after the build."""
    ma, d = coords_a.shape[-2:]
    mb = coords_b.shape[-2]
    sq = torch.zeros(
        (coords_a.shape[0], ma, mb), dtype=coords_a.dtype,
        device=coords_a.device,
    )
    for c in range(d):
        diff = coords_a[..., :, None, c] - coords_b[..., None, :, c]
        sq = sq + diff * diff
    dist = torch.sqrt(torch.clamp(sq, min=0.0))
    need_eye = mask is not None or shift is not None or zero_diag
    if need_eye:
        eye = torch.eye(ma, mb, dtype=torch.bool, device=dist.device)
    if zero_diag:
        dist = torch.where(eye, torch.zeros_like(dist), dist)
    rho = CORRELATION_FNS[model](dist[:, None], phis[:, :, None, None])
    if mask is not None:
        mm = mask[:, None, :, None] * mask[:, None, None, :]
        rho = mm * rho + (1.0 - mm) * eye.to(rho.dtype)
    if shift is not None:
        rho = rho + torch.where(
            eye, shift[:, None, :, None], torch.zeros_like(rho)
        )
    if row_mask is not None:
        rho = row_mask[:, None, :, None] * rho
    return rho


def kernel_layout(coords_a, coords_b, zero_diag: bool, masked: bool,
                  shifted: bool) -> int:
    """SYMMETRIC for a masked or shifted build (always square and on
    one coordinate set) and for a square same-coordinates zero-diagonal
    build of more than NARROW_MAX_M rows (its output is symmetric, so
    the kernel computes one half and mirrors it); NARROW for the rest:
    every cross build, at any width, and the small square ones. The
    same at float32 and float64."""
    square = coords_a is coords_b and zero_diag
    if masked or shifted or (square and coords_b.shape[-2] > NARROW_MAX_M):
        return SYMMETRIC
    return NARROW


def _launch(ca, cb, phis, mask, shift, model, zero_diag, out, layout, row_mask=None):
    """One kernel launch on the current stream, of the kernel built for
    ``out``'s dtype; raises on a launch error (the C function returns
    cudaGetLastError()). ``layout`` SYMMETRIC needs ``cb`` to be ``ca``;
    ``row_mask`` needs NARROW (or TILED, the reference)."""
    k, s, ma, mb = out.shape
    d = ca.shape[-1]
    args = [
        ca.data_ptr(), cb.data_ptr(), phis.data_ptr(),
        0 if mask is None else mask.data_ptr(),
        0 if shift is None else shift.data_ptr(),
        0 if row_mask is None else row_mask.data_ptr(),
        out.data_ptr(), k, s, ma, mb, d,
        ca.stride(0), cb.stride(0),
        _MODEL_IDS[model], int(mask is not None), int(shift is not None),
        int(row_mask is not None), int(zero_diag), layout,
    ]
    err = _kernel(out.dtype)(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_corr kernel launch failed: CUDA error {err} "
            f"(K={k}, s={s}, ma={ma}, mb={mb}, d={d}, layout={layout})"
        )


def _fused_build(
    entry: str,
    coords_a: torch.Tensor,
    coords_b: torch.Tensor,
    phis: torch.Tensor,
    model: str,
    *,
    mask: Optional[torch.Tensor] = None,
    shift=None,
    zero_diag: bool = False,
    row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Shared body of the five entry points (twin of
    ``pallas_build._fused_build``)."""
    if model not in CORRELATION_FNS:
        raise ValueError(
            f"unknown cov model {model!r}; expected one of "
            f"{sorted(CORRELATION_FNS)}"
        )
    masked = mask is not None
    shifted = shift is not None
    layout = kernel_layout(coords_a, coords_b, zero_diag, masked, shifted)
    if (masked or shifted) and coords_a is not coords_b:
        # the in-tile row == col test is the "same point" diagonal only
        # when both operands are the same coordinate set
        raise ValueError(
            "mask/shift require a square same-coordinates build "
            "(pass the identical coords tensor for both operands)"
        )
    batched = coords_a.dim() == 3 or coords_b.dim() == 3 or phis.dim() == 2
    ca = coords_a if coords_a.dim() == 3 else coords_a[None]
    cb = coords_b if coords_b.dim() == 3 else coords_b[None]
    ph = phis if phis.dim() == 2 else phis[None]
    k = max(ca.shape[0], cb.shape[0], ph.shape[0])
    ma, d = ca.shape[-2:]
    mb = cb.shape[-2]
    dev = ca.device
    dtype = ca.dtype
    ph = ph.to(dtype).expand(k, ph.shape[-1])
    mk = sh = rm = None
    if masked:
        mk = mask.to(dtype)
        mk = (mk if mk.dim() == 2 else mk[None]).expand(k, ma)
    if row_mask is not None:
        rm = row_mask.to(dtype)
        rm = (rm if rm.dim() == 2 else rm[None]).expand(k, ma)
    if shifted:
        sh = torch.as_tensor(shift, dtype=dtype, device=dev)
        sh = torch.zeros((k, ma), dtype=dtype, device=dev) + sh
    if dev.type == "cpu":
        PLAIN_CALLS[entry] += 1
        out = plain_build(
            ca.expand(k, ma, d), cb, ph, model, mask=mk, shift=sh,
            zero_diag=zero_diag, row_mask=rm,
        )
    else:
        if dev.type != "cuda":
            raise ValueError(f"fused build: unsupported device {dev}")
        tensors = [("coords_a", ca), ("coords_b", cb), ("phis", ph)]
        if masked:
            tensors.append(("mask", mk))
        if shifted:
            tensors.append(("shift", sh))
        if rm is not None:
            tensors.append(("row_mask", rm))
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"fused build: coordinates must be float32 or float64, got {dtype}")
        for name, t in tensors:
            if t.device != dev:
                raise ValueError(f"fused build: {name} is on {t.device}, not {dev}")
            if t.dtype != dtype:
                raise TypeError(f"fused build: {name} must be {dtype}, got {t.dtype}")
        if not 1 <= d <= _MAX_D or cb.shape[-1] != d:
            raise ValueError(
                f"fused build: coordinate dimension must be 1..{_MAX_D} "
                f"and equal on both operands, got {d} and {cb.shape[-1]}"
            )
        # a K-shared operand keeps stride 0 on K (no copy); the (m, d)
        # block of each k must be contiguous
        ca = ca.contiguous() if ca.shape[0] == k else ca[:1].contiguous().expand(k, ma, d)
        if layout == SYMMETRIC:
            cb = ca
        else:
            cb = cb.contiguous() if cb.shape[0] == k else cb[:1].contiguous().expand(k, mb, d)
        ph = ph.contiguous()
        mk = None if mk is None else mk.contiguous()
        sh = None if sh is None else sh.contiguous()
        rm = None if rm is None else rm.contiguous()
        out = torch.empty((k, ph.shape[-1], ma, mb), dtype=dtype, device=dev)
        if out.numel():
            _launch(ca, cb, ph, mk, sh, model, zero_diag, out, layout, rm)
            LAUNCHES[entry] += 1
            LAYOUT_LAUNCHES[launch_key(layout, dtype)] += 1
    return out if batched else out[0]


def fused_correlation(coords, phi, model: str) -> torch.Tensor:
    """(m, m) correlation from (m, d) coords and a scalar phi, with an
    exact-unit diagonal (or (K, m, m) from (K, m, d) coords and (K,)
    phis)."""
    phi = torch.as_tensor(phi, dtype=coords.dtype, device=coords.device)
    phis = phi.reshape(-1, 1) if coords.dim() == 3 else phi.reshape(1)
    out = _fused_build(
        "fused_correlation", coords, coords, phis, model, zero_diag=True
    )
    return out[:, 0] if coords.dim() == 3 else out[0]


def fused_correlation_stack(coords, phis, model: str) -> torch.Tensor:
    """(s, m, m) correlation stack for an (s,) phi vector (the kriging
    test build)."""
    return _fused_build(
        "fused_correlation_stack", coords, coords, phis, model,
        zero_diag=True,
    )


def fused_masked_correlation_stack(coords, phis, mask, model: str) -> torch.Tensor:
    """(s, m, m) stack of R~ = M R(phi_k) M + (I - M) — the masked
    build of the phi proposal and the initial factor."""
    return _fused_build(
        "fused_masked_correlation_stack", coords, coords, phis, model,
        mask=mask, zero_diag=True,
    )


def fused_cross_correlation(
    coords_a, coords_b, phis, model: str, *, row_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(s, ma, mb) cross-correlation stack between two coordinate sets
    (the kriging cross build; no diagonal treatment). ``row_mask``
    ((ma,) or (K, ma)) multiplies row i by row_mask[..., i] as it is
    stored: the sampler's zeroing of pad rows, with no second pass."""
    return _fused_build(
        "fused_cross_correlation", coords_a, coords_b, phis, model,
        row_mask=row_mask,
    )


def fused_masked_shifted_build(coords, phis, mask, shift, model: str) -> torch.Tensor:
    """(s, m, m) stack of S = M R(phi_k) M + (I - M) + diag(shift), ready
    for a plain Cholesky — the u-draw's S build. shift: scalar, (m,) or
    (K, m), shared across the stack."""
    return _fused_build(
        "fused_masked_shifted_build", coords, coords, phis, model,
        mask=mask, shift=shift, zero_diag=True,
    )


def build_bytes_model(
    m: int,
    s: int = 1,
    *,
    d: int = 2,
    tile: int = TILE,
    fused: bool,
    dtype_bytes: int = 4,
) -> dict:
    """Device-memory traffic of one (s, m, m) correlation-stack build
    (twin of ``pallas_build.build_bytes_model``, at this kernel's tile).

    Unfused (distance matrix + elementwise correlation): s*m^2 reads of
    the distance matrix and s*m^2 writes. Fused: each (tile, tile)
    output tile reads two (tile, d) coordinate blocks plus up to three
    (tile,) mask/shift rows; writes are s*m^2 either way — the floor
    both paths share, which bounds the kernel."""
    nt = -(-m // tile)
    write = s * m * m * dtype_bytes
    if not fused:
        read = s * m * m * dtype_bytes
    else:
        read = s * nt * nt * (2 * tile * d + 3 * tile) * dtype_bytes
    return {"read_bytes": read, "write_bytes": write, "total_bytes": read + write}
