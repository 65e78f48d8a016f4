"""Every batch row's sweep noise in one launch.

The port's default noise source (models/probit_gp.GeneratorNoise) gives
each batch row its own torch CUDA generator, and each sweep draws per
row one ``torch.rand``, one ``torch.randn`` and, under logit, one
``exponential_`` call, maps uniforms with ``_uniform`` and stacks the
fields (models/probit_gp.draw_sweep_noise, the per-row layout). The
kernel here (``smk_torch/csrc/sweep_noise.cu``) draws the same numbers,
bit for bit, for every row and call in one launch and writes them into
the stacked fields. A CUDA generator's numbers depend only on its seed,
its Philox offset and the call's element count, through torch's launch
policy (ATen's ``calc_execution_policy``): :func:`call_plan` transcribes
that policy, :func:`sweep_plan` applies it to a sweep's three calls, and
:func:`draw` reads each row's seed and offset from its generator,
launches once on the current stream and then advances each generator's
offset exactly as the three calls would have. So every generator's
state after a sweep is the per-row path's, and snapshots, restores,
forks and checkpoints see no difference.

:func:`covers` says which sweeps the kernel draws: on a CUDA device, at
float32 or float64, one gaussian proposal (the multiple-try and
non-gaussian families draw more calls a row), and under logit one trial
a site (``weight > 1`` sums exponentials with a torch reduction). The
rest, and every CPU draw, stays on the per-row path. The per-row path
is the plain version the card tests hold the kernel against.
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from smk_torch.ops import cuda_build

LIBRARY = "sweep_noise"
# torch's distribution kernels: 256 threads a block, and a Philox offset
# step of 4 counter words per curand call of a thread
BLOCK = 256
PHILOX_WORDS_PER_CALL = 4
# curand values a call returns: curand_uniform4 / curand_normal4 at
# float32, curand_uniform2_double / curand_normal2_double at float64
UNROLL = {torch.float32: 4, torch.float64: 2}

LAUNCHES = 0
_COUNT_LOCK = threading.Lock()


class CallPlan(NamedTuple):
    """One generator call as torch launches it: its element count, its
    grid of BLOCK-thread blocks and the Philox offset it consumes."""

    numel: int
    grid: int
    increment: int


class SweepPlan(NamedTuple):
    """A row's three calls of one sweep (rand, randn, exponential; the
    last empty under probit), the latent uniforms of the rand call
    (n_z, 0 under logit) and the sizes of the randn call's fields (kb,
    kprop, ku_prior, ku_noise, ka, kpred; kpred 0 off collecting
    sweeps)."""

    calls: Tuple[CallPlan, CallPlan, CallPlan]
    n_z: int
    normal_sizes: Tuple[int, ...]

    @property
    def increment(self) -> int:
        """The Philox offset a row's sweep consumes."""
        return sum(c.increment for c in self.calls)


def call_plan(numel: int, unroll: int, sms: int, threads_per_sm: int) -> CallPlan:
    """torch's launch policy for a distribution call of ``numel``
    elements: grid = min(SMs * (threads per SM / 256), ceil(numel /
    256)), offset increment ((numel - 1) / (256 grid unroll) + 1) * 4.
    A call of no elements launches nothing and consumes nothing."""
    if numel <= 0:
        return CallPlan(0, 0, 0)
    grid = min(sms * (threads_per_sm // BLOCK), -(-numel // BLOCK))
    increment = ((numel - 1) // (BLOCK * grid * unroll) + 1) * PHILOX_WORDS_PER_CALL
    return CallPlan(numel, grid, increment)


def sweep_plan(shapes, collect: bool, dtype, sms: int, threads_per_sm: int) -> SweepPlan:
    """The calls of one row's sweep under ``shapes``
    (models/probit_gp.SweepShapes), in draw_sweep_noise's order."""
    m, q, p, t, w = shapes.m, shapes.q, shapes.p, shapes.t, shapes.weight
    logit = shapes.link == "logit"
    n_z = 0 if logit else w * m * q
    normal_sizes = (q * p, q, q * m, q * m, q * q, q * t if collect else 0)
    n_exp = w * shapes.pg_n_terms * m * q if logit else 0
    unroll = UNROLL[dtype]
    calls = tuple(call_plan(n, unroll, sms, threads_per_sm)
                  for n in (n_z + q + 1, sum(normal_sizes), n_exp))
    return SweepPlan(calls, n_z, normal_sizes)


def covers(shapes, dtype, device) -> bool:
    """Whether the kernel draws a sweep of ``shapes`` at ``dtype`` on
    ``device``: a CUDA device, float32 or float64, one proposal of the
    gaussian family, and one trial a site under logit."""
    return (torch.device(device).type == "cuda" and dtype in UNROLL and shapes.k >= 1
            and shapes.proposals == 1 and shapes.family == "gaussian"
            and (shapes.link == "probit" or shapes.weight == 1))


def bind_kernel(lib, dtype):
    """The C entry point of ``dtype`` (``smk_sweep_noise_f32`` /
    ``_f64``) with its ctypes signature: philox, K, kz, kphi, ka_u, the
    six normal outputs and their sizes, numel, grid, inc, n_z, q, the
    two floors and the stream."""
    fn = lib.smk_sweep_noise_f64 if dtype == torch.float64 else lib.smk_sweep_noise_f32
    if fn.argtypes is None:
        p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, ll, i, d, d, p]
        fn.restype = ctypes.c_int
    return fn


def draw(generators: Sequence[torch.Generator], shapes, *, collect: bool, dtype,
         device, z_floor: float, u_floor: float) -> dict:
    """One sweep's stacked noise fields for the rows of ``generators``
    (one CUDA generator a row, all distinct), as the per-row path stacks
    them: kz, kb, kprop, kphi, ku_prior, ku_noise, ka, ka_u and kpred
    (None off collecting sweeps). ``z_floor`` / ``u_floor``: the
    ``_uniform`` floors of the latent and the accept uniforms. Each
    generator's offset advances by the sweep's increment."""
    global LAUNCHES
    device = torch.device(device)
    k = len(generators)
    m, q, p, t, w = shapes.m, shapes.q, shapes.p, shapes.t, shapes.weight
    props = torch.cuda.get_device_properties(device)  # what torch's policy reads
    plan = sweep_plan(shapes, collect, dtype, props.multi_processor_count,
                      props.max_threads_per_multi_processor)
    philox = np.empty((k, 2), np.uint64)
    philox[:, 0] = [g.initial_seed() for g in generators]
    philox[:, 1] = [g.get_offset() for g in generators]
    # one non-blocking copy from pinned memory: no wait on the card
    philox_dev = torch.from_numpy(philox.view(np.int64)).pin_memory().to(
        device, non_blocking=True)
    opts = dict(dtype=dtype, device=device)
    if shapes.link == "logit":
        kz = torch.empty((k, shapes.pg_n_terms, m, q), **opts)
    else:
        kz = torch.empty((k, m, q) if w == 1 else (k, w, m, q), **opts)
    kphi = torch.empty((k, q), **opts)
    ka_u = torch.empty((k,), **opts)
    normal = [torch.empty(s, **opts) for s in ((k, q, p), (k, q), (k, q, m), (k, q, m),
                                                (k, q, q), (k, q, t))[:5 + int(collect)]]
    ptrs = (ctypes.c_void_p * 6)(*[x.data_ptr() for x in normal], *([None] * (6 - len(normal))))
    sizes = (ctypes.c_longlong * 6)(*plan.normal_sizes)
    numel = (ctypes.c_longlong * 3)(*[c.numel for c in plan.calls])
    grid = (ctypes.c_int * 3)(*[c.grid for c in plan.calls])
    inc = (ctypes.c_ulonglong * 3)(*[c.increment for c in plan.calls])
    with torch.cuda.device(device):
        err = bind_kernel(cuda_build.load(LIBRARY), dtype)(
            philox_dev.data_ptr(), k, kz.data_ptr(), kphi.data_ptr(), ka_u.data_ptr(), ptrs,
            sizes, numel, grid, inc, plan.n_z, q, z_floor, u_floor,
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"sweep noise kernel launch failed: CUDA error {err} (rows={k}, m={m}, q={q}, "
            f"link={shapes.link}, collect={collect}, dtype={dtype})")
    with _COUNT_LOCK:
        LAUNCHES += 1
    for g, offset in zip(generators, philox[:, 1].tolist()):
        g.set_offset(offset + plan.increment)
    kb, kprop, ku_prior, ku_noise, ka, *kpred = normal
    return dict(kz=kz, kb=kb, kprop=kprop, kphi=kphi, ku_prior=ku_prior, ku_noise=ku_noise,
                ka=ka, ka_u=ka_u, kpred=kpred[0] if collect else None)
