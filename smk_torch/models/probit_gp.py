"""Multivariate binary spatial GP regression — the per-subset model,
twin of ``smk_tpu/models/probit_gp.py`` (the dense engine and the
Vecchia/NNGP sparse engine, ``subset_engine``; probit and logit links;
conditional phi, or collapsed phi single-try or multiple-try
with a gaussian, student-t or mixture proposal; Cholesky or CG u-draw,
the CG operator in fp32 or bf16, Jacobi- or Nystrom-preconditioned;
native or blocked Cholesky and triangular solves; correlation builds in
fp32 or bf16; float32 or float64; several chains; factor reuse and the
kriging cache).

The JAX sampler is written for one subset and vmapped over K; here the K
subsets are a leading axis written out in every tensor, and the
``lax.scan`` over sweeps is a Python loop. Randomness is split from the
sweep: each sweep consumes one :class:`SweepNoise`, whose fields stand
for the nine JAX subkeys of a sweep, from a noise source (per-subset
``torch.Generator`` streams by default). A source that replays the JAX
key schedule makes this sampler and the JAX one consume the same
numbers, which is how the tests hold the two draw for draw.

Chains (``n_chains`` = C > 1) are more batch: the state, the noise and
the per-subset data are K*C wide, subset-major (row k*C + c is chain c
of subset k, the order of the twin's per-(subset, chain) keys), and
:meth:`SpatialGPSampler.finalize` pools each subset's chains.

The correlation builds go through the dispatch seam below: with
``fused_build="pallas"`` every build is the fused kernel
(ops/fused_build.py), with ``"off"`` it is the distance-matrix build.
Under ``subset_engine="vecchia"`` no (m, m) matrix is built at all: the
engine conditions each site on its nearest predecessors
(ops/vecchia.py), and ``SamplerState.chol_r`` carries the packed
per-site coefficients in place of the dense factor, as in the twin.
No sweep reads a device value on the host: where the JAX sampler
branches per subset with a ``lax.cond`` (an accept side), its vmapped K
axis lowers the branch to a select, and the select is what runs here.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from smk_torch.config import SMKConfig, check_ported
from smk_torch.ops.cg import (
    cg_solve,
    nystrom_apply,
    nystrom_factor,
    shifted_correlation_operator,
)
from smk_torch.ops.chol import (
    batched_shifted_cholesky,
    blocked_cholesky,
    blocked_tri_solve,
    chol_logdet,
    chol_solve,
    cholesky,
    finite_factor,
    jittered_cholesky,
    panel_inverses,
    shifted_cholesky,
    tri_solve,
)
from smk_torch.ops.distance import cross_distance, pairwise_distance
from smk_torch.ops.factor_cache import (
    FactorCache,
    empty_counter,
    scatter_component,
    select_accept,
    set_component,
    tick,
)
from smk_torch.ops.fused_build import (
    fused_correlation_stack,
    fused_cross_correlation,
    fused_masked_correlation_stack,
    fused_masked_shifted_build,
)
from smk_torch.ops.kernels import correlation
from smk_torch.ops import sweep_noise
from smk_torch.ops.polya_gamma import gamma_draws, sample_pg
from smk_torch.ops.quantiles import masked_quantile_grid, quantile_grid
from smk_torch.ops.truncnorm import _TINY, sample_albert_chib_latent
from smk_torch.ops.vecchia import (
    build_neighbor_consts,
    build_test_neighbor_consts,
    reverse_neighbors,
    vecchia_coeffs,
    vecchia_krige_draw,
    vecchia_loglik,
    vecchia_posterior_draw,
)
from smk_torch.utils.tracing import count, span, stage
from smk_torch.utils.diagnostics import (
    effective_sample_size,
    masked_effective_sample_size,
    masked_rhat,
    rhat,
)


class SubsetData(NamedTuple):
    """The K stacked (padded) subsets.

    coords: (K, m, d); x: (K, m, q, p); y: (K, m, q); mask: (K, m) 1.0
    real / 0.0 pad; coords_test: (t, d) and x_test: (t, q, p), shared
    by every subset."""

    coords: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor
    coords_test: torch.Tensor
    x_test: torch.Tensor


class BuildConsts(NamedTuple):
    """Geometry the correlation builds consume: the distance matrices
    on the unfused path (dist (K, m, m), dist_cross (K, m, t),
    dist_test (t, t)), the raw coordinates on the fused path. Under the
    Vecchia engine those five are None and the neighbor geometry of
    ops/vecchia.py takes their place: each site's nearest predecessors
    (nbr_*, with the reverse lists that sum F^T in a fixed order) and
    each test site's nearest observed sites (tnbr_*)."""

    dist: Optional[torch.Tensor]
    dist_cross: Optional[torch.Tensor]
    dist_test: Optional[torch.Tensor]
    coords: Optional[torch.Tensor]
    coords_test: Optional[torch.Tensor]
    nbr_idx: Optional[torch.Tensor] = None  # (K, m, nn) int64
    nbr_dist: Optional[torch.Tensor] = None  # (K, m, nn+1, nn+1)
    nbr_valid: Optional[torch.Tensor] = None  # (K, m, nn)
    tnbr_idx: Optional[torch.Tensor] = None  # (K, t, nn) int64
    tnbr_dist: Optional[torch.Tensor] = None  # (K, t, nn+1, nn+1)
    tnbr_valid: Optional[torch.Tensor] = None  # (K, t, nn)
    nbr_rev: Optional[torch.Tensor] = None  # (K, m, D) reverse lists of nbr_idx


class SamplerState(NamedTuple):
    """The carried chain state, K stacked. The JAX twin's PRNG ``key``
    has no counterpart: randomness comes from the noise source."""

    beta: torch.Tensor  # (K, q, p)
    u: torch.Tensor  # (K, m, q) component GPs
    a: torch.Tensor  # (K, q, q) lower-triangular coregionalization
    phi: torch.Tensor  # (K, q)
    chol_r: torch.Tensor  # (K, q, m, m) Cholesky of R~(phi); under the
    # Vecchia engine the packed coefficients (K, q, m, nn+1) instead
    phi_accept: torch.Tensor  # (K, q) running acceptance count
    phi_log_step: torch.Tensor  # (K, q) log MH step


class SubsetResult(NamedTuple):
    """Per-subset compressed posteriors and diagnostics, K stacked."""

    param_grid: torch.Tensor  # (K, n_quantiles, n_params)
    w_grid: torch.Tensor  # (K, n_quantiles, t*q)
    phi_accept_rate: torch.Tensor  # (K, q)
    param_samples: torch.Tensor  # (K, n_kept, n_params)
    w_samples: torch.Tensor  # (K, n_kept, t*q)
    param_ess: torch.Tensor  # (K, n_params)
    param_rhat: torch.Tensor  # (K, n_params)
    w_ess: torch.Tensor  # (K, t*q)
    w_rhat: torch.Tensor  # (K, t*q)


class SweepShapes(NamedTuple):
    """What one sweep's noise draws: k rows of the batch (subsets times
    chains), their shapes, and the collapsed phi move's proposal count
    and family (1 and "gaussian" for the conditional sampler, whose
    proposal is always gaussian)."""

    k: int
    m: int
    q: int
    p: int
    t: int
    weight: int = 1
    link: str = "probit"
    pg_n_terms: int = 64
    proposals: int = 1
    family: str = "gaussian"


def sweep_shapes(cfg: SMKConfig, k: int, m: int, q: int, p: int, t: int,
                 weight: int = 1) -> SweepShapes:
    """The SweepShapes of a fit of ``k`` subsets under ``cfg``: k * n_chains
    rows, and the collapsed sampler's proposal count and family."""
    collapsed = cfg.phi_sampler == "collapsed"
    return SweepShapes(
        k * cfg.n_chains, m, q, p, t, weight, cfg.link, cfg.pg_n_terms,
        cfg.phi_proposals if collapsed else 1,
        cfg.phi_proposal_family if collapsed else "gaussian",
    )


class SweepNoise(NamedTuple):
    """The random numbers of one Gibbs sweep, K stacked — one field per
    subkey of the JAX sweep (probit_gp.py:700-702).

    kz: probit: uniforms on [_TINY, 1), (K, m, q) (a (weight,) trial
        axis after K when weight > 1) — the Albert–Chib latents;
        logit: Gamma(weight, 1) draws, (K, pg_n_terms, m, q) — the
        Pólya-Gamma series;
    kb: normals (K, q, p) — the beta draw;
    kprop: normals (K, q) — the phi proposal. Under the collapsed
        sampler the twin draws component j's proposal as a scalar from
        fold_in(kprop, j): column j holds that scalar, an increment of
        the proposal family (mtm_proposal_eps). With J = phi_proposals
        > 1 it is (K, q, J): component j's J forward increments;
    kphi: uniforms on [1e-12, 1), (K, q) — the phi accept test (column
        j: component j's scalar from fold_in(kphi, j) when collapsed);
    ku_prior, ku_noise: normals (K, q, m) — the Matheron u-draw;
    ka: normals (K, q, q), row l using its first l+1 entries — the A rows;
    ka_u: uniforms on [1e-12, 1), (K,) — the inverse-Wishart accept test;
    kpred: normals (K, q, t) — the kriging draw (collecting sweeps only,
        else None);
    ksel: Gumbel draws (K, q, J) — the multiple-try candidate selection
        (jax.random.categorical(k, lw) is argmax(lw + gumbel(k))), None
        at J = 1;
    krev: (K, q, J - 1) increments of the proposal family — the
        reverse set drawn around the selected candidate, None at J = 1.
        (The twin draws component j's three from split(fold_in(kprop,
        j), 3).)"""

    kz: torch.Tensor
    kb: torch.Tensor
    kprop: torch.Tensor
    kphi: torch.Tensor
    ku_prior: torch.Tensor
    ku_noise: torch.Tensor
    ka: torch.Tensor
    ka_u: torch.Tensor
    kpred: Optional[torch.Tensor]
    ksel: Optional[torch.Tensor] = None
    krev: Optional[torch.Tensor] = None


# a noise source: (sweep index, collecting?) -> that sweep's SweepNoise.
# The chunked executor (parallel/recovery.py) needs four more operations
# of its source, which GeneratorNoise has: rows(ids, m=None) (the source
# of batch rows ids alone, at subset size m), snapshot() and
# restore(snap) (its state at a chunk boundary, as numpy), fork(mask,
# attempts) (a quarantine retry's fresh stream for the masked rows) and
# identity() (bytes naming the stream, for the checkpoint's run
# identity). The twin carries its PRNG key in the chain state instead.
NoiseSource = Callable[[int, bool], SweepNoise]


# the floor of the accept tests' uniforms (kphi, ka_u)
_ACCEPT_FLOOR = 1e-12


def _uniform(u01: torch.Tensor, minval: float) -> torch.Tensor:
    """[0, 1) uniforms mapped to [minval, 1), as jax.random.uniform."""
    return torch.clamp(u01 * (1.0 - minval) + minval, min=minval)


# Multi-try proposal families (SMKConfig.phi_proposal_family): the
# shared increment distribution on the logit-transformed scale, as the
# twin's (probit_gp.py:291-319). Symmetry around zero is load-bearing:
# the MTM-II weights drop the proposal density because q(a | b) =
# q(b | a) for every family here.
_MTM_T_DF = 3  # student_t: heavy tails, finite variance at df = 3
_MTM_MIX_WIDE = 8.0  # mixture: the wide component's scale multiplier


def mtm_proposal_eps(generator: torch.Generator, shape, family: str, *,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Symmetric proposal increments of ``family`` from ``generator``:
    "gaussian" normals; "student_t" with 3 degrees of freedom, as
    z / sqrt((z_1^2 + z_2^2 + z_3^2) / 3) from four normals (exact for
    an integer df, and no gamma sampler is needed); "mixture" a 50/50
    scale mixture z * (8 if u < 0.5 else 1)."""
    opts = dict(dtype=dtype, device=device)
    if family == "gaussian":
        return torch.randn(shape, generator=generator, **opts)
    if family == "student_t":
        z = torch.randn((_MTM_T_DF + 1,) + tuple(shape), generator=generator, **opts)
        return z[0] / torch.sqrt(torch.sum(z[1:] * z[1:], dim=0) / _MTM_T_DF)
    if family == "mixture":
        z = torch.randn(shape, generator=generator, **opts)
        wide = torch.rand(shape, generator=generator, **opts) < 0.5
        return z * torch.where(wide, _MTM_MIX_WIDE, 1.0).to(dtype)
    raise ValueError(f"unknown phi_proposal_family {family!r}")


def gumbel_draws(generator: torch.Generator, shape, *, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws -log(-log u), u uniform on [tiny, 1) (as
    jax.random.gumbel)."""
    tiny = torch.finfo(dtype).tiny
    u = _uniform(torch.rand(shape, generator=generator, dtype=dtype, device=device), tiny)
    return -torch.log(-torch.log(u))


def draw_sweep_noise(
    generator: torch.Generator,
    shapes: SweepShapes,
    *,
    collect: bool,
    dtype=torch.float32,
    device=None,
) -> SweepNoise:
    """One subset's sweep noise (no K axis) from ``generator``: one
    uniform and one normal draw, sliced into the fields, under logit one
    exponential draw for the Gamma(weight, 1) series terms, and last the
    collapsed move's family increments and, at J > 1, its Gumbel and
    reverse draws (so the single-try gaussian stream is unchanged)."""
    m, q, p, t, w = shapes.m, shapes.q, shapes.p, shapes.t, shapes.weight
    logit = shapes.link == "logit"
    z_shape = (m, q) if w == 1 else (w, m, q)
    n_z = 0 if logit else math.prod(z_shape)
    uni = torch.rand(
        (n_z + q + 1,), generator=generator, dtype=dtype, device=device
    )
    sizes = [q * p, q, q * m, q * m, q * q] + ([q * t] if collect else [])
    nor = torch.randn(
        (sum(sizes),), generator=generator, dtype=dtype, device=device
    )
    kb, kprop, ku_p, ku_n, ka, *kpred = torch.split(nor, sizes)
    if logit:
        kz = gamma_draws(generator, w, (shapes.pg_n_terms, m, q), dtype=dtype,
                         device=device)
    else:
        kz = _uniform(uni[:n_z], _TINY).reshape(z_shape)
    ksel = krev = None
    j_try, family = shapes.proposals, shapes.family
    opts = dict(dtype=dtype, device=device)
    if j_try > 1:
        kprop = mtm_proposal_eps(generator, (q, j_try), family, **opts)
        ksel = gumbel_draws(generator, (q, j_try), **opts)
        krev = mtm_proposal_eps(generator, (q, j_try - 1), family, **opts)
    elif family != "gaussian":
        kprop = mtm_proposal_eps(generator, (q,), family, **opts)
    return SweepNoise(
        kz=kz,
        kb=kb.reshape(q, p),
        kprop=kprop,
        kphi=_uniform(uni[n_z : n_z + q], _ACCEPT_FLOOR),
        ku_prior=ku_p.reshape(q, m),
        ku_noise=ku_n.reshape(q, m),
        ka=ka.reshape(q, q),
        ka_u=_uniform(uni[n_z + q], _ACCEPT_FLOOR),
        kpred=kpred[0].reshape(q, t) if collect else None,
        ksel=ksel,
        krev=krev,
    )


def stack_noise(per_subset: Sequence[SweepNoise]) -> SweepNoise:
    """K per-subset SweepNoise tuples -> one with a leading K axis."""
    return SweepNoise(*(
        None if f[0] is None else torch.stack(f)
        for f in zip(*per_subset)
    ))


def chunk_noise(noise: "NoiseSource", start_it: int, n_iters: int, collect: bool) -> SweepNoise:
    """The buffered noise of sweeps [start_it, start_it + n_iters): the
    source called sweep by sweep, as an eager chunk calls it (so each
    generator draws the same numbers in the same order), every field
    stacked on a leading sweep axis. A captured chunk reads it from its
    static buffers; nothing inside the chunk draws."""
    per = [noise(start_it + i, collect) for i in range(n_iters)]
    return SweepNoise(*(None if f[0] is None else torch.stack(f) for f in zip(*per)))


def subset_generators(seed: int, k: int, device) -> List[torch.Generator]:
    """One generator per batch row (subset, or (subset, chain)), seeded
    from ``seed`` by numpy's SeedSequence (independent streams; twin of
    the per-subset key split of parallel/executor.subset_chain_keys)."""
    gens = []
    for child in np.random.SeedSequence(seed).spawn(k):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> np.uint64(1)))
        gens.append(g)
    return gens


def fork_seed(seed: int, attempt: int) -> int:
    """The seed of a row's stream after its ``attempt``-th quarantine
    retry: a child of the row's initial seed and the attempt (the
    twin's fold_in(key, attempt) on the key held at chunk start)."""
    child = np.random.SeedSequence([int(seed), int(attempt)])
    return int(child.generate_state(1, np.uint64)[0] >> np.uint64(1))


class GeneratorNoise:
    """The default noise source: each batch row (subset, or (subset,
    chain)) draws its sweep noise from its own generator. ``seeds``:
    the rows' initial seeds (default: each generator's), which name the
    stream and seed its quarantine forks. ``batched``: whether a sweep's
    noise is one kernel launch for every row (ops/sweep_noise.py: the
    per-row draws' numbers, bit for bit, and each generator advanced as
    they advance it) instead of :func:`draw_sweep_noise` row by row."""

    def __init__(self, generators: Sequence[torch.Generator], shapes: SweepShapes,
                 *, dtype=torch.float32, device=None, seeds: Optional[Sequence[int]] = None):
        self.generators = list(generators)
        self.seeds = ([g.initial_seed() for g in self.generators] if seeds is None
                      else [int(s) for s in seeds])
        self.shapes = shapes
        self.dtype = dtype
        self.device = device
        # one launch a sweep for every row (ops/sweep_noise.py) where the
        # kernel covers the shapes and each row has a CUDA generator of
        # its own; else the per-row draws
        self.batched = (device is not None and sweep_noise.covers(shapes, dtype, device)
                        and all(g.device.type == "cuda" for g in self.generators)
                        and len({id(g) for g in self.generators}) == len(self.generators))

    def __call__(self, it: int, collect: bool) -> SweepNoise:
        rows = len(self.generators)
        with span("smk.noise", rows=rows):
            if self.batched and not torch.cuda.is_current_stream_capturing():
                count("noise_rows_batched", rows)
                return SweepNoise(**sweep_noise.draw(
                    self.generators, self.shapes, collect=collect, dtype=self.dtype,
                    device=self.device, z_floor=_TINY, u_floor=_ACCEPT_FLOOR))
            count("noise_rows_rowwise", rows)
            return stack_noise([
                draw_sweep_noise(g, self.shapes, collect=collect,
                                 dtype=self.dtype, device=self.device)
                for g in self.generators
            ])

    def rows(self, ids, *, m: Optional[int] = None) -> "GeneratorNoise":
        """The source of batch rows ``ids`` alone (in that order), their
        own generators shared, so a run over those rows draws what the
        whole run draws for them; ``m``: the subset size they sweep at
        (a ragged bucket group's), default this source's."""
        ids = [int(i) for i in ids]
        shapes = self.shapes._replace(k=len(ids), m=self.shapes.m if m is None else int(m))
        return GeneratorNoise([self.generators[i] for i in ids], shapes, dtype=self.dtype,
                              device=self.device, seeds=[self.seeds[i] for i in ids])

    def subset(self, lo: int, hi: int) -> "GeneratorNoise":
        """The source of batch rows [lo, hi) alone (:meth:`rows`)."""
        return self.rows(range(lo, hi))

    def to(self, device) -> "GeneratorNoise":
        """This source drawing on ``device`` (a mesh entry's): new
        generators of that device in these generators' states, so they
        draw the same numbers (a card's Philox state is the same on every
        card; a CPU and a CUDA generator share no state format). The
        copies advance on their own."""
        device = torch.device(device)
        gens = []
        for g in self.generators:
            if g.device.type != device.type:
                raise ValueError(
                    f"a {g.device.type} generator's state cannot move to {device}")
            new = torch.Generator(device=device)
            new.set_state(g.get_state())
            gens.append(new)
        return GeneratorNoise(gens, self.shapes, dtype=self.dtype, device=device,
                              seeds=self.seeds)

    def snapshot(self) -> np.ndarray:
        """(rows, state bytes) uint8: each generator's state."""
        return np.stack([g.get_state().numpy() for g in self.generators])

    def restore(self, snap) -> None:
        """Set each generator to its state in ``snap`` (from snapshot)."""
        snap = np.asarray(snap, np.uint8)
        if snap.shape[0] != len(self.generators):
            raise ValueError(
                f"noise snapshot has {snap.shape[0]} rows, the source {len(self.generators)}"
            )
        for g, s in zip(self.generators, snap):
            g.set_state(torch.from_numpy(np.ascontiguousarray(s)))

    def fork(self, mask, attempts) -> None:
        """Reseed each row of ``mask`` from its initial seed and its
        ``attempts`` entry (:func:`fork_seed`); the other rows keep
        their streams."""
        for i in np.flatnonzero(np.asarray(mask, bool)):
            self.generators[i].manual_seed(fork_seed(self.seeds[i], int(attempts[i])))

    def identity(self) -> bytes:
        """The rows' initial seeds, as bytes."""
        return np.asarray(self.seeds, np.uint64).tobytes()


def n_params(q: int, p: int) -> int:
    """beta (q*p) + lower-tri of K = A A^T (q(q+1)/2) + phi (q)."""
    return q * p + q * (q + 1) // 2 + q


def chunk_build_calls(cfg: SMKConfig, q: int, kind: str, start: int, n: int) -> dict:
    """Calls per fused-build entry point of one scan entry of the
    sampler, sweeps [start, start + n) at whatever batch: a burn-in
    chunk (``kind="burn"``) or a collecting one (any other kind). The
    cache is built from the state at entry, as the twin's burn_chunk and
    sample_chunk do.

    - masked stack: the CG operator at entry (u_solver="cg"); per update
      sweep the conditional proposal stack (one call) or the collapsed
      accept side (one per component: a select over K, so built whether
      or not a subset accepts); R~ for the back-multiply of a threaded
      S-factor (thread_s), every sweep;
    - shifted build: S_cur and S_prop per component per collapsed
      update (multiple-try: the (J+1)-deep forward stack and the
      (J-1)-deep reverse stack, one call each, so the count is the
      same); the Cholesky u-draw's S per component per sweep, except
      where the collapsed block hands it over (thread_s on update
      sweeps);
    - kriging cross and test builds, collecting only: the cache at entry
      and the proposal's operators per update sweep (one call, or one
      per component when collapsed); without the cache, one per sweep.

    Chains change nothing here: they widen every call's batch. The
    Vecchia engine builds no (m, m) matrix, so it calls none.
    """
    out = dict.fromkeys(
        ("fused_correlation", "fused_masked_correlation_stack",
         "fused_masked_shifted_build", "fused_cross_correlation",
         "fused_correlation_stack"), 0)
    if cfg.subset_engine == "vecchia" or n <= 0:
        return out
    collapsed = cfg.phi_sampler == "collapsed"
    cg = cfg.u_solver == "cg"
    thread_s = cfg.factor_reuse and collapsed and not cg
    upd = sum(1 for it in range(start, start + n) if it % cfg.phi_update_every == 0)
    per_update = q if collapsed else 1
    out["fused_masked_correlation_stack"] = int(cg) + per_update * upd + (q * n if thread_s else 0)
    shifted = 2 * q * upd if collapsed else 0
    if not cg:
        shifted += q * (n - (upd if thread_s else 0))
    out["fused_masked_shifted_build"] = shifted
    if kind != "burn":
        krige = (1 + per_update * upd) if cfg.krige_cache else n
        out["fused_cross_correlation"] = out["fused_correlation_stack"] = krige
    return out


def build_calls(cfg: SMKConfig, q: int, n_sweeps: int, n_burn: int,
                chunk_iters: Optional[int] = None) -> dict:
    """Calls per fused-build entry point of a fused run of the sampler:
    R~ at init, then a burn-in scan of sweeps [0, n_burn) and a
    collecting scan of [n_burn, n_sweeps), each a scan entry
    (chunk_build_calls). With ``chunk_iters`` each scan runs as chunks
    of that many sweeps (the chunked executor's plan,
    parallel/recovery.py), and each chunk is a scan entry."""
    out = chunk_build_calls(cfg, q, "burn", 0, 0)
    if cfg.subset_engine != "vecchia":
        out["fused_masked_correlation_stack"] = 1  # R~ at init
    for kind, lo, hi in (("burn", 0, n_burn), ("samp", n_burn, n_sweeps)):
        step = (hi - lo) if chunk_iters is None else chunk_iters
        for a in range(lo, hi, max(step, 1)):
            for key, v in chunk_build_calls(cfg, q, kind, a, min(step, hi - a)).items():
                out[key] += v
    return out


def dispatched_build_calls(cfg: SMKConfig, q: int, chunks, entries: int = 1) -> dict:
    """Calls per fused-build entry point that a chunked run implies from
    its own record (parallel/recovery.py): the initial state's R~ on
    each of the ``entries`` that started it (the mesh entries of this
    process, each its block whole also where ``chunk_size`` splits it;
    1 unmeshed), then each dispatched chunk's calls at its
    rung (chunk_build_calls) once per piece that ran it (the record's
    ``pieces``, one by default). ``chunks``: ChunkPipelineStats.chunks;
    the drain is left out."""
    out = chunk_build_calls(cfg, q, "burn", 0, 0)
    if cfg.subset_engine != "vecchia":
        out["fused_masked_correlation_stack"] = int(entries)
    for ch in chunks:
        if ch["phase"] == "drain":
            continue
        kind = "burn" if ch["phase"] == "burn" else "samp"
        n_pieces = int(ch.get("pieces", 1))
        for key, v in chunk_build_calls(cfg, q, kind, ch["iteration"] - ch["n_iters"],
                                        ch["n_iters"]).items():
            out[key] += n_pieces * v
    return out


def _pad_identity(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """R~ = M R M + (I - M) per subset: r is (K, ..., m, m), mask (K, m)."""
    mm = mask[:, :, None] * mask[:, None, :]
    mm = mm.reshape((mm.shape[0],) + (1,) * (r.dim() - 3) + mm.shape[1:])
    eye = torch.eye(mask.shape[-1], dtype=r.dtype, device=r.device)
    return mm * r + (1.0 - mm) * eye


def _np_float(dtype):
    """The numpy scalar type of the sampler's dtype: the twin computes its
    scalar constants in the working dtype (float32, or float64 under
    jax_enable_x64)."""
    return np.float64 if dtype == torch.float64 else np.float32


class SpatialGPSampler:
    """The K-batched subset sampler, dense or Vecchia engine
    (``subset_engine``).

    ``guard_rejects``: (K*C,) int32 on the device, the collapsed moves the
    Metropolis test accepted and the finite-factor guard turned down,
    summed over components and update sweeps since the sampler was made
    (None before the first collapsed update). Instrumentation only: the
    chain never reads it, and no sweep reads it on the host."""

    def __init__(self, config: SMKConfig, *, weight: int = 1):
        check_ported(config)
        self.config = config
        self.weight = int(weight)
        self._fused = config.fused_build == "pallas"
        self._vecchia = config.subset_engine == "vecchia"
        self.guard_rejects = None

    def chain_data(self, data: SubsetData) -> SubsetData:
        """The K subsets' data for the K*C-wide chain batch, subset-major:
        each subset's coords, x, y and mask repeated for its C chains
        (O(m) per row; the test sites stay shared). The data itself when
        C = 1."""
        c = self.config.n_chains
        if c == 1:
            return data
        rep = lambda a: torch.repeat_interleave(a, c, dim=0)  # noqa: E731
        return data._replace(coords=rep(data.coords), x=rep(data.x), y=rep(data.y),
                             mask=rep(data.mask))

    # ------------------------------------------------------------------
    # Correlation builds — the one dispatch seam between the sampler and
    # its (m, m) builds (twin of probit_gp.py:367-549). phis carry a
    # leading K axis.
    # ------------------------------------------------------------------
    def _corr(self, dist, phi):
        """The correlation on the unfused path. build_dtype="bfloat16"
        evaluates it in bf16 on bf16 distances and phi, then upcasts
        (the twin's build-dtype gate, probit_gp.py:373-389)."""
        cfg = self.config
        with span("smk.build", entry="correlation", rows=dist.shape[0]):
            if cfg.build_dtype == "bfloat16":
                return correlation(
                    dist.to(torch.bfloat16), phi.to(torch.bfloat16), cfg.cov_model
                ).to(dist.dtype)
            return correlation(dist, phi, cfg.cov_model)

    def _masked_corr_stack(self, consts, phis, mask):
        """(K, s, m, m) masked correlation stack for (K, s) phis."""
        if self._fused:
            return fused_masked_correlation_stack(
                consts.coords, phis, mask, self.config.cov_model
            )
        return _pad_identity(
            self._corr(consts.dist[:, None], phis[..., None, None]), mask
        )

    def _masked_corr_one(self, consts, phi, mask):
        """(K, m, m) masked correlation at one phi per subset."""
        if self._fused:
            return fused_masked_correlation_stack(
                consts.coords, phi[:, None], mask, self.config.cov_model
            )[:, 0]
        return _pad_identity(self._corr(consts.dist, phi[:, None, None]), mask)

    def _shifted_chol_stack(self, consts, phis, mask, shift):
        """(chol_stack, r_stack) for S = R~(phi_s) + diag(shift) over
        (K, s) phis: the multiple-try candidates' build and factor, one
        call each. Fused: the shifted stack comes from the kernel and
        r_stack is None (the accept side rebuilds R~ at the selected
        phi); off: r_stack is the masked correlation stack."""
        count("factor_mm", phis.numel())
        if self._fused:
            s_stk = fused_masked_shifted_build(
                consts.coords, phis, mask, shift, self.config.cov_model
            )
            return cholesky(s_stk), None
        r_stk = self._masked_corr_stack(consts, phis, mask)
        return batched_shifted_cholesky(r_stk, shift), r_stk

    def _shifted_chol_one(self, consts, phi, mask, shift):
        """(chol_s, s_mat, r) for S = R~(phi) + diag(shift), one phi per
        subset. Fused: s_mat is the kernel's shifted build (handed back
        for the u-draw's back-multiply) and r is None; off: r is R~ and
        s_mat None."""
        count("factor_mm", phi.numel())
        if self._fused:
            s_mat = fused_masked_shifted_build(
                consts.coords, phi[:, None], mask, shift,
                self.config.cov_model,
            )[:, 0]
            return cholesky(s_mat), s_mat, None
        r = self._masked_corr_one(consts, phi, mask)
        return shifted_cholesky(r, shift), None, r

    def _chol_r(self, r):
        """Factor the (stacked) correlation under the scale-aware jitter:
        blocked (ops/chol.blocked_cholesky) when chol_block_size > 0,
        else natively. On the native route ``r`` is a fresh build that
        nothing reads afterwards (its CG operators are taken from it
        first, _r_operators), so the jitter goes onto its diagonal in
        place rather than into a copy (the same values as the twin's
        jittered_cholesky); the blocked route factors a padded copy."""
        cfg = self.config
        jit_eff = cfg.effective_jitter(r.shape[-1])
        count("factor_mm", r.shape[:-2].numel())
        if cfg.chol_block_size > 0:
            return blocked_cholesky(r, jit_eff, cfg.chol_block_size)
        r.diagonal(dim1=-2, dim2=-1).add_(jit_eff)
        return cholesky(r)

    def _vecchia_coeffs(self, nbr_dist, nbr_valid, phi, m):
        """Packed Vecchia coefficients (K, q, ..., nn+1) at the (K, q)
        decays ``phi`` over the neighbor blocks (K, ..., nn+1, nn+1) of
        one geometry, under the jitter of subset size m."""
        cfg = self.config
        return vecchia_coeffs(
            nbr_dist[:, None], nbr_valid[:, None], phi, cfg.effective_jitter(m),
            cfg.cov_model, cfg.build_dtype,
        )

    def _mv_dtype(self, dtype):
        return torch.bfloat16 if self.config.cg_matvec_dtype == "bfloat16" else dtype

    def _r_operators(self, r_full):
        """(r_mv, nys_z), the carried CG operators, from a fresh
        (K, s, m, m) masked correlation: R~ in the matvec dtype (a copy,
        since the caller then factors ``r_full`` in place) and the
        Nystrom factor of its first ``cg_precond_rank`` columns."""
        cfg = self.config
        r_mv = r_full.to(self._mv_dtype(r_full.dtype), copy=True)
        nys_z = None
        if cfg.cg_precond == "nystrom":
            rank = min(cfg.cg_precond_rank, r_full.shape[-1])
            nys_z = nystrom_factor(r_full[..., :rank])
        return r_mv, nys_z

    def _use_blocked_tri(self, m: int) -> bool:
        """Whether the blocked triangular solve engages at size m (at
        m <= block size it is the native solve, and no panel inverses
        are built or carried)."""
        bs = self.config.trisolve_block_size
        return bs > 0 and m > bs

    def _chol_inv(self, chol_r):
        """(..., nb, p, p) diagonal-panel inverses of a stacked factor."""
        return panel_inverses(chol_r, self.config.trisolve_block_size)

    def _tri(self, l, b, inv=None, *, trans: bool = False):
        """m-sized solve against a factor: the blocked form (with
        optional carried panel inverses) when trisolve_block_size > 0,
        the native solve otherwise."""
        bs = self.config.trisolve_block_size
        if bs > 0:
            return blocked_tri_solve(l, b, bs, inv, trans=trans)
        return tri_solve(l, b, trans=trans)

    def _cross_test_corr(self, consts, phi, mask):
        """(r_cross (K, q, m, t) with pad rows zeroed, r_test
        (K, q, t, t)) for the kriging draw."""
        model = self.config.cov_model
        if self._fused:
            r_cross = fused_cross_correlation(
                consts.coords, consts.coords_test, phi, model, row_mask=mask
            )
            r_test = fused_correlation_stack(consts.coords_test, phi, model)
        else:
            r_cross = mask[:, None, :, None] * self._corr(
                consts.dist_cross[:, None], phi[..., None, None]
            )
            r_test = self._corr(consts.dist_test, phi[..., None, None])
        return r_cross, r_test

    def _krige_ops(self, chol_r, phi, mask, consts, inv):
        """(krige_w, krige_chol): W = R~^{-1} R_c and
        chol(R_t - R_c^T W + jitter) for the carried factor (``inv``: its
        panel inverses, or None)."""
        r_cross, r_test = self._cross_test_corr(consts, phi, mask)
        jit_eff = self.config.effective_jitter(chol_r.shape[-1])
        v = self._tri(chol_r, r_cross, inv)
        w = self._tri(chol_r, v, inv, trans=True)
        cond_cov = r_test - r_cross.mT @ w
        return w, jittered_cholesky(cond_cov, jit_eff)

    def _proposal_operators(self, r_ops, chol_prop, inv_prop, phi_prop, mask,
                            consts, cache):
        """Proposal-side values of every populated FactorCache field —
        the one inventory both refresh sites (the conditional step and
        the collapsed block) draw from. Inputs carry (K, s) leading axes
        (s = q, or 1 for one component). ``r_ops``: the proposal's
        (r_mv, nys_z) from _r_operators, taken before its correlation
        was factored in place (the twin passes the correlation itself)."""
        r_mv_p = nys_p = kw_p = kc_p = None
        if cache.r_mv is not None:
            r_mv_p, nys_p = r_ops
        if cache.krige_w is not None:
            kw_p, kc_p = self._krige_ops(chol_prop, phi_prop, mask, consts, inv_prop)
        return FactorCache(
            r_mv=r_mv_p, nys_z=nys_p, chol_inv=inv_prop, krige_w=kw_p,
            krige_chol=kc_p, n_chol=cache.n_chol,
            n_chol_calls=cache.n_chol_calls,
        )

    def _solve_cache(self, consts, mask, state, *, predict: bool = False) -> FactorCache:
        """The cache for the current (phi, chol_r), rebuilt at each scan
        entry: the CG operators (u_solver="cg"), the panel inverses
        (when the blocked solve engages) and, with ``predict``
        (collecting sweeps only), the kriging operators."""
        cfg = self.config
        r_mv = nys_z = chol_inv = krige_w = krige_chol = None
        if self._vecchia:
            # no dense operator exists: the u-draw is a CG on the sparse
            # precision and the kriging rebuilds its coefficients per
            # kept draw; only the factorization counters ride
            return FactorCache(
                r_mv=None, nys_z=None, chol_inv=None, n_chol=empty_counter(),
                n_chol_calls=empty_counter(),
            )
        if cfg.u_solver == "cg":
            r_mv, nys_z = self._r_operators(
                self._masked_corr_stack(consts, state.phi, mask)
            )
        if self._use_blocked_tri(state.chol_r.shape[-1]):
            chol_inv = self._chol_inv(state.chol_r)
        if predict and cfg.krige_cache:
            krige_w, krige_chol = self._krige_ops(
                state.chol_r, state.phi, mask, consts, chol_inv
            )
        return FactorCache(
            r_mv=r_mv, nys_z=nys_z, chol_inv=chol_inv, krige_w=krige_w,
            krige_chol=krige_chol, n_chol=empty_counter(),
            n_chol_calls=empty_counter(),
        )

    def _mtm_ratio(self, consts, mask, cache, j, ytilde, shift, phi_j, t_cur, step,
                   noise, *, thread_s: bool):
        """The multiple-try (MTM II, Liu, Liang & Wong 2000) proposal and
        log acceptance ratio of component j, J = phi_proposals (twin:
        probit_gp.py:1058-1175): the current point and J candidates are
        built and factored in one (J+1)-deep call; a candidate is chosen
        by its importance weight; J - 1 reverse points drawn around it
        are built and factored in one (J-1)-deep call. Weights are the
        collapsed marginal plus the transform's Jacobian (the symmetric
        proposal densities cancel); a non-finite weight (a failed
        factor) is -inf, so an all -inf forward set selects index 0 and
        its -inf weight sum rejects. Returns (cache, log_ratio (K,),
        phi_prop, r_prop (the selected candidate's R~, or None when
        fused), chol_s_cur, chol_s_prop (the S-factors, with thread_s))."""
        cfg = self.config
        lo, hi = cfg.priors.phi_min, cfg.priors.phi_max
        j_try = cfg.phi_proposals
        rows = torch.arange(phi_j.shape[0], device=phi_j.device)

        def stack_logw(t_vec, phi_vec):
            chol_stk, r_stk = self._shifted_chol_stack(consts, phi_vec, mask, shift)
            yt = ytilde[:, None].expand(-1, phi_vec.shape[1], -1)
            alpha = self._tri(chol_stk, yt)
            ll = -0.5 * torch.sum(alpha * alpha, dim=-1) - 0.5 * chol_logdet(chol_stk)
            sig = torch.sigmoid(t_vec)
            lw = ll + torch.log(sig * (1.0 - sig))
            return torch.where(torch.isfinite(lw), lw, -math.inf), r_stk, chol_stk

        t_props = t_cur[:, None] + step[:, None] * noise.kprop[:, j]
        t_stack = torch.cat([t_cur[:, None], t_props], dim=1)  # (K, J+1)
        phi_stack = torch.cat([phi_j[:, None], lo + (hi - lo) * torch.sigmoid(t_props)], dim=1)
        lw_stack, r_stack, chol_stack = stack_logw(t_stack, phi_stack)
        cache = tick(cache, j_try + 1, n_calls=1)
        lw_cur, lw_fwd = lw_stack[:, 0], lw_stack[:, 1:]
        # jax.random.categorical: argmax of the weights plus Gumbel noise
        sel = torch.argmax(lw_fwd + noise.ksel[:, j], dim=1) + 1
        phi_prop = phi_stack[rows, sel]
        t_sel = t_stack[rows, sel]
        # only the selected slices survive: the forward stacks are freed
        # before the reverse set is built
        r_prop = None if r_stack is None else r_stack[rows, sel]
        chol_s_cur = chol_s_prop = None
        if thread_s:
            chol_s_cur = chol_stack[:, 0].clone()
            chol_s_prop = chol_stack[rows, sel]
        del r_stack, chol_stack
        t_rev = t_sel[:, None] + step[:, None] * noise.krev[:, j]
        phi_rev = lo + (hi - lo) * torch.sigmoid(t_rev)
        lw_rev, _, _ = stack_logw(t_rev, phi_rev)
        cache = tick(cache, j_try - 1, n_calls=1)
        log_ratio = torch.logsumexp(lw_fwd, dim=1) - torch.logsumexp(
            torch.cat([lw_rev, lw_cur[:, None]], dim=1), dim=1
        )
        return cache, log_ratio, phi_prop, r_prop, chol_s_cur, chol_s_prop

    def _collapsed_update(self, consts, mask, state, phi, chol_r, cache, j,
                          ytilde, d_vec, noise, *, thread_s: bool):
        """Component j's partially-collapsed phi move on an update sweep
        (twin of collapsed_phi_block's ``upd``): MH on the marginal
        ytilde ~ N(0, R~(phi) + jit I + D), u_j integrated out, single-try
        or, with phi_proposals = J > 1, multiple-try (_mtm_ratio).
        Returns (phi, chol_r, cache, accepted (K,), chol_s): chol_s is the
        S-factor at the selected phi when ``thread_s``, else None.

        The twin's accept branch is a lax.cond, a select over its
        vmapped K axis: the accept side (R~(phi'), its factor, the
        refreshed operators) is built for every subset and selected
        where the move is accepted and the factor is finite. Each m x m
        workspace is released before the next is built (the twin orders
        them with optimization barriers)."""
        cfg = self.config
        lo, hi = cfg.priors.phi_min, cfg.priors.phi_max
        m = mask.shape[-1]
        shift = cfg.effective_jitter(m) + d_vec
        phi_j = phi[:, j]
        step = torch.exp(state.phi_log_step[:, j])
        t_cur = torch.log((phi_j - lo) / (hi - phi_j))

        if cfg.phi_proposals > 1:
            cache, log_ratio, phi_prop, r_prop, chol_s_cur, chol_s_prop = self._mtm_ratio(
                consts, mask, cache, j, ytilde, shift, phi_j, t_cur, step, noise,
                thread_s=thread_s,
            )
        else:
            def marg_ll(phi_v):
                chol_s, _, r = self._shifted_chol_one(consts, phi_v, mask, shift)
                alpha = self._tri(chol_s, ytilde)
                ll = -0.5 * torch.sum(alpha * alpha, dim=-1) - 0.5 * chol_logdet(chol_s)
                return ll, r, chol_s

            t_prop = t_cur + step * noise.kprop[:, j]
            sig_cur = torch.sigmoid(t_cur)
            sig_prop = torch.sigmoid(t_prop)
            phi_prop = lo + (hi - lo) * sig_prop
            cache = tick(cache, 2)  # S_cur and S_prop
            ll_cur, _, chol_s_cur = marg_ll(phi_j)
            if not thread_s:
                chol_s_cur = None
            ll_prop, r_prop, chol_s_prop = marg_ll(phi_prop)
            if not thread_s:
                chol_s_prop = None
            log_ratio = (
                ll_prop + torch.log(sig_prop * (1.0 - sig_prop))
                - ll_cur - torch.log(sig_cur * (1.0 - sig_cur))
            )
        accept_mh = torch.log(noise.kphi[:, j]) < log_ratio

        # the accept side: the carried prior factor at phi' (fused: R~(phi')
        # was never built by the marginal, only S was) and the operators
        r_acc = self._masked_corr_one(consts, phi_prop, mask) if r_prop is None else r_prop
        del r_prop
        r_ops = self._r_operators(r_acc[:, None]) if cache.r_mv is not None else None
        chol_prop = self._chol_r(r_acc)
        del r_acc
        cache = tick(cache, 1)
        # fp32 guard: the marginal factors the well-conditioned S, so it
        # can accept a phi whose bare R~ + jit I factor fails
        # (near-duplicate locations); such an accept is rejected
        ok = finite_factor(chol_prop)
        acc = accept_mh & ok
        turned_down = (accept_mh & ~ok).to(torch.int32)
        self.guard_rejects = (
            turned_down if self.guard_rejects is None else self.guard_rejects + turned_down
        )
        inv_prop = None if cache.chol_inv is None else self._chol_inv(chol_prop)[:, None]
        prop_ops = self._proposal_operators(
            r_ops, chol_prop[:, None], inv_prop, phi_prop[:, None], mask, consts, cache
        )
        cache = scatter_component(prop_ops, cache, j, acc)
        del prop_ops, r_ops, inv_prop
        acc3 = acc[:, None, None]
        phi = set_component(phi, j, torch.where(acc, phi_prop, phi_j))
        chol_r = set_component(chol_r, j, torch.where(acc3, chol_prop, chol_r[:, j]))
        del chol_prop
        chol_s = torch.where(acc3, chol_s_prop, chol_s_cur) if thread_s else None
        return phi, chol_r, cache, acc, chol_s

    # ------------------------------------------------------------------
    def init_state(
        self, data: SubsetData, beta_init: Optional[torch.Tensor] = None,
        consts: Optional[BuildConsts] = None,
    ) -> SamplerState:
        """Starting values mirroring the reference (R:56-60): beta from
        the warm start, phi = 3/0.5, A = I, u = 0. ``consts``: the fit's
        :meth:`_consts` of ``data``, whose geometry (the neighbor sets, or
        the distance matrix) is then reused instead of built again (the
        twin builds it here and in _consts; it is deterministic, so both
        agree)."""
        cfg = self.config
        k, m, q, p = data.x.shape
        dtype, dev = data.x.dtype, data.x.device
        if beta_init is None:
            beta_init = torch.zeros((q, p), dtype=dtype, device=dev)
        lo, hi = cfg.priors.phi_min, cfg.priors.phi_max
        phi0 = torch.full((k, q), 3.0 / 0.5, dtype=dtype, device=dev)
        phi0 = torch.clamp(phi0, lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))
        if self._vecchia:
            if consts is None:
                _, nbr_dist, nbr_valid = build_neighbor_consts(
                    data.coords, data.mask, cfg.n_neighbors
                )
            else:
                nbr_dist, nbr_valid = consts.nbr_dist, consts.nbr_valid
            chol0 = self._vecchia_coeffs(nbr_dist, nbr_valid, phi0, m)
        elif self._fused:
            chol0 = self._chol_r(fused_masked_correlation_stack(
                data.coords, phi0, data.mask, cfg.cov_model
            ))
        else:
            dist = pairwise_distance(data.coords) if consts is None else consts.dist
            chol0 = self._chol_r(_pad_identity(
                self._corr(dist[:, None], phi0[..., None, None]), data.mask
            ))
        log_step = float(np.log(_np_float(dtype)(self.config.phi_step)))
        return SamplerState(
            beta=beta_init.to(dtype).expand(k, q, p).clone(),
            u=torch.zeros((k, m, q), dtype=dtype, device=dev),
            a=torch.eye(q, dtype=dtype, device=dev).expand(k, q, q).clone(),
            phi=phi0,
            chol_r=chol0,
            phi_accept=torch.zeros((k, q), dtype=dtype, device=dev),
            phi_log_step=torch.full((k, q), log_step, dtype=dtype, device=dev),
        )

    # ------------------------------------------------------------------
    def _gibbs_step(
        self,
        data: SubsetData,
        consts: BuildConsts,
        state: SamplerState,
        cache: FactorCache,
        it: int,
        noise: SweepNoise,
        *,
        collect: bool,
        gain: Optional[torch.Tensor] = None,
    ) -> Tuple[SamplerState, FactorCache, Optional[tuple]]:
        """One Gibbs sweep of every subset. Returns (state, cache,
        (params (K, n_params), w_star (K, t*q)) or None). ``gain``: the
        sweep's Robbins–Monro scale as a 0-d tensor (:meth:`chunk_gains`);
        with it, ``it`` only decides whether phi updates, so any index
        congruent to the sweep's modulo ``phi_update_every`` will do (a
        captured chunk replays at any start of its phase). Each numbered
        stage below is a stage span of the sweep's span (utils/tracing)."""
        stage("smk.latent")
        cfg = self.config
        k, m, q, p = data.x.shape
        dtype, dev = data.x.dtype, data.x.device
        mask = data.mask
        jit_eff = cfg.effective_jitter(m)
        f = _np_float(dtype)  # scalar constants in the working dtype
        beta, u, a, phi = state.beta, state.u, state.a, state.phi

        # --- 1. link augmentation: z ~ N(eta + w, 1/omega) ------------
        eta_fixed = torch.einsum("kmqp,kqp->kmq", data.x, beta)
        w = torch.einsum("kmj,klj->kml", u, a)  # u @ a^T
        mu = eta_fixed + w
        if cfg.link == "probit":  # Albert–Chib
            # binomial trials: the noise carries its trial axis after K
            kz = noise.kz if self.weight == 1 else noise.kz.movedim(1, 0)
            zbar = sample_albert_chib_latent(kz, mu, data.y, self.weight)
            womega = float(self.weight) * mask[..., None].expand(k, m, q)
        else:  # logit: Pólya-Gamma, the series terms after K
            omega = sample_pg(noise.kz.movedim(1, 0), self.weight, mu, cfg.pg_n_terms)
            zbar = (data.y - 0.5 * self.weight) / omega
            womega = omega * mask[..., None]
        ts = 1.0 / cfg.n_subsets if cfg.priors.temper == "power" else 1.0

        # --- 2. beta | z, w (conjugate, near-flat normal prior) ------
        stage("smk.beta")
        resid_b = zbar - w
        prec_b = torch.einsum("kmqp,kmq,kmqr->kqpr", data.x, womega, data.x)
        chol_pb = jittered_cholesky(prec_b, ts / cfg.priors.beta_scale ** 2)
        rhs = torch.einsum("kmqp,kmq->kqp", data.x, womega * resid_b)
        beta = chol_solve(chol_pb, rhs) + tri_solve(chol_pb, noise.kb, trans=True)
        eta_fixed = torch.einsum("kmqp,kqp->kmq", data.x, beta)

        # --- 3. phi MH ---------------------------------------------------
        # "conditional" (here): batched random-walk MH on p(phi_j | u_j);
        # "collapsed": per component inside the u loop below
        lo, hi = cfg.priors.phi_min, cfg.priors.phi_max
        collapsed = cfg.phi_sampler == "collapsed"

        def u_loglik(chol, inv):
            alpha = self._tri(chol, u.transpose(1, 2), inv)  # (K, q, m)
            return -0.5 * torch.sum(alpha * alpha, dim=-1) - 0.5 * chol_logdet(chol)

        is_update = it % cfg.phi_update_every == 0
        chol_r = state.chol_r
        accepted = torch.zeros((k, q), dtype=dtype, device=dev)
        if is_update and self._vecchia:
            # the same move, proposal and Jacobians (twin: phi_mh_vecchia),
            # with the proposal's coefficients (one batched (q m, nn, nn)
            # factor call) and the sparse loglik in place of the dense
            # factor and its triangular-solve loglik
            stage("smk.phi")
            step = torch.exp(state.phi_log_step)
            t_cur = torch.log((phi - lo) / (hi - phi))
            t_prop = t_cur + step * noise.kprop
            sig_cur = torch.sigmoid(t_cur)
            sig_prop = torch.sigmoid(t_prop)
            phi_prop = lo + (hi - lo) * sig_prop
            packed_prop = self._vecchia_coeffs(consts.nbr_dist, consts.nbr_valid, phi_prop, m)
            cache = tick(cache, q, n_calls=1)
            u_t = u.transpose(1, 2)
            log_ratio = (
                vecchia_loglik(packed_prop, consts.nbr_idx, u_t)
                + torch.log(sig_prop * (1.0 - sig_prop))
                - vecchia_loglik(state.chol_r, consts.nbr_idx, u_t)
                - torch.log(sig_cur * (1.0 - sig_cur))
            )
            accept = torch.log(noise.kphi) < log_ratio
            phi = torch.where(accept, phi_prop, phi)
            chol_r = torch.where(accept[..., None, None], packed_prop, state.chol_r)
            accepted = accept.to(dtype)
        elif is_update and not collapsed:
            stage("smk.phi")
            step = torch.exp(state.phi_log_step)
            t_cur = torch.log((phi - lo) / (hi - phi))
            t_prop = t_cur + step * noise.kprop
            sig_cur = torch.sigmoid(t_cur)
            sig_prop = torch.sigmoid(t_prop)
            phi_prop = lo + (hi - lo) * sig_prop
            log_jac_cur = torch.log(sig_cur * (1.0 - sig_cur))
            log_jac_prop = torch.log(sig_prop * (1.0 - sig_prop))
            r_prop = self._masked_corr_stack(consts, phi_prop, mask)
            r_ops = self._r_operators(r_prop) if cache.r_mv is not None else None
            chol_prop = self._chol_r(r_prop)
            del r_prop
            cache = tick(cache, q, n_calls=1)
            inv_prop = self._chol_inv(chol_prop) if self._use_blocked_tri(m) else None
            log_ratio = (
                u_loglik(chol_prop, inv_prop) + log_jac_prop
                - u_loglik(state.chol_r, cache.chol_inv) - log_jac_cur
            )
            accept = torch.log(noise.kphi) < log_ratio
            # the JAX sampler gates this refresh on any(accept) with a
            # lax.cond, which its vmapped K axis lowers to a select: the
            # select is what runs here, with no host sync
            prop_ops = self._proposal_operators(
                r_ops, chol_prop, inv_prop, phi_prop, mask, consts, cache
            )
            cache = select_accept(prop_ops, cache, accept)
            del prop_ops, r_ops, inv_prop
            phi = torch.where(accept, phi_prop, phi)
            chol_r = torch.where(accept[..., None, None], chol_prop, state.chol_r)
            del chol_prop
            accepted = accept.to(dtype)

        def rm_adapt(accepted):
            # Robbins–Monro toward the target acceptance, burn-in only;
            # the gain clock counts phi updates (float32, as the twin)
            if not (cfg.phi_adapt and not collect):
                return state.phi_log_step
            scale = gain if gain is not None else float(self._rm_scale(it, f))
            return torch.clamp(
                state.phi_log_step + scale * (accepted - cfg.phi_target_accept),
                float(np.log(f(1e-3))), float(np.log(f(50.0))),
            )

        # --- 4. U | z, beta, A, phi — per-component Matheron draw -----
        # (collapsed: each component's phi move first, then its u_j draw)
        # with thread_s the collapsed block hands its S-factor at the
        # selected phi to the Cholesky u-draw, which then factors nothing
        thread_s = cfg.factor_reuse and collapsed and cfg.u_solver == "chol"
        e0 = zbar - eta_fixed
        big = cfg.mask_noise_var
        u = u.clone()
        for j in range(q):
            stage("smk.u_draw")
            a_j = a[:, :, j]  # (K, q)
            w_full = torch.einsum("kmi,kli->kml", u, a)
            partial_resid = e0 - w_full + u[:, :, j, None] * a_j[:, None, :]
            c_vec = torch.einsum("kml,kl->km", womega, a_j * a_j)
            b_vec = torch.einsum("kml,kl->km", womega * partial_resid, a_j)
            c_safe = torch.clamp(c_vec, min=float(f(1.0) / f(big)))
            ytilde = b_vec / c_safe
            d_vec = torch.clamp(1.0 / c_safe, max=big)
            if self._vecchia:
                # the exact conditional N(P^{-1} b, P^{-1}), P = Q + diag(c),
                # drawn by perturbation and Jacobi CG on the sparse
                # precision, from the dense draw's two noise vectors
                u[:, :, j] = vecchia_posterior_draw(
                    chol_r[:, j], consts.nbr_idx, b_vec, c_safe, noise.ku_prior[:, j],
                    noise.ku_noise[:, j], cfg.cg_iters, consts.nbr_rev,
                )
                continue
            chol_s = None
            if collapsed and is_update:
                stage("smk.phi")
                phi, chol_r, cache, acc_j, chol_s = self._collapsed_update(
                    consts, mask, state, phi, chol_r, cache, j, ytilde, d_vec,
                    noise, thread_s=thread_s,
                )
                accepted[:, j] = acc_j.to(dtype)
                stage("smk.u_draw")
            elif thread_s:
                # non-update sweep: the u-draw's S-factor at the current
                # phi, built here so the draw itself never factors
                chol_s, _, _ = self._shifted_chol_one(
                    consts, phi[:, j], mask, jit_eff + d_vec
                )
                cache = tick(cache, 1)
            u_star = (chol_r[:, j] @ noise.ku_prior[:, j, :, None])[..., 0]
            eta_star = torch.sqrt(d_vec) * noise.ku_noise[:, j]
            rhs_vec = ytilde - u_star - eta_star
            if cfg.u_solver == "cg":
                # (R~ + D) s = rhs by fixed-iteration PCG, R~ applied from
                # the carried matvec matrix (bf16 or fp32, fp32 sums)
                shift = jit_eff + d_vec
                mv, diag, apply_r = shifted_correlation_operator(
                    cache.r_mv[:, j], shift, self._mv_dtype(dtype), dtype
                )
                if cfg.cg_precond == "nystrom":
                    pre = nystrom_apply(cache.nys_z[:, j], shift)
                    s = cg_solve(mv, rhs_vec, cfg.cg_iters, precond=pre)
                else:
                    s = cg_solve(mv, rhs_vec, cfg.cg_iters, diag=diag)
                u[:, :, j] = u_star + apply_r(s) + jit_eff * s
            elif self._fused and chol_s is not None:
                # thread_s handed the factor over; only R~ is rebuilt
                r0 = self._masked_corr_one(consts, phi[:, j], mask)
                s = chol_solve(chol_s, rhs_vec)
                u[:, :, j] = u_star + (r0 @ s[..., None])[..., 0] + jit_eff * s
            elif self._fused:
                # one fused shifted build serves the factor and the
                # back-multiply: R~ s + jit s = (S - diag(d)) s
                chol_s, s_mat, _ = self._shifted_chol_one(
                    consts, phi[:, j], mask, jit_eff + d_vec
                )
                cache = tick(cache, 1)
                s = chol_solve(chol_s, rhs_vec)
                u[:, :, j] = u_star + (s_mat @ s[..., None])[..., 0] - d_vec * s
            elif chol_s is None:
                chol_s, _, r0 = self._shifted_chol_one(consts, phi[:, j], mask,
                                                       jit_eff + d_vec)
                cache = tick(cache, 1)
                s = chol_solve(chol_s, rhs_vec)
                u[:, :, j] = u_star + (r0 @ s[..., None])[..., 0] + jit_eff * s
            else:
                r0 = self._masked_corr_one(consts, phi[:, j], mask)
                s = chol_solve(chol_s, rhs_vec)
                u[:, :, j] = u_star + (r0 @ s[..., None])[..., 0] + jit_eff * s
            del chol_s

        phi_accept = state.phi_accept + accepted
        phi_log_step = rm_adapt(accepted)

        # --- 5. A | z, beta, U (lower-triangular rows) ----------------
        stage("smk.a")
        prior_prec = ts / float(f(cfg.priors.a_scale)) ** 2
        a_new = torch.zeros_like(a)
        for l in range(q):
            u_sub = u[:, :, : l + 1]
            wom_l = womega[:, :, l]
            eye_l = torch.eye(l + 1, dtype=dtype, device=dev)
            prec = u_sub.mT @ (wom_l[..., None] * u_sub) + prior_prec * eye_l
            chol_p = jittered_cholesky(prec, cfg.jitter)
            mean_l = chol_solve(
                chol_p, torch.einsum("kmi,km->ki", u_sub, wom_l * e0[:, :, l])
            )
            row = mean_l + tri_solve(chol_p, noise.ka[:, l, : l + 1], trans=True)
            a_new[:, l, : l + 1] = row

        if cfg.priors.a_prior == "invwishart":
            # independence MH with the conjugate normal draw as proposal:
            # the likelihood cancels, leaving prior densities (R:64)
            nu = cfg.priors.iw_df if cfg.priors.iw_df > 0 else q
            s_iw = cfg.priors.iw_scale
            eye_q = torch.eye(q, dtype=dtype, device=dev)
            tril_r, tril_c = torch.tril_indices(q, q, device=dev)
            jac_w = (q - torch.arange(q, device=dev)).to(dtype)

            def log_prior_ratio(a_mat):
                diag = torch.abs(torch.diagonal(a_mat, dim1=-2, dim2=-1)) + 1e-30
                jac = torch.sum(jac_w * torch.log(diag), dim=-1)
                log_det_k = 2.0 * torch.sum(torch.log(diag), dim=-1)
                a_inv = tri_solve(a_mat, eye_q.expand_as(a_mat))
                tr_psi_kinv = s_iw * torch.sum(a_inv * a_inv, dim=(-2, -1))
                lp_iw = -0.5 * (nu + q + 1) * log_det_k - 0.5 * tr_psi_kinv
                lp_n = -0.5 * prior_prec * torch.sum(
                    a_mat[:, tril_r, tril_c] ** 2, dim=-1
                )
                return ts * lp_iw + jac - lp_n

            log_alpha = log_prior_ratio(a_new) - log_prior_ratio(a)
            acc_a = torch.log(noise.ka_u) < log_alpha
            a = torch.where(acc_a[:, None, None], a_new, a)
        else:
            a = a_new

        new_state = SamplerState(
            beta=beta, u=u, a=a, phi=phi, chol_r=chol_r,
            phi_accept=phi_accept, phi_log_step=phi_log_step,
        )
        if not collect:
            return new_state, cache, None

        # --- 6. predictive kriging draw (spPredict equivalent) --------
        stage("smk.krige")
        if self._vecchia:
            # nearest-neighbor kriging: the test sites' coefficients at
            # the current phi (O(t nn^3), rebuilt per kept draw)
            tpacked = self._vecchia_coeffs(consts.tnbr_dist, consts.tnbr_valid, phi, m)
            u_star_test = vecchia_krige_draw(
                tpacked, consts.tnbr_idx, u.transpose(1, 2), noise.kpred
            )
        elif cache.krige_w is not None:
            cond_mean = torch.einsum("kqmt,kmq->kqt", cache.krige_w, u)
            u_star_test = cond_mean + torch.einsum(
                "kqts,kqs->kqt", cache.krige_chol, noise.kpred
            )
        else:
            r_cross, r_test = self._cross_test_corr(consts, phi, mask)
            v = self._tri(chol_r, r_cross, cache.chol_inv)  # (K, q, m, t)
            alpha = self._tri(chol_r, u.transpose(1, 2), cache.chol_inv)  # (K, q, m)
            cond_mean = torch.einsum("kqmt,kqm->kqt", v, alpha)
            chol_c = jittered_cholesky(r_test - v.mT @ v, jit_eff)
            u_star_test = cond_mean + (chol_c @ noise.kpred[..., None])[..., 0]
        # (t, q) rows per subset, response-fastest: (u*_test^T A^T)
        w_star = torch.einsum("kqt,klq->ktl", u_star_test, a).reshape(k, -1)
        k_mat = a @ a.mT
        tril_r, tril_c = torch.tril_indices(q, q, device=dev)
        params = torch.cat(
            [beta.reshape(k, -1), k_mat[:, tril_r, tril_c], phi], dim=-1
        )
        return new_state, cache, (params, w_star)

    # ------------------------------------------------------------------
    def _consts(self, data: SubsetData) -> BuildConsts:
        """Distance matrices on the unfused path; the raw coordinates on
        the fused path (no (m, m) distance matrix exists there); the
        neighbor geometry under the Vecchia engine (its (K, m, m)
        candidate matrix is a transient of the build)."""
        if self._vecchia:
            nn = self.config.n_neighbors
            nbr = build_neighbor_consts(data.coords, data.mask, nn)
            tnbr = build_test_neighbor_consts(data.coords, data.mask, data.coords_test, nn)
            return BuildConsts(None, None, None, None, None, *nbr, *tnbr,
                               nbr_rev=reverse_neighbors(nbr[0]))
        if self._fused:
            return BuildConsts(None, None, None, data.coords, data.coords_test)
        return BuildConsts(
            pairwise_distance(data.coords),
            cross_distance(data.coords, data.coords_test[None]),
            pairwise_distance(data.coords_test),
            None,
            None,
        )

    def run(
        self,
        data: SubsetData,
        init_state: SamplerState,
        noise: Optional[NoiseSource] = None,
        *,
        seed: int = 0,
        consts: Optional[BuildConsts] = None,
    ) -> SubsetResult:
        """Burn-in sweeps, collecting sweeps, compression. ``data`` holds
        the K subsets; ``init_state`` and ``noise`` are K*C wide
        (n_chains = C; twin of ``run`` at C = 1 and of ``run_chains``
        above it), subset-major. ``noise`` defaults to per-row generators
        seeded from ``seed``. ``consts``: :meth:`_consts` of the K*C-wide
        chain data, if the caller has built it already (both scans use
        one build)."""
        cfg = self.config
        rows = data.x.shape[0] * cfg.n_chains
        if init_state.beta.shape[0] != rows:
            raise ValueError(
                f"init_state has {init_state.beta.shape[0]} rows; {data.x.shape[0]} "
                f"subsets of {cfg.n_chains} chains need {rows}"
            )
        if noise is None:
            noise = self.default_noise(data, seed)
        data = self.chain_data(data)
        if consts is None:
            consts = self._consts(data)
        state = self.burn_chunk(data, consts, init_state, noise, 0, cfg.n_burn_in)
        state = state._replace(phi_accept=torch.zeros_like(state.phi_accept))
        state, (param_draws, w_draws) = self.sample_chunk(
            data, consts, state, noise, cfg.n_burn_in, cfg.n_kept
        )
        with span("smk.finalize", rows=rows):
            return self.finalize(state, param_draws, w_draws)

    def default_noise(self, data: SubsetData, seed: int = 0) -> GeneratorNoise:
        """One generator per (subset, chain) row of ``data``'s K subsets,
        seeded from ``seed``."""
        k, m, q, p = data.x.shape
        shapes = sweep_shapes(self.config, k, m, q, p, data.coords_test.shape[0], self.weight)
        return GeneratorNoise(subset_generators(seed, shapes.k, data.x.device), shapes,
                              dtype=data.x.dtype, device=data.x.device)

    def _rm_scale(self, it: int, f):
        """The Robbins–Monro scale of sweep ``it`` as a scalar of numpy
        type ``f`` (the working dtype's, _np_float): the gain (its clock
        counts phi updates, as the twin's), zero on a sweep that does not
        update phi."""
        cfg = self.config
        gain = f(cfg.phi_adapt_rate) * (f(1.0) + f(it) / f(cfg.phi_update_every)) ** f(-0.6)
        return gain * f(1.0 if it % cfg.phi_update_every == 0 else 0.0)

    def chunk_gains(self, start_it: int, n_iters: int, collect: bool, dtype,
                    device) -> Optional[torch.Tensor]:
        """The (n_iters,) Robbins–Monro scales of sweeps [start_it,
        start_it + n_iters) on ``device`` (None when the chunk does not
        adapt): a device value multiplies bitwise as the Python scalar
        does, and it lets one captured chunk serve every start. Uploaded
        through pinned memory, so no call waits for the device."""
        if not (self.config.phi_adapt and not collect):
            return None
        f = _np_float(dtype)
        vals = np.asarray([self._rm_scale(it, f) for it in range(start_it, start_it + n_iters)], f)
        host = torch.from_numpy(vals)
        if torch.device(device).type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host

    # smklint: captured
    def _sweeps(self, data: SubsetData, consts: BuildConsts, state: SamplerState, noise_at,
                gains: Optional[torch.Tensor], it0: int, n_iters: int, collect: bool):
        """Sweeps it0 .. it0 + n_iters - 1: the one body of the eager
        chunks and of the captured chunk programs. ``noise_at(i)`` is
        sweep i's SweepNoise; ``gains`` :meth:`chunk_gains`. Returns
        (state, draws or None)."""
        with span("smk.cache", predict=collect):
            cache = self._solve_cache(consts, data.mask, state, predict=collect)
        draws = None
        if collect:
            k, m, q, p = data.x.shape
            t = data.coords_test.shape[0]
            opts = dict(dtype=data.x.dtype, device=data.x.device)
            draws = (torch.empty((k, n_iters, n_params(q, p)), **opts),
                     torch.empty((k, n_iters, t * q), **opts))
        every = self.config.phi_update_every
        for i in range(n_iters):
            nz = noise_at(i)
            with span("smk.sweep", it=it0 + i, collect=collect, phi=(it0 + i) % every == 0):
                state, cache, out = self._gibbs_step(
                    data, consts, state, cache, it0 + i, nz, collect=collect,
                    gain=None if gains is None else gains[i],
                )
            if collect:
                draws[0][:, i] = out[0]
                draws[1][:, i] = out[1]
        return state, draws

    def count_chunk(self, data: SubsetData, consts: BuildConsts, state: SamplerState,
                    noise: NoiseSource, start_it: int, n_iters: int, *, collect: bool = False,
                    with_calls: bool = False):
        """Sweeps [start_it, start_it + n_iters) as :meth:`burn_chunk`
        (``collect=False``) or :meth:`sample_chunk` (draws discarded) run
        them, returning ``(state, n_chol)``: the m x m factorizations the
        sweeps performed, the FactorCache counter of the cache built at
        entry (twin of ``count_chunk``). ``with_calls``: ``(state, (n_chol,
        n_chol_calls))``, the second the batched Cholesky calls issued.
        The counters are the whole batch's per row (every row factors
        alike)."""
        gains = self.chunk_gains(start_it, n_iters, collect, data.x.dtype, data.x.device)
        with span("smk.cache", predict=collect):
            cache = self._solve_cache(consts, data.mask, state, predict=collect)
        every = self.config.phi_update_every
        for i in range(n_iters):
            it = start_it + i
            nz = noise(it, collect)
            with span("smk.sweep", it=it, collect=collect, phi=it % every == 0):
                state, cache, _ = self._gibbs_step(
                    data, consts, state, cache, it, nz, collect=collect,
                    gain=None if gains is None else gains[i])
        if with_calls:
            return state, (cache.n_chol, cache.n_chol_calls)
        return state, cache.n_chol

    def burn_chunk(self, data: SubsetData, consts: BuildConsts, state: SamplerState,
                   noise: NoiseSource, start_it: int, n_iters: int) -> SamplerState:
        """Non-collecting sweeps [start_it, start_it + n_iters) of the
        K*C-wide chain ``data`` (twin of ``burn_chunk``): the cache is
        built from ``state`` at entry and the Robbins–Monro gain follows
        the global sweep index. A caller that chunks the burn-in resets
        ``phi_accept`` to zero after its last chunk, as ``run`` does. The
        noise is drawn sweep by sweep (a long burn-in never holds it all)."""
        if n_iters == 0:
            return state
        gains = self.chunk_gains(start_it, n_iters, False, data.x.dtype, data.x.device)
        return self._sweeps(data, consts, state, lambda i: noise(start_it + i, False), gains,
                            start_it, n_iters, False)[0]

    def sample_chunk(self, data: SubsetData, consts: BuildConsts, state: SamplerState,
                     noise: NoiseSource, start_it: int, n_iters: int):
        """Collecting sweeps [start_it, start_it + n_iters) (twin of
        ``sample_chunk``), the cache with its kriging operators built
        from ``state`` at entry; returns (state, (param_draws (K*C,
        n_iters, n_params), w_draws (K*C, n_iters, t*q)))."""
        return self._sweeps(data, consts, state, lambda i: noise(start_it + i, True), None,
                            start_it, n_iters, True)

    def program_bucket_fields(self) -> tuple:
        """The model-identity fields of every program bucket key
        (compile/programs.py), the twin's eight: ``(cov_model, link,
        fused_build, n_chains, phi_proposals, subset_engine, n_neighbors,
        build_dtype)``."""
        cfg = self.config
        return (cfg.cov_model, cfg.link, cfg.fused_build, cfg.n_chains, cfg.phi_proposals,
                cfg.subset_engine, cfg.n_neighbors, cfg.build_dtype)

    def kernel_libraries(self, dtype, device) -> tuple:
        """The CUDA kernel libraries (ops/cuda_build.SOURCES) the sampler
        launches on ``dtype`` data on ``device``: the correlation build of
        that dtype on the fused dense path on the card, and the sweep
        noise kernel where it covers the config's draws (ops/sweep_noise
        .covers); none elsewhere."""
        if torch.device(device).type != "cuda":
            return ()
        libs = ()
        if self._fused and not self._vecchia:
            libs = ("fused_corr_f64",) if dtype == torch.float64 else ("fused_corr",)
        if sweep_noise.covers(sweep_shapes(self.config, 1, 1, 1, 1, 1), dtype, device):
            libs += (sweep_noise.LIBRARY,)
        return libs

    def chunk_touches_guard(self, phase: int, n_iters: int) -> bool:
        """Whether sweeps phase .. phase + n_iters - 1 (modulo
        ``phi_update_every``) can add to ``guard_rejects``: a collapsed
        update on the dense engine."""
        cfg = self.config
        return (cfg.phi_sampler == "collapsed" and not self._vecchia
                and any((phase + i) % cfg.phi_update_every == 0 for i in range(n_iters)))

    def chunk_program(self, collect: bool, n_iters: int, phase: int):
        """The static-buffer body of one chunk bucket (compile/programs
        .GraphProgram): ``fn(data, consts, state, noise, gains, guard) ->
        (state, draws or None, guard)``, where ``noise`` is the chunk's
        SweepNoise stacked on a leading sweep axis (:func:`chunk_noise`),
        ``gains`` :meth:`chunk_gains` and ``guard`` the rows'
        ``guard_rejects`` in (zeros for none yet) when
        :meth:`chunk_touches_guard`, else None. It reads nothing else of
        the model's mutable state, draws nothing and syncs nothing, so
        it can be captured and replayed at any chunk start of ``phase``."""
        touches = self.chunk_touches_guard(phase, n_iters)
        # the model holds its programs (compile/programs.get_program): a
        # weak reference back keeps that from being a cycle, so a model's
        # graphs and their memory go when the model does
        ref = weakref.ref(self)

        # smklint: captured
        def fn(data, consts, state, noise, gains, guard):
            model = ref()
            held = model.guard_rejects
            model.guard_rejects = guard if touches else None
            try:
                state, draws = model._sweeps(
                    data, consts, state,
                    lambda i: SweepNoise(*(None if f is None else f[i] for f in noise)),
                    gains, phase, n_iters, collect)
                return state, draws, model.guard_rejects if touches else None
            finally:
                model.guard_rejects = held

        return fn

    def finalize(self, state, param_draws, w_draws) -> SubsetResult:
        """Quantile compression and diagnostics over the kept draws of the
        K*C rows (twin of ``finalize``): each subset's C chains are pooled
        chain-major for the grids and samples, ESS is summed over chains,
        R-hat spans them and the accept rate is their mean."""
        cfg = self.config
        c = cfg.n_chains
        n_phi_updates = sum(
            1 for i in range(cfg.n_burn_in, cfg.n_samples)
            if i % cfg.phi_update_every == 0
        )
        kc, n = param_draws.shape[:2]
        chains_p = param_draws.reshape(kc // c, c, n, -1)
        chains_w = w_draws.reshape(kc // c, c, n, -1)
        pooled_p = chains_p.reshape(kc // c, c * n, -1)
        pooled_w = chains_w.reshape(kc // c, c * n, -1)
        accept = state.phi_accept / float(max(n_phi_updates, 1))
        return SubsetResult(
            param_grid=quantile_grid(pooled_p, cfg.n_quantiles, dim=1),
            w_grid=quantile_grid(pooled_w, cfg.n_quantiles, dim=1),
            phi_accept_rate=torch.mean(accept.reshape(kc // c, c, -1), dim=1),
            param_samples=pooled_p,
            w_samples=pooled_w,
            param_ess=torch.sum(effective_sample_size(chains_p, dim=2), dim=1),
            param_rhat=rhat(chains_p),
            w_ess=torch.sum(effective_sample_size(chains_w, dim=2), dim=1),
            w_rhat=rhat(chains_w),
        )

    def finalize_masked(self, state, param_draws, w_draws, row_mask, it_end) -> SubsetResult:
        """:meth:`finalize` over capacity-padded draw buffers (the
        adaptive schedule's; twin of ``finalize_masked``): ``row_mask``
        (K, n_cap) is true where a subset's rows hold draws (shared by
        its chains, which advance together) and ``it_end`` (K,) the
        global iteration at which each subset left the dispatch group,
        which sets its phi-acceptance divisor. Only ``state.phi_accept``
        is read. ``param_samples`` and ``w_samples`` come back at
        capacity, invalid rows zeroed."""
        cfg = self.config
        c = cfg.n_chains
        e = cfg.phi_update_every
        kc, n = param_draws.shape[:2]
        k = kc // c
        dev = param_draws.device
        row_mask = torch.as_tensor(np.asarray(row_mask, bool), device=dev)
        ends = np.asarray(it_end, np.int64)
        n_upd = np.maximum((ends + e - 1) // e - (cfg.n_burn_in + e - 1) // e, 1)
        chains_p = param_draws.reshape(k, c, n, -1)
        chains_w = w_draws.reshape(k, c, n, -1)
        dt = param_draws.dtype
        pooled_mask = row_mask.repeat(1, c)  # chain-major pooling
        pooled_p = chains_p.reshape(k, c * n, -1) * pooled_mask[..., None].to(dt)
        pooled_w = chains_w.reshape(k, c * n, -1) * pooled_mask[..., None].to(dt)
        accept = state.phi_accept.to(dev)
        div = torch.as_tensor(np.repeat(n_upd, c), dtype=accept.dtype, device=dev)
        accept = accept / div[:, None]
        chain_mask = row_mask[:, None, :]
        return SubsetResult(
            param_grid=masked_quantile_grid(pooled_p, pooled_mask, cfg.n_quantiles),
            w_grid=masked_quantile_grid(pooled_w, pooled_mask, cfg.n_quantiles),
            phi_accept_rate=torch.mean(accept.reshape(k, c, -1), dim=1),
            param_samples=pooled_p,
            w_samples=pooled_w,
            param_ess=torch.sum(masked_effective_sample_size(chains_p, chain_mask), dim=1),
            param_rhat=masked_rhat(chains_p, row_mask),
            w_ess=torch.sum(masked_effective_sample_size(chains_w, chain_mask), dim=1),
            w_rhat=masked_rhat(chains_w, row_mask),
        )


# The twin's aliases: the probit name of the sampler, and the factor
# cache under its former name.
SpatialProbitGP = SpatialGPSampler
SolveCache = FactorCache
