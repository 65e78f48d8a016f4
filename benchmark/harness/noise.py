"""The random numbers of a fit, drawn again for the reference.

The window calls ``fit_meta_kriging(..., seed=fit_seed(seed, i))``, so
the port draws with its default randomness, as every user's call does.
This module is a frozen copy of that randomness's layout, so that the
reference draws the same numbers on the same device without importing
the port. Where it came from (smk_torch, as of the port's first
benchmark):

- ``api.TorchRandomness``: ``SeedSequence(seed).spawn(3)`` gives the
  partition's, the sweeps' and the resample's children; the partition
  and resample generators are seeded with each child's first uint32,
  the sweeps' root seed is the middle child's first uint32;
- ``models/probit_gp.subset_generators``: one generator per batch row
  (subset-major over chains), seeded from ``SeedSequence(root).spawn(rows)``
  with each child's first uint64 shifted right by one;
- ``models/probit_gp.draw_sweep_noise`` at one proposal of the gaussian
  family and binary responses: per row and sweep one uniform draw
  (probit: m q latent uniforms on [1e-7, 1), then q phi-accept and one
  A-accept uniform on [1e-12, 1)), one normal draw (beta q p, proposal
  q, u prior q m, u noise q m, A q q, and on collecting sweeps the
  kriging q t), and under logit last one Exponential(1) draw of
  (1, pg_n_terms, m, q) (``ops/polya_gamma.gamma_draws`` at b = 1);
- ``parallel/partition.random_permutation`` (``torch.randperm``) and
  ``ops/quantiles.resample_index`` (``torch.randint``).

A CUDA generator's numbers depend on its seed, the call's size and the
order of calls alone, so the reference, drawing row by row in the
sweeps' order on the port's device, gets the port's numbers.

A configuration whose noise this layout does not draw (``LAYOUT``) names
a noise module of its own (harness/spec.py); ``streams`` refuses it.
"""

from __future__ import annotations

import numpy as np
import torch

TINY_Z = 1e-7  # the Albert-Chib uniforms' floor
TINY_U = 1e-12  # the accept tests' floor
# The sampler settings this layout is drawn for; each is also the port's
# default (smk_torch/config.SMKConfig), so a key left out is drawn too.
# The proposals are the collapsed move's: the conditional sampler (the
# port's default) draws one gaussian proposal whatever they say.
LAYOUT = {"dtype": "float32", "subset_engine": "dense", "phi_proposals": 1,
          "phi_proposal_family": "gaussian"}


def child_seed(*words: int) -> int:
    """A 63-bit seed from any whole numbers (seeds may pass 2**32)."""
    seq = np.random.SeedSequence([int(w) % (1 << 64) for w in words])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def fit_seed(seed: int, fit: int) -> int:
    """The ``seed`` the window passes to fit ``fit`` of a run seeded
    ``seed`` (the warm-up fit is fit -1): every fit its own numbers."""
    return child_seed(seed, fit)


def _generator(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _children(seed: int):
    """(partition seed, sweeps' root seed, resample seed) of a fit."""
    part, fit, res = np.random.SeedSequence(int(seed)).spawn(3)
    return tuple(int(c.generate_state(1, np.uint32)[0]) for c in (part, fit, res))


def permutation(seed: int, n: int, device) -> torch.Tensor:
    """The partition's permutation of range(n) of a fit seeded ``seed``."""
    return torch.randperm(n, generator=_generator(device, _children(seed)[0]), device=device)


def resample_index(seed: int, n_draws: int, n_grid: int, device) -> torch.Tensor:
    """The combined posterior's resampled grid rows of a fit seeded ``seed``."""
    g = _generator(device, _children(seed)[2])
    return torch.randint(0, n_grid, (n_draws,), generator=g, device=device)


def _unit(u: torch.Tensor, floor: float) -> torch.Tensor:
    """[0, 1) uniforms mapped to [floor, 1)."""
    return torch.clamp(u * (1.0 - floor) + floor, min=floor)


class SweepStreams:
    """The sweeps' noise of a fit seeded ``seed`` over ``rows`` batch
    rows: one generator a row, each drawn once a sweep, in the sweeps'
    order. ``self(collect)`` returns the next sweep's fields with rows
    first: ``kz`` (rows, m, q) probit uniforms or (rows, n_terms, m, q)
    logit Exponential(1) draws; ``kb`` (rows, q, p), ``kprop`` (rows, q),
    ``ku_prior`` and ``ku_noise`` (rows, q, m), ``ka`` (rows, q, q),
    ``kpred`` (rows, q, t) on collecting sweeps (else None) normals;
    ``kphi`` (rows, q) and ``ka_u`` (rows,) uniforms."""

    def __init__(self, seed: int, rows: int, device, *, m: int, q: int, p: int, t: int,
                 link: str, pg_n_terms: int, dtype=torch.float32):
        root = _children(seed)[1]
        self.generators = [
            _generator(device, int(c.generate_state(1, np.uint64)[0] >> np.uint64(1)))
            for c in np.random.SeedSequence(root).spawn(rows)]
        self.device, self.dtype = torch.device(device), dtype
        self.m, self.q, self.p, self.t = m, q, p, t
        self.logit, self.pg_n_terms = link == "logit", pg_n_terms

    def _row(self, g: torch.Generator, collect: bool) -> dict:
        m, q, p, t = self.m, self.q, self.p, self.t
        opts = dict(generator=g, dtype=self.dtype, device=self.device)
        n_z = 0 if self.logit else m * q
        uni = torch.rand((n_z + q + 1,), **opts)
        sizes = [q * p, q, q * m, q * m, q * q] + ([q * t] if collect else [])
        nor = torch.randn((sum(sizes),), **opts)
        kb, kprop, ku_p, ku_n, ka, *kpred = torch.split(nor, sizes)
        if self.logit:
            e = torch.empty((1, self.pg_n_terms, m, q), dtype=self.dtype, device=self.device)
            e.exponential_(generator=g)
            kz = e[0]
        else:
            kz = _unit(uni[:n_z], TINY_Z).reshape(m, q)
        return {
            "kz": kz, "kb": kb.reshape(q, p), "kprop": kprop,
            "kphi": _unit(uni[n_z:n_z + q], TINY_U),
            "ku_prior": ku_p.reshape(q, m), "ku_noise": ku_n.reshape(q, m),
            "ka": ka.reshape(q, q), "ka_u": _unit(uni[n_z + q], TINY_U),
            "kpred": kpred[0].reshape(q, t) if collect else None,
        }

    def __call__(self, collect: bool) -> dict:
        per = [self._row(g, collect) for g in self.generators]
        return {k: None if per[0][k] is None else torch.stack([r[k] for r in per])
                for k in per[0]}


def check_layout(cfg: dict) -> None:
    """A ValueError naming the first sampler key of configuration
    ``cfg`` whose noise this layout does not draw."""
    s = cfg["sampler"]
    collapsed = s.get("phi_sampler") == "collapsed"
    for key, want in LAYOUT.items():
        got = s.get(key, want)
        if got != want and (collapsed or not key.startswith("phi_proposal")):
            raise ValueError(f"{key}: harness/noise.py draws {want!r} only, not {got!r}; "
                             "name the configuration's own noise module")


def streams(seed: int, cfg: dict, device) -> SweepStreams:
    """The sweeps' noise of fit seed ``seed`` of configuration ``cfg``:
    every batch row (K subsets by C chains) at the subset size."""
    check_layout(cfg)
    s = cfg["sampler"]
    k = cfg["n_subsets"]
    return SweepStreams(seed, k * s.get("n_chains", 1), device, m=-(-cfg["n"] // k),
                        q=cfg["q"], p=cfg["p"], t=cfg["t"], link=s.get("link", "probit"),
                        pg_n_terms=s.get("pg_n_terms", 64))
