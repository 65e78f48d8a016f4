"""The cells' inputs, made in numpy from the run's seed. Frozen copies,
so that a change to the program cannot change what is measured:

- ``binary_field``: ``chip_smoke.binary_field`` (the RFF probit field
  of ``bench.py:make_binary_field``), unchanged;
- ``ebird_proxy``: ``smk_torch/data/ebird.make_ebird_proxy`` (Thomas
  clusters of checklists, two LMC-mixed exponential GP fields, logit
  presence), unchanged but for the seed, which the run gives.

Each returns ``(y, x, coords, coords_test, x_test)`` as float32 arrays:
(n, q), (n, q, p), (n, 2), (t, 2), (t, q, p); the last t generated
points are the test sites.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(*arrays):
    return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays)


def binary_field(n: int, q: int, p: int, t: int, seed: int, phi: float = 6.0,
                 n_features: int = 256):
    """Probit binary field over uniform locations with an RFF
    exponential-type GP latent."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n + t, 2))
    freqs = phi * rng.standard_cauchy(size=(n_features, 2))
    phase = rng.uniform(0.0, 2.0 * np.pi, size=n_features)
    coef = rng.normal(size=(q, n_features))
    w = np.sqrt(2.0 / n_features) * np.cos(coords @ freqs.T + phase) @ coef.T
    x = np.concatenate([np.ones((n + t, q, 1)), rng.normal(size=(n + t, q, p - 1))], -1)
    beta = np.linspace(0.8, -0.6, q * p).reshape(q, p)
    eta = np.einsum("nqp,qp->nq", x, beta) + w
    prob = torch.special.ndtr(torch.from_numpy(eta)).numpy()
    y = (rng.uniform(size=eta.shape) < prob).astype(np.float32)
    return _f32(y[:n], x[:n], coords[:n], coords[n:], x[n:])


def _standardize(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.float64)
    sd = v.std(axis=0)
    return (v - v.mean(axis=0)) / np.where(sd > 0, sd, 1.0)


def ebird_proxy(n: int, q: int, p: int, t: int, seed: int, n_hotspots: int = 96,
                hotspot_scale: float = 0.006, hotspot_frac: float = 0.85,
                n_features: int = 384, phi: tuple = (9.0, 5.0)):
    """eBird-like presence/absence at n + t checklists (q = 2 species,
    p = 3 covariates: intercept, effort, elevation)."""
    if (q, p) != (2, 3):
        raise ValueError(f"the eBird proxy has q = 2, p = 3, not q = {q}, p = {p}")
    total = n + t
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.03, 0.97, size=(n_hotspots, 2))
    weights = np.exp(-1.8 * centers.sum(axis=1))
    weights /= weights.sum()
    n_hot = int(hotspot_frac * total)
    assign = rng.choice(n_hotspots, size=n_hot, p=weights)
    pts_hot = centers[assign] + hotspot_scale * rng.normal(size=(n_hot, 2))
    pts_bg = rng.uniform(size=(total - n_hot, 2))
    coords = np.clip(np.concatenate([pts_hot, pts_bg]), 0.0, 1.0)
    coords = coords[rng.permutation(total)]
    effort = _standardize(rng.gamma(2.0, 0.75, size=total))
    kx = rng.normal(size=(2, 4)) * 2.2
    elev = np.cos(coords @ kx + rng.uniform(0, 2 * np.pi, 4)).sum(axis=1)
    elev = _standardize(elev + 0.3 * rng.normal(size=total))
    design = np.stack([np.ones(total), effort, elev], axis=1)
    u = np.empty((total, q))
    for j in range(q):
        freqs = phi[j] * rng.standard_cauchy(size=(n_features, 2))
        phase = rng.uniform(0, 2 * np.pi, n_features)
        coef = rng.normal(size=n_features)
        u[:, j] = np.sqrt(2.0 / n_features) * np.cos(coords @ freqs.T + phase) @ coef
    a = np.array([[1.0, 0.0], [0.55, 0.8]])
    beta = np.array([[-1.3, 0.55, 0.35], [-2.4, 0.75, -0.60]])
    eta = design @ beta.T + u @ a.T
    prob = 1.0 / (1.0 + np.exp(-eta))
    y = (rng.uniform(size=(total, q)) < prob).astype(np.float32)
    x = np.repeat(design[:, None, :], q, axis=1)
    return _f32(y[:n], x[:n], coords[:n], coords[n:], x[n:])


GENERATORS = {"binary_field": binary_field, "ebird_proxy": ebird_proxy}


def make_inputs(cfg: dict, seed: int):
    """The inputs of configuration ``cfg`` (its ``data`` generator at
    its n, q, p, t) from ``seed``."""
    gen = GENERATORS[cfg["data"]]
    return gen(cfg["n"], cfg["q"], cfg["p"], cfg["t"], seed)
