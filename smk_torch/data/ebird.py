"""The offline eBird-like proxy data set — the port's own copy of
``make_ebird_proxy`` from ``smk_tpu/data/ebird.py`` (pure numpy; the
same seed gives bitwise the same arrays). The CSV loader is not ported
yet (ROADMAP A12).

Checklist locations follow a Thomas cluster process around birding
hotspots on an accessibility gradient, so near-duplicate locations are
common; covariates are a per-checklist effort and a smooth elevation
field; q = 2 species' presences come from a logit model over
cross-correlated latent GP fields (LMC) at ~25 % / ~10 % prevalence.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PresenceAbsenceData(NamedTuple):
    """y: (n, q) 0/1 presence; x: (n, q, p) per-species design rows;
    coords: (n, 2) in the unit square; covariate_names: p names;
    species_names: q names."""

    y: np.ndarray
    x: np.ndarray
    coords: np.ndarray
    covariate_names: tuple
    species_names: tuple
    n_dropped_na: int = 0
    n_dropped_duplicates: int = 0


def _standardize(v: np.ndarray) -> np.ndarray:
    """Column-wise z-scoring (axis 0); constant columns pass through
    centered."""
    v = np.asarray(v, np.float64)
    sd = v.std(axis=0)
    return (v - v.mean(axis=0)) / np.where(sd > 0, sd, 1.0)


def make_ebird_proxy(
    n: int = 65_536,
    *,
    seed: int = 0,
    n_hotspots: int = 96,
    hotspot_scale: float = 0.006,
    hotspot_frac: float = 0.85,
    n_features: int = 384,
    phi: tuple = (9.0, 5.0),
) -> PresenceAbsenceData:
    """Deterministic eBird-like proxy: ``hotspot_frac`` of checklists
    scatter N(center, hotspot_scale^2) around hotspot centers, the rest
    are uniform background; two unit-variance exponential-covariance GPs
    (random Fourier features) mixed by a lower-triangular A; presence by
    the logit link."""
    rng = np.random.default_rng(seed)
    q, p = 2, 3

    # locations: Thomas cluster process + background
    centers = rng.uniform(0.03, 0.97, size=(n_hotspots, 2))
    weights = np.exp(-1.8 * centers.sum(axis=1))
    weights /= weights.sum()
    n_hot = int(hotspot_frac * n)
    assign = rng.choice(n_hotspots, size=n_hot, p=weights)
    pts_hot = centers[assign] + hotspot_scale * rng.normal(size=(n_hot, 2))
    pts_bg = rng.uniform(size=(n - n_hot, 2))
    coords = np.clip(np.concatenate([pts_hot, pts_bg]), 0.0, 1.0)
    order = rng.permutation(n)
    coords = coords[order]

    # covariates: effort + smooth elevation
    effort = _standardize(rng.gamma(2.0, 0.75, size=n))
    kx = rng.normal(size=(2, 4)) * 2.2
    elev = np.cos(coords @ kx + rng.uniform(0, 2 * np.pi, 4)).sum(axis=1)
    elev = _standardize(elev + 0.3 * rng.normal(size=n))
    design = np.stack([np.ones(n), effort, elev], axis=1)

    # latent LMC fields (RFF exponential GPs)
    u = np.empty((n, q))
    for j in range(q):
        freqs = phi[j] * rng.standard_cauchy(size=(n_features, 2))
        phase = rng.uniform(0, 2 * np.pi, n_features)
        coef = rng.normal(size=n_features)
        u[:, j] = np.sqrt(2.0 / n_features) * np.cos(coords @ freqs.T + phase) @ coef
    a = np.array([[1.0, 0.0], [0.55, 0.8]])
    w = u @ a.T

    # presence: logit link
    beta = np.array([[-1.3, 0.55, 0.35], [-2.4, 0.75, -0.60]])
    eta = design @ beta.T + w
    prob = 1.0 / (1.0 + np.exp(-eta))
    y = (rng.uniform(size=(n, q)) < prob).astype(np.float32)

    x = np.repeat(design[:, None, :], q, axis=1)
    return PresenceAbsenceData(
        y=y,
        x=x.astype(np.float32),
        coords=coords.astype(np.float32),
        covariate_names=("intercept", "effort", "elevation"),
        species_names=("species_common", "species_scarce"),
    )
