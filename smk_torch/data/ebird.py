"""Presence/absence data — the port's own copy of ``smk_tpu/data/ebird.py``
(pure numpy and ``csv``; the same inputs give bitwise the same arrays and
files):

- ``load_presence_absence_csv`` reads an eBird-style checklist export
  (rows are checklists with coordinates, effort covariates and
  per-species detections) into ``fit_meta_kriging``'s layouts, and
  ``write_presence_absence_csv`` writes that schema back;
- ``make_ebird_proxy`` is the offline proxy data set.

Checklist locations follow a Thomas cluster process around birding
hotspots on an accessibility gradient, so near-duplicate locations are
common; covariates are a per-checklist effort and a smooth elevation
field; q = 2 species' presences come from a logit model over
cross-correlated latent GP fields (LMC) at ~25 % / ~10 % prevalence.
"""

from __future__ import annotations

import csv
import math
from typing import NamedTuple, Optional, Sequence

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


# cell spellings real eBird/citizen-science exports use for "missing"
_NA_TOKENS = frozenset({"", "na", "nan", "n/a", "null", "none", "-"})


def _parse_cell(raw: str, *, row_num: int, col: str, kind: str) -> float:
    """Parse one CSV cell with named errors.

    kind="species": eBird's 'X' (present, uncounted) maps to 1, counts
    clamp to presence 0/1, negatives are an error. kind="number":
    plain float. NA-ish tokens raise _NACell for the caller's
    drop/error policy; anything unparseable names the row and column.
    """
    s = raw.strip() if raw is not None else ""
    if s.lower() in _NA_TOKENS or raw is None:
        raise _NACell(row_num, col)
    if kind == "species" and s.lower() == "x":
        return 1.0  # eBird "X" = detected, count not recorded
    try:
        v = float(s)
    except ValueError:
        raise ValueError(
            f"row {row_num}, column {col!r}: cannot parse {raw!r} as a "
            "number"
        ) from None
    if not math.isfinite(v):
        # R writes Inf/-Inf spellings that float() happily parses; a
        # non-finite coordinate poisons the unit-square rescale with
        # NaN far from the source — fail here, namedly
        raise ValueError(
            f"row {row_num}, column {col!r}: non-finite value {raw!r}"
        )
    if kind == "species":
        if v < 0:
            raise ValueError(
                f"row {row_num}, column {col!r}: negative species "
                f"count {raw!r}"
            )
        return 1.0 if v > 0 else 0.0  # counts clamp to presence
    return v


class _NACell(Exception):
    def __init__(self, row_num, col):
        self.row_num, self.col = row_num, col
        super().__init__(f"row {row_num}, column {col!r}: missing value")


def load_presence_absence_csv(
    path: str,
    species_cols: Sequence[str],
    *,
    lat_col: str = "latitude",
    lon_col: str = "longitude",
    covariate_cols: Sequence[str] = ("effort_hrs",),
    max_rows: Optional[int] = None,
    na_policy: str = "error",
    checklist_id_col: Optional[str] = None,
) -> PresenceAbsenceData:
    """Load an eBird-style checklist CSV into framework layouts.

    Each row is one checklist; ``species_cols`` hold detections —
    0/1, counts (clamped to presence), or eBird's ``X`` (present,
    uncounted). Coordinates are min-max rescaled to the unit square
    (the sampler's phi prior, Unif(4, 12) on a unit domain, assumes
    O(1) distances — reference prior at
    MetaKriging_BinaryResponse.R:63); covariates are standardized and
    an intercept column is prepended.

    Real-export hygiene (a messy CSV must fail *namedly* or follow a
    documented policy, never a bare ``float()`` traceback):

    - Missing columns: ValueError up front naming every absent column
      (and the header actually found).
    - NA / empty / unparseable cells: ``na_policy="error"`` (default)
      raises naming the row number and column; ``na_policy="drop"``
      skips the row and counts it in ``n_dropped_na``.
    - Duplicate checklists: pass ``checklist_id_col`` to keep the
      first occurrence of each id and count the rest in
      ``n_dropped_duplicates`` (eBird shared checklists appear once
      per observer — without an id column every row is kept).

    ``max_rows`` bounds CSV rows SCANNED (header excluded), not rows
    kept: on a drop-heavy multi-million-row export a kept-rows cap
    would silently read to end of file, so with drop policies active
    the returned dataset can hold fewer than ``max_rows`` rows.

    Memory note: with ``checklist_id_col`` set, the dedupe set holds
    every distinct id string seen — O(rows scanned) host memory (tens
    of bytes per id). On a multi-million-row export bound the scan
    with ``max_rows`` or pre-dedupe the export if that footprint
    matters.
    """
    if na_policy not in ("error", "drop"):
        raise ValueError("na_policy must be 'error' or 'drop'")
    lat, lon, covs, ys = [], [], [], []
    n_na = 0
    n_dup = 0
    seen_ids = set()
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        header = reader.fieldnames or []
        needed = [lat_col, lon_col, *covariate_cols, *species_cols]
        if checklist_id_col is not None:
            needed.append(checklist_id_col)
        missing = [c for c in needed if c not in header]
        if missing:
            raise ValueError(
                f"{path}: missing column(s) {missing}; header has "
                f"{header}"
            )
        for i, row in enumerate(reader):
            # max_rows bounds rows SCANNED (not kept): on a
            # drop-heavy multi-million-row export, a kept-rows cap
            # would silently read to EOF
            if max_rows is not None and i >= max_rows:
                break
            row_num = i + 2  # 1-based, counting the header line
            cid = None
            if checklist_id_col is not None:
                cid = (row[checklist_id_col] or "").strip()
                if not cid:
                    # blank id = not a shared checklist (eBird's
                    # group_identifier is empty for solo lists) — it
                    # identifies nothing, so it must never dedupe
                    cid = None
                elif cid in seen_ids:
                    n_dup += 1
                    continue
            try:
                vals = (
                    _parse_cell(row[lat_col], row_num=row_num,
                                col=lat_col, kind="number"),
                    _parse_cell(row[lon_col], row_num=row_num,
                                col=lon_col, kind="number"),
                    [_parse_cell(row[c], row_num=row_num, col=c,
                                 kind="number")
                     for c in covariate_cols],
                    [_parse_cell(row[s], row_num=row_num, col=s,
                                 kind="species")
                     for s in species_cols],
                )
            except _NACell as e:
                if na_policy == "drop":
                    n_na += 1
                    continue
                raise ValueError(
                    f"{path}: {e} (pass na_policy='drop' to skip such "
                    "rows)"
                ) from None
            lat.append(vals[0])
            lon.append(vals[1])
            covs.append(vals[2])
            ys.append(vals[3])
            if cid is not None:
                seen_ids.add(cid)
    if not lat:
        raise ValueError(f"no usable rows read from {path}")
    coords = np.stack([np.asarray(lon), np.asarray(lat)], axis=1)
    span = np.maximum(coords.max(0) - coords.min(0), 1e-12)
    coords = (coords - coords.min(0)) / span.max()  # isotropic rescale
    covs = np.asarray(covs, np.float64)
    design = np.concatenate(
        [np.ones((len(lat), 1)), _standardize(covs)], axis=1
    )
    q = len(species_cols)
    x = np.repeat(design[:, None, :], q, axis=1)
    return PresenceAbsenceData(
        y=np.asarray(ys, np.float32),
        x=x.astype(np.float32),
        coords=coords.astype(np.float32),
        covariate_names=("intercept",) + tuple(covariate_cols),
        species_names=tuple(species_cols),
        n_dropped_na=n_na,
        n_dropped_duplicates=n_dup,
    )


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


def write_presence_absence_csv(
    path: str, data: PresenceAbsenceData
) -> None:
    """Write a PresenceAbsenceData back to the CSV schema
    ``load_presence_absence_csv`` reads (round-trip utility; also how
    the proxy can be materialized on disk as a committed dataset)."""
    cov_names = [c for c in data.covariate_names if c != "intercept"]
    cov_idx = [
        i for i, c in enumerate(data.covariate_names) if c != "intercept"
    ]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(
            ["latitude", "longitude", *cov_names, *data.species_names]
        )
        for i in range(data.y.shape[0]):
            writer.writerow(
                [
                    f"{data.coords[i, 1]:.6f}",
                    f"{data.coords[i, 0]:.6f}",
                    *(f"{data.x[i, 0, j]:.6f}" for j in cov_idx),
                    *(int(v) for v in data.y[i]),
                ]
            )
