"""Fit artifacts — twin of ``smk_tpu/serve/artifact.py`` (the bundle;
generation publication is ROADMAP A11c): everything the prediction
engine needs from a finished fit, as one integrity-checked bundle.

The serving path holds no training data, no chain state and no live
``MetaKrigingResult``: it loads a frozen artifact holding the combined
quantile grids, the resampled composition draws, the anchor-grid
coordinates, the plug-in phi and the anchor-grid Cholesky factor (from
:func:`smk_torch.api.prediction_factors`, so a loaded engine factors
nothing), plus the fit config's digest for provenance.

The on-disk format is the twin's, field for field: one ``.npz`` of numpy
arrays written through a temp file and an atomic rename, with a CRC32
over every payload field and the format version. An artifact either
package writes loads in the other; only ``config_digest`` is the writing
package's own (compile/programs.config_digest). A truncated or
bit-flipped artifact raises a typed :class:`ArtifactError` at load.
"""

from __future__ import annotations

import os
import zlib
from typing import NamedTuple

import numpy as np

from smk_torch.utils.checkpoint import _atomic_savez

ARTIFACT_VERSION = 1

# every stored field is covered by the CRC, in the order hashed — the
# scalars and strings too (a flipped byte in jitter/cov_model/link
# mis-serves every prediction as silently as one in an array would)
_PAYLOAD_FIELDS = (
    "sample_par", "sample_w", "param_grid", "w_grid",
    "coords_test", "phi", "chol_tt",
    "q", "p", "jitter", "jitter_per_m",
    "cov_model", "link", "config_digest", "version",
)


class ArtifactError(RuntimeError):
    """The artifact at a path cannot be served from: unreadable,
    truncated, an unknown format version, or a failed checksum."""


class FitArtifact(NamedTuple):
    """One frozen fit, ready to serve (numpy arrays, as the twin's).

    ``sample_par`` (S, n_params) / ``sample_w`` (S, t*q,
    response-fastest): the resampled combined-posterior draws;
    ``param_grid`` / ``w_grid``: the combined quantile grids;
    ``coords_test`` (t, d): the anchor grid; ``phi`` (q,): the
    posterior-median decay; ``chol_tt`` (q, t, t): the anchor-grid
    Cholesky; ``cov_model``/``link``/``jitter``/``jitter_per_m``: the
    config fields the composition depends on; ``config_digest``: the
    fit config's digest."""

    sample_par: np.ndarray
    sample_w: np.ndarray
    param_grid: np.ndarray
    w_grid: np.ndarray
    coords_test: np.ndarray
    phi: np.ndarray
    chol_tt: np.ndarray
    q: int
    p: int
    cov_model: str
    link: str
    jitter: float
    jitter_per_m: float
    config_digest: str

    @property
    def n_draws(self) -> int:
        return int(self.sample_par.shape[0])

    @property
    def n_anchor(self) -> int:
        return int(self.coords_test.shape[0])

    @property
    def coord_dim(self) -> int:
        return int(self.coords_test.shape[1])

    def serve_digest(self) -> str:
        """Digest of every config-derived field the serving computation
        depends on (the twin's: equal in both packages for one
        artifact)."""
        import hashlib

        return hashlib.sha256(repr((
            ARTIFACT_VERSION, self.cov_model, self.link,
            float(self.jitter), float(self.jitter_per_m),
            str(self.sample_w.dtype),
        )).encode()).hexdigest()[:12]

    def var_floor(self) -> float:
        """The marginal-variance floor of the composition draw: the
        scale-aware jitter the fit used at the anchor size."""
        return max(float(self.jitter), float(self.jitter_per_m) * self.n_anchor)


def _crc(arrays: dict) -> int:
    h = zlib.crc32(np.asarray([ARTIFACT_VERSION], np.int64).tobytes())
    for name in _PAYLOAD_FIELDS:
        h = zlib.crc32(np.ascontiguousarray(arrays[name]).tobytes(), h)
    return h


def save_artifact(path: str, result, coords_test, *, config=None, cache=None) -> str:
    """Persist a fit as a serving artifact.

    ``result``: the port's :class:`~smk_torch.api.MetaKrigingResult`;
    ``coords_test``: the anchor grid it predicted at; ``cache``: an
    already-built prediction FactorCache (e.g. from
    :func:`~smk_torch.api.predict_at`) — without one the anchor factor is
    built here once, on the result's device. Atomic and CRC-stamped;
    returns ``path``."""
    import torch

    from smk_torch.api import _host, plugin_phi_layout, prediction_factors
    from smk_torch.config import SMKConfig

    def _np32(a) -> np.ndarray:
        return np.asarray(_host(a), np.float32)

    cfg = config or SMKConfig()
    ct = _np32(coords_test)
    q, p, phi = plugin_phi_layout(result, ct.shape[0])
    if cache is None:
        dev = result.sample_w.device
        cache = prediction_factors(
            torch.as_tensor(ct, device=dev), torch.as_tensor(phi, device=dev), config=cfg
        )
    arrays = {
        "sample_par": _np32(result.sample_par),
        "sample_w": _np32(result.sample_w),
        "param_grid": _np32(result.param_grid),
        "w_grid": _np32(result.w_grid),
        "coords_test": ct,
        "phi": np.asarray(phi, np.float32),
        "chol_tt": _np32(cache.krige_chol),
        "q": np.asarray([q], np.int64),
        "p": np.asarray([p], np.int64),
        "jitter": np.asarray([cfg.jitter], np.float64),
        "jitter_per_m": np.asarray([cfg.jitter_per_m], np.float64),
        "cov_model": np.frombuffer(cfg.cov_model.encode(), np.uint8),
        "link": np.frombuffer(cfg.link.encode(), np.uint8),
        "config_digest": np.frombuffer(_fit_digest(cfg).encode(), np.uint8),
        "version": np.asarray([ARTIFACT_VERSION], np.int64),
    }
    arrays["crc"] = np.asarray([_crc(arrays)], np.uint32)
    _atomic_savez(path, arrays)
    return path


def _fit_digest(cfg) -> str:
    from smk_torch.compile.programs import config_digest

    return config_digest(cfg)


def load_artifact(path: str) -> FitArtifact:
    """Load and verify a serving artifact; raises :class:`ArtifactError`
    naming the path on a missing file, a torn npz, missing fields, an
    unknown version or a CRC mismatch."""
    if not os.path.exists(path):
        raise ArtifactError(f"no serving artifact at {path!r}")
    try:
        with np.load(path) as data:
            arrays = {k: np.asarray(data[k]) for k in data.files}
    except Exception as e:  # any unreadable bundle is the same typed error
        raise ArtifactError(
            f"serving artifact {path!r} is unreadable ({e!r}) — "
            "truncated or corrupt; re-export it with save_artifact"
        ) from e
    missing = [k for k in _PAYLOAD_FIELDS + ("crc",) if k not in arrays]
    if missing:
        raise ArtifactError(
            f"serving artifact {path!r} is missing fields "
            f"{missing} — not a save_artifact bundle"
        )
    version = int(arrays["version"][0])
    if version != ARTIFACT_VERSION:
        raise ArtifactError(
            f"serving artifact {path!r} has format version "
            f"{version}, this build reads {ARTIFACT_VERSION}"
        )
    want = int(arrays["crc"][0])
    got = _crc(arrays)
    if got != want:
        raise ArtifactError(
            f"serving artifact {path!r} failed its integrity "
            f"checksum (stored {want:#010x}, recomputed "
            f"{got:#010x}) — the payload is corrupt"
        )
    return FitArtifact(
        sample_par=arrays["sample_par"],
        sample_w=arrays["sample_w"],
        param_grid=arrays["param_grid"],
        w_grid=arrays["w_grid"],
        coords_test=arrays["coords_test"],
        phi=arrays["phi"],
        chol_tt=arrays["chol_tt"],
        q=int(arrays["q"][0]),
        p=int(arrays["p"][0]),
        cov_model=arrays["cov_model"].tobytes().decode(),
        link=arrays["link"].tobytes().decode(),
        jitter=float(arrays["jitter"][0]),
        jitter_per_m=float(arrays["jitter_per_m"][0]),
        config_digest=arrays["config_digest"].tobytes().decode(),
    )
