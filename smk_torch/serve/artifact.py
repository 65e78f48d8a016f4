"""Fit artifacts — twin of ``smk_tpu/serve/artifact.py``: everything the
prediction engine needs from a finished fit, as one integrity-checked
bundle, and the generations a live fit publishes them in.

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

**Generations.** A live fit (serve/ingest.py) re-fits and republishes,
so a generation directory holds numbered bundles
(``artifact.g000000.npz``, ...) and one manifest, ``MANIFEST.json``,
naming the current one. A publish has two phases:
:func:`land_generation` writes the bundle at its generation's name
(itself atomic), then :func:`commit_generation` renames a temp manifest
over the live one. A crash in either window leaves the previous
manifest, and so every replica's load, intact; the orphaned bundle is
overwritten by the next publish at the same name. The manifest's fields
and format number are the twin's: a generation directory either package
publishes loads in the other.
"""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import NamedTuple, Optional, Tuple

import numpy as np

from smk_torch.utils.checkpoint import _atomic_savez

ARTIFACT_VERSION = 1

# the one live pointer of a generation directory: names the current
# bundle; replaced atomically by commit_generation
GENERATION_MANIFEST = "MANIFEST.json"

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
        # a result of numpy arrays (serve/ingest.py's combined fit) has
        # its factor built on the CPU
        dev = result.sample_w.device if torch.is_tensor(result.sample_w) else "cpu"
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


# ---------------------------------------------------------------------------
# Generation-committed publication
# ---------------------------------------------------------------------------


class GenerationError(ArtifactError):
    """A generation directory cannot be served from: nothing was ever
    committed, or the committed manifest is unreadable or not a
    manifest."""


def generation_artifact_name(generation: int) -> str:
    """The bundle name of a generation: deterministic, so a torn
    publish's orphan is overwritten by the retry at the same name."""
    g = int(generation)
    if g < 0:
        raise ValueError(f"generation must be >= 0, got {g}")
    return f"artifact.g{g:06d}.npz"


def current_generation(gen_dir: str) -> Optional[dict]:
    """The committed manifest of ``gen_dir``, or None when nothing was
    ever committed. A manifest that exists but does not parse is a
    :class:`GenerationError` (commits are atomic renames, so it is
    damage, not a crash window)."""
    path = os.path.join(gen_dir, GENERATION_MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise GenerationError(
            f"generation manifest {path!r} is unreadable ({e!r}) — "
            "commits are atomic renames, so this is corruption, not "
            "a crash window; recommit with publish_generation"
        ) from e
    if not isinstance(manifest, dict) or "generation" not in manifest or "artifact" not in manifest:
        raise GenerationError(
            f"generation manifest {path!r} is missing its "
            "generation/artifact fields — not a commit_generation "
            "manifest"
        )
    return manifest


def land_generation(gen_dir: str, result, coords_test, *, config=None, cache=None,
                    generation: Optional[int] = None) -> Tuple[int, str]:
    """Phase one of a publish: write the bundle at its generation's name
    (atomic and CRC-stamped, :func:`save_artifact`) without touching the
    manifest. ``generation`` defaults to the committed one + 1 (0 in a
    fresh directory). Returns ``(generation, bundle_path)``."""
    os.makedirs(gen_dir, exist_ok=True)
    if generation is None:
        cur = current_generation(gen_dir)
        generation = 0 if cur is None else int(cur["generation"]) + 1
    path = os.path.join(gen_dir, generation_artifact_name(generation))
    save_artifact(path, result, coords_test, config=config, cache=cache)
    return int(generation), path


def commit_generation(gen_dir: str, generation: int, *, meta: Optional[dict] = None) -> dict:
    """Phase two: write the manifest to a temp file, fsync it and rename
    it over the live one, making ``generation`` current in one step. The
    bundle must be landed (a :class:`GenerationError` otherwise).
    Returns the committed manifest."""
    name = generation_artifact_name(generation)
    bundle = os.path.join(gen_dir, name)
    if not os.path.exists(bundle):
        raise GenerationError(
            f"cannot commit generation {int(generation)}: bundle "
            f"{bundle!r} is not landed — call land_generation first"
        )
    manifest = {
        "generation": int(generation),
        "artifact": name,
        "format": ARTIFACT_VERSION,
        # smklint: disable=SMK110 -- a wall-clock provenance stamp in the durable manifest (operators correlate generations with outside logs), not a duration; monotonic() has no epoch
        "published_at": time.time(),
    }
    if meta:
        manifest.update(meta)
    path = os.path.join(gen_dir, GENERATION_MANIFEST)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def publish_generation(gen_dir: str, result, coords_test, *, config=None, cache=None,
                       generation: Optional[int] = None, meta: Optional[dict] = None) -> dict:
    """Land the bundle, then commit the manifest; returns the manifest."""
    gen, _ = land_generation(gen_dir, result, coords_test, config=config, cache=cache,
                             generation=generation)
    return commit_generation(gen_dir, gen, meta=meta)


def load_current_generation(gen_dir: str) -> Tuple[FitArtifact, dict]:
    """``(artifact, manifest)`` of the committed generation: a
    :class:`GenerationError` when nothing was committed, the bundle's own
    :class:`ArtifactError` when the committed bundle is damaged."""
    manifest = current_generation(gen_dir)
    if manifest is None:
        raise GenerationError(
            f"no generation committed in {gen_dir!r} — publish one "
            "with publish_generation"
        )
    return load_artifact(os.path.join(gen_dir, manifest["artifact"])), manifest


def orphan_generations(gen_dir: str) -> Tuple[int, ...]:
    """Landed but never committed generations (bundles newer than the
    committed one): a torn publish's residue or a publish in flight.
    Inert; the next publish overwrites the lowest."""
    if not os.path.isdir(gen_dir):
        return ()
    cur = current_generation(gen_dir)
    committed = -1 if cur is None else int(cur["generation"])
    out = []
    for name in os.listdir(gen_dir):
        if name.startswith("artifact.g") and name.endswith(".npz"):
            try:
                g = int(name[len("artifact.g"):-len(".npz")])
            except ValueError:
                continue
            if g > committed:
                out.append(g)
    return tuple(sorted(out))
