"""The system under test: ``smk_torch.fit_meta_kriging``, called as a
user calls it, with a ``seed``, the port's default randomness and the
cell's fit arguments. The only module of the harness that imports the
port, and it does so when called, not when imported."""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

from harness import noise as default_noise
from harness import spec


def smk_config(cfg: dict):
    """The port's SMKConfig of configuration file ``cfg`` (its
    ``sampler`` fields, priors nested)."""
    from smk_torch import PriorConfig, SMKConfig

    fields = dict(cfg["sampler"], n_subsets=cfg["n_subsets"], n_samples=cfg["n_samples"])
    fields["priors"] = PriorConfig(**fields["priors"])
    return SMKConfig(**fields)


def fit_keywords(fit_args: dict, files: Path) -> dict:
    """``fit_args`` (spec.fit_args) as ``fit_meta_kriging``'s keywords:
    a ``checkpoint_path`` is taken relative to ``files``, which is
    emptied, so that no fit resumes from another's files."""
    kw = dict(fit_args)
    if "checkpoint_path" in kw:
        rel = Path(str(kw["checkpoint_path"]))
        if rel.is_absolute() or ".." in rel.parts:
            raise ValueError(f"fit_args: checkpoint_path {str(rel)!r} leads out of {files}")
        shutil.rmtree(files, ignore_errors=True)
        (files / rel).parent.mkdir(parents=True, exist_ok=True)
        kw["checkpoint_path"] = str(files / rel)
    return kw


def fit_once(cfg: dict, inputs, seed: int, fit: int, *, device, n_samples=None,
             fit_args=None, files: Path = None, noise=default_noise):
    """One whole ``fit_meta_kriging`` of the cell on ``inputs`` (arrays
    or tensors), seeded ``noise.fit_seed(seed, fit)``, with the cell's
    ``fit_args`` (checkpoints in ``files``, by default
    spec.fit_files()). ``n_samples`` overrides the depth (the warm-up
    fit)."""
    from smk_torch import fit_meta_kriging

    conf = smk_config(cfg)
    if n_samples is not None:
        conf = dataclasses.replace(conf, n_samples=int(n_samples))
    kw = fit_keywords(fit_args or {}, spec.fit_files() if files is None else files)
    y, x, coords, coords_test, x_test = inputs
    return fit_meta_kriging(y, x, coords, coords_test, x_test, config=conf,
                            seed=noise.fit_seed(seed, fit), device=device, **kw)
