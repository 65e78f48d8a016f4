"""The system under test: ``smk_torch.fit_meta_kriging``, called as a
user calls it, with a ``seed`` and the port's default randomness. The
only module of the harness that imports the port, and it does so when
called, not when imported."""

from __future__ import annotations

import dataclasses

from harness import noise


def smk_config(cfg: dict):
    """The port's SMKConfig of configuration file ``cfg`` (its
    ``sampler`` fields, priors nested)."""
    from smk_torch import PriorConfig, SMKConfig

    fields = dict(cfg["sampler"], n_subsets=cfg["n_subsets"], n_samples=cfg["n_samples"])
    fields["priors"] = PriorConfig(**fields["priors"])
    return SMKConfig(**fields)


def fit_once(cfg: dict, inputs, seed: int, fit: int, *, device, n_samples=None):
    """One whole ``fit_meta_kriging`` of the cell on ``inputs`` (arrays
    or tensors), seeded ``noise.fit_seed(seed, fit)``. ``n_samples``
    overrides the depth (the warm-up fit)."""
    from smk_torch import fit_meta_kriging

    conf = smk_config(cfg)
    if n_samples is not None:
        conf = dataclasses.replace(conf, n_samples=int(n_samples))
    y, x, coords, coords_test, x_test = inputs
    return fit_meta_kriging(y, x, coords, coords_test, x_test, config=conf,
                            seed=noise.fit_seed(seed, fit), device=device)
