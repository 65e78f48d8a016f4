"""The plain reference against the port at a small size on the CPU, on
the same inputs and random numbers. With the CG operator in float32 the
sampler is not chaotic and the two agree to float32 round-off carried
through the sweeps (1e-3 on the grids, against gaps of 0.1 to 1 with the
bf16 operator); with the configured bf16 operator a run is judged
correct."""

# smklint: test-budget=fits at the small CPU shapes (4 subsets of 128, 24 sweeps), 1 to 4 s each

import copy

import numpy as np
import pytest

from harness import judge, noise, reference, spec
from _tiny import TINY, run_cpu


def small(cell: str, **sampler):
    cfg = copy.deepcopy(spec.cell(cell)["config"])
    for k, v in TINY.items():
        if k == "sampler":
            cfg["sampler"].update(v)
        else:
            cfg[k] = v
    cfg["sampler"].update(sampler)
    return cfg


@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
def test_reference_follows_the_port_to_round_off(cell):
    import torch

    from harness import port

    cfg = small(cell, cg_matvec_dtype="float32")
    seed, fit, dev = 987654321098, 3, torch.device("cpu")
    inputs = spec.pieces(cfg).inputs(seed)
    res = port.fit_once(cfg, inputs, seed, fit, device=dev)
    s = reference.knobs(cfg)
    n_grid = int(round((1.0 - 1.0 / s["n_quantiles"]) / s["interp_grid_step"])) + 1
    fs = noise.fit_seed(seed, fit)
    perm = noise.permutation(fs, cfg["n"], dev)
    idx = noise.resample_index(fs, s["resample_size"], n_grid, dev)
    ref = reference.fit(cfg, inputs, perm, idx, noise.streams(fs, cfg, dev), dev)
    sr = res.subset_results
    host = lambda a: a.double().numpy()  # noqa: E731
    assert np.abs(host(sr.param_grid) - ref["subset_param_grid"]).max() < 1e-3
    assert np.abs(host(sr.w_grid) - ref["subset_w_grid"]).max() < 1e-3
    assert np.abs(host(sr.phi_accept_rate) - ref["phi_accept_rate"]).max() == 0.0
    port_out = {"p_quant": host(res.p_quant), "p_samples": host(res.p_samples),
                "param_quant": host(res.param_quant)}
    again = reference.fit(cfg, inputs, perm, idx, None, dev,
                          subset_grids=(host(sr.param_grid), host(sr.w_grid)))
    v = judge.numbers(port_out, ref, again)
    assert v["p_gap"] < 1e-4 and v["combine_gap"] < 1e-6


@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
def test_a_sound_run_is_correct(cell):
    res, lines = run_cpu(cell)
    assert res["correct"] is True, lines
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
def test_frozen_noise_is_the_ports_default_noise(cell):
    """noise.py's copy of the port's default randomness draws what
    TorchRandomness draws: the permutation, every row's sweeps in order
    (burn-in and collecting), and the resample index; a seed past 2**32
    included."""
    import torch

    from smk_torch.api import TorchRandomness
    from smk_torch.models.probit_gp import SweepShapes

    cfg = small(cell)
    s = reference.knobs(cfg)
    dev = torch.device("cpu")
    fs = noise.fit_seed(2 ** 40 + 3, 5)
    rng = TorchRandomness(fs, dev)
    assert torch.equal(rng.permutation(cfg["n"]), noise.permutation(fs, cfg["n"], dev))
    rows = s["n_subsets"] * s["n_chains"]
    shapes = SweepShapes(k=rows, m=s["m"], q=cfg["q"], p=cfg["p"], t=cfg["t"],
                         link=s["link"], pg_n_terms=s["pg_n_terms"])
    theirs, ours = rng.sweep_noise(shapes), noise.streams(fs, cfg, dev)
    for it, collect in [(0, False), (1, False), (2, True), (3, True)]:
        a, b = theirs(it, collect), ours(collect)
        for f in b:
            x = getattr(a, f)
            assert (x is None) == (b[f] is None), f
            if x is not None:
                assert torch.equal(x, b[f]), (f, it)
    assert torch.equal(rng.resample_index(1000, 901), noise.resample_index(fs, 1000, 901, dev))
    assert noise.fit_seed(2 ** 40 + 3, 5) != noise.fit_seed(3, 5)
