"""The work counts of harness/work.py against hand counts at small
shapes, and against the port's own build count of today."""

# smklint: test-budget=arithmetic on small shapes and one call of the port's build_calls, milliseconds

import copy
import json
from pathlib import Path

import pytest

from harness import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def small(name: str, **kw) -> dict:
    cfg = copy.deepcopy(json.loads((CONFIGS / f"{name}.json").read_text()))
    cfg.update(kw)
    return cfg


def test_schedule_by_hand():
    s = work.schedule(32, 0.75, 8)
    # sweeps 0, 8, 16, 24 update; 24 is the kept scan's only one
    assert s == {"sweeps": 32, "burn": 24, "kept": 8, "updates": 4, "updates_kept": 1}


def test_factorizations_by_hand():
    # config5's schedule at K = 2 subsets of 10, 32 sweeps, E = 16:
    # updates at 0 and 16, so per row 1 + 3 * 2 = 7 factorizations
    cfg = small("config5", n=20, n_subsets=2, n_samples=32)
    assert work.factorizations(cfg) == 2 * 7
    # config4: q = 2, 2 chains, E = 8, 16 sweeps -> updates 0, 8
    cfg = small("config4", n=30, n_subsets=3, n_samples=16)
    assert work.factorizations(cfg) == 3 * 2 * 2 * (1 + 3 * 2)


def test_ops_by_hand():
    cfg = small("config5", n=20, n_subsets=2, n_samples=32)
    m, rows, t = 10, 2, cfg["t"]
    o = work.ops(cfg)
    assert o["chol"]["flops"] == pytest.approx(14 * m ** 3 / 3)
    assert o["chol"]["bytes"] == 14 * 2 * m * m * 4
    # two marginal solves per update (2 updates) and one prior draw per sweep,
    # the kriging solves of t columns at the kept entry and its update at 16? no:
    # burn-in is 24 sweeps, so the kept scan [24, 32) holds no update
    tri_calls = rows * (2 * 2 + 32)
    kr_calls = rows * 2 * 1
    assert o["tri"]["flops"] == pytest.approx(tri_calls * m * m + kr_calls * m * m * t)
    n_mv = rows * 32 * (cfg["sampler"]["cg_iters"] + 1)
    assert o["cg"]["flops"] == pytest.approx(n_mv * 2 * m * m)
    assert o["cg"]["bytes"] == n_mv * m * m * 2


def test_build_bytes_by_hand():
    cfg = small("config5", n=20, n_subsets=2, n_samples=32)
    m, t = 10, cfg["t"]
    # square, s = 1: coords (2, 10, 2), phis (2, 1), mask (2, 10), out (2, 1, 10, 10)
    assert work.build_bytes(cfg, "square", 1) == 4 * (2 * m * 2 + 2 + 2 * m + 2 * m * m)
    assert work.build_bytes(cfg, "test", 1) == 4 * (t * 2 + 2 + 2 * t * t)


@pytest.mark.parametrize("name,n,k,ns", [("config5", 40, 4, 32), ("config4", 48, 4, 40),
                                         ("config5", 64, 8, 64)])
def test_build_calls_match_the_port_today(name, n, k, ns):
    """The frozen counts equal the port's build_calls for the same
    configuration (a later change to the port may do less work; this
    test then documents the difference)."""
    from harness.port import smk_config
    from smk_torch.models.probit_gp import build_calls

    cfg = small(name, n=n, n_subsets=k, n_samples=ns)
    conf = smk_config(cfg)
    got = {"square": 0, "shifted": 0, "cross": 0, "test": 0}
    for kind, calls, _ in work.build_calls(cfg):
        got[kind] += calls
    port = build_calls(conf, cfg["q"], conf.n_samples, conf.n_burn_in)
    assert got == {"square": port["fused_masked_correlation_stack"],
                   "shifted": port["fused_masked_shifted_build"],
                   "cross": port["fused_cross_correlation"],
                   "test": port["fused_correlation_stack"]}


def test_least_time_is_the_larger_bound():
    op = {"flops": 67e12, "bytes": 3.35e12 * 2}
    assert work.least_seconds(op, 67e12, 3.35e12) == pytest.approx(2.0)
