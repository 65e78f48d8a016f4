"""The check catches a broken timed path: each fault a one-card cell can
have, planted in the port underneath a whole run on the CPU (the
harness's look for a card skipped), turns ``correct`` false. The
exchange between cards is a fault of a four-card cell only; no such
cell is in BENCHMARK.json."""

# smklint: test-budget=one run at the small CPU shapes per case, about 2 s each

import pytest

from _tiny import run_cpu


def state_unchanged(monkeypatch):
    """Every sweep returns the state it was given."""
    from smk_torch.models.probit_gp import SpatialGPSampler

    step = SpatialGPSampler._gibbs_step

    def frozen(self, data, consts, state, cache, it, noise, **kw):
        _, cache, out = step(self, data, consts, state, cache, it, noise, **kw)
        return state, cache, out

    monkeypatch.setattr(SpatialGPSampler, "_gibbs_step", frozen)


def half_batch(monkeypatch):
    """The combine averages the first half of the subsets only."""
    import smk_torch.api as api

    combine = api.combine

    def half(grids_par, grids_w, config, *a, **kw):
        k = grids_par.shape[0] // 2
        return combine(grids_par[:k], grids_w[:k], config, *a, **kw)

    monkeypatch.setattr(api, "combine", half)


def answer_altered(monkeypatch):
    """One p(y = 1) draw is changed where it is produced."""
    import smk_torch.api as api

    predict = api.predict_probability

    def altered(*a, **kw):
        p = predict(*a, **kw).clone()
        p[0, 0] = p[0, 0] * 0.999
        return p

    monkeypatch.setattr(api, "predict_probability", altered)


@pytest.mark.parametrize("cell", ["config5.fit", "config4.fit"])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
def test_fault_turns_correct_false(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, lines = run_cpu(cell)
    assert res["correct"] is False, lines
