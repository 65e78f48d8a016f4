"""The port's data edges against the JAX package's, on the same inputs:

- ``smk_torch/data/ebird.load_presence_absence_csv``: every array, name
  and counter identical to the twin's on the same file, over the cases of
  tests/test_data_ebird.py (the round trip, mixed-scale covariates, counts
  clamped, ``X`` cells, the ``na_policy`` error and drop, duplicates,
  blank ids, ``max_rows``, missing columns, negative counts, non-finite
  cells, an empty file); an error is the same exception type with the
  same message;
- ``write_presence_absence_csv``: a byte-identical file;
- ``smk_torch/data/synthetic.tiny_binary_problem``: the twin's shapes and
  construction (its numbers come from numpy's generator, not JAX's), and
  the multi-process worker's problem built from it;
- ``parallel/executor.count_subset_factorizations``: the factorization
  and batched-call counts equal to the twin's (tolerance 0) on a run fed
  the twin's key schedule (tests/test_torch_recovery.replay), the
  phi-acceptance counts at the sweep tolerance (5e-5), and the twin's
  refusal of chains.
"""

# smklint: test-budget=CSV files of at most 256 rows; two twin count_subset_factorizations calls (K=4, m=24, 6 sweeps; ~12 s of compiles) in a module fixture
import numpy as np
import pytest
import torch

from smk_tpu.config import SMKConfig as JaxConfig
from smk_tpu.data import ebird as jebird
from smk_tpu.data import synthetic as jsynthetic
from smk_tpu.models.probit_gp import SpatialGPSampler as JaxSampler
from smk_tpu.parallel import executor as jexec
from smk_torch import convert
from smk_torch.config import SMKConfig
from smk_torch.data import ebird
from smk_torch.data.synthetic import tiny_binary_problem
from smk_torch.models.probit_gp import SpatialGPSampler
from smk_torch.parallel import executor
from smk_torch.parallel.partition import random_partition
from smk_torch.testing import dcn_worker
from test_torch_recovery import _problem, replay

MESSY_CSV = """checklist_id,latitude,longitude,effort_hrs,sp1,sp2
L001,40.10,-3.10,1.5,0,1
L002,40.20,-3.20,2.0,X,0
L003,40.30,-3.30,NA,1,0
L002,40.20,-3.20,2.0,1,1
L004,40.40,-3.40,0.5,3,0
L005,,-3.50,1.0,0,0
L006,40.60,-3.60,1.0,x,X
L007,40.70,-3.70,abc,0,1
"""
NO_L007 = "\n".join(ln for ln in MESSY_CSV.splitlines() if "L007" not in ln) + "\n"
HALF_NA = "latitude,longitude,effort_hrs,sp\n" + "".join(
    f"40.{i},-3.0,NA,1\n" if i % 2 == 0 else f"40.{i},-3.0,1.0,1\n" for i in range(10))
BLANK_IDS = ("checklist_id,latitude,longitude,effort_hrs,sp\nG001,40.1,-3.1,1.0,1\n"
             ",40.2,-3.2,1.0,0\n,40.3,-3.3,1.0,1\nG001,40.1,-3.1,1.0,1\n,40.4,-3.4,1.0,0\n")


def _mixed_scale():
    rng = np.random.default_rng(11)
    lines = ["latitude,longitude,effort_hrs,elevation,sp"]
    for _ in range(200):
        lines.append(f"{rng.uniform(40, 41):.6f},{rng.uniform(-3, -2):.6f},"
                     f"{rng.gamma(2.0, 1.0):.4f},{rng.normal(500.0, 120.0):.2f},"
                     f"{int(rng.uniform() < 0.3)}")
    return "\n".join(lines) + "\n"


# case -> (file text, or None for the proxy round trip; loader keywords)
CASES = {
    "round_trip": (None, dict(species_cols=["species_common", "species_scarce"],
                              covariate_cols=("effort", "elevation"))),
    "mixed_scale": (_mixed_scale(), dict(species_cols=["sp"],
                                         covariate_cols=("effort_hrs", "elevation"))),
    "empty": ("latitude,longitude,effort_hrs,sp\n", dict(species_cols=["sp"])),
    "missing_species": (MESSY_CSV, dict(species_cols=["sp1", "sp9"])),
    "missing_lat": (MESSY_CSV, dict(species_cols=["sp1"], lat_col="lat_wrong")),
    "na_error": (MESSY_CSV, dict(species_cols=["sp1", "sp2"])),
    "unparseable": (MESSY_CSV, dict(species_cols=["sp1", "sp2"], na_policy="drop",
                                    checklist_id_col="checklist_id")),
    "drop_x_clamped_duplicates": (NO_L007, dict(species_cols=["sp1", "sp2"], na_policy="drop",
                                                checklist_id_col="checklist_id")),
    "max_rows": (HALF_NA, dict(species_cols=["sp"], na_policy="drop", max_rows=6)),
    "negative_count": ("latitude,longitude,effort_hrs,sp\n40.0,-3.0,1.0,-2\n",
                       dict(species_cols=["sp"])),
    "non_finite": ("latitude,longitude,effort_hrs,sp\n-Inf,-3.0,1.0,1\n",
                   dict(species_cols=["sp"])),
    "blank_ids": (BLANK_IDS, dict(species_cols=["sp"], checklist_id_col="checklist_id")),
    "bad_policy": (NO_L007, dict(species_cols=["sp1"], na_policy="skip")),
}


def _load(loader, path, kw):
    try:
        return ("ok", loader(path, **kw))
    except Exception as e:  # compared across the packages below
        return ("raised", type(e), str(e))


@pytest.mark.parametrize("case", sorted(CASES))
def test_csv_loader_is_the_twins(case, tmp_path):
    text, kw = CASES[case]
    path = str(tmp_path / f"{case}.csv")
    if text is None:
        jebird.write_presence_absence_csv(path, jebird.make_ebird_proxy(n=256, seed=1))
    else:
        with open(path, "w") as f:
            f.write(text)
    mine, twin = _load(ebird.load_presence_absence_csv, path, kw), _load(
        jebird.load_presence_absence_csv, path, kw)
    assert mine[0] == twin[0], (mine, twin)
    if mine[0] == "raised":
        assert mine[1:] == twin[1:]
        return
    got, want = mine[1], twin[1]
    for f in ("y", "x", "coords"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("covariate_names", "species_names", "n_dropped_na", "n_dropped_duplicates"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("n,seed", [(64, 0), (300, 4)])
def test_csv_writer_writes_the_twins_bytes(n, seed, tmp_path):
    data = ebird.make_ebird_proxy(n=n, seed=seed)
    mine, twin = str(tmp_path / "mine.csv"), str(tmp_path / "twin.csv")
    ebird.write_presence_absence_csv(mine, data)
    jebird.write_presence_absence_csv(twin, jebird.PresenceAbsenceData(*data))
    with open(mine, "rb") as a, open(twin, "rb") as b:
        assert a.read() == b.read()
    back = ebird.load_presence_absence_csv(mine, list(data.species_names),
                                           covariate_cols=("effort", "elevation"))
    assert np.array_equal(back.y, data.y) and back.x.shape == data.x.shape


@pytest.mark.parametrize("kw", [{}, dict(n=96, q=2, p=3, t=5)])
def test_tiny_binary_problem_has_the_twins_shapes_and_construction(kw):
    mine = tiny_binary_problem(seed=5, **kw)
    twin = jsynthetic.tiny_binary_problem(seed=5, **kw)
    for a, b in zip(mine, twin):
        assert a.shape == b.shape and a.dtype == np.float32 and a.dtype == b.dtype
    y, x, coords, ct, xt = mine
    assert set(np.unique(y)) <= {0.0, 1.0} and np.all(x[..., 0] == 1.0)
    assert np.all(xt == 1.0) and coords.min() >= 0.0 and coords.max() <= 1.0
    assert ct.min() >= 0.0 and ct.max() <= 1.0
    again, other = tiny_binary_problem(seed=5, **kw), tiny_binary_problem(seed=6, **kw)
    assert all(np.array_equal(a, b) for a, b in zip(mine, again))
    assert not np.array_equal(mine[2], other[2])


def test_dcn_worker_problem_is_tiny_binary_problem():
    want = tiny_binary_problem(seed=11, n=dcn_worker.K * dcn_worker.M, q=dcn_worker.Q,
                               p=dcn_worker.P, t=dcn_worker.T)
    assert all(np.array_equal(a, b) for a, b in zip(dcn_worker.problem(), want))


# (config keywords, n_iters, collect, with_calls)
COUNT_CASES = {
    "burn": (dict(n_subsets=4, n_samples=16), 6, False, False),
    "collect-every2-calls": (dict(n_subsets=4, n_samples=16, phi_update_every=2), 6, True,
                             True),
}


@pytest.fixture(scope="module")
def counts():
    jp, ct, xt, key = _problem()
    out = {}
    for name, (kw, n_iters, collect, with_calls) in COUNT_CASES.items():
        twin = jexec.count_subset_factorizations(
            JaxSampler(JaxConfig(**kw)), jp, ct, xt, key, n_iters=n_iters, collect=collect,
            with_calls=with_calls)
        cfg = SMKConfig(**kw)
        part = convert.partition_from_numpy(jp, device="cpu")
        mine = executor.count_subset_factorizations(
            SpatialGPSampler(cfg), part, torch.as_tensor(np.array(ct)),
            torch.as_tensor(np.array(xt)), replay(key, cfg, 4, part.subset_size),
            n_iters=n_iters, collect=collect, with_calls=with_calls)
        out[name] = (twin, mine)
    return out


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_count_subset_factorizations_is_the_twins(counts, case):
    (j_acc, j_cnt), (acc, cnt) = counts[case]
    if COUNT_CASES[case][3]:
        assert len(cnt) == 2
        for a, b in zip(cnt, j_cnt):
            assert a.dtype == torch.int64 and np.array_equal(a.numpy(), np.asarray(b))
    else:
        assert np.array_equal(cnt.numpy(), np.asarray(j_cnt))
    assert acc.shape == j_acc.shape
    np.testing.assert_allclose(acc.numpy(), np.asarray(j_acc), atol=5e-5, rtol=5e-5)


def test_count_subset_factorizations_refuses_chains_as_the_twin():
    y, x, coords, ct, xt = tiny_binary_problem(seed=1, n=32)
    part = random_partition(torch.arange(32), *map(torch.as_tensor, (y, x, coords)), 2)
    cfg = SMKConfig(n_subsets=2, n_samples=8, n_chains=2)
    with pytest.raises(ValueError, match="single-chain") as mine:
        executor.count_subset_factorizations(SpatialGPSampler(cfg), part, torch.as_tensor(ct),
                                             torch.as_tensor(xt), n_iters=2)
    with pytest.raises(ValueError) as twin:
        jexec.count_subset_factorizations(
            JaxSampler(JaxConfig(n_subsets=2, n_samples=8, n_chains=2)), None, None, None,
            None, n_iters=2)
    assert str(mine.value) == str(twin.value)
