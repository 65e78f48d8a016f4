"""The port's ragged partition math against the JAX twin, exactly: the
bucket ladder (smk_torch/compile/buckets.py), the Morton partitioner
and the padded partition (smk_torch/parallel/partition.py), each typed
rejection with the twin's message; and the config's ladder check,
which goes through the bucket module. (Coherent fits, through the
chunked executor's ragged fan-out: tests/test_torch_ragged_fit.py.)

Inputs are numpy arrays from seeded generators; uniform, clustered and
three-dimensional coordinates, subset counts from 1 to 13.
"""

# smklint: test-budget=pure host arithmetic on n <= 500 rows; each JAX gather is one small jitted call
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.compile import buckets as jb
from smk_tpu.parallel import partition as jpart
from smk_torch import SMKConfig, config
from smk_torch.compile import buckets as tb
from smk_torch.parallel import partition as tpart


def _same_outcome(fn_twin, fn_port, *args, **kwargs):
    """Both return equal values, or both raise ValueError with one
    message."""
    try:
        want = fn_twin(*args, **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port(*args, **kwargs)
        assert str(got.value) == str(e)
        return None
    got = fn_port(*args, **kwargs)
    assert got == want
    return got


# ----------------------------------------------------------------------
# compile/buckets.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("max_size, min_bucket",
                         [(1, 8), (8, 8), (9, 8), (100, 8), (3906, 8), (4097, 8), (7812, 64),
                          (5, 1), (1000, 3), (0, 8), (10, 0)])
def test_bucket_ladder_matches_twin(max_size, min_bucket):
    _same_outcome(jb.bucket_ladder, tb.bucket_ladder, max_size, min_bucket=min_bucket)


LADDER = (8, 11, 16, 23, 32, 45, 64)


@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 63, 64, 65, 0, -3])
def test_select_bucket_and_bucket_for_match_twin(n):
    assert tb.select_bucket(n, LADDER) == jb.select_bucket(n, LADDER)
    _same_outcome(jb.bucket_for, tb.bucket_for, n, LADDER)


@pytest.mark.parametrize("ladder", [
    (8, 16, 32), [4], 7, 7.0, np.array([3, 9]), "8,16", b"8", (), (0, 4), (4, 4), (8, 4),
    ("a",), None, 3.5,
])
def test_validate_ladder_matches_twin(ladder):
    try:
        want = jb.validate_ladder(ladder)
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            tb.validate_ladder(ladder)
        assert str(got.value) == str(e)
        return
    assert tb.validate_ladder(ladder) == want


@pytest.mark.parametrize("sizes, buckets", [
    ((5, 9, 16), (8, 11, 16)), ((), ()), ((3,), (4, 8)), ((9,), (8,)), ((8, 8), (8, 8)),
])
def test_pad_accounting_matches_twin(sizes, buckets):
    _same_outcome(jb.pad_accounting, tb.pad_accounting, sizes, buckets)


def test_config_checks_its_ladder_through_the_bucket_module():
    """One ladder rule in the port: SMKConfig normalizes and rejects
    bucket_ladder with compile/buckets.validate_ladder."""
    assert config.validate_ladder is tb.validate_ladder
    assert not hasattr(config, "_validate_ladder")
    assert SMKConfig(bucket_ladder=64).bucket_ladder == (64,)
    assert SMKConfig(bucket_ladder=[8, 16.0]).bucket_ladder == (8, 16)
    with pytest.raises(ValueError, match="strictly ascending"):
        SMKConfig(bucket_ladder=(16, 8))


# ----------------------------------------------------------------------
# parallel/partition.py
# ----------------------------------------------------------------------
def _coords(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(size=(n, 2))
    if kind == "clustered":
        centers = rng.uniform(size=(3, 2))
        return centers[rng.integers(0, 3, n)] + 0.02 * rng.normal(size=(n, 2))
    if kind == "3d":
        return rng.uniform(-5.0, 5.0, size=(n, 3))
    return np.zeros((n, 2))  # "constant": every span zero


@pytest.mark.parametrize("kind", ["uniform", "clustered", "3d"])
def test_morton_codes_match_twin(kind):
    c = _coords(kind, 300, 1)
    lo, span = c.min(0) + 0.1, np.ptp(c, 0) * 0.7  # some rows fall outside the frame
    for bits in (16, 5):
        got = tpart.morton_codes(c, lo=lo, span=span, bits=bits)
        want = jpart.morton_codes(c, lo=lo, span=span, bits=bits)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind, n, k, cell_bits", [
    ("uniform", 500, 7, None), ("uniform", 500, 1, None), ("clustered", 400, 13, None),
    ("3d", 300, 5, None), ("uniform", 257, 4, 1), ("uniform", 100, 100, None),
    ("constant", 50, 3, None), ("uniform", 200, 6, 30),
])
def test_coherent_assignments_match_twin(kind, n, k, cell_bits):
    c = _coords(kind, n, 2).astype(np.float32)
    got = tpart.coherent_assignments(c, k, cell_bits=cell_bits)
    want = jpart.coherent_assignments(c, k, cell_bits=cell_bits)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("coords, k", [(np.zeros((5,)), 2), (np.zeros((5, 2)), 0),
                                       (np.zeros((5, 2)), 6)])
def test_coherent_assignments_rejects_like_twin(coords, k):
    with pytest.raises(ValueError) as want:
        jpart.coherent_assignments(coords, k)
    with pytest.raises(ValueError) as got:
        tpart.coherent_assignments(coords, k)
    assert str(got.value) == str(want.value)


def _rows(n=300, q=2, p=2, seed=3):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(n, q)) < 0.5).astype(np.float32)
    x = rng.normal(size=(n, q, p)).astype(np.float32)
    coords = _coords("clustered", n, seed).astype(np.float32)
    return y, x, coords


def _assert_same_partition(got: tpart.PaddedPartition, want):
    assert got.sizes == want.sizes and got.ladder == want.ladder
    assert got.buckets == want.buckets
    assert got.bucket_of_subset == want.bucket_of_subset
    assert got.pad_summary() == want.pad_summary()
    assert got.n_subsets == want.n_subsets
    for g, w in zip(got.groups, want.groups, strict=True):
        assert (g.bucket, g.subset_ids) == (w.bucket, w.subset_ids)
        for f in ("y", "x", "mask", "index"):
            np.testing.assert_array_equal(getattr(g.part, f).numpy(), np.asarray(getattr(w.part, f)),
                                          err_msg=f)
        # real rows exactly; the far-line pad coordinates far + i span 0.01
        # to one fp32 ulp, since XLA on the CPU contracts the multiply-add
        # into an FMA (one rounding where PyTorch rounds twice)
        real = g.part.mask.numpy() > 0
        got_c, want_c = g.part.coords.numpy(), np.asarray(w.part.coords)
        np.testing.assert_array_equal(got_c[real], want_c[real])
        np.testing.assert_allclose(got_c[~real], want_c[~real], rtol=1.2e-7, atol=0)
        assert g.part.subset_size == g.bucket


@pytest.mark.parametrize("ladder", [None, (32, 64, 128), 200])
def test_padded_partition_matches_twin(ladder):
    """Unequal subsets (one a rung exactly, one a row past a rung, one
    with a single row) grouped by bucket; the pad rows on the far line."""
    y, x, coords = _rows()
    rng = np.random.default_rng(4)
    perm = rng.permutation(y.shape[0])
    cuts = np.cumsum([64, 65, 1, 40, 100])
    assignments = np.split(perm, cuts)[:5]
    got = tpart.padded_partition(*map(torch.as_tensor, (y, x, coords)), assignments, ladder=ladder)
    want = jpart.padded_partition(*map(jnp.asarray, (y, x, coords)), assignments, ladder=ladder)
    _assert_same_partition(got, want)
    assert any(bool((g.part.mask == 0).any()) for g in got.groups)


@pytest.mark.parametrize("k", [1, 6, 11])
def test_coherent_partition_matches_twin(k):
    y, x, coords = _rows()
    got = tpart.coherent_partition(*map(torch.as_tensor, (y, x, coords)), k)
    want = jpart.coherent_partition(None, *map(jnp.asarray, (y, x, coords)), k)
    _assert_same_partition(got, want)
    rows = np.sort(np.concatenate([g.part.index[g.part.mask > 0].numpy() for g in got.groups]))
    np.testing.assert_array_equal(rows, np.arange(y.shape[0]))


@pytest.mark.parametrize("case", [
    "float_indices", "out_of_range", "negative", "one_based", "duplicate_across",
    "duplicate_within", "ladder_too_short", "no_subsets", "empty_subset", "bad_ladder",
])
def test_padded_partition_rejects_like_twin(case):
    y, x, coords = _rows(n=50)
    a = [np.arange(0, 20), np.arange(20, 50)]
    ladder = None
    if case == "float_indices":
        a = [np.arange(0, 20, dtype=np.float64), np.arange(20, 50)]
    elif case == "out_of_range":
        a = [np.arange(0, 20), np.arange(20, 51)]
    elif case == "negative":
        a = [np.arange(-1, 20), np.arange(20, 50)]
    elif case == "one_based":
        a = [np.arange(1, 21), np.arange(21, 51)]
    elif case == "duplicate_across":
        a = [np.arange(0, 21), np.arange(20, 50)]
    elif case == "duplicate_within":
        a = [np.array([0, 1, 1]), np.arange(20, 50)]
    elif case == "ladder_too_short":
        ladder = (8, 16, 23)
    elif case == "no_subsets":
        a = []
    elif case == "empty_subset":
        a = [np.arange(0, 20), np.arange(0)]
    elif case == "bad_ladder":
        ladder = (32, 16)
    with pytest.raises(ValueError) as want:
        jpart.padded_partition(*map(jnp.asarray, (y, x, coords)), a, ladder=ladder)
    with pytest.raises(ValueError) as got:
        tpart.padded_partition(*map(torch.as_tensor, (y, x, coords)), a, ladder=ladder)
    assert str(got.value) == str(want.value)
