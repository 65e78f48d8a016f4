"""Small shared synthetic problems — the port's counterpart of
``smk_tpu/data/synthetic.py``.

``tiny_binary_problem`` is the one fixed-seed toy problem of the
multi-process worker (testing/dcn_worker.py) and of its one-process
reference in the tests: both must build the same bytes (the two-process
tests compare digests across processes), so the construction lives here
once. It is deterministic in ``seed`` through numpy's generator; it does
not reproduce the twin's arrays, which come from JAX's generator.
"""

from __future__ import annotations

import numpy as np


def tiny_binary_problem(seed: int = 0, n: int = 240, q: int = 1, p: int = 2, t: int = 6):
    """(y, x, coords, coords_test, x_test) for a tiny binary fit, float32
    numpy arrays: coords (n, 2) uniform on the unit square; x (n, q, p),
    an intercept column of ones and standard normals; y (n, q)
    Bernoulli(0.5) noise (these problems exercise plumbing, not
    statistical recovery); coords_test (t, 2) uniform; x_test (t, q, p)
    ones. Drawn in that order from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    x = np.concatenate([np.ones((n, q, 1)), rng.normal(size=(n, q, p - 1))],
                       -1).astype(np.float32)
    y = (rng.uniform(size=(n, q)) < 0.5).astype(np.float32)
    coords_test = rng.uniform(size=(t, 2)).astype(np.float32)
    x_test = np.ones((t, q, p), np.float32)
    return y, x, coords, coords_test, x_test
