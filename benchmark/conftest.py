"""pytest settings of the benchmark's own tests (benchmark/tests): the
checkout and the benchmark directory on the path, and the fixture that
decides, when a test runs, whether a card is there."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA device; skips the test where none is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check's control runs on the card")
    return torch.device("cuda", 0)
