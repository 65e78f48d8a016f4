"""The check's control on the card, at each cell's own size: the port
run with its own TF32 path on (SMKConfig.matmul_precision = "high", the
precision just below the configuration's float32 with TF32 off) must
come out not correct. Run on the card with

    python -m pytest benchmark/tests/test_harness_control.py -m gpu
"""

# smklint: test-budget=on the card only: one run at a cell's size, about 40 s each

import pytest

from harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2147483711, 2147483712, 2147483713])
def test_tf32_control_is_not_correct(card, cell, seed):
    import run

    res, lines = run.run(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                          "--trace", "0"], control="tf32")
    print(cell, seed, lines[-len(res["checks"]):])
    assert res["correct"] is False, lines
