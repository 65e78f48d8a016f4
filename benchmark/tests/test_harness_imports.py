"""Nothing the benchmark runs imports JAX, the JAX package, bench.py or
chip_smoke.py (top-level module names compared whole), and the
yardstick's modules import nothing of the port."""

# smklint: test-budget=AST scans, and one run at the small CPU shapes in a fresh interpreter (about 10 s)

import ast
import subprocess
import sys

import pytest

from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "smk_tpu", "bench", "chip_smoke"}
YARDSTICK = ["data.py", "noise.py", "reference.py", "judge.py", "work.py", "trace.py",
             "window.py", "spec.py"]


def top_imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(spec.BENCH.rglob("*.py")), ids=lambda p: p.name)
def test_no_forbidden_import(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "smk_torch" not in top_imports(spec.BENCH / "harness" / name)


def test_names_compared_whole():
    import run

    assert run.forbidden_modules() == [] or "smk_tpu" not in sys.modules
    fake = {"jaxtyping": None, "smk_tpu_extra": None, "smk_torch": None}
    saved = {k: sys.modules.get(k) for k in fake}
    try:
        sys.modules.update(fake)
        assert not {"jaxtyping", "smk_tpu_extra", "smk_torch"} & set(run.forbidden_modules())
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from _tiny import run_cpu\n"
        "res, _ = run_cpu('config4.fit')\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & %r)\n"
        "print('BAD', bad, res['correct'])\n"
    ) % (str(spec.BENCH / "tests"), str(spec.BENCH), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(spec.ROOT))
    assert "BAD [] True" in out.stdout, out.stderr[-2000:]
