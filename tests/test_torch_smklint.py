"""The port's smklint (smk_torch/analysis: engine.py, rules.py, lint.py)
against the JAX package's (smk_tpu/analysis).

- Parity: for the rules ported with the twin's semantics (SMK107, 108,
  110, 111, 113, 115, 116, 117, 118, 119), every source the twin's own
  tests (tests/test_smklint.py) lint — fixtures, real modules and their
  seeded defects — is linted by both engines, the twin's on its
  ``smk_tpu/...`` path, the port's on the ``smk_torch/...`` twin path
  (and the source's ``smk_tpu`` names renamed): the same
  ``(id, line)`` findings of those rules. The sources are collected by
  running the twin's test classes with its ``lint_source`` wrapped.
- The torch rules (SMK102, 103, 109, 112, 114, 120): positive and
  negative cases of their own, the captured-code scope of SMK103
  included, and seeded defects on the port's real modules.
- The tree gate: the port's lint of smk_torch/, chip_smoke.py and
  scripts/torch_*.py is empty; every suppression carries a reason.
- The CLI's exit codes, and RULES.md naming every twin id.
"""

# smklint: test-budget=pure stdlib AST work on in-memory sources (the twin's fixtures re-linted by both engines, a few hundred ms a class); the tree-wide sweep ~5 s; one CLI subprocess with no torch import
import inspect
import os
import re
import subprocess
import sys

import pytest

import test_smklint as twin_tests
from smk_torch.analysis import engine, lint, rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARITY_RULES = {"SMK107", "SMK108", "SMK110", "SMK111", "SMK113", "SMK115", "SMK116",
                "SMK117", "SMK118", "SMK119"}
PARITY_CLASSES = ["TestUnusedImport", "TestFaultInjectionZone", "TestTelemetryDiscipline",
                  "TestUnboundedWait", "TestAtomicWrite", "TestLadderDiscipline",
                  "TestBoundedCoalesceWait", "TestDeviceLayout", "TestScheduleDiscipline",
                  "TestGenerationPublicationRule"]


def _param_sets(fn):
    """The argument dicts of a method's parametrize marks (one empty dict
    for an unparametrized method)."""
    sets = [{}]
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        new = []
        for base in sets:
            for vals in mark.args[1]:
                vals = vals if len(names) > 1 else (vals,)
                new.append({**base, **dict(zip(names, vals))})
        sets = new
    return sets


def _twin_sources(cls_name, monkeypatch):
    """Every distinct (source, path, kwargs) the twin's test class lints,
    with the twin engine's findings."""
    seen = {}
    real = twin_tests.lint_source

    def recorder(source, path="<memory>/smk_tpu/fixture.py", **kw):
        key = (source, path, tuple(sorted(kw.items())))
        if key not in seen:
            seen[key] = real(source, path=path, **kw)
        return seen[key]

    monkeypatch.setattr(twin_tests, "lint_source", recorder)
    cls = getattr(twin_tests, cls_name)
    for name, fn in sorted(vars(cls).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        params = [p for p in inspect.signature(fn).parameters if p != "self"]
        for args in _param_sets(fn):
            assert set(params) <= set(args), (cls_name, name, params)
            fn(cls(), **args)
    return [(src, path, dict(kw), found) for (src, path, kw), found in seen.items()]


def _port(text):
    return text.replace("smk_tpu", "smk_torch")


def _hits(findings):
    return sorted((f.rule, f.line) for f in findings if f.rule in PARITY_RULES)


@pytest.mark.parametrize("cls_name", PARITY_CLASSES)
def test_ported_rules_match_the_twin_on_its_own_sources(cls_name, monkeypatch):
    sources = _twin_sources(cls_name, monkeypatch)
    assert len(sources) >= 3
    n_hit = 0
    for source, path, kw, found in sources:
        want = _hits(found)
        got = _hits(engine.lint_source(_port(source), path=_port(path), **kw))
        assert got == want, (cls_name, path, source[:300])
        n_hit += bool(want)
    assert n_hit >= 1  # the class's positives reached both engines


# -- the torch rules ---------------------------------------------------------
MODELS = "smk_torch/models/fixture.py"
DATA = "smk_torch/data/fixture.py"


def _ids(src, path=MODELS):
    return [f.rule for f in engine.lint_source(src, path=path)]


def _lines(src, rule, path=MODELS):
    return [f.line for f in engine.lint_source(src, path=path) if f.rule == rule]


@pytest.mark.parametrize("src, hit", [
    ("import torch\nz = torch.randn(3)\n", True),
    ("import torch\nz = torch.rand((3,), device='cpu')\n", True),
    ("import torch\ni = torch.randint(0, 5, (3,))\n", True),
    ("import torch\np = torch.randperm(9)\n", True),
    ("import torch\nb = torch.bernoulli(torch.full((3,), 0.5))\n", True),
    ("import torch\nm = torch.multinomial(torch.ones(3), 2)\n", True),
    ("import torch\nt = torch.empty(3)\nt.uniform_()\n", True),
    ("import torch\nt = torch.empty(3)\nt.normal_(0.0, 1.0)\n", True),
    ("import torch\ntorch.manual_seed(0)\n", True),
    ("import torch\ntorch.seed()\n", True),
    ("import numpy as np\nz = np.random.normal(size=3)\n", True),
    ("import random\nz = random.random()\n", True),
    ("import time\nimport torch\ng = torch.Generator().manual_seed(int(time.time()))\n", True),
    ("import numpy as np\nrng = np.random.default_rng()\n", True),
    # an explicit generator is the contract
    ("import torch\ng = torch.Generator()\nz = torch.randn(3, generator=g)\n", False),
    ("import torch\ng = torch.Generator()\nt = torch.empty(3)\nt.uniform_(generator=g)\n",
     False),
    ("import torch\ng = torch.Generator()\ng.manual_seed(7)\n", False),
    ("import numpy as np\nrng = np.random.default_rng(3)\nz = rng.normal(size=3)\n", False),
])
def test_host_nondeterminism_torch(src, hit):
    assert ("SMK102" in _ids(src)) is hit
    assert "SMK102" not in _ids(src, path="scripts/fixture.py")


def test_host_nondeterminism_zones():
    # outside the sampler/ops/parallel zones the torch samplers are not
    # the fit's; numpy's global state is flagged everywhere in smk_torch/
    assert "SMK102" not in _ids("import torch\nz = torch.randn(3)\n", path=DATA)
    assert "SMK102" in _ids("import numpy as np\nnp.random.seed(0)\n", path=DATA)


CAPTURED = (
    "import torch\n"
    "class S:\n"
    "    # smklint: captured\n"
    "    def body(self, x):\n"
    "        return self.step(x)\n"
    "    def step(self, x):\n"
    "        {stmt}\n"
    "        return x\n"
    "    def host(self, x):\n"
    "        return x.sum().item()\n"
)


@pytest.mark.parametrize("stmt, hit", [
    ("v = x.sum().item()", True),
    ("v = x.tolist()", True),
    ("v = x.cpu()", True),
    ("v = x.numpy()", True),
    ("torch.cuda.synchronize()", True),
    ("v = float(torch.max(x))", True),
    ("v = bool(torch.isfinite(x).all())", True),
    ("if torch.any(x > 0): x = x + 1", True),
    ("assert torch.all(x > 0)", True),
    ("v = x.to('cpu', non_blocking=True)", False),
    ("v = torch.where(x > 0, x, 0.0)", False),
    ("v = int(x.shape[0])", False),
    ("if x.dim() == 2: x = x + 1", False),
])
def test_host_sync_in_captured_code(stmt, hit):
    src = CAPTURED.replace("{stmt}", stmt)
    assert (_lines(src, "SMK103") == [7]) is hit
    # the same code unmarked is host code: nothing to capture
    assert "SMK103" not in _ids(src.replace("    # smklint: captured\n", "    #\n"))


def test_captured_scope_follows_nesting_and_names():
    src = (
        "import torch\n"
        "def helper(x):\n"
        "    return x.item()\n"
        "def make():\n"
        "    # smklint: captured\n"
        "    def fn(x):\n"
        "        return inner(x) + helper(x)\n"
        "    def inner(x):\n"
        "        return x\n"
        "    return fn\n"
    )
    assert _lines(src, "SMK103") == [3]


def test_real_sampler_clean_and_seeded_defect_caught():
    real = "smk_torch/models/probit_gp.py"
    src = open(os.path.join(REPO, real)).read()
    module = engine.parse_module(real, source=src, known_ids={r.id for r in rules.ALL_RULES})
    names = {getattr(f, "name", None) for f in rules.captured_functions(module)}
    assert {"_sweeps", "_gibbs_step", "_collapsed_update", "fn"} <= names
    assert _ids(src, path=real) == []
    i = src.index("    def _gibbs_step(")
    j = src.index("\n", src.index('"""', src.index('"""', i) + 3)) + 1
    broken = src[:j] + "        _ = state.phi.sum().item()\n" + src[j:]
    assert _lines(broken, "SMK103", path=real) == [src[:j].count("\n") + 1]


@pytest.mark.parametrize("src, hit", [
    ("import os\nos.environ['SMK_TORCH_BUILD_DIR'] = '/tmp/b'\n", True),
    ("import os\nos.environ.setdefault('SMK_TORCH_BUILD_DIR', '/tmp/b')\n", True),
    ("import os\nos.putenv('SMK_TORCH_BUILD_DIR', '/tmp/b')\n", True),
    ("import os\nos.environ.update({'SMK_TORCH_BUILD_DIR': '/tmp/b'})\n", True),
    ("from smk_torch.compile import xla_cache\nxla_cache._ARMED = '/tmp/b'\n", True),
    ("import os\nd = os.environ.get('SMK_TORCH_BUILD_DIR')\n", False),
    ("import os\nos.environ['OMP_NUM_THREADS'] = '1'\n", False),
    ("from smk_torch.compile import xla_cache\nxla_cache.enable_persistent_cache('/tmp/b')\n",
     False),
])
def test_compile_cache_config_torch(src, hit):
    assert ("SMK109" in _ids(src, path="smk_torch/parallel/fixture.py")) is hit
    # the helper's home and the build module are the sanctioned writers
    assert "SMK109" not in _ids(src, path="smk_torch/compile/xla_cache.py")
    assert "SMK109" not in _ids(src, path="smk_torch/ops/cuda_build.py")
    assert "SMK109" not in _ids(src, path="scripts/fixture.py")


@pytest.mark.parametrize("src, hit", [
    ("from smk_torch.parallel.executor import Mesh\nm = Mesh([], ('subsets',))\n", True),
    ("from smk_torch.parallel.executor import MeshEntry\ne = MeshEntry(0, 'cpu', 0, 'cpu')\n",
     True),
    ("from smk_torch.parallel import executor\nm = executor.Mesh([], ('k',))\n", True),
    ("from smk_torch.parallel.executor import make_mesh\nm = make_mesh(2, device='cpu')\n",
     False),
    ("from smk_torch.parallel import executor\nm = executor.sub_mesh(x, 1)\n", False),
])
def test_mesh_hygiene_torch(src, hit):
    assert ("SMK112" in _ids(src, path="smk_torch/api.py")) is hit
    assert "SMK112" not in _ids(src, path="smk_torch/parallel/executor.py")
    assert "SMK112" not in _ids(src, path="tests/test_fixture_virtual.py")


SERVE = "smk_torch/serve/fixture.py"


@pytest.mark.parametrize("src, hit", [
    ("from smk_torch.serve.engine import _invoke_program\n"
     "def serve_one(prog, key, args):\n"
     "    return _invoke_program(prog, key, *args)\n", True),
    ("import torch\ndef wait():\n    torch.cuda.synchronize()\n", True),
    ("def wait(ev):\n    ev.synchronize()\n", True),
    ("from smk_torch.utils.tracing import device_sync\ndef wait(x):\n    device_sync(x)\n",
     True),
    ("from smk_torch.serve.deadline import run_under_deadline\n"
     "from smk_torch.serve.engine import _invoke_program\n"
     "def serve_one(prog, key, args, budget):\n"
     "    def worker():\n"
     "        return _invoke_program(prog, key, *args)\n"
     "    return run_under_deadline(worker, budget)\n", False),
    ("import torch\n"
     "def serve_one(watchdog, budget):\n"
     "    return watchdog.run(lambda: torch.cuda.synchronize(), budget)\n", False),
])
def test_deadline_discipline_torch(src, hit):
    assert ("SMK114" in _ids(src, path=SERVE)) is hit
    assert "SMK114" not in _ids(src, path=MODELS)


def test_real_engine_clean_and_seeded_defect_caught():
    real = "smk_torch/serve/engine.py"
    src = open(os.path.join(REPO, real)).read()
    assert "SMK114" not in _ids(src, path=real)
    broken = src + "\n\ndef _sneaky(prog, key):\n    return _invoke_program(prog, key)\n"
    assert "SMK114" in _ids(broken, path=real)


@pytest.mark.parametrize("src, hit", [
    ("from smk_torch.ops.chol import shifted_cholesky\n"
     "def step(r, s):\n    return shifted_cholesky(r, s)\n", True),
    ("from smk_torch.ops import chol\n"
     "def step(r, s):\n    return chol.blocked_cholesky(r, s, 256)\n", True),
    ("from smk_torch.ops.chol import batched_shifted_cholesky as bsc\n"
     "def step(r, s):\n    return bsc(r, s)\n", True),
    ("from smk_torch.ops.chol import shifted_cholesky\n"
     "class S:\n    def _shifted_chol_one(self, r, s):\n        return shifted_cholesky(r, s)\n",
     False),
    ("from smk_torch.ops.chol import cholesky, jittered_cholesky\n"
     "def step(r):\n    return cholesky(r), jittered_cholesky(r)\n", False),
])
def test_engine_dispatch_torch(src, hit):
    assert ("SMK120" in _ids(src, path=MODELS)) is hit
    assert "SMK120" not in _ids(src, path="smk_torch/ops/fixture.py")


def test_real_sampler_engine_seam_and_seeded_defect():
    real = "smk_torch/models/probit_gp.py"
    src = open(os.path.join(REPO, real)).read()
    assert "SMK120" not in _ids(src, path=real)
    broken = src + "\n\ndef _direct(r, s):\n    return shifted_cholesky(r, s)\n"
    assert "SMK120" in _ids(broken, path=real)


def test_suppressions_and_the_captured_directive():
    justified = ("import torch\n# smklint: disable=SMK102 -- fixture\nz = torch.randn(3)\n")
    assert _ids(justified) == []
    bare = "import torch\nz = torch.randn(3)  # smklint: disable=SMK102\n"
    assert _ids(bare) == ["SMK100"]
    # a twin-only id is unknown to the port: its suppression is a finding
    assert _ids("x = 1  # smklint: disable=SMK104 -- twin rule\n") == ["SMK100"]
    stale = "# smklint: disable=SMK110 -- nothing here\nx = 1\n"
    assert _ids(stale) == ["SMK100"]
    assert _ids("# smklint: captured\ndef f(x):\n    return x\n") == []


# -- the tree gate, the CLI, the catalogue -----------------------------------
def _targets():
    scripts = sorted(os.path.join(REPO, "scripts", n) for n in os.listdir(
        os.path.join(REPO, "scripts")) if n.startswith("torch_") and n.endswith(".py"))
    return [os.path.join(REPO, "smk_torch"), os.path.join(REPO, "chip_smoke.py")] + scripts


def test_port_tree_lints_clean():
    findings = engine.lint_paths(_targets(), repo_root=REPO)
    assert findings == [], "\n".join(f.render() for f in findings)
    # every suppression in the tree carries its reason
    for path in engine._iter_py_files(_targets()):
        source = open(path, encoding="utf-8").read()
        for i, comment in engine._comment_tokens(source, source.splitlines()):
            if re.search(r"#\s*smklint:\s*disable", comment):
                assert re.search(r"--\s*\S", comment), f"{path}:{i}"


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "smk_torch" / "models"
    bad.mkdir(parents=True)
    (bad / "m.py").write_text("import torch\nx = torch.randn(3)\n")
    out = subprocess.run([sys.executable, "-m", "smk_torch.analysis.lint", str(bad / "m.py")],
                         capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 1 and "SMK102" in out.stdout
    (bad / "m.py").write_text("import torch\ng = torch.Generator()\nx = torch.randn(3, generator=g)\n")
    assert lint.main([str(bad / "m.py")]) == 0
    assert "clean" in capsys.readouterr().out
    assert lint.main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert "SMK103" in listed and "SMK101 (not ported)" in listed
    assert lint.main(["--select", "SMK999", "x.py"]) == 2
    assert lint.main([str(tmp_path / "no_such_dir")]) == 2
    assert lint.main([]) == 2


def test_every_twin_rule_is_ported_or_listed():
    from smk_tpu.analysis.rules import ALL_RULES as TWIN_RULES

    twin_ids = {r.id for r in TWIN_RULES}
    port_ids = {r.id for r in rules.ALL_RULES}
    assert port_ids | set(rules.NOT_PORTED) == twin_ids
    assert not port_ids & set(rules.NOT_PORTED)
    text = open(os.path.join(REPO, "smk_torch", "analysis", "RULES.md")).read()
    for rid in twin_ids:
        assert rid in text, rid
    for rid in rules.NOT_PORTED:
        assert re.search(rf"{rid}.*not ported", text), rid
