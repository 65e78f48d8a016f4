"""The port's public surface against the JAX package's (ROADMAP C6):
for the top level and each subpackage, every name in the twin's
``__all__`` is in the port's ``__all__`` and resolves, or stands in that
package's ``NOT_PORTED`` with a reason (which may also list a JAX-only
public name of the twin's modules, as the trace scopes); and the port
exports nothing the twin lacks but the names its README lists (the top
level's randomness objects and ``param_names``, the serving manifest
name and ``hash_row_noise``, the ragged-mesh planner's types,
``GraphProgram`` and ``STORE_FORMAT``)."""

# smklint: test-budget=imports of both packages' __init__ modules and attribute lookups; no fit, well under a second a package
import importlib
import pkgutil

import pytest

PACKAGES = ["", "ops", "parallel", "models", "data", "utils", "serve", "obs", "compile",
            "testing", "analysis"]

# the port's own exports, as README.md lists them
PORT_ONLY = {
    "": {"FitRandomness", "TorchRandomness", "param_names"},
    "serve": {"GENERATION_MANIFEST", "hash_row_noise"},
    "compile": {"RaggedMeshEntry", "RaggedMeshPlan", "plan_ragged_mesh", "GraphProgram",
                "STORE_FORMAT"},
}


def _pkg(root, sub):
    return importlib.import_module(root + ("." + sub if sub else ""))


def _twin_has(twin, name) -> bool:
    """``name`` is public in the twin package or in one of its modules."""
    if name in getattr(twin, "__all__", []) or hasattr(twin, name):
        return True
    for info in pkgutil.iter_modules(getattr(twin, "__path__", [])):
        mod = importlib.import_module(f"{twin.__name__}.{info.name}")
        if hasattr(mod, name):
            return True
    return False


@pytest.mark.parametrize("sub", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_public_surface_matches_the_twin(sub):
    twin, port = _pkg("smk_tpu", sub), _pkg("smk_torch", sub)
    twin_all = list(getattr(twin, "__all__", []))
    port_all = set(getattr(port, "__all__", []))
    not_ported = getattr(port, "NOT_PORTED", {})
    for name, why in not_ported.items():
        assert _twin_has(twin, name) and name not in port_all, name
        assert isinstance(why, str) and len(why) > 20, name
    missing = [n for n in twin_all if n not in port_all and n not in not_ported]
    assert missing == []
    for name in port_all:
        assert getattr(port, name) is not None, name
    extra = port_all - set(twin_all)
    assert extra == PORT_ONLY.get(sub, set())
