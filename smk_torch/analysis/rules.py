"""smklint rules of the port — the JAX package's invariants that carry
over to PyTorch, each under its twin's id (see analysis/RULES.md for
the map: which ids are ported, which are JAX-only and why).

All rules are pure-AST (no torch import). Shared machinery:

- attribute-chain resolution (``torch.cuda.synchronize`` →
  ``("torch", "cuda", "synchronize")``);
- captured-context discovery (SMK103): functions marked
  ``# smklint: captured`` — the bodies a CUDA graph captures — plus
  everything they (transitively) call within the module, including
  ``self.<method>`` calls resolved by name.

A rule's zone is the ``smk_torch/`` twin of its twin rule's
``smk_torch/`` zone.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set, Tuple

from smk_torch.analysis.engine import Finding, LintContext, LintModule

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

_TORCH_ROOTS = {"torch"}
_NP_ROOTS = {"np", "numpy", "onp"}


def attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """("torch", "cuda", "synchronize") for torch.cuda.synchronize; ()
    when not a plain name/attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _contains_torch_call(node: ast.AST) -> bool:
    """Does this expression call into torch (i.e. can it yield a
    tensor)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain and chain[0] in _TORCH_ROOTS:
                return True
    return False


class _FuncIndex(ast.NodeVisitor):
    """Every FunctionDef/AsyncFunctionDef/Lambda in the module, with
    its enclosing function (for nesting propagation)."""

    def __init__(self):
        self.funcs: List[ast.AST] = []
        self.parent: dict = {}
        self.by_name: dict = {}
        self._stack: List[ast.AST] = []

    def _enter(self, node):
        self.funcs.append(node)
        self.parent[node] = self._stack[-1] if self._stack else None
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.by_name.setdefault(node.name, []).append(node)
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _enter
    visit_AsyncFunctionDef = _enter
    visit_Lambda = _enter

    def visit_Assign(self, node):
        # `body = lambda s: ...` — the lambda is reachable by the
        # assigned name
        if (
            len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Lambda)
        ):
            self.by_name.setdefault(
                node.targets[0].id, []
            ).append(node.value)
        self.generic_visit(node)


def captured_functions(module: LintModule) -> Set[ast.AST]:
    """Function nodes whose bodies a CUDA graph captures: defs marked
    ``# smklint: captured``, closed over nesting and over same-module
    calls (Name calls and self.<name> method calls, resolved by
    name)."""
    idx = _FuncIndex()
    idx.visit(module.tree)
    captured: Set[ast.AST] = {
        fn for fn in idx.funcs
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        and module.directive_near_def(fn, "captured")
    }
    changed = True
    while changed:
        changed = False
        for fn in idx.funcs:
            if fn in captured:
                continue
            parent = idx.parent.get(fn)
            if parent is not None and parent in captured:
                captured.add(fn)
                changed = True
        called: Set[str] = set()
        for fn in captured:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    chain = attr_chain(node.func)
                    if len(chain) == 1:
                        called.add(chain[0])
                    elif len(chain) == 2 and chain[0] == "self":
                        called.add(chain[1])
        for name in called:
            for fn in idx.by_name.get(name, []):
                if fn not in captured:
                    captured.add(fn)
                    changed = True
    return captured


def _own_nodes(fn: ast.AST, idx_funcs: Set[ast.AST]) -> Iterator[ast.AST]:
    """Walk fn's body without descending into nested function nodes
    (they are visited as their own captured entries)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ) and node in idx_funcs:
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _in_zone(module: LintModule, *zones: str) -> bool:
    norm = module.norm_path()
    return any(z in norm for z in zones)


class Rule:
    id = "SMK000"
    name = "abstract"
    doc = ""

    def applies(self, module: LintModule) -> bool:
        return True

    def check(
        self, module: LintModule, ctx: LintContext
    ) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, module: LintModule, node, msg: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(self.id, module.path, line, f"[{self.name}] {msg}")


# ---------------------------------------------------------------------------
# SMK102 — host nondeterminism
# ---------------------------------------------------------------------------

_LEGACY_NP_RANDOM = {
    "seed", "normal", "uniform", "rand", "randn", "randint",
    "random", "choice", "permutation", "shuffle", "binomial",
    "poisson", "gamma", "beta", "exponential", "standard_normal",
    "random_sample", "get_state", "set_state", "sample",
}
_STRICT_ZONES = (
    "smk_torch/models", "smk_torch/ops", "smk_torch/parallel",
)
# torch's sampling functions: each draws from the process-global
# generator unless a `generator=` is passed
_TORCH_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint",
    "randint_like", "randperm", "normal", "bernoulli", "multinomial",
    "poisson",
}
# the in-place samplers of a tensor
_TORCH_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "exponential_", "geometric_",
    "cauchy_", "log_normal_", "random_",
}
# reseeding the process-global generator
_TORCH_GLOBAL_SEED = {"manual_seed", "seed"}


class HostNondeterminismRule(Rule):
    id = "SMK102"
    name = "host-nondeterminism"
    doc = (
        "sampler/ops/parallel modules of smk_torch/ must draw "
        "randomness from an explicit torch.Generator (the noise "
        "source): torch.rand*/randn*/randint/randperm/normal/"
        "bernoulli/multinomial and the in-place uniform_/normal_/... "
        "without generator=, torch.manual_seed/torch.seed (the "
        "process-global generator), np.random's global-state "
        "functions, stdlib random and time-seeded generators make "
        "chains unreproducible. Elsewhere in smk_torch/, np.random's "
        "global state and unseeded default_rng() are still flagged."
    )

    def applies(self, module):
        return _in_zone(module, "smk_torch/")

    def check(self, module, ctx):
        strict = _in_zone(module, *_STRICT_ZONES)
        random_module_aliases: Set[str] = set()
        random_member_names: Set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "random":
                        random_module_aliases.add(a.asname or "random")
            if isinstance(node, ast.ImportFrom):
                if node.module == "random":
                    for a in node.names:
                        random_member_names.add(a.asname or a.name)

        for node in ast.walk(module.tree):
            chain = attr_chain(node) if isinstance(
                node, ast.Attribute
            ) else ()
            if (
                len(chain) >= 3
                and chain[0] in _NP_ROOTS
                and chain[1] == "random"
                and chain[2] in _LEGACY_NP_RANDOM
            ):
                yield self.finding(
                    module, node,
                    f"np.random.{chain[2]} uses numpy's GLOBAL "
                    "generator state — use a seeded "
                    "np.random.default_rng(seed), or on the fit path "
                    "the run's torch.Generator",
                )
            if not isinstance(node, ast.Call):
                continue
            fchain = attr_chain(node.func)
            kwargs = {kw.arg for kw in node.keywords}
            if strict and fchain and fchain[0] in _TORCH_ROOTS:
                if (
                    len(fchain) == 2
                    and fchain[1] in _TORCH_SAMPLERS
                    and "generator" not in kwargs
                ):
                    yield self.finding(
                        module, node,
                        f"torch.{fchain[1]}(...) without generator= "
                        "draws from torch's process-global generator "
                        "— on the fit path every draw comes from the "
                        "run's noise source (an explicit "
                        "torch.Generator)",
                    )
                elif fchain[-1] in _TORCH_GLOBAL_SEED and len(
                    fchain
                ) in (2, 3):
                    yield self.finding(
                        module, node,
                        f"{'.'.join(fchain)}() reseeds or reads "
                        "torch's process-global generator — seed the "
                        "run's own torch.Generator instead",
                    )
            if (
                strict
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _TORCH_INPLACE_SAMPLERS
                and "generator" not in kwargs
            ):
                yield self.finding(
                    module, node,
                    f".{node.func.attr}(...) without generator= "
                    "draws from torch's process-global generator — "
                    "pass the run's torch.Generator",
                )
            # unseeded default_rng() anywhere in smk_torch/
            if (
                fchain
                and fchain[-1] == "default_rng"
                and not node.args
                and not node.keywords
            ):
                yield self.finding(
                    module, node,
                    "np.random.default_rng() without a seed is "
                    "OS-entropy nondeterminism — pass an explicit "
                    "seed",
                )
            # stdlib random module calls
            if (
                len(fchain) == 2
                and fchain[0] in random_module_aliases
            ) or (
                len(fchain) == 1
                and fchain[0] in random_member_names
            ):
                yield self.finding(
                    module, node,
                    f"stdlib random.{fchain[-1]} in smk_torch/ — "
                    "use the run's torch.Generator (or a seeded "
                    "numpy Generator outside the fit path)",
                )
            # time-seeded generators (`torch.Generator().manual_seed(t)`
            # has no plain chain: its callee is an attribute of a call)
            leaf = fchain[-1] if fchain else (
                node.func.attr if isinstance(node.func, ast.Attribute) else ""
            )
            if leaf and (
                "rng" in leaf.lower()
                or "seed" in leaf.lower()
                or leaf == "Generator"
            ):
                for arg in ast.walk(node):
                    if isinstance(arg, ast.Call):
                        achain = attr_chain(arg.func)
                        if achain and achain[-2:] in (
                            ("time", "time"),
                            ("time", "time_ns"),
                        ):
                            yield self.finding(
                                module, node,
                                "wall-clock-seeded generator — "
                                "seeds must be explicit and "
                                "reproducible",
                            )
                            break


# ---------------------------------------------------------------------------
# SMK103 — host sync inside captured code
# ---------------------------------------------------------------------------

_SYNC_ATTRS = {
    "item": ".item() forces a device->host sync",
    "tolist": ".tolist() forces a device->host sync",
    "cpu": ".cpu() is a blocking device->host copy",
    "numpy": ".numpy() materializes on the host",
}


class HostSyncInCapturedRule(Rule):
    id = "SMK103"
    name = "host-sync-in-captured"
    doc = (
        "no host synchronization inside captured code: .item()/"
        ".tolist()/.cpu()/.numpy()/torch.cuda.synchronize, or float()/"
        "int()/bool()/if on a torch expression, inside a function "
        "marked `# smklint: captured` (a body a CUDA graph captures: "
        "the sampler's chunk functions, the serving programs) or its "
        "callees in the same module — on the card such a sync breaks "
        "the capture, and on the CPU, where nothing is captured, only "
        "this rule catches it"
    )

    def check(self, module, ctx):
        idx = _FuncIndex()
        idx.visit(module.tree)
        all_funcs = set(idx.funcs)
        for fn in captured_functions(module):
            for node in _own_nodes(fn, all_funcs):
                yield from self._check_node(module, node)

    def _check_node(self, module, node):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                if attr in _SYNC_ATTRS and not node.args:
                    yield self.finding(
                        module, node,
                        f"{_SYNC_ATTRS[attr]} inside captured code — "
                        "hoist it to the host boundary",
                    )
                    return
                if attr == "synchronize":
                    yield self.finding(
                        module, node,
                        f"{'.'.join(chain) or attr}() waits for the "
                        "device inside captured code — a capture "
                        "cannot synchronize; wait at the host boundary",
                    )
                    return
            if isinstance(node.func, ast.Name) and node.func.id in (
                "float", "int", "bool",
            ) and node.args and _contains_torch_call(node.args[0]):
                yield self.finding(
                    module, node,
                    f"{node.func.id}() on a torch expression inside "
                    "captured code reads the tensor on the host — "
                    "keep it a tensor (torch.where), or compute the "
                    "scalar at the host boundary",
                )
        if isinstance(node, (ast.If, ast.While)) and _contains_torch_call(
            node.test
        ):
            yield self.finding(
                module, node,
                "branching on a torch expression inside captured code "
                "is an implicit bool() on a tensor (a device->host "
                "sync) — use torch.where, or branch on host values",
            )
        if isinstance(node, ast.Assert) and _contains_torch_call(node.test):
            yield self.finding(
                module, node,
                "assert on a torch expression inside captured code is "
                "an implicit bool() on a tensor — move it to the host "
                "boundary",
            )


# ---------------------------------------------------------------------------
# SMK107 — unused module-level imports (ruff F401 backstop)
# ---------------------------------------------------------------------------


class UnusedImportRule(Rule):
    id = "SMK107"
    name = "unused-import"
    doc = (
        "module-level imports that no code in the file references — "
        "the in-repo backstop for ruff's F401 so the scripts/lint.py "
        "gate has teeth in environments (like this container) where "
        "ruff is not installed. __init__.py re-exports and "
        "try/except availability probes are exempt."
    )

    def applies(self, module):
        return module.basename != "__init__.py"

    def check(self, module, ctx):
        bindings = []  # (name, line, rendered)
        for stmt in module.tree.body:
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if a.asname:
                        bindings.append((a.asname, stmt.lineno, a.name))
                    else:
                        bindings.append((
                            a.name.split(".")[0], stmt.lineno, a.name,
                        ))
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.module == "__future__":
                    continue
                for a in stmt.names:
                    if a.name == "*":
                        continue
                    bindings.append((
                        a.asname or a.name, stmt.lineno,
                        f"{stmt.module or ''}.{a.name}",
                    ))
        if not bindings:
            return
        used: Set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            # __all__ = ["name", ...] counts as use (re-export)
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == "__all__":
                        for sub in ast.walk(node.value):
                            if isinstance(sub, ast.Constant) and isinstance(
                                sub.value, str
                            ):
                                used.add(sub.value)
            # string annotations / forward refs
            if isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ) and len(node.value) < 120:
                used.update(
                    part for part in re.findall(r"\w+", node.value)
                )
        for name, line, rendered in bindings:
            if name not in used:
                yield Finding(
                    self.id, module.path, line,
                    f"[{self.name}] {rendered!r} (bound as {name!r}) "
                    "is imported but never used in this module",
                )


# ---------------------------------------------------------------------------
# SMK108 — fault-injection zone (chaos APIs are test-only)
# ---------------------------------------------------------------------------

_FAULTS_MODULE = "smk_torch.testing"


class FaultInjectionZoneRule(Rule):
    id = "SMK108"
    name = "fault-injection-zone"
    doc = (
        "chaos-injection APIs (smk_torch.testing.faults) may only be "
        "imported/armed under tests/ and scripts/ — an injector "
        "reference in smk_torch/ library code would ship deterministic "
        "chaos (subset NaNs, writer failures, simulated kills) to "
        "production fits; the harness exists to TEST the "
        "fault-isolation engine, never to ride inside it"
    )

    def applies(self, module):
        norm = module.norm_path()
        # only library code is restricted; the harness package itself,
        # tests/, scripts/, bench.py and anything outside smk_torch/
        # may reference the injectors freely
        if "smk_torch/testing" in norm:
            return False
        return "smk_torch/" in norm

    def _flag(self, module, node, rendered):
        return Finding(
            self.id, module.path, node.lineno,
            f"[{self.name}] {rendered} references the chaos-injection "
            "harness from smk_torch/ library code — fault injectors are "
            "armed only under tests/ and scripts/ (a production fit "
            "must never import its own saboteur); move the reference "
            "into the test or probe script that drives it",
        )

    def check(self, module, ctx):
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name.startswith(_FAULTS_MODULE):
                        yield self._flag(
                            module, node, f"import {a.name}"
                        )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                # absolute: from smk_torch.testing[.faults] import ...
                if mod.startswith(_FAULTS_MODULE):
                    yield self._flag(
                        module, node, f"from {mod} import ..."
                    )
                # the package-attribute spelling: from smk_torch import
                # testing (and the relative `from . import testing`)
                elif (
                    mod == "smk_torch" or (node.level >= 1 and not mod)
                ) and any(a.name == "testing" for a in node.names):
                    yield self._flag(
                        module, node,
                        f"from {mod or '.' * node.level} import "
                        "testing",
                    )
                # relative within the package: from .testing import
                # faults / from ..testing.faults import ...
                elif node.level >= 1 and (
                    mod == "testing" or mod.startswith("testing.")
                ):
                    yield self._flag(
                        module, node,
                        f"from {'.' * node.level}{mod} import ...",
                    )
            elif isinstance(node, ast.Call):
                # dynamic escape hatch: importlib.import_module(
                # "smk_torch.testing.faults") and friends
                for arg in node.args:
                    if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str
                    ) and arg.value.startswith(_FAULTS_MODULE):
                        yield self._flag(
                            module, node,
                            f"dynamic import of {arg.value!r}",
                        )


# ---------------------------------------------------------------------------
# SMK109 — the build directory is armed through compile/ only
# ---------------------------------------------------------------------------

# The environment variable that names the kernels' build directory
# (ops/cuda_build.build_dir), and the armed-directory state that
# compile/xla_cache.enable_persistent_cache owns. Assembled from parts
# so this module's own AST never contains the literal.
_BUILD_DIR_ENV = "SMK_TORCH" + "_BUILD_DIR"
_BUILD_DIR_ZONES = ("smk_torch/compile/", "smk_torch/ops/cuda_build")
# calls that write an environment entry by key
_ENV_WRITERS = {"setdefault", "putenv", "update", "__setitem__"}


class CompileCacheConfigRule(Rule):
    id = "SMK109"
    name = "compile-cache-config"
    doc = (
        "setting SMK_TORCH_BUILD_DIR (os.environ[...] = / "
        "os.environ.setdefault / os.putenv / os.environ.update) or "
        "arming the build directory (assigning xla_cache._ARMED) in "
        "smk_torch/ outside compile/ and ops/cuda_build.py — "
        "compile.xla_cache.enable_persistent_cache is the one source "
        "of truth for where the kernel libraries are built and "
        "loaded (the port's persistent compile cache); a second "
        "writer sends nvcc to a directory the program store and the "
        "fingerprint checks do not see"
    )

    def applies(self, module):
        norm = module.norm_path()
        if any(z in norm for z in _BUILD_DIR_ZONES):
            return False
        return "smk_torch/" in norm

    @staticmethod
    def _is_key(node) -> bool:
        return isinstance(node, ast.Constant) and node.value == _BUILD_DIR_ENV

    def check(self, module, ctx):
        msg = (
            "the kernels' build directory is set outside compile/ — "
            "arm it through smk_torch.compile.xla_cache."
            "enable_persistent_cache (SMKConfig.xla_cache_dir), the one "
            "source of truth for path resolution, the environment "
            "override and the build directory the store fingerprints"
        )
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript) and self._is_key(
                        tgt.slice
                    ):
                        yield self.finding(module, node, msg)
                    chain = attr_chain(tgt)
                    if chain and chain[-1] == "_ARMED" and len(chain) >= 2:
                        yield self.finding(module, node, msg)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if not chain or chain[-1] not in _ENV_WRITERS:
                    continue
                args = list(node.args) + [kw.value for kw in node.keywords]
                hit = any(self._is_key(a) for a in node.args) or any(
                    kw.arg == _BUILD_DIR_ENV for kw in node.keywords
                ) or any(
                    isinstance(a, ast.Dict)
                    and any(self._is_key(k) for k in a.keys)
                    for a in args
                )
                if hit:
                    yield self.finding(module, node, msg)


# ---------------------------------------------------------------------------
# SMK110 — telemetry discipline (one span source of truth)
# ---------------------------------------------------------------------------

# The sanctioned telemetry zones: the obs subsystem itself and the
# tracing module that owns the clock (utils/tracing.monotonic) and
# the span/stats primitives.
_TELEMETRY_ZONES = ("smk_torch/obs/", "smk_torch/utils/tracing")

# time-module members whose CALL in library code is ad-hoc telemetry
# (interval timing / timestamping). time.sleep, strftime, gmtime etc.
# are not timing instrumentation and stay legal.
_TIME_CLOCK_FNS = {
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "process_time", "process_time_ns",
}


class TelemetryDisciplineRule(Rule):
    id = "SMK110"
    name = "telemetry-discipline"
    doc = (
        "smk_torch/ library code outside smk_torch/obs/ and "
        "utils/tracing.py may not take its own wall-clock "
        "measurements (time.perf_counter()/time.time()/...) or emit "
        "its own JSONL lines (f.write(json.dumps(...))) — "
        "utils/tracing.monotonic is the one clock, "
        "phase_timer/ChunkPipelineStats/the run log are the one span "
        "source of truth, and obs/reporter.py is the one JSONL "
        "writer"
    )

    def applies(self, module):
        norm = module.norm_path()
        if any(z in norm for z in _TELEMETRY_ZONES):
            return False
        return "smk_torch/" in norm

    def check(self, module, ctx):
        # names imported straight off the time module:
        # `from time import perf_counter` / `... as clock`
        time_member_aliases: dict = {}
        time_module_aliases: Set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        time_module_aliases.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time" and node.level == 0:
                    for a in node.names:
                        if a.name in _TIME_CLOCK_FNS:
                            time_member_aliases[
                                a.asname or a.name
                            ] = a.name
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if (
                len(chain) == 2
                and chain[0] in time_module_aliases
                and chain[1] in _TIME_CLOCK_FNS
            ):
                yield self.finding(
                    module, node,
                    f"direct {chain[0]}.{chain[1]}() timing in "
                    "library code — take timestamps from "
                    "utils/tracing.monotonic (or emit through "
                    "phase_timer / ChunkPipelineStats / the run "
                    "log) so every measurement lands in the one "
                    "span source of truth",
                )
            elif (
                len(chain) == 1 and chain[0] in time_member_aliases
            ):
                orig = time_member_aliases[chain[0]]
                yield self.finding(
                    module, node,
                    f"direct time.{orig}() timing (imported as "
                    f"{chain[0]}) in library code — use "
                    "utils/tracing.monotonic / phase_timer instead",
                )
            # JSONL emission: a .write(...) whose argument embeds
            # json.dumps(...) — the hand-rolled line-record writer
            # obs/reporter.py replaces. json.dumps alone (manifests,
            # fingerprints) stays legal.
            if (
                chain
                and chain[-1] == "write"
                and isinstance(node.func, ast.Attribute)
            ):
                for arg in node.args:
                    hit = any(
                        isinstance(sub, ast.Call)
                        and attr_chain(sub.func)[-1:] == ("dumps",)
                        for sub in ast.walk(arg)
                    )
                    if hit:
                        yield self.finding(
                            module, node,
                            "hand-rolled JSONL emission "
                            "(.write(json.dumps(...))) in library "
                            "code — write line records through "
                            "smk_torch.obs.reporter (JsonlWriter / "
                            "write_records): flush-per-record and "
                            "crash-truncation safety live there",
                        )
                        break


# ---------------------------------------------------------------------------
# SMK111 — unbounded waits (the hang class the chunk watchdog catches)
# ---------------------------------------------------------------------------

# Blocking methods whose ZERO-argument call waits forever by default.
# A positional argument exempts the call — dict.get(key), ",".join(xs)
# and sock.recv(n) carry operands, while queue.get(), thread.join(),
# fut.result(), event.wait(), lock.acquire() and sock.accept() are the
# unbounded spellings.
_WAIT_METHODS = {"get", "join", "result", "wait", "acquire", "accept"}
_TIMEOUT_KWARGS = {"timeout", "timeout_s", "deadline", "deadline_s"}


class UnboundedWaitRule(Rule):
    id = "SMK111"
    name = "unbounded-wait"
    doc = (
        "blocking waits without a timeout in smk_torch/ library code — "
        "queue.get()/.join()/.result()/.wait()/.acquire()/.accept() "
        "called with no arguments and no timeout= keyword, and "
        "socket.create_connection without a timeout. An unbounded "
        "wait is exactly the hang class the chunk watchdog exists to "
        "catch: a dead peer turns it into an indefinite "
        "stall that eats the whole job. Pass a timeout and handle "
        "expiry, or suppress with the reason the wait is bounded by "
        "construction"
    )

    def applies(self, module):
        return "smk_torch/" in module.norm_path()

    @staticmethod
    def _socket_aliases(tree):
        """Every local name create_connection may be reached through:
        module aliases (``import socket [as s]``) and member aliases
        (``from socket import create_connection [as conn]``) — the
        same from-import coverage SMK110 grew for the time clocks."""
        mod_aliases, member_aliases = set(), set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "socket":
                        mod_aliases.add(a.asname or "socket")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "socket" and node.level == 0:
                    for a in node.names:
                        if a.name == "create_connection":
                            member_aliases.add(a.asname or a.name)
        return mod_aliases, member_aliases

    def check(self, module, ctx):
        sock_mods, sock_members = self._socket_aliases(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            has_timeout_kw = any(
                kw.arg in _TIMEOUT_KWARGS for kw in node.keywords
            )
            if (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _WAIT_METHODS
                and not node.args
                and not has_timeout_kw
            ):
                yield self.finding(
                    module, node,
                    f".{node.func.attr}() with no timeout — an "
                    "unbounded blocking wait in library code hangs "
                    "forever when its peer dies (the failure mode "
                    "the chunk watchdog converts into a typed "
                    "ChunkTimeoutError); pass timeout= and handle "
                    "expiry, or justify why the wait is bounded by "
                    "construction",
                )
            elif (
                (
                    len(chain) == 2
                    and chain[0] in sock_mods
                    and chain[1] == "create_connection"
                )
                or (len(chain) == 1 and chain[0] in sock_members)
            ) and len(node.args) < 2 and not has_timeout_kw:
                yield self.finding(
                    module, node,
                    "socket.create_connection without a timeout "
                    "inherits the system default (often infinite) — "
                    "pass an explicit timeout so a dead coordinator "
                    "surfaces as an error, not a hang",
                )


# ---------------------------------------------------------------------------
# SMK112 — mesh hygiene (one Mesh constructor, honest topology keys)
# ---------------------------------------------------------------------------

_MESH_CTORS = {"Mesh", "MeshEntry"}


class MeshHygieneRule(Rule):
    id = "SMK112"
    name = "mesh-hygiene"
    doc = (
        "direct Mesh(...)/MeshEntry(...) construction in smk_torch/ "
        "library code outside parallel/executor.py — "
        "executor.make_mesh / sub_mesh are the ONE mesh source of "
        "truth: the program store keys captured programs by the mesh's "
        "topology fingerprint, and the failure-domain attribution "
        "derives subset->device->host placement from make_mesh's "
        "contiguous 1-D layout, so an ad-hoc Mesh with a different "
        "entry order or axis name silently desynchronizes both"
    )

    def applies(self, module):
        norm = module.norm_path()
        if "smk_torch/parallel/executor" in norm:
            return False
        return "smk_torch/" in norm

    def check(self, module, ctx):
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain and chain[-1] in _MESH_CTORS and (
                len(chain) == 1 or chain[-2] == "executor"
            ):
                yield self.finding(
                    module, node,
                    f"direct {chain[-1]}(...) construction in library "
                    "code — build meshes through "
                    "smk_torch.parallel.executor.make_mesh / sub_mesh "
                    "(the one source of truth for entry order and axis "
                    "naming): the program store's topology "
                    "fingerprints and the failure-domain layout oracle "
                    "both assume its contiguous 1-D layout",
                )


# ---------------------------------------------------------------------------
# SMK113 — atomic-write discipline in durable-state modules
# ---------------------------------------------------------------------------

# The modules whose on-disk output is LATER RE-READ by resume/store
# code — checkpoint manifests/segments/shards, serialized
# executables, JSONL protocol/run-log records. A direct truncating
# write at a live path in any of these can strand a torn file a
# crash makes permanent; every write must go through write-to-temp +
# atomic-rename (os.replace) or the append-atomic reporter.
_DURABLE_MODULES = (
    "smk_torch/utils/checkpoint",
    "smk_torch/parallel/checkpoint",
    "smk_torch/parallel/recovery",
    "smk_torch/compile/store",
    "smk_torch/compile/xla_cache",
    "smk_torch/obs/reporter",
    "smk_torch/obs/events",
    # serving artifacts: a torn fit bundle is a torn
    # deployment — same write-to-temp + atomic-rename contract
    "smk_torch/serve/artifact",
    # the ingest append log: pending batch files are
    # re-read by restart replay — a torn segment is lost rows
    "smk_torch/serve/ingest",
)


class AtomicWriteRule(Rule):
    id = "SMK113"
    name = "atomic-write-discipline"
    doc = (
        "durable-state modules (checkpoint, compile store, reporter "
        "— files later re-read by resume/store code) may not open a "
        "path for truncating write (open(path, 'w'/'wb'), io.open, "
        "Path.open, write_text/write_bytes) outside a function that "
        "completes the write-to-temp + atomic-rename shape "
        "(os.replace/os.rename in the same function) — a crash "
        "mid-write otherwise strands a TORN file at a live path, "
        "exactly the corruption class the v5-v8 checkpoint layouts' "
        "crash-window guarantees exclude. Append mode "
        "('a') stays legal: it never destroys committed bytes (the "
        "reporter's flush-per-record contract)."
    )

    def applies(self, module):
        norm = module.norm_path()
        return any(z in norm for z in _DURABLE_MODULES)

    @staticmethod
    def _open_aliases(tree) -> Set[str]:
        """Local names that ARE an open function: the builtin (always
        'open'), ``io.open`` member imports and their aliases — the
        same from-import coverage SMK110/111 grew."""
        out = {"open"}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.module in ("io", "builtins") and node.level == 0:
                    for a in node.names:
                        if a.name == "open":
                            out.add(a.asname or a.name)
        return out

    @staticmethod
    def _mode_arg(node: ast.Call, pos: int):
        """The mode argument of an open()-shaped call: (present,
        constant-value-or-None). ``pos`` is the positional index of
        the mode (1 for open/io.open, 0 for the ``x.open(mode)``
        method spelling); mode= keyword wins either way."""
        for kw in node.keywords:
            if kw.arg == "mode":
                if isinstance(kw.value, ast.Constant):
                    return True, kw.value.value
                return True, None
        if len(node.args) > pos:
            arg = node.args[pos]
            if isinstance(arg, ast.Constant):
                return True, arg.value
            return True, None
        return False, "r"

    @staticmethod
    def _blessed(fn) -> bool:
        """The enclosing function completes the atomic-rename shape:
        it also calls os.replace/os.rename, so the opened path is
        (by the repo convention) a temp the rename publishes."""
        if fn is None:
            return False
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if chain[-1:] in (("replace",), ("rename",)) and (
                    len(chain) >= 2 and chain[0] == "os"
                ):
                    return True
        return False

    def check(self, module, ctx):
        opens = self._open_aliases(module.tree)
        idx = _FuncIndex()
        idx.visit(module.tree)

        def enclosing(node):
            for fn in idx.funcs:
                if isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    for sub in ast.walk(fn):
                        if sub is node:
                            return fn
            return None

        # one pass over every open()-shaped call / pathlib write
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            mode_pos = None
            if (len(chain) == 1 and chain[0] in opens) or chain[
                -2:
            ] == ("io", "open"):
                # builtin/io/from-import-aliased open(file, mode)
                mode_pos = 1
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "open"
                and chain[-2:] != ("io", "open")
            ):
                # the method spelling: Path(...).open(mode) — mode
                # leads (gzip.open-style module calls with a path
                # first still land here; their mode arg 0 is the
                # path, a non-constant → the non-constant-mode arm
                # asks for restructuring or suppression, which is
                # the safe default in a durable module)
                mode_pos = 0
            is_open = mode_pos is not None
            is_pathwrite = isinstance(node.func, ast.Attribute) and (
                node.func.attr in ("write_text", "write_bytes")
            )
            if is_pathwrite:
                if not self._blessed(enclosing(node)):
                    yield self.finding(
                        module, node,
                        f".{node.func.attr}(...) writes a live path "
                        "in a durable-state module with no atomic "
                        "rename in the enclosing function — a crash "
                        "mid-write strands a torn file resume/store "
                        "code will later re-read; write to a temp "
                        "and os.replace it",
                    )
                continue
            if not is_open:
                continue
            present, mode = self._mode_arg(node, mode_pos)
            if not present:
                continue  # default mode "r"
            if mode is None:
                # non-constant mode: cannot prove it is not a
                # truncating write — the reporter's "a"-or-"w"
                # conditional is the one justified case (suppressed
                # with its append-atomic contract)
                if not self._blessed(enclosing(node)):
                    yield self.finding(
                        module, node,
                        "open(...) with a non-constant mode in a "
                        "durable-state module — smklint cannot "
                        "verify the write is not truncating a live "
                        "path; make the mode a literal, restructure "
                        "to temp + os.replace, or suppress with the "
                        "justification",
                    )
                continue
            if not isinstance(mode, str) or "w" not in mode:
                continue  # read/append modes never truncate history
            if self._blessed(enclosing(node)):
                continue
            yield self.finding(
                module, node,
                f"open(..., {mode!r}) truncates a path in a "
                "durable-state module with no os.replace/os.rename "
                "in the enclosing function — a crash mid-write "
                "strands a TORN file at a live path that "
                "resume/store code later re-reads (the v5-v8 "
                "checkpoint crash-window guarantees assume "
                "write-to-temp + atomic rename); use the blessed "
                "helpers (utils/checkpoint._atomic_savez, "
                "compile/store.save, obs/reporter) or rename from a "
                "temp",
            )


# ---------------------------------------------------------------------------
# SMK114 — deadline discipline on the serving request path
# ---------------------------------------------------------------------------

# the spellings serve code can reach (or synchronously wait on) the
# device by: the engine's ONE dispatch seam, plus the device syncs
_SERVE_DISPATCH_NAMES = {"_invoke_program", "invoke_program"}
_SERVE_SYNC_ATTRS = {"synchronize", "device_sync"}


class DeadlineDisciplineRule(Rule):
    id = "SMK114"
    name = "deadline-discipline"
    doc = (
        "request-path code in smk_torch/serve/ reaching a program "
        "dispatch (the engine's _invoke_program seam) or a device sync "
        "(torch.cuda.synchronize, an event's .synchronize(), "
        "device_sync) outside a watchdog/deadline context — every "
        "serve dispatch must run inside a function handed to "
        "serve.deadline.run_under_deadline (or a watchdog's .run), "
        "because a bare dispatch on the caller thread reintroduces "
        "the unbounded hang the request-deadline contract exists to "
        "exclude: a wedged device program must become a typed "
        "RequestTimeoutError within the deadline, never a hung caller"
    )

    def applies(self, module):
        return "smk_torch/serve/" in module.norm_path()

    @staticmethod
    def _guarded(tree):
        """(names, lambda-nodes) the module hands to a deadline
        runner: the first argument of ``run_under_deadline(fn, ...)``
        or of any ``<watchdog|deadline>.run(fn, ...)`` — a local
        ``def worker(): ...`` passed by name, or an inline lambda.
        Name-level matching, not scope-chased."""
        names: Set[str] = set()
        lambdas: list = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            chain = attr_chain(node.func)
            runner = chain[-1:] == ("run_under_deadline",) or (
                chain[-1:] == ("run",)
                and any(
                    "deadline" in part.lower()
                    or "watchdog" in part.lower()
                    for part in chain[:-1]
                )
            )
            if not runner:
                continue
            arg0 = node.args[0]
            if isinstance(arg0, ast.Name):
                names.add(arg0.id)
            elif isinstance(arg0, ast.Lambda):
                lambdas.append(arg0)
        return names, lambdas

    def check(self, module, ctx):
        names, lambdas = self._guarded(module.tree)
        funcs = [
            n for n in ast.walk(module.tree)
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            )
        ]

        def is_guarded(node) -> bool:
            for fn in funcs:
                if not any(sub is node for sub in ast.walk(fn)):
                    continue
                if isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ) and fn.name in names:
                    return True
                if isinstance(fn, ast.Lambda) and any(
                    fn is lam for lam in lambdas
                ):
                    return True
            return False

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            leaf = chain[-1] if chain else (
                node.func.attr if isinstance(node.func, ast.Attribute)
                else None
            )
            dispatch = leaf is not None and (
                leaf in _SERVE_DISPATCH_NAMES or leaf in _SERVE_SYNC_ATTRS
            )
            if not dispatch:
                continue
            if is_guarded(node):
                continue
            yield self.finding(
                module, node,
                f"serve request-path dispatch {'.'.join(chain) or leaf}"
                "(...) outside a deadline context — run it inside a "
                "function handed to "
                "serve.deadline.run_under_deadline(fn, budget, ...) "
                "so a wedged device program becomes a typed "
                "RequestTimeoutError within the request deadline "
                "instead of hanging the caller",
            )


# ---------------------------------------------------------------------------
# SMK115 — ladder discipline (one shape-bucket arithmetic)
# ---------------------------------------------------------------------------

# The one sanctioned owner of padded-shape / bucket-size arithmetic
#: the √2 ladder generator, smallest-fitting-bucket
# selection, slice planning and pad accounting all live here and are
# SHARED by the m-axis ragged partitions and the serve engine's
# query-batch ladder.
_BUCKETS_ZONE = "smk_torch/compile/buckets"


class LadderDisciplineRule(Rule):
    id = "SMK115"
    name = "ladder-discipline"
    doc = (
        "smk_torch/ library code outside compile/buckets.py may not "
        "compute padded shapes or bucket sizes itself — the enforced "
        "signatures are the √2-rung arithmetic forms: a half-power "
        "`base ** (x / 2)`, the `2 ** 0.5` constant, and `sqrt(2)` "
        "calls (math/np/torch or from-import spellings). "
        "compile/buckets.bucket_ladder / bucket_for / select_bucket "
        "/ slice_plan are the one source of truth: a second ladder "
        "implementation that drifts by one rounding rule would "
        "fragment the L1/L2 compile store into near-duplicate shape "
        "buckets and silently undo the O(#buckets) compile "
        "conversion"
    )

    def applies(self, module):
        norm = module.norm_path()
        if _BUCKETS_ZONE in norm:
            return False
        return "smk_torch/" in norm

    def check(self, module, ctx):
        # bare sqrt imported off math/numpy: `from math import sqrt`
        # (aliased or not) — the same from-import coverage
        # SMK110/111 grew
        sqrt_aliases = {"sqrt"}
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                for a in node.names:
                    if a.name == "sqrt":
                        sqrt_aliases.add(a.asname or a.name)
        msg_rung = (
            "half-power (√2-rung) arithmetic in library code — "
            "bucket/padded-shape sizes come from "
            "compile/buckets.bucket_ladder / bucket_for / "
            "select_bucket, the one ladder the compile-store keys "
            "are bucketed by (SMK115 ladder-discipline)"
        )
        msg_sqrt = (
            "sqrt(2) ladder constant in library code — the √2 "
            "bucket ladder lives in compile/buckets.py; import its "
            "helpers instead of re-deriving rung math (SMK115 "
            "ladder-discipline)"
        )
        for node in ast.walk(module.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                node.op, ast.Pow
            ):
                r = node.right
                if (
                    isinstance(r, ast.BinOp)
                    and isinstance(r.op, ast.Div)
                    and isinstance(r.right, ast.Constant)
                    and not isinstance(r.right.value, bool)
                    and r.right.value in (2, 2.0)
                ):
                    yield self.finding(module, node, msg_rung)
                elif (
                    isinstance(r, ast.Constant)
                    and r.value == 0.5
                    and isinstance(node.left, ast.Constant)
                    and not isinstance(node.left.value, bool)
                    and node.left.value in (2, 2.0)
                ):
                    yield self.finding(module, node, msg_sqrt)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if (
                    chain
                    and chain[-1] in sqrt_aliases
                    and len(node.args) == 1
                    and not node.keywords
                    and isinstance(node.args[0], ast.Constant)
                    and not isinstance(node.args[0].value, bool)
                    and node.args[0].value in (2, 2.0)
                ):
                    yield self.finding(module, node, msg_sqrt)


# ---------------------------------------------------------------------------
# SMK116 — coalesce-wait discipline (config-driven bounds on the
# cross-request serving hot path)
# ---------------------------------------------------------------------------

# The two serving modules added. Both sit on EVERY request's
# latency path when coalescing/fleets are armed, so their waits carry
# a stricter contract than SMK111's bounded-at-all: the bound itself
# must be derived from config or budget state, never a hard-coded
# numeric literal.
_COALESCE_ZONES = ("smk_torch/serve/coalesce", "smk_torch/serve/fleet")


class BoundedCoalesceWaitRule(Rule):
    id = "SMK116"
    name = "coalesce-wait-discipline"
    doc = (
        "hard-coded wait bounds in the coalescer/fleet hot path "
        "(smk_torch/serve/coalesce.py, smk_torch/serve/fleet.py) — any "
        "time.sleep(...) call, and any blocking wait "
        "(.get/.join/.result/.wait/.acquire/.accept) whose timeout "
        "is a numeric literal rather than a config- or "
        "budget-derived variable. These modules hold OTHER requests' "
        "latency budgets while they wait: a literal "
        "freezes a latency policy the operator can no longer tune "
        "through SMKConfig.coalesce_window_ms or the request's "
        "DeadlineBudget, and a sleep is an unconditional hold even "
        "when the batch is ready to flush. Derive every bound from "
        "the window/budget state (hold variables, budget.remaining())"
    )

    def applies(self, module):
        norm = module.norm_path()
        return any(z in norm for z in _COALESCE_ZONES)

    @staticmethod
    def _sleep_aliases(tree):
        """Every local name time.sleep may be reached through:
        module aliases (``import time [as t]``) and member aliases
        (``from time import sleep [as snooze]``) — the same
        from-import coverage SMK110/111 grew."""
        mod_aliases, member_aliases = set(), set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        mod_aliases.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time" and node.level == 0:
                    for a in node.names:
                        if a.name == "sleep":
                            member_aliases.add(a.asname or a.name)
        return mod_aliases, member_aliases

    @staticmethod
    def _numeric_literal(node) -> bool:
        """A bare int/float constant (optionally signed); bools are
        not timeouts (lock.acquire(True) is a blocking flag)."""
        if isinstance(node, ast.UnaryOp) and isinstance(
            node.op, (ast.USub, ast.UAdd)
        ):
            node = node.operand
        return (
            isinstance(node, ast.Constant)
            and not isinstance(node.value, bool)
            and isinstance(node.value, (int, float))
        )

    def check(self, module, ctx):
        sleep_mods, sleep_members = self._sleep_aliases(module.tree)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            is_sleep = (
                len(chain) == 2
                and chain[0] in sleep_mods
                and chain[1] == "sleep"
            ) or (len(chain) == 1 and chain[0] in sleep_members)
            if is_sleep:
                yield self.finding(
                    module, node,
                    "time.sleep(...) in the coalescer/fleet hot "
                    "path — an unconditional hold that keeps "
                    "sleeping after the batch is ready and ignores "
                    "every member's deadline; wait on the batch "
                    "condition variable with a window/budget-derived "
                    "timeout instead",
                )
                continue
            if not (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _WAIT_METHODS
            ):
                continue
            flagged = False
            for kw in node.keywords:
                if kw.arg in _TIMEOUT_KWARGS and self._numeric_literal(
                    kw.value
                ):
                    yield self.finding(
                        module, node,
                        f".{node.func.attr}({kw.arg}=<literal>) — a "
                        "hard-coded wait bound in the coalescer/"
                        "fleet hot path freezes a latency policy the "
                        "operator cannot tune; derive the timeout "
                        "from coalesce_window_ms or the request's "
                        "DeadlineBudget (budget.remaining())",
                    )
                    flagged = True
                    break
            if not flagged and node.args and self._numeric_literal(
                node.args[0]
            ):
                yield self.finding(
                    module, node,
                    f".{node.func.attr}(<numeric literal>) — a "
                    "hard-coded wait bound in the coalescer/fleet "
                    "hot path freezes a latency policy the operator "
                    "cannot tune; derive the bound from "
                    "coalesce_window_ms or the request's "
                    "DeadlineBudget (budget.remaining())",
                )


# ---------------------------------------------------------------------------
# SMK117 — device-layout discipline (one K-divisibility arithmetic)
# ---------------------------------------------------------------------------

# The two sanctioned owners of K-axis device-layout arithmetic
#: the ragged-mesh planner (pad-to-device-multiple,
# super-batch fusion) in compile/buckets.py, and the executor's
# layout oracle + contiguous-assignment helpers
# (require_divisible_layout / fits_layout / subset_device_assignment
# / sub_mesh) in parallel/executor.py.
_LAYOUT_ZONES = (
    "smk_torch/compile/buckets",
    "smk_torch/parallel/executor",
)

# local names that denote a device count when used as a divisor
_DEVICE_COUNT_NAMES = {
    "n_devices",
    "n_dev",
    "num_devices",
    "device_count",
    "local_device_count",
    "mesh_size",
}


class DeviceLayoutRule(Rule):
    id = "SMK117"
    name = "device-layout-discipline"
    doc = (
        "device-divisibility / K-padding arithmetic in smk_torch/ "
        "library code outside compile/buckets.py and "
        "parallel/executor.py — `% <device count>`, "
        "`// <device count>` (including ceil-to-multiple spellings "
        "like `(k + n - 1) // n` and `-(-k // n)`), and "
        "`ceil(k / <device count>)`, where the divisor is a device "
        "count (`n_devices`-style names, `mesh.devices.size`, "
        "`torch.cuda.device_count()`). A third copy of the layout check is "
        "how a ragged fit silently desynchronizes from the "
        "bin-packed RaggedMeshPlan the executor/checkpoint/"
        "failure-domain oracles all derive from: route the check "
        "through executor.require_divisible_layout / fits_layout, "
        "and the padding through compile/buckets.plan_ragged_mesh "
        ""
    )

    def applies(self, module):
        norm = module.norm_path()
        if any(z in norm for z in _LAYOUT_ZONES):
            return False
        return "smk_torch/" in norm

    @staticmethod
    def _ceil_aliases(tree) -> Set[str]:
        """Local names ``math.ceil`` may be reached through bare:
        ``from math import ceil [as c]`` — same from-import coverage
        as SMK115's sqrt handling."""
        out = {"ceil"}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                for a in node.names:
                    if a.name == "ceil":
                        out.add(a.asname or a.name)
        return out

    @classmethod
    def _is_device_count(cls, node) -> bool:
        """Is this expression a device count? Bare names from the
        conventional set, attribute chains ending in
        ``.devices.size``, ``torch.cuda.device_count()`` /
        ``local_device_count()`` calls — each optionally wrapped
        in ``int(...)`` / ``len(...)``."""
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain and chain[-1] in (
                "device_count", "local_device_count"
            ):
                return True
            if chain in (("int",), ("len",)) and len(node.args) == 1:
                return cls._is_device_count(node.args[0])
            return False
        chain = attr_chain(node)
        if not chain:
            return False
        if chain[-1] in _DEVICE_COUNT_NAMES:
            return True
        return len(chain) >= 2 and chain[-2:] == ("devices", "size")

    def check(self, module, ctx):
        ceil_aliases = self._ceil_aliases(module.tree)
        msg = (
            "K-axis device-layout arithmetic in library code — the "
            "divisibility check belongs to the executor layout "
            "oracle (parallel/executor.require_divisible_layout / "
            "fits_layout) and the padding to the ragged-mesh "
            "planner (compile/buckets.plan_ragged_mesh), the one "
            "layout every sharding/checkpoint/failure-domain oracle "
            "derives from (SMK117 device-layout-discipline)"
        )
        for node in ast.walk(module.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.Mod, ast.FloorDiv)
            ):
                if self._is_device_count(node.right):
                    yield self.finding(module, node, msg)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                is_ceil = (
                    len(chain) == 2
                    and chain[0] == "math"
                    and chain[1] == "ceil"
                ) or (len(chain) == 1 and chain[0] in ceil_aliases)
                if (
                    is_ceil
                    and len(node.args) == 1
                    and isinstance(node.args[0], ast.BinOp)
                    and isinstance(node.args[0].op, ast.Div)
                    and self._is_device_count(node.args[0].right)
                ):
                    yield self.finding(module, node, msg)


# ---------------------------------------------------------------------------
# SMK118 — schedule discipline (one early-stop decision function)
# ---------------------------------------------------------------------------

# The sanctioned readers of the adaptive decision knobs:
# the scheduler itself (its __init__ is THE knob-read site) and the
# config module that defines/validates them.
_SCHEDULE_ZONES = (
    "smk_torch/parallel/schedule",
    "smk_torch/config",
)

# Modules allowed to construct an AdaptiveScheduler: the chunked
# executor (the one consult site) and the warm-path precompiler
# (ladder geometry — it never calls observe()).
_SCHEDULER_CTOR_ZONES = (
    "smk_torch/parallel/schedule",
    "smk_torch/parallel/recovery",
    "smk_torch/compile/warmup",
)

# The decision knobs. `adaptive_schedule` itself is NOT here — it is
# the on/off gate, and gating dispatch on it is exactly what callers
# are supposed to do.
_SCHEDULE_KNOBS = {
    "target_rhat",
    "target_ess",
    "adapt_patience",
    "min_samples_before_stop",
    "adapt_max_extra_frac",
}


class ScheduleDisciplineRule(Rule):
    id = "SMK118"
    name = "schedule-discipline"
    doc = (
        "adaptive early-stop decision logic outside "
        "parallel/schedule.py — reads of the decision knobs "
        "(`target_rhat`, `target_ess`, `adapt_patience`, "
        "`min_samples_before_stop`, `adapt_max_extra_frac`) in "
        "smk_torch/ library code outside parallel/schedule.py and "
        "config.py, `.observe(...)` consults outside "
        "parallel/recovery.py (the chunked executor owns the ONE "
        "consult site), and `AdaptiveScheduler(...)` construction "
        "outside recovery/warmup. A second decision site is how "
        "freeze/compaction decisions stop being a pure replayable "
        "function of the committed boundary stats: the kill/resume "
        "identity and the off-mode golden pin both depend on every "
        "decision flowing through AdaptiveScheduler.observe "
        ""
    )

    def applies(self, module):
        return "smk_torch/" in module.norm_path()

    def check(self, module, ctx):
        norm = module.norm_path()
        in_sched_zone = any(z in norm for z in _SCHEDULE_ZONES)
        in_ctor_zone = any(z in norm for z in _SCHEDULER_CTOR_ZONES)
        in_executor = "smk_torch/parallel/recovery" in norm
        knob_msg = (
            "adaptive decision knob read outside parallel/schedule.py "
            "— the scheduler's __init__ is the one sanctioned reader; "
            "a second reader is a second early-stop policy waiting to "
            "drift from the replayable one (SMK118 "
            "schedule-discipline)"
        )
        consult_msg = (
            "AdaptiveScheduler consult outside the chunked executor — "
            "parallel/recovery.py owns the ONE observe() site (every "
            "decision must be a pure function of COMMITTED boundary "
            "stats, sidecar-persisted for kill/resume identity); "
            "route new signals through the executor's boundary record "
            "(SMK118 schedule-discipline)"
        )
        ctor_msg = (
            "AdaptiveScheduler constructed outside "
            "parallel/recovery.py / compile/warmup.py — a scheduler "
            "instance whose decisions do not flow through the "
            "executor's committed boundaries cannot be replayed from "
            "the sidecar (SMK118 schedule-discipline)"
        )
        for node in ast.walk(module.tree):
            if (
                not in_sched_zone
                and isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and node.attr in _SCHEDULE_KNOBS
            ):
                yield self.finding(module, node, knob_msg)
            elif isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if not chain:
                    continue
                if (
                    not in_executor
                    and not in_sched_zone
                    and len(chain) >= 2
                    and chain[-1] == "observe"
                    and any(
                        "sched" in part.lower() for part in chain[:-1]
                    )
                ):
                    yield self.finding(module, node, consult_msg)
                elif (
                    not in_ctor_zone
                    and chain[-1] == "AdaptiveScheduler"
                ):
                    yield self.finding(module, node, ctor_msg)


# ---------------------------------------------------------------------------
# SMK119 — generation-publication discipline
# ---------------------------------------------------------------------------

# The ONLY in-tree modules that may PUBLISH a generation — commit a
# manifest/generation file onto its live path by atomic rename.
# serve/artifact.py owns serving-artifact generations
# (commit_generation, ); parallel/checkpoint.py owns the v8
# distributed-checkpoint generation manifest. Publication
# anywhere else forks the commit protocol: a second writer can
# publish a generation no rollback scan knows about, torn-publish
# recovery (orphan overwrite at the deterministic bundle name) stops
# being exhaustive, and the SMK113 atomic-write blessing no longer
# implies crash safety — the rename is atomic but the PROTOCOL isn't.
_PUBLICATION_MODULES = (
    "smk_torch/serve/artifact",
    "smk_torch/parallel/checkpoint",
)

# a rename call is a PUBLICATION (not a generic temp-file commit,
# which SMK113 already disciplines) when manifest/generation naming
# reaches it — in the call's own arguments or anywhere in the
# enclosing function's non-docstring string constants
_PUBLICATION_MARKERS = ("manifest", "generation")

# attribute-chain roots whose .replace/.rename members are NOT
# filesystem renames (dataclasses.replace, np/str munging)
_NON_RENAME_ROOTS = {
    "dataclasses", "np", "numpy", "jnp", "jax", "torch", "re", "string",
}


class GenerationPublicationRule(Rule):
    id = "SMK119"
    name = "generation-publication-discipline"
    doc = (
        "generation publication — an atomic rename (os.replace/"
        "os.rename or the Path method spelling) whose call arguments "
        "or enclosing function mention manifest/generation naming — "
        "may only live in serve/artifact.py (commit_generation) or "
        "parallel/checkpoint.py (the v8 distributed manifest). A "
        "second publisher forks the two-phase commit protocol: its "
        "generations are invisible to rollback/orphan scans, so a "
        "crash can leave a committed-looking manifest the recovery "
        "path never audits. Route new publication through "
        "serve.artifact.publish_generation / the checkpoint "
        "committer instead."
    )

    def applies(self, module):
        norm = module.norm_path()
        if "smk_torch/" not in norm:
            return False
        return not any(z in norm for z in _PUBLICATION_MODULES)

    @staticmethod
    def _rename_aliases(tree) -> Set[str]:
        """Local names bound to os.replace/os.rename by from-import
        (the same alias coverage SMK110/111/113 grew)."""
        out: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                if node.module == "os" and node.level == 0:
                    for a in node.names:
                        if a.name in ("replace", "rename"):
                            out.add(a.asname or a.name)
        return out

    @staticmethod
    def _is_rename_call(node: ast.Call, aliases: Set[str]) -> bool:
        chain = attr_chain(node.func)
        if not chain:
            return False
        if chain[-2:] in (("os", "replace"), ("os", "rename")):
            return True
        if len(chain) == 1 and chain[0] in aliases:
            return True
        # the Path method spelling: p.replace(target) / p.rename(t) —
        # exclude roots that are never filesystem handles
        if (
            len(chain) == 2
            and chain[-1] in ("replace", "rename")
            and chain[0] not in _NON_RENAME_ROOTS
            and chain[0] != "os"
        ):
            return True
        return False

    @staticmethod
    def _marker_strings(node: ast.AST, *, skip_docstrings: bool) -> bool:
        """Does ``node``'s subtree contain a string constant naming a
        manifest/generation? Docstrings are skipped when scanning a
        whole function — prose ABOUT generations is not publication."""
        doc_nodes = set()
        if skip_docstrings:
            for sub in ast.walk(node):
                if isinstance(
                    sub,
                    (ast.FunctionDef, ast.AsyncFunctionDef,
                     ast.ClassDef, ast.Module),
                ):
                    body = getattr(sub, "body", [])
                    if (
                        body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(body[0].value, ast.Constant)
                        and isinstance(body[0].value.value, str)
                    ):
                        doc_nodes.add(body[0].value)
        for sub in ast.walk(node):
            if sub in doc_nodes:
                continue
            if isinstance(sub, ast.Constant) and isinstance(
                sub.value, str
            ):
                low = sub.value.lower()
                if any(m in low for m in _PUBLICATION_MARKERS):
                    return True
        return False

    def check(self, module, ctx):
        aliases = self._rename_aliases(module.tree)
        idx = _FuncIndex()
        idx.visit(module.tree)

        def enclosing(node):
            for fn in idx.funcs:
                if isinstance(
                    fn, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    for sub in ast.walk(fn):
                        if sub is node:
                            return fn
            return None

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if not self._is_rename_call(node, aliases):
                continue
            args_subtree = ast.Module(
                body=[
                    ast.Expr(value=a)
                    for a in list(node.args)
                    + [kw.value for kw in node.keywords]
                ],
                type_ignores=[],
            )
            touched = self._marker_strings(
                args_subtree, skip_docstrings=False
            )
            if not touched:
                fn = enclosing(node)
                if fn is not None:
                    touched = self._marker_strings(
                        fn, skip_docstrings=True
                    )
            if not touched:
                continue
            yield self.finding(
                module, node,
                "atomic rename publishing a manifest/generation "
                "outside serve/artifact.py + parallel/checkpoint.py "
                "— a second generation publisher forks the two-phase "
                "commit protocol (its generations are invisible to "
                "rollback/orphan recovery); route publication "
                "through serve.artifact.publish_generation or the "
                "distributed-checkpoint committer",
            )


# ---------------------------------------------------------------------------
# SMK120 — engine-dispatch discipline
# ---------------------------------------------------------------------------

# The dense subset-factor entry points in ops/chol.py. A model-layer
# call site reaching one of these DIRECTLY has hard-wired the dense
# engine: under subset_engine="vecchia" the call still builds and
# factors the full (m, m) block — the m^3 wall the sparse engine exists
# to dodge. ops/chol.cholesky and jittered_cholesky are deliberately
# absent: they are the shared primitives both engines use.
_DENSE_FACTOR_FUNCS = (
    "shifted_cholesky",
    "batched_shifted_cholesky",
    "blocked_cholesky",
)

# The engine-dispatch seam inside models/: the only functions allowed
# to touch the dense factor entry points.
_ENGINE_SEAM_FUNCS = (
    "_chol_r",
    "_shifted_chol_one",
    "_shifted_chol_stack",
)


class EngineDispatchRule(Rule):
    id = "SMK120"
    name = "engine-dispatch-discipline"
    doc = (
        "engine dispatch — model-layer code (smk_torch/models/) may "
        "not call the dense subset-factor entry points "
        "(ops.chol.shifted_cholesky / batched_shifted_cholesky / "
        "blocked_cholesky) except from inside the engine-dispatch "
        "seam (_chol_r / _shifted_chol_one / _shifted_chol_stack). "
        "A direct call hard-wires the dense engine: under "
        "subset_engine='vecchia' it still builds and factors the "
        "full (m, m) block while the rest of the sampler runs sparse. "
        "Route the call through the seam (or dispatch on the engine "
        "and suppress the dense arm with a justification)."
    )

    def applies(self, module):
        return "smk_torch/models/" in module.norm_path()

    @staticmethod
    def _factor_aliases(tree) -> dict:
        """Local names bound to a dense factor entry point by
        from-import."""
        out: dict = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module == "smk_torch.ops.chol":
                    for a in node.names:
                        if a.name in _DENSE_FACTOR_FUNCS:
                            out[a.asname or a.name] = a.name
        return out

    @staticmethod
    def _dense_factor_call(node: ast.Call, aliases: dict):
        chain = attr_chain(node.func)
        if not chain:
            return None
        if len(chain) == 1:
            return aliases.get(chain[0])
        if chain[-1] in _DENSE_FACTOR_FUNCS and chain[-2] == "chol":
            return chain[-1]
        return None

    def check(self, module, ctx):
        aliases = self._factor_aliases(module.tree)
        rule = self
        found: List[Finding] = []

        # the INNERMOST enclosing def decides: a nested helper inside a
        # seam function is still the seam, a seam-named closure inside
        # a non-seam function is not
        class _Walk(ast.NodeVisitor):
            def __init__(self):
                self.stack: List[str] = []

            def visit_FunctionDef(self, node):
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Call(self, node):
                target = rule._dense_factor_call(node, aliases)
                if target is not None:
                    inner = self.stack[-1] if self.stack else None
                    if inner not in _ENGINE_SEAM_FUNCS:
                        found.append(rule.finding(
                            module, node,
                            f"direct call to dense factor entry "
                            f"point '{target}' outside the engine-"
                            "dispatch seam (_chol_r / "
                            "_shifted_chol_one / _shifted_chol_stack)"
                            " — this hard-wires the dense engine; "
                            "route through the seam or dispatch on "
                            "the engine first",
                        ))
                self.generic_visit(node)

        _Walk().visit(module.tree)
        yield from found


ALL_RULES = [
    HostNondeterminismRule(),
    HostSyncInCapturedRule(),
    UnusedImportRule(),
    FaultInjectionZoneRule(),
    CompileCacheConfigRule(),
    TelemetryDisciplineRule(),
    UnboundedWaitRule(),
    MeshHygieneRule(),
    AtomicWriteRule(),
    DeadlineDisciplineRule(),
    LadderDisciplineRule(),
    BoundedCoalesceWaitRule(),
    DeviceLayoutRule(),
    ScheduleDisciplineRule(),
    GenerationPublicationRule(),
    EngineDispatchRule(),
]

# The twin's ids that have no counterpart here, each with its reason
# (analysis/RULES.md gives the long form).
NOT_PORTED = {
    "SMK101": "JAX-only: the port defines no custom primitives and has "
    "no vmap, so no batching rule can be missing",
    "SMK104": "JAX-only: torch has no buffer donation (donate_argnums) "
    "and no async copy_to_host_async to order against it",
    "SMK105": "JAX-only: a pinned program guards an XLA module context; "
    "a CUDA graph has none (its capture is the program)",
    "SMK106": "the twin's rule: tests/ is shared, and the twin's tree "
    "gate already lints every tests/test_torch_*.py",
}
