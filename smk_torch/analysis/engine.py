"""smklint rule engine of the port: findings, suppression directives,
file walking — the port's own copy of the JAX package's engine (same
``Finding``, directive grammar, ``lint_paths``/``lint_source`` and
SMK100), plus the ``captured`` directive of SMK103.

Design constraints:

- pure stdlib ``ast`` — the linter runs in seconds on the CPU with no
  torch import;
- every rule has an id, one-line docs, and per-line / per-file
  ``# smklint: disable=<id>`` suppression;
- every suppression must carry a justification (text after ``--``);
  a bare suppression is itself a finding (SMK100) and cannot be
  suppressed.

Directive grammar (one per comment, anywhere on the line):

    # smklint: disable=SMK103 -- why this is deliberate
    # smklint: disable-file=SMK102 -- why, for the whole file
    # smklint: captured                  (on/above a def: SMK103)
    # smklint: pinned-program            (parsed; the twin's SMK105)
    # smklint: test-budget=<why fast>    (module-level: SMK106)
    # smklint: budget=<why fast>         (on/above a test def: SMK106)

Line-scoped disables apply to findings on the comment's own line or
the line immediately below (comment-above-statement style).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

BARE_SUPPRESSION_ID = "SMK100"

_DIRECTIVE_RE = re.compile(r"#\s*smklint:\s*(?P<body>[^#]*)")
_DISABLE_RE = re.compile(
    r"^(?P<kind>disable|disable-file)\s*=\s*(?P<ids>[A-Z0-9,\s]+?)"
    r"(?:\s*--\s*(?P<why>.*\S))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Suppression:
    rule: str
    line: int  # comment line; covers `line` and `line + 1`
    file_wide: bool
    justified: bool
    used: bool = False

    def covers(self, finding: Finding) -> bool:
        if finding.rule != self.rule:
            return False
        return self.file_wide or finding.line in (
            self.line, self.line + 1
        )


@dataclass
class Directives:
    suppressions: List[Suppression] = field(default_factory=list)
    pinned_lines: List[int] = field(default_factory=list)
    captured_lines: List[int] = field(default_factory=list)
    budget_lines: List[int] = field(default_factory=list)
    file_budget: bool = False
    malformed: List[Finding] = field(default_factory=list)


def _comment_tokens(source: str, lines: List[str]):
    """(line, comment_text) for every real COMMENT token — directives
    inside string literals (e.g. lint-fixture strings in tests) must
    NOT parse as directives for the file that merely quotes them."""
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        return [
            (t.start[0], t.string)
            for t in toks
            if t.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return list(enumerate(lines, start=1))


def _parse_directives(
    path: str, source: str, lines: List[str], known_ids
) -> Directives:
    d = Directives()
    for i, text in _comment_tokens(source, lines):
        m = _DIRECTIVE_RE.search(text)
        if m is None:
            continue
        body = m.group("body").strip()
        if body.startswith("pinned-program"):
            d.pinned_lines.append(i)
            continue
        if body.startswith("captured"):
            d.captured_lines.append(i)
            continue
        if body.startswith("test-budget="):
            d.file_budget = True
            continue
        if body.startswith("budget="):
            d.budget_lines.append(i)
            continue
        dm = _DISABLE_RE.match(body)
        if dm is None:
            d.malformed.append(Finding(
                BARE_SUPPRESSION_ID, path, i,
                f"unrecognized smklint directive {body!r} (expected "
                "disable=<ID> -- <justification>, disable-file=<ID> "
                "-- <justification>, captured, pinned-program, "
                "budget=, or test-budget=)",
            ))
            continue
        why = dm.group("why")
        ids = [s for s in re.split(r"[,\s]+", dm.group("ids")) if s]
        for rid in ids:
            if rid == BARE_SUPPRESSION_ID or rid not in known_ids:
                d.malformed.append(Finding(
                    BARE_SUPPRESSION_ID, path, i,
                    f"suppression names unknown rule id {rid!r}"
                    if rid != BARE_SUPPRESSION_ID
                    else f"{BARE_SUPPRESSION_ID} (bare/unjustified "
                    "suppression) cannot itself be suppressed",
                ))
                continue
            if not why:
                # the suppression is honored (the author's intent is
                # clear) but the missing justification is its own
                # unsuppressable finding — one actionable report, not
                # the underlying finding twice
                d.malformed.append(Finding(
                    BARE_SUPPRESSION_ID, path, i,
                    f"suppression of {rid} carries no justification — "
                    "append ` -- <one-line reason>`",
                ))
            d.suppressions.append(Suppression(
                rule=rid, line=i,
                file_wide=dm.group("kind") == "disable-file",
                justified=bool(why),
            ))
    return d


@dataclass
class LintModule:
    """One parsed source file, shared across all rules."""

    path: str
    source: str
    tree: ast.Module
    lines: List[str]
    directives: Directives

    @property
    def basename(self) -> str:
        return os.path.basename(self.path)

    def norm_path(self) -> str:
        return self.path.replace(os.sep, "/")

    def directive_near_def(self, node, kind: str) -> bool:
        """True when a `captured`/`pinned-program`/`budget=` directive
        sits on the def line, a decorator line, or within two lines
        above the def's first line (decorators included)."""
        linenos = [node.lineno] + [
            d.lineno for d in getattr(node, "decorator_list", [])
        ]
        start = min(linenos)
        lines = {
            "captured": self.directives.captured_lines,
            "pinned-program": self.directives.pinned_lines,
        }.get(kind, self.directives.budget_lines)
        return any(
            start - 2 <= ln <= max(linenos) + 1 for ln in lines
        )


class LintContext:
    """Run-wide state rules may consult (e.g. "is this function name
    referenced anywhere under tests/?" for the golden-pin rule)."""

    def __init__(self, tests_text: str = "", repo_root: str = "."):
        self.tests_text = tests_text
        self.repo_root = repo_root

    def referenced_in_tests(self, name: str) -> bool:
        return name in self.tests_text


def parse_module(
    path: str, source: Optional[str] = None, known_ids=()
) -> Optional[LintModule]:
    if source is None:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None  # a file that does not parse is pytest's problem
    lines = source.splitlines()
    return LintModule(
        path=path, source=source, tree=tree, lines=lines,
        directives=_parse_directives(
            path, source, lines, set(known_ids)
        ),
    )


def _iter_py_files(paths: Iterable[str]):
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d not in ("__pycache__", ".git", ".ruff_cache")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        elif p.endswith(".py"):
            yield p


def _apply_suppressions(
    module: LintModule, findings: List[Finding]
) -> List[Finding]:
    kept = []
    for f in findings:
        hit = None
        for s in module.directives.suppressions:
            if s.covers(f):
                hit = s
                break
        if hit is None:
            kept.append(f)
        else:
            hit.used = True
    kept.extend(module.directives.malformed)
    # a suppression that matched nothing is stale — the violation it
    # was excusing is gone (or never lived on the covered lines) and
    # leaving it would silently mask the NEXT finding to land there
    for s in module.directives.suppressions:
        if not s.used and s.justified:
            kept.append(Finding(
                BARE_SUPPRESSION_ID, module.path, s.line,
                f"suppression of {s.rule} matched no finding — the "
                "code it excused is gone or the comment is on the "
                "wrong line; delete it (a stale disable masks the "
                "next real violation here)",
            ))
    return kept


def lint_module(
    module: LintModule, rules, ctx: LintContext
) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for rule in rules:
        if not rule.applies(module):
            continue
        for f in rule.check(module, ctx):
            key = (f.rule, f.line, f.message)
            if key not in seen:  # nested-function walks can repeat
                seen.add(key)
                findings.append(f)
    return _apply_suppressions(module, findings)


def _build_context(files: List[str], repo_root: str) -> LintContext:
    """Concatenate the text of every tests/ file reachable from the
    lint targets — the reference corpus a rule may consult. Looks next
    to each target and under repo_root so `lint smk_torch/` still sees
    tests/."""
    seen = set()
    chunks = []
    roots = {repo_root}
    for f in files:
        parent = os.path.dirname(os.path.abspath(f))
        roots.add(parent)
        roots.add(os.path.dirname(parent))
    for root in roots:
        tdir = os.path.join(root, "tests")
        if not os.path.isdir(tdir):
            continue
        for name in sorted(os.listdir(tdir)):
            full = os.path.join(tdir, name)
            if name.endswith(".py") and full not in seen:
                seen.add(full)
                try:
                    with open(full, "r", encoding="utf-8") as fh:
                        chunks.append(fh.read())
                except OSError:
                    pass
    return LintContext("\n".join(chunks), repo_root)


def lint_paths(
    paths: Iterable[str], rules=None, repo_root: str = "."
) -> List[Finding]:
    """Lint files/directories; returns unsuppressed findings sorted by
    (path, line). Raises FileNotFoundError/ValueError on operands that
    don't exist or aren't .py files/directories — a typo'd path must
    fail the gate loudly, never lint zero files and report clean."""
    from smk_torch.analysis.rules import ALL_RULES

    paths = list(paths)
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"lint path {p!r} does not exist (cwd: {os.getcwd()})"
            )
        if not os.path.isdir(p) and not p.endswith(".py"):
            raise ValueError(
                f"lint path {p!r} is neither a directory nor a .py "
                "file"
            )
    rules = ALL_RULES if rules is None else rules
    known = {r.id for r in rules}
    files = list(dict.fromkeys(_iter_py_files(paths)))
    ctx = _build_context(files, repo_root)
    out: List[Finding] = []
    for path in files:
        module = parse_module(path, known_ids=known)
        if module is not None:
            out.extend(lint_module(module, rules, ctx))
    return sorted(out, key=lambda f: (f.path, f.line, f.rule))


def lint_source(
    source: str,
    path: str = "<memory>/smk_torch/fixture.py",
    rules=None,
    tests_text: str = "",
) -> List[Finding]:
    """Lint a source string (the fixture/test entry point). ``path``
    participates in rule scoping, so fixtures pick their zone by
    choosing a virtual path."""
    from smk_torch.analysis.rules import ALL_RULES

    rules = ALL_RULES if rules is None else rules
    known = {r.id for r in rules}
    module = parse_module(path, source=source, known_ids=known)
    if module is None:
        raise SyntaxError(f"fixture does not parse: {path}")
    return sorted(
        lint_module(module, rules, LintContext(tests_text)),
        key=lambda f: (f.path, f.line, f.rule),
    )
