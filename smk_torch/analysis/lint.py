"""smklint CLI of the port: ``python -m smk_torch.analysis.lint
<paths...>`` (e.g. ``smk_torch chip_smoke.py scripts/torch_*.py``).

Exit status 0 = no unsuppressed findings, 1 = findings, 2 = usage.
Deliberately imports no torch — the whole run is stdlib AST work and
finishes in seconds on the CPU (a tier-1 test runs it).
"""

from __future__ import annotations

import argparse
import sys
import time

from smk_torch.analysis.engine import lint_paths
from smk_torch.analysis.rules import ALL_RULES, NOT_PORTED


def _list_rules() -> str:
    out = ["smklint rules (suppress: # smklint: disable=<ID> -- <why>)"]
    out.append(
        "  SMK100 bare-suppression: a suppression without a "
        "justification (` -- reason`) or naming an unknown rule id is "
        "itself a finding and cannot be suppressed"
    )
    for rule in ALL_RULES:
        out.append(f"  {rule.id} {rule.name}: {rule.doc}")
    for rid, why in sorted(NOT_PORTED.items()):
        out.append(f"  {rid} (not ported): {why}")
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m smk_torch.analysis.lint",
        description=(
            "static analysis enforcing the port's invariants "
            "(see smk_torch/analysis/RULES.md)"
        ),
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (e.g. smk_torch/ chip_smoke.py)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit",
    )
    parser.add_argument(
        "--select", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if not args.paths:
        parser.print_usage()
        return 2

    rules = ALL_RULES
    if args.select:
        wanted = {s.strip() for s in args.select.split(",") if s.strip()}
        unknown = wanted - {r.id for r in ALL_RULES}
        if unknown:
            print(f"unknown rule id(s): {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in ALL_RULES if r.id in wanted]

    # smklint: disable=SMK110 -- the linter CLI times itself, and analysis/ stays torch-free so it cannot import the tracing clock (utils/tracing imports torch)
    t0 = time.perf_counter()
    try:
        findings = lint_paths(args.paths, rules=rules)
    except (FileNotFoundError, ValueError) as e:
        # a typo'd operand must never produce a false-green gate
        print(f"smklint: {e}", file=sys.stderr)
        return 2
    # smklint: disable=SMK110 -- the same torch-free CLI self-timing site as above
    dt = time.perf_counter() - t0
    for f in findings:
        print(f.render())
    n_files = len(set(f.path for f in findings))
    if findings:
        print(
            f"smklint: {len(findings)} finding(s) in {n_files} "
            f"file(s) [{dt:.2f}s]"
        )
        return 1
    print(f"smklint: clean [{dt:.2f}s]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
