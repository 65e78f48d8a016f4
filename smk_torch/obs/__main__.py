"""CLI: ``python -m smk_torch.obs summarize <run.jsonl> [--json]``."""

import sys


def main(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m smk_torch.obs summarize <run.jsonl> [--json]")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "summarize":
        from smk_torch.obs.summarize import main as summarize_main

        return summarize_main(rest)
    print(f"unknown obs command {cmd!r} (expected: summarize)")
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
