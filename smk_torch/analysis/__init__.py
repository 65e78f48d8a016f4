"""The port's correctness tooling — twin of ``smk_tpu/analysis``.

Two layers:

- ``smklint`` — AST static analysis (engine.py + rules.py, CLI in
  lint.py) of the invariants the port carries over from the JAX
  package, each rule under its twin's id (host-side determinism, no
  host sync inside captured code, one clock, bounded waits, one mesh
  constructor, atomic writes, deadlines on the serving path, ...).
  Run it as ``python -m smk_torch.analysis.lint smk_torch chip_smoke.py
  scripts/torch_*.py``.
- runtime sanitizers (sanitizers.py): ``recompile_guard`` (fails a
  declared-warm region that builds a kernel library or captures a
  program) and ``transfer_guard_strict`` (arms torch's CUDA sync debug
  mode and ledgers every sanctioned device<->host copy).

The rule map, with the twin's ids that are JAX-only, is
``smk_torch/analysis/RULES.md``.
"""

from smk_torch.analysis.engine import Finding, lint_paths, lint_source

_SANITIZER_EXPORTS = (
    "RecompileError",
    "TransferLedger",
    "explicit_d2h",
    "recompile_guard",
    "transfer_guard_strict",
)

__all__ = [
    "Finding",
    "lint_paths",
    "lint_source",
    *_SANITIZER_EXPORTS,
]


def __getattr__(name):
    # sanitizers import torch; the lint CLI stays stdlib-only, so the
    # runtime layer loads lazily
    if name in _SANITIZER_EXPORTS:
        from smk_torch.analysis import sanitizers

        return getattr(sanitizers, name)
    raise AttributeError(name)
