"""The port's span recorder (``smk_torch.obs.record_spans``), armed
around a call. Beside port.py, the one other module of the harness that
imports the port, and it does so when called, not when imported."""

from __future__ import annotations


def available() -> bool:
    """Whether the port has a span recorder."""
    try:
        from smk_torch.obs import record_spans  # noqa: F401
    except ImportError:
        return False
    return True


def recorded(call):
    """``(call(), recorder)`` with the port's span recorder armed around
    the call; the recorder holds the spans (``export()``: Unix-clock ns,
    harness/spans.py), their ``totals()`` and the ``counters``. None
    where the port has no recorder (a program from before it)."""
    try:
        from smk_torch.obs import record_spans
    except ImportError:
        return None
    with record_spans() as rec:
        out = call()
    return out, rec
