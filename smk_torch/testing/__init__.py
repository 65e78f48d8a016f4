"""Test-only instrumentation of the port — twin of ``smk_tpu/testing``.

``smk_torch.testing.faults`` is the deterministic chaos-injection
harness and ``testing/dcn_worker`` the multi-process worker. Nothing in
here may be imported from ``smk_torch`` library code — smklint rule
SMK108 enforces that the injectors are referenced only under ``tests/``
and ``scripts/`` (and ``chip_smoke.py``).
"""

__all__: list = []
