"""The reduction of a profiler trace to the traced fit's numbers: busy
time per card, the window from the first event to the last end, device
time by name, and each long idle gap named by what the host was doing."""

# smklint: test-budget=pure Python on hand-made events, milliseconds

import json

import pytest

from harness import trace


def test_chrome_trace_to_summary(tmp_path):
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 0, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "potrf", "ts": 10, "dur": 40, "args": {"device": 0}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 55, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 20,
         "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "gemv", "ts": 200, "dur": 100, "args": {"device": 0}},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    dev, host, window = trace.read_chrome_trace(path)
    assert window == (0.0, 300.0) and len(dev) == 3 and len(host) == 2
    s = trace.summarize(dev, host, window)
    assert s["window_s"] == pytest.approx(300e-6)
    assert s["busy_s"] == pytest.approx(160e-6)
    assert s["device_ops"][0] == ["gemv", pytest.approx(100e-6)]
    # gaps: [80, 200) named by the launch that ends it; [50, 60) inside the
    # synchronisation; [0, 10) inside no host call, ended by potrf
    assert s["idle_gaps"] == [["launching gemv", pytest.approx(120e-6)],
                              ["launching potrf", pytest.approx(10e-6)],
                              ["cudaStreamSynchronize", pytest.approx(10e-6)]]
