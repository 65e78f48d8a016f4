"""Where the port runs: the CUDA device unless the caller asks for the
CPU. There is no silent drop to the CPU when no card is present."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA device, and
    raises when there is none (pass ``device="cpu"`` to run the plain
    PyTorch versions on the CPU, as the tests do)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "smk_torch runs on the CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def in_callers_context(fn, dev: torch.device):
    """``fn`` wrapped to run on another thread under this thread's CUDA
    device, current stream and grad mode (all three are per thread in
    torch), so a worker queues the same work on the same stream."""
    grad = torch.is_grad_enabled()
    if dev.type != "cuda":
        def run():
            with torch.set_grad_enabled(grad):
                return fn()
        return run
    stream = torch.cuda.current_stream(dev)

    def run():
        with torch.cuda.device(dev), torch.cuda.stream(stream), torch.set_grad_enabled(grad):
            return fn()
    return run
