"""The five fused-build entry points of any checkout, and the sampler's
kriging build, timed under both timers of chip_smoke.py on one CUDA
card.

    python3 scripts/torch_kernel_times.py [--root DIR]

Imports smk_torch from DIR (default: this checkout), builds its kernels
from DIR's sources, and times each entry point at the main path's shapes
(K = 32, s = 1, m = 3906, t = 64, exponential, as chip_smoke.py) with
this checkout's chip_smoke.ms_median, so every checkout is timed the
same way: `ms`, one call from an idle card (the wrapper's host time
counts), and `device_ms`, each call queued behind a short device sleep.
Beside them: the cross build with the sampler's row mask (in the kernel
where the checkout's fused_cross_correlation takes `row_mask`, else as
the product after the build that the sampler took), the sampler's whole
kriging build SpatialGPSampler._cross_test_corr (cross build, mask, test
stack) and an empty launch (torch.cuda._sleep(1)). To compare two
checkouts, run it on both in turns in one call. Prints the card's
nvidia-smi line, then one JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO), help="checkout whose smk_torch is timed")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    root = Path(args.root).resolve()

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs  # this checkout's timer and shapes, for every root

    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    from smk_torch import SMKConfig
    from smk_torch.models.probit_gp import BuildConsts, SpatialGPSampler
    from smk_torch.ops import cuda_build
    from smk_torch.ops import fused_build as fb

    cs.check(Path(fb.__file__).resolve().is_relative_to(root),
             f"smk_torch was imported from {fb.__file__}, not from {root}")
    print(cs.nvidia_smi_line(), flush=True)
    cuda_build.build()

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k, m, t = cs.MAIN_K, cs.MAIN_M, cs.MAIN_T
    coords = torch.rand(k, m, 2, generator=gen, device=dev)
    test = torch.rand(t, 2, generator=gen, device=dev)
    phis = 4.0 + 8.0 * torch.rand(k, 1, generator=gen, device=dev)
    mask = torch.ones(k, m, device=dev)
    shift = 0.5 + 1.5 * torch.rand(k, m, generator=gen, device=dev)
    model = "exponential"
    calls = {
        "fused_masked_correlation_stack":
            lambda: fb.fused_masked_correlation_stack(coords, phis, mask, model),
        "fused_masked_shifted_build":
            lambda: fb.fused_masked_shifted_build(coords, phis, mask, shift, model),
        "fused_cross_correlation": lambda: fb.fused_cross_correlation(coords, test, phis, model),
        "fused_correlation_stack": lambda: fb.fused_correlation_stack(test, phis, model),
        "fused_correlation": lambda: fb.fused_correlation(coords, phis[:, 0], model),
    }
    in_kernel = "row_mask" in inspect.signature(fb.fused_cross_correlation).parameters
    if in_kernel:
        calls["cross_with_row_mask"] = lambda: fb.fused_cross_correlation(
            coords, test, phis, model, row_mask=mask)
    else:
        calls["cross_with_row_mask"] = lambda: mask[:, None, :, None] * fb.fused_cross_correlation(
            coords, test, phis, model)
    sampler = SpatialGPSampler(SMKConfig(n_subsets=k, fused_build="pallas"))
    consts = BuildConsts(None, None, None, coords, test)
    calls["cross_test_corr"] = lambda: sampler._cross_test_corr(consts, phis, mask)
    calls["empty_launch"] = lambda: torch.cuda._sleep(1)
    times = {}
    for name, run in calls.items():
        times[name] = {"ms": cs.ms_median(run), "device_ms": cs.ms_median(run, device_only=True)}
        torch.cuda.empty_cache()
    cs.check(sum(fb.PLAIN_CALLS.values()) == 0 and all(fb.LAUNCHES[n] > 0 for n in fb.ENTRY_POINTS),
             "an entry point did not launch its kernel")
    times["cross_with_row_mask"]["row_mask_in_kernel"] = in_kernel
    print(json.dumps({"root": str(root), "K": k, "m": m, "t": t, "kernels": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
