"""Where a Gibbs sweep of the PyTorch port (smk_torch) spends its time
on one CUDA card.

    python3 scripts/torch_sweep_profile.py [--k 32] [--m 3906] [--q 1]

Builds config5's per-chip slice (K subsets of m rows, t = 64 test
sites, exponential covariance; the data recipe of chip_smoke.py) and
runs the K-batched sampler with fused_build="pallas" (the CUDA kernel)
and "off" (the port's distance-matrix build) in turns — pallas, off,
off, pallas — so the two are compared on one card within one process.
For each turn it prints one JSON line: ms per burn-in and per
collecting sweep (host clock around each synced sweep; median), peak
device memory, and a torch.profiler window over two collecting sweeps:
device time by kernel (the largest entries), the device's busy time
(sum of kernel times on its one stream) and its idle share of the
window. The card's nvidia-smi name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def run_turn(fused, data, args, device):
    import torch

    from chip_smoke import profile_sweeps
    from smk_torch.config import SMKConfig
    from smk_torch.models import probit_gp as tp

    k, m, q, p = data.x.shape
    cfg = SMKConfig(n_subsets=k, n_samples=40, fused_build=fused)
    model = tp.SpatialGPSampler(cfg)
    shapes = tp.SweepShapes(k, m, q, p, data.coords_test.shape[0])
    noise = tp.GeneratorNoise(tp.subset_generators(args.seed, k, device), shapes,
                              device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = model.init_state(data)
    consts = model._consts(data)
    cache = model._solve_cache(consts, data.mask, state)

    def sweep(it, collect):
        nonlocal state, cache
        start = time.perf_counter()
        state, cache, _ = model._gibbs_step(
            data, consts, state, cache, it, noise(it, collect), collect=collect
        )
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3

    burn = [sweep(it, False) for it in range(args.burn)]
    cache = model._solve_cache(consts, data.mask, state, predict=True)
    collect = [sweep(args.burn + i, True) for i in range(args.collect)]
    window = profile_sweeps(
        lambda: [sweep(args.burn + args.collect + i, True) for i in range(2)], top=args.top
    )
    return {
        "fused_build": fused, "K": k, "m": m, "q": q,
        "burn_ms_median": statistics.median(burn[1:] or burn),
        "collect_ms_median": statistics.median(collect),
        "burn_ms": burn, "collect_ms": collect,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "profile": window,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--m", type=int, default=3906)
    ap.add_argument("--q", type=int, default=1)
    ap.add_argument("--t", type=int, default=64)
    ap.add_argument("--burn", type=int, default=4)
    ap.add_argument("--collect", type=int, default=3)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import binary_field
    from smk_torch.models.probit_gp import SubsetData
    from smk_torch.parallel.partition import random_partition

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    y, x, coords, ct, xt = (
        torch.as_tensor(a, device=device)
        for a in binary_field(args.k * args.m, args.q, 2, args.t, args.seed)
    )
    g = torch.Generator(device=device).manual_seed(args.seed)
    perm = torch.randperm(y.shape[0], generator=g, device=device)
    part = random_partition(perm, y, x, coords, args.k)
    data = SubsetData(part.coords, part.x, part.y, part.mask, ct, xt)
    for fused in ("pallas", "off", "off", "pallas"):
        print(json.dumps(run_turn(fused, data, args, device)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
