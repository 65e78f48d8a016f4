"""What bounds the symmetric correlation-build kernel on one CUDA card.

    python3 scripts/torch_build_probe.py [--k 32] [--m 3904,3906]

Builds variants of smk_torch/csrc/fused_corr.cu, each the shipped
source with one text substitution, and times the square masked build
(K x 1 x m x m, d = 2, exponential) through each at every m, next to a
plain fill of the same output and the tile kernel (layout 0). Variants:

- shipped          the source as it is;
- tile_aligned     column segments start at multiples of 64, not on
                   32-byte sector boundaries (rows whose start is not
                   sector-aligned then share sectors between blocks);
- no_store         the 16-byte output stores are skipped;
- no_correlation   sqrt, exp, mask blend and shift are skipped (the
                   region holds the squared distances);
- blocks2, blocks4 __launch_bounds__ asks for 2 or 4 resident blocks
                   per SM instead of 3;
- generic_d2       d = 2 runs the generic instantiation (the dimension
                   read at run time, the column coordinates from shared
                   memory) instead of the one compiled for d = 2.

Times are CUDA-event medians of one call queued behind a short device
sleep (chip_smoke.ms_median with device_only), taken in turns (variant
order, then reversed). Each variant's output must equal the tile
kernel's bit for bit where it computes the same function. Prints the
card's nvidia-smi line, one JSON line per variant build (registers,
spills, SASS instructions of the masked exponential kernel that d = 2
runs), and one per m.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

LAUNCH_BOUNDS = "__launch_bounds__(SYM_THREADS, 3)"
STORE_IF = "  if (j >= 0 && j + 4 <= M) {\n"
VARIANTS = {
    "shipped": [],
    "tile_aligned": [
        ("HALO - sector_offset(row)", "HALO"),
        (STORE_IF, "  if (j >= 0 && j + 4 <= M &&\n"
                   "      (reinterpret_cast<unsigned long long>(row + j) & 15) == 0) {\n"),
    ],
    "no_store": [
        ("    __stcs(reinterpret_cast<float4*>(row + j), v);\n",
         "    if (v.x == 1234.5f) __stcs(reinterpret_cast<float4*>(row + j), v);\n"),
    ],
    "no_correlation": [
        ("sm.val[a][b + cc] = pair_value<MODEL, MASKED, SHIFTED, true>(",
         "sm.val[a][b + cc] = sq[cc]; if (false) pair_value<MODEL, MASKED, SHIFTED, true>("),
    ],
    "blocks2": [(LAUNCH_BOUNDS, "__launch_bounds__(SYM_THREADS, 2)")],
    "blocks4": [(LAUNCH_BOUNDS, "__launch_bounds__(SYM_THREADS, 4)")],
    "generic_d2": [
        ("    if (args.D == 2) return launch_sym<MODEL, MASKED, SHIFTED, 2>(args, stream);\n", ""),
    ],
}
# variants whose output is the shipped kernel's
SAME_FUNCTION = ("shipped", "tile_aligned", "blocks2", "blocks4", "generic_d2")
# the exponential masked kernel that d = 2 runs (its last template
# argument is the compiled dimension, 0 for the generic one)
SASS_KERNEL = "fused_corr_sym_kernelILi0ELb1ELb0ELi2E"
SASS_KERNEL_GENERIC = "fused_corr_sym_kernelILi0ELb1ELb0ELi0E"


def build_variants(out_dir: Path) -> dict:
    """One nvcc per variant, all started together; returns name ->
    (library path, build report)."""
    from smk_torch.ops import cuda_build

    src = (cuda_build.csrc_dir() / "fused_corr.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate(timeout=cuda_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{err}")
        built[name] = (lib, err)
    return built


def ptxas_report(err: str, kernel: str) -> dict:
    """Registers and spill bytes of `kernel`."""
    lines = err.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            block = " ".join(lines[n:n + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            return {"registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None}
    return {}


def sass_count(lib: Path, kernel: str) -> int | None:
    """Instructions in the SASS of `kernel` (static count, from
    cuobjdump), or None where cuobjdump is missing."""
    from smk_torch.ops import cuda_build

    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "--dump-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    for part in re.split(r"\n\s*Function : ", out)[1:]:
        if part.split("\n", 1)[0].startswith("_Z") and kernel in part.split("\n", 1)[0]:
            return len(re.findall(r"/\*[0-9a-f]{4}\*/\s+[^;]*;", part))
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--m", default="3904,3906")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_build_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import ms_median, nvidia_smi_line
    from smk_torch.ops import cuda_build
    from smk_torch.ops.fused_build import bind_kernel

    print(nvidia_smi_line(), flush=True)
    built = build_variants(cuda_build.build_dir() / "probe")
    fns = {}
    for name, (lib, err) in built.items():
        fns[name] = bind_kernel(ctypes.CDLL(str(lib)))
        kernel = SASS_KERNEL_GENERIC if name == "generic_d2" else SASS_KERNEL
        print(json.dumps({"variant": name, "kernel": kernel, **ptxas_report(err, kernel),
                          "sass_instructions": sass_count(lib, kernel)}), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k = args.k
    for m in (int(v) for v in args.m.split(",")):
        coords = torch.rand(k, m, 2, device=dev, generator=gen)
        phis = 4.0 + 8.0 * torch.rand(k, 1, device=dev, generator=gen)
        mask = torch.ones(k, m, device=dev)
        out = torch.empty(k, 1, m, m, device=dev)

        def launch(fn, layout):
            err = fn(coords.data_ptr(), coords.data_ptr(), phis.data_ptr(), mask.data_ptr(),
                     0, out.data_ptr(), k, 1, m, m, 2, coords.stride(0), coords.stride(0),
                     0, 1, 0, 1, layout, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(fns["shipped"], 0)
        torch.cuda.synchronize()
        want = out.clone()
        row = {"m": m, "K": k, "write_GB": out.numel() * 4 / 1e9,
               "fill_ms": ms_median(lambda: out.fill_(1.0), device_only=True)}
        order = list(fns)
        for name in order + order[::-1]:
            row.setdefault(name + "_ms", []).append(
                ms_median(lambda: launch(fns[name], 1), device_only=True))
            if name in SAME_FUNCTION:
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"m={m}: variant {name} != the tile kernel")
        row["tile_kernel_ms"] = ms_median(lambda: launch(fns["shipped"], 0), device_only=True)
        print(json.dumps(row), flush=True)
        del out, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
