"""What bounds the correlation-build kernels on one CUDA card.

    python3 scripts/torch_build_probe.py [--k 32] [--m 3904,3906]
    python3 scripts/torch_build_probe.py --narrow [--k 32] [--m 3906]
    python3 scripts/torch_build_probe.py --f64 [--k 32] [--m 3904,3906]

Builds variants of smk_torch/csrc/fused_corr.cu (its float32 library),
each the shipped source with one text substitution, and times the square masked build
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

With --narrow it probes the narrow kernel (layout 2) instead, timed on
the kriging builds at (K, 1, m, t): the cross build with its row mask
at t = 64 and 123 and the test stack (K, 1, 64, 64), beside the tile
kernel (which has no row mask) and a plain fill of the same output.
Variants:

- shipped          the source as it is;
- rows32 .. rows128  32, 64 or 128 rows a work item (NARROW_ROWS; the
                   shipped kernel takes 96);
- item_per_block   one work item a block (no persistent grid);
- batch1           each pass loads its rows' operands on its own
                   (NARROW_BATCH = 1);
- plain_stores     the output stores without the evict-first hint;
- no_store         the output stores are skipped;
- no_correlation   sqrt, exp and the row mask are skipped (the output
                   holds the squared distances).

Every variant that computes the shipped function must equal the tile
kernel bit for bit. Its build lines report the row-masked d = 2 cross
kernel.

With --f64 it probes the double symmetric kernel (the float64 library,
built with -DSMK_FUSED_CORR_F64) on the float64 masked build, beside the
double tile kernel. Variants: shipped; blocks3, blocks6, blocks8
(resident blocks asked of the compiler: 4 shipped); tile_aligned;
no_store; no_correlation. Its build lines also count the FP64
instructions an element in the SASS (chip_smoke.sass_fp64_per_element).
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

SYM_TILES = "STILE = 64, THREADS = 256, MIN_BLOCKS = 3;"
STORE_IF = "  if (j >= 0 && j + V <= M) {\n"
VARIANTS = {
    "shipped": [],
    "tile_aligned": [
        ("HALO - sector_offset(row)", "HALO"),
        (STORE_IF, "  if (j >= 0 && j + V <= M &&\n"
                   "      (reinterpret_cast<unsigned long long>(row + j) & 15) == 0) {\n"),
    ],
    "no_store": [
        ("    __stcs(reinterpret_cast<typename Num<T>::vec*>(row + j), v);\n",
         "    if (v.x == 1234.5f) __stcs(reinterpret_cast<typename Num<T>::vec*>(row + j), v);\n"),
    ],
    "no_correlation": [
        ("sm.val[a][b + cc] = pair_value<MODEL, MASKED, SHIFTED, true>(",
         "sm.val[a][b + cc] = sq[cc]; if (false) pair_value<MODEL, MASKED, SHIFTED, true>("),
    ],
    "blocks2": [(SYM_TILES, "STILE = 64, THREADS = 256, MIN_BLOCKS = 2;")],
    "blocks4": [(SYM_TILES, "STILE = 64, THREADS = 256, MIN_BLOCKS = 4;")],
    "generic_d2": [
        ("    if (args.D == 2) return launch_sym<T, MODEL, MASKED, SHIFTED, 2>(args, stream);\n", ""),
    ],
}
# variants whose output is the shipped kernel's
SAME_FUNCTION = ("shipped", "tile_aligned", "blocks2", "blocks4", "generic_d2")
F64_TILES = "STILE = 32, THREADS = 128, MIN_BLOCKS = 4;"
F64_VARIANTS = {
    "shipped": [],
    "blocks3": [(F64_TILES, "STILE = 32, THREADS = 128, MIN_BLOCKS = 3;")],
    "blocks6": [(F64_TILES, "STILE = 32, THREADS = 128, MIN_BLOCKS = 6;")],
    "blocks8": [(F64_TILES, "STILE = 32, THREADS = 128, MIN_BLOCKS = 8;")],
    "tile_aligned": VARIANTS["tile_aligned"],
    "no_store": VARIANTS["no_store"],
    "no_correlation": VARIANTS["no_correlation"],
}
F64_SAME_FUNCTION = ("shipped", "blocks3", "blocks6", "blocks8", "tile_aligned")
NARROW_ROWS_LINE = re.compile(r"constexpr int NARROW_ROWS = \d+;")
NARROW_STORE4 = "__stcs(reinterpret_cast<typename N::vec*>(row + j0), N::pack(v));"
NARROW_STORE1 = "__stcs(row + j0 + js * cc, v[cc]);"
NARROW_VARIANTS = {
    "shipped": [],
    "rows32": [(None, "constexpr int NARROW_ROWS = 32;")],
    "rows64": [(None, "constexpr int NARROW_ROWS = 64;")],
    "rows128": [(None, "constexpr int NARROW_ROWS = 128;")],
    "item_per_block": [("  const int grid = (int)(items < resident ? items : resident);\n"
                        "  fused_corr_narrow_kernel", "  const int grid = (int)items;\n"
                        "  fused_corr_narrow_kernel")],
    "batch1": [("constexpr int NARROW_BATCH = 4;", "constexpr int NARROW_BATCH = 1;")],

    "plain_stores": [
        (NARROW_STORE4, "*reinterpret_cast<typename N::vec*>(row + j0) = N::pack(v);"),
        (NARROW_STORE1, "row[j0 + js * cc] = v[cc];"),
    ],
    "no_store": [
        (NARROW_STORE4, "if (v[0] == 1234.5f) " + NARROW_STORE4),
        (NARROW_STORE1, "if (v[cc] == 1234.5f) " + NARROW_STORE1),
    ],
    "no_correlation": [
        ("          v[cc] = pair_value<MODEL, false, false, ZERO_DIAG>(\n"
         "              sq, i == j0 + js * cc, phi, T(0), T(0), T(0));\n"
         "          if (ROW_MASK) v[cc] = N::mul(ri[p], v[cc]);\n",
         "          v[cc] = sq;\n"),
    ],
}
NARROW_SAME_FUNCTION = ("shipped", "rows32", "rows64", "rows128", "item_per_block",
                        "batch1", "plain_stores")
# the exponential masked kernel that d = 2 runs (its last template
# argument is the compiled dimension, 0 for the generic one)
SASS_KERNEL = "fused_corr_sym_kernelIfLi0ELb1ELb0ELi2E"
SASS_KERNEL_GENERIC = "fused_corr_sym_kernelIfLi0ELb1ELb0ELi0E"
# the row-masked exponential cross kernel at d = 2 (layout 2)
SASS_KERNEL_NARROW = "fused_corr_narrow_kernelIfLi0ELb1ELb0ELi2E"
# the double masked exponential kernel at d = 2
SASS_KERNEL_F64 = "fused_corr_sym_kernelIdLi0ELb1ELb0ELi2E"


def build_variants(out_dir: Path, narrow: bool = False, f64: bool = False) -> dict:
    """One nvcc per variant (VARIANTS, NARROW_VARIANTS or, into the
    float64 library, F64_VARIANTS), all started together; returns name
    -> (library path, build report)."""
    from smk_torch.ops import cuda_build

    src = (cuda_build.csrc_dir() / "fused_corr.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    variants = F64_VARIANTS if f64 else VARIANTS
    flags = cuda_build.SOURCES["fused_corr_f64" if f64 else "fused_corr"][1]
    if narrow:  # None stands for the source's NARROW_ROWS line
        rows_line = NARROW_ROWS_LINE.search(src).group(0)
        variants = {name: [(rows_line if old is None else old, new) for old, new in subs]
                    for name, subs in NARROW_VARIANTS.items()}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        stem = f"{name}_f64" if f64 else name
        cu = out_dir / f"{stem}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, "-o", str(lib), str(cu)],
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


def probe_narrow(fns: dict, k: int, m: int, gen) -> dict:
    """Every narrow variant on the kriging builds at (k, 1, m, t), in
    turns, beside the tile kernel and a fill of the same output."""
    import torch
    from chip_smoke import ms_median

    dev = torch.device("cuda", 0)
    coords = torch.rand(k, m, 2, device=dev, generator=gen)
    phis = 4.0 + 8.0 * torch.rand(k, 1, device=dev, generator=gen)
    mask = torch.ones(k, m, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    # (label, row coordinates, column coordinates, zero_diag, row mask)
    for t in (64, 123):
        sites = torch.rand(t, 2, device=dev, generator=gen)[None].expand(k, t, 2)
        rows[f"cross_t{t}"] = (coords, sites, 0, mask)
    stack = torch.rand(64, 2, device=dev, generator=gen)[None].expand(k, 64, 2)
    rows["stack_t64"] = (stack, stack, 1, None)
    out_rows = []
    for label, (ca, cb, zero_diag, rm) in rows.items():
        ma, mb = ca.shape[1], cb.shape[1]
        out = torch.empty(k, 1, ma, mb, device=dev)

        def launch(fn, layout):
            # the row mask on the narrow kernel only (the tile kernel has none)
            row_mask = rm if layout == 2 else None
            err = fn(ca.data_ptr(), cb.data_ptr(), phis.data_ptr(), 0, 0,
                     0 if row_mask is None else row_mask.data_ptr(), out.data_ptr(),
                     k, 1, ma, mb, 2, ca.stride(0), cb.stride(0), 0, 0, 0,
                     int(row_mask is not None), zero_diag, layout, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(fns["shipped"], 0)
        torch.cuda.synchronize()
        want = out.clone() if rm is None else rm[:, None, :, None] * out
        row = {"build": label, "shape": [k, 1, ma, mb], "write_MB": out.numel() * 4 / 1e6,
               "fill_ms": ms_median(lambda: out.fill_(1.0), device_only=True),
               "tile_kernel_ms": ms_median(lambda: launch(fns["shipped"], 0), device_only=True)}
        order = list(fns)
        for name in order + order[::-1]:
            row.setdefault(name + "_ms", []).append(
                ms_median(lambda: launch(fns[name], 2), device_only=True))
            torch.cuda.synchronize()
            if name in NARROW_SAME_FUNCTION and not torch.equal(out, want):
                raise AssertionError(f"{label}: narrow variant {name} != the tile kernel")
        out_rows.append(row)
    return out_rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--m", default=None, help="rows (default 3904,3906; --narrow 3906)")
    ap.add_argument("--narrow", action="store_true", help="probe the narrow kernel")
    ap.add_argument("--f64", action="store_true", help="probe the double symmetric kernel")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    args.m = args.m or ("3906" if args.narrow else "3904,3906")

    import torch

    if not torch.cuda.is_available():
        print("torch_build_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import ms_median, nvidia_smi_line, sass_fp64_per_element
    from smk_torch.ops import cuda_build
    from smk_torch.ops.fused_build import bind_kernel, bind_kernel_f64

    print(nvidia_smi_line(), flush=True)
    built = build_variants(cuda_build.build_dir() / "probe", narrow=args.narrow, f64=args.f64)
    fns = {}
    for name, (lib, err) in built.items():
        fns[name] = (bind_kernel_f64 if args.f64 else bind_kernel)(ctypes.CDLL(str(lib)))
        kernel = (SASS_KERNEL_F64 if args.f64 else SASS_KERNEL_NARROW if args.narrow else
                  SASS_KERNEL_GENERIC if name == "generic_d2" else SASS_KERNEL)
        row = {"variant": name, "kernel": kernel, **ptxas_report(err, kernel),
               "sass_instructions": sass_count(lib, kernel)}
        if args.f64:
            row["sass_fp64"] = sass_fp64_per_element(lib, kernel)
        print(json.dumps(row), flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    k = args.k
    if args.narrow:
        for m in (int(v) for v in args.m.split(",")):
            for row in probe_narrow(fns, k, m, gen):
                print(json.dumps(row), flush=True)
        return 0
    dtype = torch.float64 if args.f64 else torch.float32
    same = F64_SAME_FUNCTION if args.f64 else SAME_FUNCTION
    for m in (int(v) for v in args.m.split(",")):
        coords = torch.rand(k, m, 2, device=dev, generator=gen, dtype=dtype)
        phis = 4.0 + 8.0 * torch.rand(k, 1, device=dev, generator=gen, dtype=dtype)
        mask = torch.ones(k, m, device=dev, dtype=dtype)
        out = torch.empty(k, 1, m, m, device=dev, dtype=dtype)

        def launch(fn, layout):
            err = fn(coords.data_ptr(), coords.data_ptr(), phis.data_ptr(), mask.data_ptr(),
                     0, 0, out.data_ptr(), k, 1, m, m, 2, coords.stride(0), coords.stride(0),
                     0, 1, 0, 0, 1, layout, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        launch(fns["shipped"], 0)
        torch.cuda.synchronize()
        want = out.clone()
        row = {"m": m, "K": k, "dtype": str(dtype), "write_GB": out.numel() * out.element_size() / 1e9,
               "fill_ms": ms_median(lambda: out.fill_(1.0), device_only=True)}
        order = list(fns)
        for name in order + order[::-1]:
            row.setdefault(name + "_ms", []).append(
                ms_median(lambda: launch(fns[name], 1), device_only=True))
            if name in same:
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
