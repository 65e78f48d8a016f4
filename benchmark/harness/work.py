"""The work of one fit, counted from the configuration's shapes and the
sampler's schedule, never read from the program: a change that does less
work then shows as a faster sweep, not as a changed yardstick.

The schedule is the production sampler's, as the port runs it (and its
reference, harness/reference.py): dense subsets of m sites, K subsets of
C chains (K C batch rows), q components, collapsed phi moves on the
sweeps it with it % E == 0, the Nystrom-preconditioned CG u-draw with
the kriging cache. Frozen here from the port's ``probit_gp.build_calls``
(builds per entry point) and from its sweep (factorizations: R~ at the
start, then S_cur, S_prop and R~(phi') per component per update sweep).

Each count is a list of operations of one kind with their FLOPs and the
bytes they must move at least (each input read once, each output written
once, as ``chip_smoke.bound`` counts a build).
"""

from __future__ import annotations

F32 = 4  # bytes of a float32
BF16 = 2


def schedule(n_samples: int, burn_frac: float, every: int) -> dict:
    """Sweeps, burn-in, and the update sweeps in each phase."""
    n_burn = int(burn_frac * n_samples)
    upd = [it for it in range(n_samples) if it % every == 0]
    return {
        "sweeps": n_samples, "burn": n_burn, "kept": n_samples - n_burn,
        "updates": len(upd), "updates_kept": sum(1 for it in upd if it >= n_burn),
    }


def shape(cfg: dict) -> dict:
    """rows (K C), m, q, t and the schedule of configuration ``cfg``."""
    s = cfg["sampler"]
    k = cfg["n_subsets"]
    return dict(
        k=k, rows=k * s["n_chains"], m=-(-cfg["n"] // k), q=cfg["q"], t=cfg["t"],
        d=2, rank=s["cg_precond_rank"], cg_iters=s["cg_iters"],
        **schedule(cfg["n_samples"], s["burn_in_frac"], s["phi_update_every"]),
    )


def build_calls(cfg: dict) -> list:
    """The correlation builds of one fit: (kind, calls, s) with kind
    "square" (masked R~, (rows, s, m, m)), "shifted" (R~ + diag, the
    same shape plus a shift row), "cross" ((rows, s, m, t) with the row
    mask) and "test" ((rows, s, t, t)). As the port's build_calls for
    the collapsed CG sampler with the kriging cache: R~ at the start
    (s = q), the CG operator at each of the two scan entries (s = q), per
    update sweep and component the accept side's R~(phi') (s = 1) and the
    marginal's S_cur and S_prop (s = 1 each); on the kept scan the
    kriging builds at its entry (s = q) and per update sweep and
    component (s = 1)."""
    w = shape(cfg)
    q, upd, upd_kept = w["q"], w["updates"], w["updates_kept"]
    return [
        ("square", 3, q),  # start, burn-in entry, kept entry: s = q each
        ("square", q * upd, 1),
        ("shifted", 2 * q * upd, 1),
        ("cross", 1, q), ("cross", q * upd_kept, 1),
        ("test", 1, q), ("test", q * upd_kept, 1),
    ]


def build_bytes(cfg: dict, kind: str, s: int) -> int:
    """The least bytes of one build: its inputs (coordinates, phis, the
    mask, the shift) read once and its output written once."""
    w = shape(cfg)
    rows, m, t, d = w["rows"], w["m"], w["t"], w["d"]
    phis = rows * s * F32
    if kind == "square":
        return rows * m * d * F32 + phis + rows * m * F32 + rows * s * m * m * F32
    if kind == "shifted":
        return rows * m * d * F32 + phis + 2 * rows * m * F32 + rows * s * m * m * F32
    if kind == "cross":
        return rows * m * d * F32 + t * d * F32 + phis + rows * m * F32 + rows * s * m * t * F32
    if kind == "test":
        return t * d * F32 + phis + rows * s * t * t * F32
    raise ValueError(kind)


def factorizations(cfg: dict) -> int:
    """m x m Cholesky factorizations of one fit (all rows): R~ of each
    component at the start, then per update sweep and component S_cur,
    S_prop and R~(phi')."""
    w = shape(cfg)
    return w["rows"] * w["q"] * (1 + 3 * w["updates"])


def ops(cfg: dict) -> dict:
    """FLOPs and least bytes of one fit by class:

    - ``chol``: the m x m factorizations, m^3 / 3 FLOPs each, the matrix
      read and the factor written;
    - ``tri``: products and solves against an m x m triangular factor:
      per update sweep and component the marginal's two solves
      (1 column each), per sweep and component the prior draw L z (1
      column), on the kept scan the kriging operator's two solves of t
      columns at its entry and per update; m^2 FLOPs a column, the
      triangle (m^2 / 2 floats) read once per call;
    - ``cg``: the CG operator's bf16 products, cg_iters + 1 per sweep and
      component (the iterations and the back-multiply), 2 m^2 FLOPs and
      m^2 bf16 values read each;
    - ``build``: the correlation builds, bytes only (build_calls).
    """
    w = shape(cfg)
    rows, m, q, t = w["rows"], w["m"], w["q"], w["t"]
    n, upd, upd_kept = w["sweeps"], w["updates"], w["updates_kept"]
    n_chol = factorizations(cfg)
    chol = {"flops": n_chol * m ** 3 / 3.0, "bytes": n_chol * 2 * m * m * F32}
    tri_calls = rows * q * (2 * upd + n)
    kr_calls = rows * q * 2 * (1 + upd_kept)
    tri = {
        "flops": tri_calls * m * m + kr_calls * m * m * t,
        "bytes": (tri_calls + kr_calls) * (m * m // 2) * F32,
    }
    n_mv = rows * q * n * (w["cg_iters"] + 1)
    cg = {"flops": n_mv * 2.0 * m * m, "bytes": n_mv * m * m * BF16}
    build = {"flops": 0.0, "bytes": sum(c * build_bytes(cfg, kind, s)
                                         for kind, c, s in build_calls(cfg))}
    return {"chol": chol, "tri": tri, "cg": cg, "build": build}


def least_seconds(op: dict, peak_flops: float, peak_bytes: float) -> float:
    """The least time the peaks allow: the larger of FLOPs over the
    compute peak and bytes over the memory peak."""
    return max(op["flops"] / peak_flops, op["bytes"] / peak_bytes)


def fit_least_seconds(cfg: dict, peaks: dict) -> float:
    """The least time of one fit's counted work on one card: factor and
    triangular work at the float32 peak, the CG products at the bf16
    peak, each bounded by its bytes over the memory peak; the builds by
    their bytes."""
    o = ops(cfg)
    bw = peaks["hbm_bytes_per_s"]
    return (least_seconds(o["chol"], peaks["fp32_flops"], bw)
            + least_seconds(o["tri"], peaks["fp32_flops"], bw)
            + least_seconds(o["cg"], peaks["bf16_flops"], bw)
            + o["build"]["bytes"] / bw)
