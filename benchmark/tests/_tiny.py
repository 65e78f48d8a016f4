"""Small shapes of each cell for the CPU tests (not a test module)."""

TINY = dict(n=4 * 128, n_subsets=4, t=12, n_samples=24,
            sampler=dict(cg_precond_rank=32, trisolve_block_size=64))


def run_cpu(cell: str, seed: int = 123456789012, seconds: float = 0.5, trace: int = 0,
            **kw):
    import run

    return run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)], device="cpu", overrides=TINY, **kw)
