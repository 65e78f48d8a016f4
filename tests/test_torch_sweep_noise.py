"""The sweep noise kernel (ops/sweep_noise.py, csrc/sweep_noise.cu).

CPU tests: the launch plan against a transcription of torch's
``calc_execution_policy`` (ATen/native/cuda/DistributionTemplates.h),
which sweeps the kernel covers and which stay on the per-row path, and
the counters of both paths.

Card tests (``gpu``; skipped without a CUDA device): the kernel's
SweepNoise against the per-row path's (models/probit_gp
.draw_sweep_noise, stacked), field for field with ``torch.equal``, and
every generator's state bytes after every sweep, over the links, the
collecting and non-collecting sweeps, 1, 32 and 128 rows, both cells'
shapes, a call past the grid's reach, float64, binomial trials, forks
and restores in a run of sweeps, and a ``rows(ids, m)`` source sharing
the whole source's generators; then a whole fit at each cell's shapes on
both paths.
"""

# smklint: test-budget=the CPU cases are launch-plan arithmetic and a few per-row draws at m = 16 (the whole file ~5 s here); the card cases skip without a CUDA device
import types

import numpy as np
import pytest
import torch

from smk_torch import PriorConfig, SMKConfig, fit_meta_kriging
from smk_torch.models import probit_gp as tp
from smk_torch.ops import sweep_noise as sn
from smk_torch.utils import tracing

H100 = (132, 2048)
A100 = (108, 2048)


def _torch_policy(numel: int, unroll: int, sms: int, threads_per_sm: int):
    """calc_execution_policy, line by line: (grid.x, stride, counter
    offset), in the header's unsigned arithmetic."""
    block_size = 256
    grid_x = (numel + block_size - 1) // block_size
    blocks_per_sm = threads_per_sm // block_size
    grid_x = min(sms * blocks_per_sm, grid_x)
    counter_offset = ((numel - 1) // (block_size * grid_x * unroll) + 1) * 4
    return grid_x, block_size * grid_x, counter_offset


@pytest.mark.parametrize("card", [H100, A100], ids=["h100", "a100"])
@pytest.mark.parametrize("unroll", [4, 2], ids=["float32", "float64"])
@pytest.mark.parametrize("numel", [1, 3, 3906, 7816, 131_072, 524_288, 2_500_000])
def test_call_plan_is_torchs_launch_policy(numel, unroll, card):
    plan = sn.call_plan(numel, unroll, *card)
    grid, stride, inc = _torch_policy(numel, unroll, *card)
    assert (plan.numel, plan.grid, plan.increment) == (numel, grid, inc)
    assert sn.BLOCK * plan.grid == stride


def test_call_plan_known_values():
    """By hand at 132 SMs x 2048 threads (1056 blocks at most)."""
    assert sn.call_plan(3, 4, *H100) == (3, 1, 4)
    assert sn.call_plan(4236, 4, *H100) == (4236, 17, 4)  # config4's normals
    assert sn.call_plan(131_072, 4, *H100) == (131_072, 512, 4)
    # past the grid's reach: 1056 blocks, lanes .y-.w, still one iteration
    assert sn.call_plan(524_288, 4, *H100) == (524_288, 1056, 4)
    # past four lanes of the whole grid (1,081,344): a second iteration
    assert sn.call_plan(1_081_345, 4, *H100) == (1_081_345, 1056, 8)
    assert sn.call_plan(540_673, 2, *H100) == (540_673, 1056, 8)
    assert sn.call_plan(0, 4, *H100) == (0, 0, 0)


def test_sweep_plan_follows_draw_sweep_noise():
    c5 = tp.SweepShapes(32, 3906, 1, 2, 64)
    plan = sn.sweep_plan(c5, True, torch.float32, *H100)
    assert plan.n_z == 3906 and plan.calls[0].numel == 3906 + 1 + 1
    assert plan.normal_sizes == (2, 1, 3906, 3906, 1, 64)
    assert plan.calls[1].numel == 7880 and plan.calls[2] == (0, 0, 0)
    assert plan.increment == 8
    c4 = tp.SweepShapes(128, 1024, 2, 3, 64, link="logit")
    plan = sn.sweep_plan(c4, False, torch.float32, *H100)
    assert plan.n_z == 0 and plan.calls[0].numel == 3
    assert plan.normal_sizes == (6, 2, 2048, 2048, 4, 0) and plan.calls[1].numel == 4108
    assert plan.calls[2] == (131_072, 512, 4) and plan.increment == 12
    trials = tp.SweepShapes(4, 100, 1, 2, 8, weight=3)
    assert sn.sweep_plan(trials, True, torch.float64, *H100).n_z == 300


def _shapes(**kw):
    return tp.SweepShapes(**dict(dict(k=4, m=16, q=2, p=2, t=4), **kw))


@pytest.mark.parametrize("case,covered", [
    ("cuda_float32", True), ("cuda_float64", True), ("probit_trials", True),
    ("cpu", False), ("bfloat16", False), ("float16", False), ("multiple_try", False),
    ("student_t", False), ("mixture", False), ("logit_trials", False), ("no_rows", False),
])
def test_which_sweeps_the_kernel_covers(case, covered):
    shapes, dtype, device = _shapes(), torch.float32, "cuda"
    if case == "cuda_float64":
        dtype = torch.float64
    elif case == "probit_trials":
        shapes = _shapes(weight=3)
    elif case == "cpu":
        device = "cpu"
    elif case in ("bfloat16", "float16"):
        dtype = getattr(torch, case)
    elif case == "multiple_try":
        shapes = _shapes(proposals=4)
    elif case in ("student_t", "mixture"):
        shapes = _shapes(family=case)
    elif case == "logit_trials":
        shapes = _shapes(link="logit", weight=2)
    elif case == "no_rows":
        shapes = _shapes(k=0)
    assert sn.covers(shapes, dtype, device) is covered


def _fake_cuda_generators(n):
    return [types.SimpleNamespace(device=torch.device("cuda"), initial_seed=lambda i=i: i)
            for i in range(n)]


def test_the_source_takes_the_kernel_only_with_a_cuda_generator_a_row():
    shapes = _shapes()
    assert tp.GeneratorNoise(_fake_cuda_generators(4), shapes, device="cuda").batched
    cpu = tp.subset_generators(3, 4, "cpu")
    assert not tp.GeneratorNoise(cpu, shapes, device="cpu").batched
    assert not tp.GeneratorNoise(cpu, shapes, device="cuda").batched
    shared = _fake_cuda_generators(3)
    assert not tp.GeneratorNoise(shared + shared[:1], shapes, device="cuda").batched
    assert not tp.GeneratorNoise(_fake_cuda_generators(4), shapes._replace(proposals=2),
                                 device="cuda").batched
    assert not tp.GeneratorNoise(_fake_cuda_generators(4), shapes, dtype=torch.bfloat16,
                                 device="cuda").batched


def test_sampler_lists_the_library_where_the_kernel_covers_its_draws():
    base = dict(n_subsets=2, n_samples=4)
    model = tp.SpatialGPSampler(SMKConfig(**base, fused_build="pallas"))
    assert model.kernel_libraries(torch.float32, "cuda") == ("fused_corr", "sweep_noise")
    assert model.kernel_libraries(torch.float64, "cuda") == ("fused_corr_f64", "sweep_noise")
    assert model.kernel_libraries(torch.float32, "cpu") == ()
    unfused = tp.SpatialGPSampler(SMKConfig(**base, fused_build="off"))
    assert unfused.kernel_libraries(torch.float32, "cuda") == ("sweep_noise",)
    mtm = tp.SpatialGPSampler(SMKConfig(**base, fused_build="pallas", phi_sampler="collapsed",
                                        phi_proposals=4))
    assert mtm.kernel_libraries(torch.float32, "cuda") == ("fused_corr",)


@pytest.mark.parametrize("path", ["rowwise", "batched"])
def test_counters_count_the_rows_of_each_path(path, monkeypatch):
    """Each call counts its rows under its path's counter. The batched
    path is stood in for on the CPU by the per-row draws, stacked."""
    shapes = _shapes(k=3)
    noise = tp.GeneratorNoise(tp.subset_generators(7, 3, "cpu"), shapes, device="cpu")
    if path == "batched":
        def fake_draw(gens, shapes, *, collect, dtype, device, z_floor, u_floor):
            assert (z_floor, u_floor) == (tp._TINY, tp._ACCEPT_FLOOR)
            return tp.stack_noise([tp.draw_sweep_noise(g, shapes, collect=collect, dtype=dtype,
                                                       device=device) for g in gens])._asdict()

        monkeypatch.setattr(sn, "draw", fake_draw)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        noise.batched = True
    with tracing.record_spans() as rec:
        for it in range(5):
            nz = noise(it, it >= 3)
            assert nz.kz.shape == (3, 16, 2) and (nz.kpred is None) == (it < 3)
    assert rec.counters == {f"noise_rows_{path}": 15}
    assert [s["attrs"] for s in rec.spans if s["name"] == "smk.noise"] == [{"rows": 3}] * 5


def test_a_capture_keeps_the_per_row_path(monkeypatch):
    noise = tp.GeneratorNoise(tp.subset_generators(7, 2, "cpu"), _shapes(k=2), device="cpu")
    noise.batched = True
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    monkeypatch.setattr(sn, "draw", lambda *a, **k: pytest.fail("drew under a capture"))
    ref = tp.GeneratorNoise(tp.subset_generators(7, 2, "cpu"), _shapes(k=2), device="cpu")
    for a, b in zip(noise(0, True), ref(0, True)):
        assert (a is None and b is None) or torch.equal(a, b)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
C5 = dict(m=3906, q=1, p=2, t=64)
C4 = dict(m=1024, q=2, p=3, t=64, pg_n_terms=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _pair(shapes, seed, device, dtype=torch.float32):
    """The kernel's source and the per-row source, on generators of the
    same seeds."""
    fast = tp.GeneratorNoise(tp.subset_generators(seed, shapes.k, device), shapes, dtype=dtype,
                             device=device)
    slow = tp.GeneratorNoise(tp.subset_generators(seed, shapes.k, device), shapes, dtype=dtype,
                             device=device)
    assert fast.batched
    slow.batched = False
    return fast, slow


def _same(fast, slow, it, collect):
    before = sn.LAUNCHES
    a, b = fast(it, collect), slow(it, collect)
    assert sn.LAUNCHES == before + 1
    for name, x, y in zip(tp.SweepNoise._fields, a, b):
        if y is None:
            assert x is None, name
            continue
        assert x.shape == y.shape and x.dtype == y.dtype and x.is_contiguous(), name
        assert torch.equal(x, y), (name, int((x != y).sum()))
    for i, (g, h) in enumerate(zip(fast.generators, slow.generators)):
        assert torch.equal(g.get_state(), h.get_state()), f"row {i}'s generator state"


@pytest.mark.gpu
@pytest.mark.parametrize("collect", [False, True], ids=["burn", "collect"])
@pytest.mark.parametrize("rows", [1, 32, 128])
@pytest.mark.parametrize("cell", ["config5_probit", "config4_logit"])
def test_kernel_draws_the_per_row_numbers(cell, rows, collect, card):
    dims = C5 if cell == "config5_probit" else C4
    link = "probit" if cell == "config5_probit" else "logit"
    fast, slow = _pair(tp.SweepShapes(rows, link=link, **dims), 8_400_000_501 + rows, card)
    for it in range(3):
        _same(fast, slow, it, collect)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["past_the_grid_logit", "past_the_grid_probit", "float64_probit",
                                  "float64_logit", "probit_trials", "float64_past_the_grid"])
def test_kernel_draws_the_per_row_numbers_beyond_the_cells(case, card):
    dtype = torch.float64 if case.startswith("float64") else torch.float32
    if case == "past_the_grid_logit":
        # 64 x 4096 x 2 = 524,288 exponentials a row: past the 1056 x 256
        # threads of the grid, so lanes .y-.w run
        shapes = tp.SweepShapes(4, 4096, 2, 3, 64, link="logit")
    elif case == "float64_past_the_grid":
        # 1,048,576 past the grid's two lanes: a second iteration
        shapes = tp.SweepShapes(2, 8192, 2, 3, 64, link="logit")
    elif case == "past_the_grid_probit":
        # 600,003 uniforms (lanes) and 1.2 million normals (a second
        # iteration) a row
        shapes = tp.SweepShapes(3, 300_000, 2, 2, 16)
    elif case == "float64_probit":
        shapes = tp.SweepShapes(32, 3906, 1, 2, 64)
    elif case == "float64_logit":
        shapes = tp.SweepShapes(16, 1024, 2, 3, 64, link="logit")
    else:
        shapes = tp.SweepShapes(8, 500, 2, 2, 16, weight=3)
    fast, slow = _pair(shapes, 2_147_483_711, card, dtype)
    for it in range(3):
        _same(fast, slow, it, it == 2)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["config5_probit", "config4_logit"])
def test_twenty_sweeps_with_forks_and_a_restore(cell, card):
    dims = C5 if cell == "config5_probit" else C4
    link = "probit" if cell == "config5_probit" else "logit"
    fast, slow = _pair(tp.SweepShapes(16, link=link, **dims), 3_500_000_021, card)
    mask = np.arange(16) % 3 == 0
    attempts = np.arange(16) % 4 + 1
    snap = None
    for it in range(20):
        if it == 6:
            for src in (fast, slow):
                src.fork(mask, attempts)
        if it == 9:
            snaps = [src.snapshot() for src in (fast, slow)]
            assert np.array_equal(*snaps)
            snap = snaps[0]
        if it == 13:
            for src in (fast, slow):
                src.restore(snap)
        _same(fast, slow, it, it >= 10)


@pytest.mark.gpu
def test_a_rows_source_shares_the_whole_sources_generators(card):
    shapes = tp.SweepShapes(12, 1024, 2, 3, 64, link="logit")
    fast, slow = _pair(shapes, 77, card)
    ids = [1, 4, 5, 9]
    for it in range(3):
        _same(fast, slow, it, False)
        sub_fast, sub_slow = fast.rows(ids, m=700), slow.rows(ids, m=700)
        assert sub_fast.batched
        sub_slow.batched = False
        _same(sub_fast, sub_slow, it, True)
    _same(fast, slow, 3, True)


def _fit(link, device):
    rng = np.random.default_rng(5)
    q, p, m, k, t = (1, 2, 3906, 2, 64) if link == "probit" else (2, 3, 1024, 2, 64)
    n = m * k
    coords = rng.uniform(size=(n + t, 2)).astype(np.float32)
    x = np.concatenate([np.ones((n + t, q, 1)), rng.normal(size=(n + t, q, p - 1))],
                       -1).astype(np.float32)
    y = (rng.uniform(size=(n, q)) < 0.5).astype(np.float32)
    cfg = SMKConfig(
        n_subsets=k, n_samples=16, link=link, n_chains=1 if link == "probit" else 2,
        cov_model="exponential", fused_build="pallas", phi_sampler="collapsed",
        phi_update_every=16 if link == "probit" else 8, phi_proposals=1,
        phi_proposal_family="gaussian", u_solver="cg", cg_precond="nystrom",
        cg_precond_rank=256, cg_iters=8, cg_matvec_dtype="bfloat16", trisolve_block_size=512,
        priors=PriorConfig(a_prior="invwishart", temper="none"))
    res = fit_meta_kriging(y, x[:n], coords[:n], coords[n:], x[n:], config=cfg, seed=8_400_000_503,
                           device=device)
    return res.param_grid, res.p_quant


@pytest.mark.gpu
@pytest.mark.parametrize("link", ["probit", "logit"], ids=["config5", "config4"])
def test_a_whole_fit_is_the_per_row_paths(link, card, monkeypatch):
    """The combined grid and p(y = 1) of a 16-sweep fit at each cell's
    shapes equal the per-row path's, within the per-row path's own
    run-to-run spread (0 where the card repeats itself)."""
    before = sn.LAUNCHES
    with tracing.record_spans() as rec:
        fast = _fit(link, card)
    assert sn.LAUNCHES - before == 16
    assert rec.counters["noise_rows_batched"] == 16 * 2 * (1 if link == "probit" else 2)
    assert "noise_rows_rowwise" not in rec.counters
    monkeypatch.setattr(sn, "covers", lambda *a: False)
    slow = [_fit(link, card) for _ in range(2)]
    assert sn.LAUNCHES - before == 16
    for i in range(2):
        spread = (slow[0][i] - slow[1][i]).abs().max()
        gap = (fast[i] - slow[0][i]).abs().max()
        assert gap <= spread, (i, float(gap), float(spread))
