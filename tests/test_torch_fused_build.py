"""The port's fused correlation build (smk_torch/ops/fused_build.py)
against the JAX package's Pallas kernel (smk_tpu/ops/pallas_build.py),
run in interpret mode as tests/test_fused_build.py runs it.

On the CPU every entry point runs its plain PyTorch version (the CUDA
kernels need the card: the gpu-marked tests hold them against the
plain version there, and the symmetric and narrow kernels against the
tile kernel bit for bit). Inputs are made with numpy from a seed and
passed to both packages.

Tolerance: both sides compute the same per-pair arithmetic (direct
squared differences summed in d order, sqrt, the model function, mask
blend, shift); they differ only where XLA's and PyTorch's exp round
differently — a few fp32 ulps of values <= 1. ATOL = 2e-6 covers that
with margin; the relative term covers the 1e8 pad-row shifts. The
invariants (unit diagonal, pad identity, symmetry) are exact.
"""

# smklint: test-budget=interpret-mode Pallas calls at m <= 147 take under a second each; the plain torch builds are milliseconds
import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smk_tpu.ops import pallas_build as jpb
from smk_torch.ops import cuda_build
from smk_torch.ops import fused_build as tfb

MODELS = ("exponential", "matern32", "matern52")
ATOL, RTOL = 2e-6, 1e-7


def _inputs(k, m, s, seed, mb=None):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0.0, 2.0, size=(k, m, 2)).astype(np.float32)
    other = (rng.uniform(0.0, 2.0, size=(k, mb or m, 2)) + 0.3).astype(np.float32)
    phis = rng.uniform(4.0, 12.0, size=(k, s)).astype(np.float32)
    mask = np.ones((k, m), np.float32)
    mask[:, -7:] = 0.0
    shift = np.where(
        mask > 0, rng.uniform(0.5, 2.0, size=(k, m)), 1e8
    ).astype(np.float32)
    return coords, other, phis, mask, shift


def _jax(entry, model, coords, phis, mask=None, shift=None, other=None, row_mask=None):
    """The Pallas entry point in interpret mode, vmapped over K; a row
    mask multiplies the cross build afterwards, as the JAX sampler
    does."""
    fn = getattr(jpb, entry)
    c = jnp.asarray(coords)
    ph = jnp.asarray(phis)
    if entry == "fused_masked_correlation_stack":
        out = jax.vmap(lambda a, b, mk: fn(a, b, mk, model, interpret=True))(
            c, ph, jnp.asarray(mask)
        )
    elif entry == "fused_masked_shifted_build":
        out = jax.vmap(
            lambda a, b, mk, sh: fn(a, b, mk, sh, model, interpret=True)
        )(c, ph, jnp.asarray(mask), jnp.asarray(shift))
    elif entry == "fused_cross_correlation":
        out = jax.vmap(lambda a, o, b: fn(a, o, b, model, interpret=True))(
            c, jnp.asarray(other), ph
        )
        if row_mask is not None:
            out = jnp.asarray(row_mask)[:, None, :, None] * out
    elif entry == "fused_correlation":
        out = jax.vmap(lambda a, b: fn(a, b[0], model, interpret=True))(c, ph)[:, None]
    else:
        out = jax.vmap(lambda a, b: fn(a, b, model, interpret=True))(c, ph)
    return np.asarray(out)


def _torch(entry, model, coords, phis, mask=None, shift=None, other=None, row_mask=None):
    fn = getattr(tfb, entry)
    c = torch.as_tensor(coords)
    ph = torch.as_tensor(phis)
    if entry == "fused_masked_correlation_stack":
        return fn(c, ph, torch.as_tensor(mask), model)
    if entry == "fused_masked_shifted_build":
        return fn(c, ph, torch.as_tensor(mask), torch.as_tensor(shift), model)
    if entry == "fused_cross_correlation":
        rm = None if row_mask is None else torch.as_tensor(row_mask)
        return fn(c, torch.as_tensor(other), ph, model, row_mask=rm)
    if entry == "fused_correlation":
        return fn(c, ph[:, 0], model)[:, None]
    return fn(c, ph, model)


def _check_invariants(out, entry, mask, shift):
    """Exact invariants of a square zero-diagonal build (K, s, m, m)."""
    out = out.numpy()
    np.testing.assert_array_equal(out, np.swapaxes(out, -1, -2))
    diag = np.diagonal(out, axis1=-2, axis2=-1)
    if entry == "fused_masked_shifted_build":
        np.testing.assert_array_equal(
            diag, np.broadcast_to((np.float32(1.0) + shift)[:, None], diag.shape)
        )
    else:
        assert (diag == 1.0).all()
    if mask is not None:
        pad = mask == 0
        m = out.shape[-1]
        for k in range(out.shape[0]):
            rows = out[k][:, pad[k]]  # (s, n_pad, m)
            want = np.eye(m, dtype=np.float32)[pad[k]]
            if shift is not None:
                want = want * (np.float32(1.0) + shift[k][pad[k]])[:, None]
            np.testing.assert_array_equal(rows, np.broadcast_to(want, rows.shape))


SQUARE = (
    "fused_masked_correlation_stack",
    "fused_masked_shifted_build",
    "fused_correlation_stack",
    "fused_correlation",
)


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("m", [40, 147])
    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("entry", SQUARE)
    def test_square_entry_points(self, entry, model, m):
        coords, _, phis, mask, shift = _inputs(2, m, 3, seed=m)
        kw = {}
        if "masked" in entry:
            kw["mask"] = mask
        if "shifted" in entry:
            kw["shift"] = shift
        got = _torch(entry, model, coords, phis, **kw)
        want = _jax(entry, model, coords, phis, **kw)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        _check_invariants(got, entry, kw.get("mask"), kw.get("shift"))

    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("ma, mb", [(40, 17), (147, 123)])
    def test_cross(self, model, ma, mb):
        coords, other, phis, _, _ = _inputs(2, ma, 2, seed=ma + mb, mb=mb)
        got = _torch("fused_cross_correlation", model, coords, phis, other=other)
        want = _jax("fused_cross_correlation", model, coords, phis, other=other)
        assert tuple(got.shape) == (2, 2, ma, mb)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("ma, mb", [(147, 64), (147, 123), (20, 7)])
    def test_cross_with_row_mask(self, model, ma, mb):
        # the sampler's kriging cross build: pad rows zeroed in the build
        coords, other, phis, mask, _ = _inputs(2, ma, 2, seed=ma * mb, mb=mb)
        want = _jax("fused_cross_correlation", model, coords, phis, other=other,
                    row_mask=mask)
        got = _torch("fused_cross_correlation", model, coords, phis, other=other,
                     row_mask=mask)
        assert tuple(got.shape) == (2, 2, ma, mb)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        plain = tfb.plain_build(torch.as_tensor(coords), torch.as_tensor(other),
                                torch.as_tensor(phis), model, row_mask=torch.as_tensor(mask))
        assert torch.equal(plain, got)
        # the product the sampler took after the build, bit for bit
        bare = _torch("fused_cross_correlation", model, coords, phis, other=other)
        assert torch.equal(got, torch.as_tensor(mask)[:, None, :, None] * bare)
        assert (got.numpy()[:, :, mask[0] == 0] == 0).all()
        # a (ma,) row mask is shared over K
        shared = tfb.fused_cross_correlation(
            torch.as_tensor(coords), torch.as_tensor(other), torch.as_tensor(phis), model,
            row_mask=torch.as_tensor(mask[0]),
        )
        assert torch.equal(shared, torch.as_tensor(mask[0])[None, None, :, None] * bare)

    def test_no_k_axis_keeps_jax_shapes(self):
        coords, other, phis, mask, shift = _inputs(1, 40, 3, seed=5, mb=9)
        c, ph = torch.as_tensor(coords[0]), torch.as_tensor(phis[0])
        out = tfb.fused_masked_shifted_build(
            c, ph, torch.as_tensor(mask[0]), torch.as_tensor(shift[0]), "exponential"
        )
        want = jpb.fused_masked_shifted_build(
            jnp.asarray(coords[0]), jnp.asarray(phis[0]), jnp.asarray(mask[0]),
            jnp.asarray(shift[0]), "exponential", interpret=True,
        )
        assert tuple(out.shape) == (3, 40, 40)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
        single = tfb.fused_correlation(c, ph[0], "matern32")
        assert tuple(single.shape) == (40, 40)
        cross = tfb.fused_cross_correlation(c, torch.as_tensor(other[0]), ph, "exponential")
        assert tuple(cross.shape) == (3, 40, 9)

    def test_shared_test_coords_broadcast_over_k(self):
        # the kriging test build: (t, d) coords shared by K subsets,
        # (K, s) phis -> (K, s, t, t)
        coords, _, phis, _, _ = _inputs(3, 12, 2, seed=9)
        got = tfb.fused_correlation_stack(torch.as_tensor(coords[0]), torch.as_tensor(phis), "matern52")
        want = np.stack([
            np.asarray(jpb.fused_correlation_stack(
                jnp.asarray(coords[0]), jnp.asarray(phis[k]), "matern52", interpret=True
            ))
            for k in range(3)
        ])
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)

    def test_scalar_shift_broadcast(self):
        coords, _, phis, mask, _ = _inputs(2, 30, 1, seed=3)
        got = _torch("fused_masked_shifted_build", "exponential", coords, phis,
                     mask=mask, shift=np.full((2, 30), 0.25, np.float32))
        scalar = tfb.fused_masked_shifted_build(
            torch.as_tensor(coords), torch.as_tensor(phis), torch.as_tensor(mask),
            0.25, "exponential",
        )
        assert torch.equal(got, scalar)


class TestWrapperContract:
    def test_unknown_model_raises(self):
        c = torch.rand(8, 2)
        with pytest.raises(ValueError, match="unknown cov model"):
            tfb.fused_correlation(c, 1.0, "gaussianish")

    def test_masked_build_needs_same_coords(self):
        c = torch.rand(8, 2)
        with pytest.raises(ValueError, match="same-coordinates"):
            tfb._fused_build(
                "fused_masked_correlation_stack", c, c.clone(), torch.ones(1),
                "exponential", mask=torch.ones(8),
            )

    def test_cpu_tensors_take_the_plain_version_and_count_it(self):
        tfb.reset_counts()
        c = torch.rand(2, 10, 2)
        tfb.fused_masked_correlation_stack(c, torch.ones(2, 1), torch.ones(2, 10), "exponential")
        tfb.fused_cross_correlation(c, torch.rand(4, 2), torch.ones(2, 1), "exponential")
        assert tfb.PLAIN_CALLS["fused_masked_correlation_stack"] == 1
        assert tfb.PLAIN_CALLS["fused_cross_correlation"] == 1
        assert sum(tfb.LAUNCHES.values()) == 0
        tfb.reset_counts()
        assert sum(tfb.PLAIN_CALLS.values()) == 0

    @pytest.mark.parametrize("fused", [True, False])
    @pytest.mark.parametrize("m, s", [(3906, 1), (147, 3)])
    def test_build_bytes_model_matches_twin_at_equal_tile(self, fused, m, s):
        mine = tfb.build_bytes_model(m, s, tile=128, fused=fused)
        assert mine == jpb.build_bytes_model(m, s, tile=128, fused=fused)
        # the kernel's own tile: writes are s m^2 floats either way
        assert tfb.build_bytes_model(m, s, fused=fused)["write_bytes"] == s * m * m * 4

    @pytest.mark.parametrize("m", [20, 300])
    @pytest.mark.parametrize("entry", tfb.ENTRY_POINTS)
    def test_each_entry_point_picks_its_layout(self, entry, m, monkeypatch):
        # narrow for every cross build (row mask and all) and for the
        # unmasked square builds up to NARROW_MAX_M rows (the test
        # stack); symmetric for masked and wider square builds; the
        # tile kernel for none
        seen = []
        real = tfb.kernel_layout

        def spy(a, b, zero_diag, masked, shifted):
            seen.append(real(a, b, zero_diag, masked, shifted))
            return seen[-1]

        monkeypatch.setattr(tfb, "kernel_layout", spy)
        coords, other, phis, mask, shift = _inputs(2, m, 1, seed=4, mb=m)
        _torch(entry, "exponential", coords, phis, mask=mask, shift=shift, other=other,
               row_mask=mask)
        want = {
            "fused_masked_correlation_stack": tfb.SYMMETRIC,
            "fused_masked_shifted_build": tfb.SYMMETRIC,
            "fused_cross_correlation": tfb.NARROW,
        }.get(entry, tfb.NARROW if m <= tfb.NARROW_MAX_M else tfb.SYMMETRIC)
        assert seen == [want]

    def test_layout_needs_the_same_coords_and_a_zero_diagonal(self):
        c = torch.rand(3, tfb.NARROW_MAX_M + 1, 2)
        assert tfb.kernel_layout(c, c, True, False, False) == tfb.SYMMETRIC
        assert tfb.kernel_layout(c, c.clone(), True, False, False) == tfb.NARROW
        assert tfb.kernel_layout(c, c, False, False, False) == tfb.NARROW

    def test_narrow_layout_takes_cross_builds_at_any_width_and_small_squares(self):
        c = torch.rand(3, 8, 2)
        square = torch.rand(3, tfb.NARROW_MAX_M, 2)
        wide = torch.rand(4 * 1024 + 1, 2)
        assert tfb.kernel_layout(c, wide, False, False, False) == tfb.NARROW
        assert tfb.kernel_layout(c, c, True, False, False) == tfb.NARROW
        assert tfb.kernel_layout(square, square, True, False, False) == tfb.NARROW
        # a masked or shifted build needs the symmetric kernel at any width
        assert tfb.kernel_layout(c, c, True, True, False) == tfb.SYMMETRIC
        assert tfb.kernel_layout(c, c, True, True, True) == tfb.SYMMETRIC
        assert tfb.kernel_layout(c, c, True, False, True) == tfb.SYMMETRIC

    @pytest.mark.parametrize("m", [8, tfb.NARROW_MAX_M, tfb.NARROW_MAX_M + 1])
    def test_float64_builds_take_the_float32_layouts(self, m):
        # the double kernels follow the float32 rules: symmetric for the
        # masked, shifted and wide square builds, narrow for the rest,
        # counted under their own keys; the tile kernel for none
        f32 = torch.rand(3, m, 2)
        f64 = f32.double()
        sites = torch.rand(5, 2, dtype=torch.float64)
        for flags in [(True, False, False), (True, True, False), (True, True, True),
                      (True, False, True)]:
            assert tfb.kernel_layout(f64, f64, *flags) == tfb.kernel_layout(f32, f32, *flags)
        assert tfb.kernel_layout(f64, f64, True, True, False) == tfb.SYMMETRIC
        assert tfb.kernel_layout(f64, sites, False, False, False) == tfb.NARROW
        assert tfb.kernel_layout(f64, f64, True, False, False) == (
            tfb.NARROW if m <= tfb.NARROW_MAX_M else tfb.SYMMETRIC)
        keys = {layout: tfb.launch_key(layout, torch.float64)
                for layout in (tfb.TILED, tfb.SYMMETRIC, tfb.NARROW)}
        assert keys == {tfb.TILED: tfb.TILED_F64, tfb.SYMMETRIC: tfb.SYMMETRIC_F64,
                        tfb.NARROW: tfb.NARROW_F64}
        assert [tfb.launch_key(x, torch.float32) for x in (0, 1, 2)] == [0, 1, 2]
        assert set(tfb.LAYOUT_LAUNCHES) == set(keys) | set(keys.values())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("layout", [tfb.TILED, tfb.SYMMETRIC, tfb.NARROW])
    def test_launch_passes_the_layout_to_the_dtypes_entry_point(self, dtype, layout,
                                                                  monkeypatch):
        # _launch binds the entry point of the output's dtype and hands it
        # the layout at either type (the pointers are not dereferenced)
        calls = []

        def kernel(dt):
            return lambda *args: calls.append((dt, args)) or 0

        monkeypatch.setattr(tfb, "_kernel", kernel)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: types.SimpleNamespace(cuda_stream=0))
        c = torch.rand(2, 9, 2, dtype=dtype)
        out = torch.empty(2, 1, 9, 9, dtype=dtype)
        tfb._launch(c, c, torch.ones(2, 1, dtype=dtype), None, None, "matern52", True, out,
                    layout)
        (dt, args), = calls
        assert dt == dtype and len(args) == 21
        assert args[-2] == layout and args[7:12] == (2, 1, 9, 9, 2) and args[14] == 2

    def test_cpu_builds_count_no_layout_launch(self):
        tfb.reset_counts()
        c = torch.rand(2, 10, 2)
        tfb.fused_cross_correlation(c, torch.rand(4, 2), torch.ones(2, 1), "exponential",
                                    row_mask=torch.ones(2, 10))
        assert tfb.PLAIN_CALLS["fused_cross_correlation"] == 1
        assert sum(tfb.LAYOUT_LAUNCHES.values()) == 0

    def test_build_module_is_lazy_and_digest_named(self, monkeypatch, tmp_path):
        monkeypatch.setenv("SMK_TORCH_BUILD_DIR", str(tmp_path))
        path = cuda_build.library_path("fused_corr")
        assert path.parent == tmp_path
        assert path.name.startswith("libfused_corr-") and path.suffix == ".so"
        assert path == cuda_build.library_path("fused_corr")  # stable digest
        assert (cuda_build.csrc_dir() / "fused_corr.cu").exists()

    def test_bound_signature_matches_the_c_entry_point(self):
        src = (cuda_build.csrc_dir() / "fused_corr.cu").read_text()
        params = re.search(r'extern "C" int smk_fused_corr\(([^)]*)\)', src).group(1)
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        assert tfb.bind_kernel(types.SimpleNamespace(smk_fused_corr=fn)) is fn
        assert len(fn.argtypes) == params.count(",") + 1
        assert fn.restype is ctypes.c_int

    def test_float64_entry_point_takes_the_same_arguments(self):
        # one source, two libraries: the float64 entry point is built only
        # under its macro, and takes the float32 one's arguments
        src = (cuda_build.csrc_dir() / "fused_corr.cu").read_text()
        params = {name: re.search(rf'extern "C" int {name}\(([^)]*)\)', src).group(1)
                  for name in ("smk_fused_corr", "smk_fused_corr_f64")}
        names = {name: [a.split()[-1].lstrip("*") for a in ps.split(",")]
                 for name, ps in params.items()}
        assert names["smk_fused_corr_f64"] == names["smk_fused_corr"]
        assert "layout" in names["smk_fused_corr_f64"]
        fn = types.SimpleNamespace(argtypes=None, restype=None)
        assert tfb.bind_kernel_f64(types.SimpleNamespace(smk_fused_corr_f64=fn)) is fn
        assert len(fn.argtypes) == params["smk_fused_corr_f64"].count(",") + 1
        assert fn.restype is ctypes.c_int
        assert cuda_build.SOURCES["fused_corr_f64"] == ("fused_corr.cu", ("-DSMK_FUSED_CORR_F64",))
        assert "#ifndef SMK_FUSED_CORR_F64" in src
        assert cuda_build.library_path("fused_corr") != cuda_build.library_path("fused_corr_f64")


@pytest.mark.gpu
class TestKernelOnCard:
    """The CUDA kernel against its plain version on the card — runs only
    where a CUDA device is visible (the chip smoke run covers the same
    ground at the main-path shapes)."""

    @pytest.mark.parametrize("entry", SQUARE + ("fused_cross_correlation",))
    def test_kernel_matches_plain(self, entry):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        coords, other, phis, mask, shift = _inputs(2, 147, 3, seed=1, mb=123)
        kw = {}
        if "masked" in entry:
            kw["mask"] = mask
        if "shifted" in entry:
            kw["shift"] = shift
        if entry == "fused_cross_correlation":
            kw["other"] = other
        plain = _torch(entry, "matern32", coords, phis, **kw)
        before = tfb.LAUNCHES[entry]
        fn = getattr(tfb, entry)
        c = torch.as_tensor(coords).cuda()
        ph = torch.as_tensor(phis).cuda()
        if entry == "fused_masked_correlation_stack":
            got = fn(c, ph, torch.as_tensor(mask).cuda(), "matern32")
        elif entry == "fused_masked_shifted_build":
            got = fn(c, ph, torch.as_tensor(mask).cuda(), torch.as_tensor(shift).cuda(),
                     "matern32")
        elif entry == "fused_cross_correlation":
            got = fn(c, torch.as_tensor(other).cuda(), ph, "matern32")
        elif entry == "fused_correlation":
            got = fn(c, ph[:, 0], "matern32")[:, None]
        else:
            got = fn(c, ph, "matern32")
        torch.cuda.synchronize()
        assert tfb.LAUNCHES[entry] == before + 1
        # CPU plain vs card kernel: exp rounds differently on the two
        np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), atol=4e-6, rtol=1e-6)
        if entry != "fused_cross_correlation":
            _check_invariants(got.cpu(), entry, kw.get("mask"), kw.get("shift"))

    # one tile, a partial last tile, the diagonal tile, every row
    # alignment mod 4
    # and d = 2 (the fit's, compiled as a constant) against the generic
    # instantiation's d = 1, 3, 8
    @pytest.mark.parametrize("m, d", [(m, 2) for m in (1, 2, 3, 63, 64, 65, 127, 129,
                                                        3905, 3906, 3907)]
                             + [(129, 1), (129, 3), (3907, 8)])
    def test_symmetric_kernel_equals_tile_kernel_bitwise(self, m, d):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        coords, _, phis, mask, shift = _inputs(2, m, 2, seed=m)
        coords = np.random.default_rng(m).uniform(0.0, 2.0, size=(2, m, d)).astype(np.float32)
        mask = np.where(np.random.default_rng(m).uniform(size=mask.shape) < 0.1, 0.0, 1.0)
        shift = np.where(mask > 0, shift, 1e8).astype(np.float32)
        c, ph = torch.as_tensor(coords).cuda(), torch.as_tensor(phis).cuda()
        mk = torch.as_tensor(mask, dtype=torch.float32).cuda()
        sh = torch.as_tensor(shift).cuda()
        for model in MODELS:
            for kw_mask, kw_shift in ((mk, None), (mk, sh), (None, None)):
                outs = []
                for layout in (tfb.SYMMETRIC, tfb.TILED):
                    # NaN-filled: an element the kernel misses fails
                    out = torch.full((2, 2, m, m), float("nan"), device="cuda")
                    tfb._launch(c, c, ph, kw_mask, kw_shift, model, True, out, layout)
                    outs.append(out)
                torch.cuda.synchronize()
                assert torch.equal(outs[0], outs[1])
                want = tfb.plain_build(c, c, ph, model, mask=kw_mask, shift=kw_shift,
                                       zero_diag=True)
                np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                                           atol=4e-6, rtol=1e-6)
                entry = "fused_masked_shifted_build" if kw_shift is not None else "fused_correlation_stack"
                _check_invariants(outs[0].cpu(), entry,
                                  None if kw_mask is None else mask.astype(np.float32),
                                  None if kw_shift is None else shift)

    # the narrow kernel's ragged widths: one to five columns, every row
    # alignment mod 4 around 64 and 128, the sampler's t = 64, the widest
    # square build it takes and one past it
    NARROW_MB = (1, 3, 4, 5, 63, 64, 65, 123, 128, 256, 257)

    @pytest.mark.parametrize("ma", [1, 147, 3907])
    def test_narrow_kernel_equals_tile_kernel_bitwise(self, ma):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        for mb in self.NARROW_MB:
            coords, other, phis, mask, _ = _inputs(2, ma, 2, seed=ma + mb, mb=mb)
            c, o, ph = (torch.as_tensor(x).cuda() for x in (coords, other, phis))
            rm = torch.as_tensor(mask).cuda()
            shared = o[:1].expand(2, mb, 2)  # K-shared test sites: stride 0 on K
            for model in MODELS:
                for cb in (o, shared):
                    outs = []
                    for layout, row_mask in ((tfb.NARROW, None), (tfb.NARROW, rm),
                                             (tfb.TILED, None)):
                        # NaN-filled: an element the kernel misses fails
                        out = torch.full((2, 2, ma, mb), float("nan"), device="cuda")
                        tfb._launch(c, cb, ph, None, None, model, False, out, layout, row_mask)
                        outs.append(out)
                    torch.cuda.synchronize()
                    assert torch.equal(outs[0], outs[2]), (ma, mb, model)
                    # the row mask in the kernel: the sampler's product
                    assert torch.equal(outs[1], rm[:, None, :, None] * outs[2]), (ma, mb, model)
                    want = tfb.plain_build(c, cb, ph, model, row_mask=rm)
                    np.testing.assert_allclose(outs[1].cpu().numpy(), want.cpu().numpy(),
                                               atol=4e-6, rtol=1e-6)

    @pytest.mark.parametrize("m, d", [(m, 2) for m in NARROW_MB] + [(123, 1), (123, 3), (64, 8)])
    def test_narrow_kernel_equals_symmetric_kernel_bitwise(self, m, d):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        rng = np.random.default_rng(m * d)
        test = torch.as_tensor(rng.uniform(0.0, 2.0, size=(m, d)).astype(np.float32)).cuda()
        ph = torch.as_tensor(rng.uniform(4.0, 12.0, size=(2, 2)).astype(np.float32)).cuda()
        c = test[None].expand(2, m, d)  # the test stack's shared coordinates
        for model in MODELS:
            outs = []
            for layout in (tfb.NARROW, tfb.SYMMETRIC):
                out = torch.full((2, 2, m, m), float("nan"), device="cuda")
                tfb._launch(c, c, ph, None, None, model, True, out, layout)
                outs.append(out)
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[1])
            want = tfb.plain_build(c, c[:1], ph, model, zero_diag=True)
            np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                                       atol=4e-6, rtol=1e-6)
            _check_invariants(outs[0].cpu(), "fused_correlation_stack", None, None)

    # the double symmetric kernel's tile edges (32 x 32, a 4-double halo)
    # and every row alignment mod 4 doubles
    @pytest.mark.parametrize("m", [1, 2, 3, 5, 29, 30, 33, 62, 65, 147, 3906, 3907])
    def test_double_kernels_equal_the_double_tile_kernel_bitwise(self, m):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: the kernel has no CPU mode")
        rng = np.random.default_rng(m)
        coords = torch.as_tensor(rng.uniform(0.0, 2.0, size=(2, m, 2))).cuda()
        test = torch.as_tensor(rng.uniform(0.3, 2.3, size=(2, 65, 2))).cuda()
        ph = torch.as_tensor(rng.uniform(4.0, 12.0, size=(2, 2))).cuda()
        mask = torch.as_tensor((rng.uniform(size=(2, m)) > 0.1).astype(np.float64)).cuda()
        shift = torch.where(mask > 0, 1.5, 1e8).double()
        for model in MODELS:
            for layout, cb, kw in ((tfb.SYMMETRIC, coords, dict(mask=mask, zero_diag=True)),
                                   (tfb.SYMMETRIC, coords,
                                    dict(mask=mask, shift=shift, zero_diag=True)),
                                   (tfb.NARROW, test, dict(row_mask=mask)),
                                   (tfb.NARROW, test[:, :64], dict())):
                outs = []
                for lay in (layout, tfb.TILED):
                    # NaN-filled: an element the kernel misses fails
                    out = torch.full((2, 2, m, cb.shape[1]), float("nan"), device="cuda",
                                     dtype=torch.float64)
                    tfb._launch(coords, cb, ph, kw.get("mask"), kw.get("shift"), model,
                                kw.get("zero_diag", False), out, lay, kw.get("row_mask"))
                    outs.append(out)
                torch.cuda.synchronize()
                assert torch.equal(outs[0], outs[1]), (m, model, layout)
                want = tfb.plain_build(coords, cb, ph, model, **kw)
                np.testing.assert_allclose(outs[0].cpu().numpy(), want.cpu().numpy(),
                                           atol=1e-14, rtol=1e-14)
