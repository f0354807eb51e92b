"""The port's kernel modules on the CPU, held against the JAX package.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests pin the arithmetic the CUDA kernels must reproduce (the
card-side comparison of kernel vs plain version is ``chip_smoke.py``'s
kernel phase).  The JAX fused Pallas functions do not run on this jax
(``pl.CostEstimate`` rejects their float fields), so the references are
the XLA arms that the JAX package's own tests assert the Pallas arms
equal in f32 (tests/test_pallas_conv.py, tests/test_pallas_resample.py):
``lax.conv_general_dilated`` + the inference-BN fold for ``fused_conv``,
and ``layers.resample_merge(impl="fast")`` for ``fused_resample``.
Inputs come from numpy with a seed; everything here is f32.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sod_project_tpu.models import layers as jlayers
from distributed_sod_project_tpu_torch.kernels import _build
from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
from distributed_sod_project_tpu_torch.models import layers as tlayers

# f32 against XLA:CPU: the same products summed in another order.
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_conv_ref(parts, w, vecs, dilation, mode, relu):
    x = jnp.concatenate([jnp.asarray(p) for p in parts], axis=-1)
    kh, kw = w.shape[:2]
    pad = [(dilation * (kh // 2),) * 2, (dilation * (kw // 2),) * 2]
    c = jax.lax.conv_general_dilated(
        x, jnp.asarray(w), (1, 1), pad, rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    if mode == "bias":
        y = c + vecs["bias"]
    elif mode == "bn":
        y = (c - vecs["mean"]) * vecs["mul"] + vecs["bias"]
    else:
        y = c
    return np.asarray(jnp.maximum(y, 0) if relu else y)


@pytest.mark.parametrize(
    "n_parts,mode,relu,dilation",
    list(itertools.product((1, 2, 3), ("none", "bias", "bn"), (False, True),
                           (1, 2))))
def test_fused_conv_plain_matches_xla_conv(n_parts, mode, relu, dilation):
    rng = np.random.default_rng(n_parts * 100 + dilation)
    chans = (5, 8, 3)[:n_parts]
    parts = [rng.standard_normal((2, 9, 7, c)).astype(np.float32)
             for c in chans]
    cout = 6
    w = (0.2 * rng.standard_normal((3, 3, sum(chans), cout))
         ).astype(np.float32)
    vecs = {}
    if mode == "bias":
        vecs["bias"] = rng.standard_normal(cout).astype(np.float32)
    elif mode == "bn":
        var = rng.uniform(0.3, 1.5, cout).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        vecs = {"mean": (0.1 * rng.standard_normal(cout)).astype(np.float32),
                # the fold in flax _normalize's order, as models/layers.py
                "mul": np.array(jax.lax.rsqrt(var + 1e-5) * scale),
                "bias": rng.standard_normal(cout).astype(np.float32)}
    want = _jax_conv_ref(parts, w, vecs, dilation, mode, relu)
    before = fc.launches
    got = fc.fused_conv([torch.from_numpy(p) for p in parts],
                        torch.from_numpy(w),
                        {k: torch.from_numpy(v) for k, v in vecs.items()},
                        kernel=(3, 3), dilation=dilation, mode=mode,
                        relu=relu)
    assert fc.launches == before  # the CPU runs the plain version only
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fused_conv_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 3)
    w = torch.zeros(3, 3, 3, 2)
    with pytest.raises(NotImplementedError, match="int8/fp8"):
        fc.fused_conv([x], w, {"qscale": torch.ones(2)}, kernel=(3, 3))
    with pytest.raises(ValueError, match="odd kernels"):
        fc.fused_conv([x], torch.zeros(2, 2, 3, 2), kernel=(2, 2))
    with pytest.raises(ValueError, match="does not match"):
        fc.fused_conv([x, x], w, kernel=(3, 3))
    with pytest.raises(ValueError, match="epilogue vectors"):
        fc.fused_conv([x], w, {"bias": torch.zeros(2)}, kernel=(3, 3),
                      mode="bn")
    with pytest.raises(ValueError, match="NHWC parts"):
        fc.fused_conv([x] * 5, torch.zeros(3, 3, 15, 2), kernel=(3, 3))


@pytest.mark.parametrize("mode,x_first", [("up", True), ("add", True),
                                          ("concat", True),
                                          ("concat", False)])
@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (6, 4)])
def test_fused_resample_plain_matches_fast_resample(mode, x_first, hw):
    rng = np.random.default_rng(hw[0] * 10 + hw[1])
    h, w = hw
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    lat = rng.standard_normal(
        (2, 2 * h, 2 * w, 4 if mode == "add" else 3)).astype(np.float32)
    before = fr.launches
    if mode == "up":
        want = jlayers.resize_to(jnp.asarray(x), (2 * h, 2 * w), impl="fast")
        got = fr.fused_upsample2(torch.from_numpy(x))
    else:
        want = jlayers.resample_merge(jnp.asarray(x), jnp.asarray(lat),
                                      mode=mode, x_first=x_first, impl="fast")
        got = fr.fused_upsample2_merge(torch.from_numpy(x),
                                       torch.from_numpy(lat), mode=mode,
                                       x_first=x_first)
    assert fr.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_fused_resample_rejects_bad_merges():
    x = torch.zeros(1, 3, 3, 4)
    with pytest.raises(ValueError, match="2x target"):
        fr.fused_upsample2_merge(x, torch.zeros(1, 5, 6, 4))
    with pytest.raises(ValueError, match="matching channels"):
        fr.fused_upsample2_merge(x, torch.zeros(1, 6, 6, 2), mode="add")
    with pytest.raises(ValueError, match="mode"):
        fr.fused_upsample2_merge(x, torch.zeros(1, 6, 6, 4), mode="mul")


@pytest.mark.parametrize("hw", [(7, 5), (8, 6), (1, 3)])
def test_max_pool_matches_flax_same_padding(hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(jlayers.max_pool(jnp.asarray(x)))
    got = tlayers.max_pool(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 10])
@pytest.mark.parametrize("axis", [1, 2])
def test_downsample2_axis_matches_jax(n, axis):
    shape = [2, 6, 6, 3]
    shape[axis] = n
    x = np.random.default_rng(n).standard_normal(shape).astype(np.float32)
    want = np.asarray(jlayers._downsample2_axis(jnp.asarray(x), axis))
    got = tlayers._downsample2_axis(torch.from_numpy(x), axis).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # ...and it IS jax.image.resize's antialiased bilinear 2x downsample.
    out = list(shape)
    out[axis] = n // 2
    ref = np.asarray(jax.image.resize(jnp.asarray(x), out, "bilinear"))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((8, 8), (12, 12)),   # up, 1.5x
                                     ((12, 9), (8, 6)),    # down, 2/3
                                     ((5, 7), (3, 10))])   # mixed
def test_resize_to_non_integer_ratio_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(3).standard_normal((2, *src, 4)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 4),
                                       "bilinear"))
    got = tlayers.resize_to(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resize_to_routes_exact_2x_through_the_resample_wrapper(monkeypatch):
    calls = []
    monkeypatch.setattr(fr, "fused_upsample2",
                        lambda x: calls.append(tuple(x.shape)) or x)
    tlayers.resize_to(torch.zeros(1, 4, 5, 2), (8, 10))
    tlayers.resize_to(torch.zeros(1, 4, 5, 2), (4, 5))   # identity
    tlayers.resize_to(torch.zeros(1, 4, 6, 2), (2, 3))   # 2x down
    assert calls == [(1, 4, 5, 2)]


def test_kernel_build_needs_nvcc_and_never_runs_at_import(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    srcs = _build._sources()
    assert {p.stem for p in srcs} == {
        "fused_conv", "fused_conv_dw", "fused_resample", "fused_resample_upT",
        "fused_loss", "fused_ssim"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # The build directory is keyed by the sources and lives under the
    # ignored build root.
    assert _build._build_dir(srcs).parent == _build.BUILD_ROOT
