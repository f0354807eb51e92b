"""The backward kernels' plain versions and the fused losses, on the CPU,
held against the JAX package.

- ``fused_conv``'s gradient (``conv_dw`` for the weight, the forward
  kernel on the flipped io-swapped weight for dx, plain epilogue
  adjoints) against ``jax.vjp`` of the XLA conv, which the JAX tests
  equate with the Pallas arm;
- the transposed resample against ``jax.vjp`` of the ``fast`` resample;
- the fused BCE/IoU/CEL loss and SSIM against the JAX Pallas kernels in
  interpret mode and against the plain ``losses`` terms on both sides.

Inputs are numpy draws from a seed; everything is f32.  Tolerances: the
conv and resample gradients are the same products summed in another
order (1e-5 of the largest value, 1e-6 for the 4-tap resample); the
loss and SSIM values are f32 sums over at most a few thousand pixels
(rtol 1e-5), and so are the per-image sums their gradients are built
from (1e-5 of the largest).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sod_project_tpu.losses import deep_supervision as jds
from distributed_sod_project_tpu.losses import elementwise as jel
from distributed_sod_project_tpu.losses import region as jreg
from distributed_sod_project_tpu.losses.ssim import ssim as jax_ssim
from distributed_sod_project_tpu.models import layers as jlayers
from distributed_sod_project_tpu.pallas import fused_loss as jfl
from distributed_sod_project_tpu.pallas import fused_ssim as jfs
from distributed_sod_project_tpu_torch import losses as tlosses
from distributed_sod_project_tpu_torch.kernels import fused_conv as fc
from distributed_sod_project_tpu_torch.kernels import fused_loss as fl
from distributed_sod_project_tpu_torch.kernels import fused_resample as fr
from distributed_sod_project_tpu_torch.kernels import fused_ssim as fs


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _jax_conv(parts, w, b, dilation, mode, relu):
    x = jnp.concatenate(parts, axis=-1)
    kh, kw = w.shape[:2]
    pad = [(dilation * (kh // 2),) * 2, (dilation * (kw // 2),) * 2]
    c = jax.lax.conv_general_dilated(
        x, w, (1, 1), pad,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)
    y = c + b if mode == "bias" else c
    return jnp.maximum(y, 0) if relu else y


_CONV_CASES = [((5, 8, 3)[:n], 6, mode, relu, 1 + (n == 2))
               for n, mode, relu in itertools.product(
                   (1, 2, 3), ("none", "bias"), (False, True))]
_CONV_CASES += [((3,), 16, "none", False, 1),   # the first layer: Ci = 3
                ((32,), 1, "bias", False, 1)]   # the head: Co = 1


@pytest.mark.parametrize("chans,cout,mode,relu,dilation", _CONV_CASES)
def test_fused_conv_gradient_matches_xla_vjp(chans, cout, mode, relu,
                                             dilation):
    rng = np.random.default_rng(sum(chans) * 10 + cout)
    parts = [rng.standard_normal((2, 9, 7, c)).astype(np.float32)
             for c in chans]
    w = (0.2 * rng.standard_normal((3, 3, sum(chans), cout))).astype(
        np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    g = rng.standard_normal((2, 9, 7, cout)).astype(np.float32)
    y, vjp = jax.vjp(lambda p, w, b: _jax_conv(p, w, b, dilation, mode, relu),
                     [jnp.asarray(p) for p in parts], jnp.asarray(w),
                     jnp.asarray(b))
    gparts, gw, gb = vjp(jnp.asarray(g))

    tparts = [torch.from_numpy(p).requires_grad_() for p in parts]
    tw = torch.from_numpy(w).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    vecs = {"bias": tb} if mode == "bias" else {}
    before = (fc.launches, fc.dw_launches)
    out = fc.fused_conv(tparts, tw, vecs, kernel=(3, 3), dilation=dilation,
                        mode=mode, relu=relu)
    out.backward(torch.from_numpy(g))
    assert (fc.launches, fc.dw_launches) == before  # plain versions only
    _close(out.detach(), y)
    for tp, want in zip(tparts, gparts):
        _close(tp.grad, want)
    _close(tw.grad, gw)
    # conv_dw alone, on the cotangent after the ReLU mask.
    dz = np.where(np.asarray(y) > 0, g, 0).astype(np.float32) if relu else g
    _close(fc.conv_dw_plain([torch.from_numpy(p) for p in parts],
                            torch.from_numpy(dz), kernel=(3, 3),
                            dilation=dilation), gw)
    if mode == "bias":
        _close(tb.grad, gb)


def test_fused_conv_skips_dx_for_inputs_without_gradient(monkeypatch):
    """The image needs no gradient: the backward runs dw only."""
    calls = []
    real = fc.fused_conv
    monkeypatch.setattr(fc, "fused_conv",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(1, 6, 6, 3)
    w = torch.randn(3, 3, 3, 4, requires_grad=True)
    real([x], w, kernel=(3, 3), mode="none").sum().backward()
    assert calls == [] and w.grad is not None


def test_fused_conv_bf16_weight_gradient_is_rounded_to_the_weight_dtype():
    """As JAX does (pallas/fused_conv.py ``dw.astype(w.dtype)``): the f32
    parameter's gradient through a bf16 cast is bf16-rounded."""
    rng = np.random.default_rng(5)
    w32 = torch.from_numpy(rng.standard_normal((3, 3, 4, 5)).astype(
        np.float32)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 4)).astype(
        np.float32)).to(torch.bfloat16)
    out = fc.fused_conv([x], w32.to(torch.bfloat16), kernel=(3, 3))
    out.float().sum().backward()
    assert w32.grad.dtype == torch.float32
    assert torch.equal(w32.grad, w32.grad.to(torch.bfloat16).float())
    want = fc.conv_dw_plain([x], torch.ones_like(out), kernel=(3, 3))
    assert torch.equal(w32.grad, want.to(torch.bfloat16).float())


def test_fused_conv_bn_mode_gradient_raises_naming_roadmap():
    x = torch.randn(1, 5, 5, 2)
    w = torch.randn(3, 3, 2, 3, requires_grad=True)
    vecs = {"mean": torch.zeros(3), "mul": torch.ones(3),
            "bias": torch.zeros(3)}
    y = fc.fused_conv([x], w, vecs, kernel=(3, 3), mode="bn")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        y.sum().backward()


@pytest.mark.parametrize("mode,x_first", [("up", True), ("add", True),
                                          ("concat", True),
                                          ("concat", False)])
@pytest.mark.parametrize("n", [1, 2, 5])  # coarse size; 1: the 1x1 maps
def test_upsample_transpose_matches_fast_resample_vjp(mode, x_first, n):
    rng = np.random.default_rng(n * 7 + len(mode))
    h, w = n, n + 1
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    lat = rng.standard_normal(
        (2, 2 * h, 2 * w, 4 if mode == "add" else 3)).astype(np.float32)
    if mode == "up":
        fn = lambda x, lat: jlayers.resize_to(  # noqa: E731
            x, (2 * h, 2 * w), impl="fast")
    else:
        fn = lambda x, lat: jlayers.resample_merge(  # noqa: E731
            x, lat, mode=mode, x_first=x_first, impl="fast")
    y, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(lat))
    g = rng.standard_normal(y.shape).astype(np.float32)
    gx, glat = vjp(jnp.asarray(g))

    tx = torch.from_numpy(x).requires_grad_()
    tlat = torch.from_numpy(lat).requires_grad_()
    out = (fr.fused_upsample2(tx) if mode == "up"
           else fr.fused_upsample2_merge(tx, tlat, mode=mode,
                                         x_first=x_first))
    before = fr.upT_launches
    out.backward(torch.from_numpy(g))
    assert fr.upT_launches == before
    _close(tx.grad, gx, 1e-6)
    if mode != "up":
        _close(tlat.grad, glat, 0)


def test_upsample_transpose_reads_a_channel_slab():
    g = torch.randn(2, 6, 4, 9)
    np.testing.assert_array_equal(
        fr.upsample2_T(g, 5, 3).numpy(),
        fr.upsample2_T_plain(g[..., 5:8].contiguous()).numpy())
    with pytest.raises(ValueError, match="outside"):
        fr.upsample2_T(g, 7, 3)
    with pytest.raises(ValueError, match="even"):
        fr.upsample2_T(torch.randn(1, 5, 4, 2))


def _maps(seed, b=2, h=16, w=16):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((b, h, w, 1))).astype(np.float32)
    t = (rng.random((b, h, w, 1)) > 0.6).astype(np.float32)
    return x, t


def test_pixel_region_sums_match_the_jax_kernel():
    x, t = _maps(0)
    want = jfl.pixel_region_sums(jnp.asarray(x), jnp.asarray(t))
    got = fl.pixel_region_sums(torch.from_numpy(x), torch.from_numpy(t))
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of 128"):
        fl.pixel_region_sums(torch.zeros(2, 10, 10, 1),
                             torch.zeros(2, 10, 10, 1))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 0.0), (1.0, 1.0, 1.0),
                                     (0.0, 0.5, 2.0)])
def test_fused_bce_iou_cel_value_and_gradient_match_jax(weights):
    x, t = _maps(1)
    jt = jnp.asarray(t)
    jv, jg = jax.value_and_grad(
        lambda a: jfl.fused_bce_iou_cel(a, jt, *weights))(jnp.asarray(x))
    bw, iw, cw = weights
    rv, rg = jax.value_and_grad(
        lambda a: bw * jel.bce_with_logits(a, jt) + iw * jreg.iou_loss(a, jt)
        + cw * jreg.cel_loss(a, jt))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tv = fl.fused_bce_iou_cel(tx, torch.from_numpy(t), *weights)
    tv.backward()
    tx2 = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(t)
    (bw * tlosses.bce_with_logits(tx2, tt) + iw * tlosses.iou_loss(tx2, tt)
     + cw * tlosses.cel_loss(tx2, tt)).backward()
    for v, g in ((jv, jg), (rv, rg)):
        np.testing.assert_allclose(float(tv.detach()), float(v), rtol=1e-5)
        _close(tx.grad, g, 1e-5)
        _close(tx2.grad, g, 1e-5)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 13, 20)])
def test_fused_ssim_value_and_gradients_match_jax(shape):
    rng = np.random.default_rng(shape[1])
    a = rng.random(shape).astype(np.float32)
    b = (0.7 * rng.random(shape)).astype(np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    kv, (kga, kgb) = jax.value_and_grad(jfs.fused_ssim_mean, (0, 1))(ja, jb)
    rv, (rga, rgb) = jax.value_and_grad(
        lambda a, b: jax_ssim(a[..., None], b[..., None]), (0, 1))(ja, jb)
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    before = (fs.launches, fs.bwd_launches)
    tv = fs.fused_ssim_mean(ta, tb)
    tv.backward()
    assert (fs.launches, fs.bwd_launches) == before
    ta2 = torch.from_numpy(a).requires_grad_()
    tlosses.ssim(ta2[..., None], torch.from_numpy(b)[..., None]).backward()
    for v, ga, gb in ((kv, kga, kgb), (rv, rga, rgb)):
        np.testing.assert_allclose(float(tv.detach()), float(v), rtol=1e-5)
        _close(ta.grad, ga, 1e-5)
        _close(tb.grad, gb, 1e-5)
        _close(ta2.grad, ga, 1e-5)


def test_fused_ssim_skips_the_target_gradient_when_not_needed():
    a = torch.rand(1, 12, 12, requires_grad=True)
    b = torch.rand(1, 12, 12)
    fs.fused_ssim_loss(a, b).backward()
    ga, gb = fs.ssim_grads(a.detach(), b, need_b=False)
    assert gb is None and a.grad.shape == a.shape
    with pytest.raises(ValueError, match="odd window"):
        fs.ssim_taps(10, 1.5)
    with pytest.raises(ValueError, match="envelope"):
        fs.ssim_sums(torch.zeros(1, 449, 449), torch.zeros(1, 449, 449))


@pytest.mark.parametrize("hw", [(16, 16), (10, 10), (8, 30)])
def test_deep_supervision_routes_and_sums_as_jax(hw):
    """16x16: both kernels (256 px is a multiple of 128); 10x10 and 8x30:
    off-lane pixel counts take the plain BCE/IoU/CEL terms, SSIM stays
    fused; the components and the total equal JAX's either way."""
    rng = np.random.default_rng(hw[0] + hw[1])
    outs = [(2 * rng.standard_normal((2, *hw, 1))).astype(np.float32)
            for _ in range(2)]
    t = (rng.random((2, *hw, 1)) > 0.5).astype(np.float32)
    kw = dict(bce_w=1.0, iou_w=1.0, ssim_w=1.0, cel_w=1.0, ssim_window=11,
              level_weights=[1.0, 0.5])
    jt, jc = jds.deep_supervision_loss([jnp.asarray(o) for o in outs],
                                       jnp.asarray(t), fused=True, **kw)
    tt, tc = tlosses.deep_supervision_loss(
        [torch.from_numpy(o) for o in outs], torch.from_numpy(t), **kw)
    fused = (hw[0] * hw[1]) % 128 == 0
    assert set(tc) == set(jc) == ({"bce_iou_cel", "ssim", "total"} if fused
                                  else {"bce", "iou", "cel", "ssim", "total"})
    for k in jc:
        np.testing.assert_allclose(float(tc[k]), float(jc[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
