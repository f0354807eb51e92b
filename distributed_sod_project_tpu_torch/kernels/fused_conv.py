"""Fused conv(+concat)(+affine)(+ReLU) over NHWC parts, and its gradient.

Replaces ``distributed_sod_project_tpu/pallas/fused_conv.py``:

- ``_call_fwd`` with ``_fwd_kernel`` -> ``csrc/fused_conv.cu``: an
  implicit GEMM that reads every part at its own channel offset, so the
  decoder's channel concat is never built; it is bound by operations at
  the wide layers and runs bf16 on the tensor cores (the note at the top
  of the source says how).
- ``_call_dw`` with ``_dw_kernel`` -> ``csrc/fused_conv_dw.cu``
  (``conv_dw``): the weight gradient, an implicit GEMM whose reduction
  runs over every pixel of the batch, split into slices summed in a
  fixed order.
- ``_fused_conv_bwd`` -> ``_FusedConvFn.backward``: dx is the forward
  kernel on the cotangent with the flipped, io-swapped weight (epilogue
  ``none``), dw is ``conv_dw``, and the epilogue adjoints (ReLU mask, the
  bias sum) are plain tensor code, as the JAX package leaves them to XLA.

Epilogue order (pallas/fused_conv.py ``_epilogue``): f32 accumulate ->
cast to the compute dtype -> ``none`` | ``bias`` (``c + bias``) |
``bn`` (``(c - mean) * mul + beta`` in f32, then cast) -> optional ReLU,
with ``mul = rsqrt(var + 1e-5) * scale`` folded by the caller
(``models/layers.py``), as at models/layers.py:231-232 of the JAX
package.  Quantized (int8/fp8) weights belong to serving arms that are
not ported yet and raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # forward-kernel launches (forward and dx); plain never counts
dw_launches = 0  # conv_dw kernel launches

MAX_PARTS = 4
MODES = ("none", "bias", "bn")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])
_DW_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
_DW_ROWS, _DW_COLS, _DW_PIXELS = 64, 64, 32  # csrc/fused_conv_dw.cu tiles
_DW_TARGET_BLOCKS = 132 * 4  # four blocks per H100 SM


def conv_plain(parts: Sequence[torch.Tensor], w: torch.Tensor,
               vecs: Dict[str, torch.Tensor], *, dilation: int, mode: str,
               relu: bool) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the concat, an f32 conv
    of the compute-dtype values, and the same epilogue op for op."""
    cd = parts[0].dtype
    x = torch.cat([p.float() for p in parts], dim=-1).permute(0, 3, 1, 2)
    kh, kw = w.shape[:2]
    acc = F.conv2d(x, w.float().permute(3, 2, 0, 1), stride=1,
                   padding=(dilation * (kh // 2), dilation * (kw // 2)),
                   dilation=dilation)
    c = acc.permute(0, 2, 3, 1).to(cd)
    if mode == "bias":
        y = (c.float() + vecs["bias"]).to(cd)
    elif mode == "bn":
        y = ((c.float() - vecs["mean"]) * vecs["mul"] + vecs["bias"]).to(cd)
    else:
        y = c
    if relu:
        y = torch.clamp_min(y, 0)
    return y.contiguous()


def _check(parts, w, kernel: Tuple[int, int], mode: str, vecs) -> None:
    if not parts or len(parts) > MAX_PARTS or any(p.ndim != 4 for p in parts):
        raise ValueError(
            f"expected 1..{MAX_PARTS} NHWC parts, got "
            f"{[tuple(p.shape) for p in parts]}")
    sp = tuple(parts[0].shape[:3])
    if any(tuple(p.shape[:3]) != sp for p in parts):
        raise ValueError("parts disagree on batch/spatial dims: "
                         f"{[tuple(p.shape) for p in parts]}")
    kh, kw = kernel
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"fused conv needs odd kernels, got {kernel}")
    cin = sum(int(p.shape[-1]) for p in parts)
    if w.ndim != 4 or tuple(w.shape[:3]) != (kh, kw, cin):
        raise ValueError(f"weight {tuple(w.shape)} does not match kernel "
                         f"{kernel} x cin {cin}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if "qscale" in vecs:
        raise NotImplementedError(
            "quantized (int8/fp8) fused-conv weights belong to the int8/fp8 "
            "serving arms, which are not ported yet (ROADMAP.md Queue 1)")
    need = {"none": set(), "bias": {"bias"}, "bn": {"mean", "mul", "bias"}}
    if set(vecs) != need[mode]:
        raise ValueError(f"mode {mode!r} takes epilogue vectors "
                         f"{sorted(need[mode])}, got {sorted(vecs)}")


def _check_cuda(name: str, tensors, x0: torch.Tensor) -> None:
    """The kernels' operand contract: one CUDA device, one supported
    dtype, contiguous."""
    if x0.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x0.device}")
    if x0.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x0.dtype} not in {list(_DTYPES)}")
    for t in tensors:
        if t.device != x0.device or t.dtype != x0.dtype:
            raise ValueError(f"{name}: operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _forward(parts, w, vecs, kernel, dilation, mode, relu) -> torch.Tensor:
    """One forward: the plain version for CPU tensors, else one launch."""
    x0 = parts[0]
    if x0.device.type == "cpu":
        return conv_plain(parts, w, vecs, dilation=dilation, mode=mode,
                          relu=relu)
    _check_cuda("fused_conv", parts + [w], x0)
    for k, v in vecs.items():
        if (v.device != x0.device or v.dtype != torch.float32
                or tuple(v.shape) != (w.shape[-1],) or not v.is_contiguous()):
            raise ValueError(f"fused_conv: epilogue vector {k!r} must be a "
                             f"contiguous float32 [{w.shape[-1]}] on "
                             f"{x0.device}")
    b, h, wd, _ = x0.shape
    cout = int(w.shape[-1])
    out = torch.empty((b, h, wd, cout), device=x0.device, dtype=x0.dtype)
    ptrs = [p.data_ptr() for p in parts] + [0] * (MAX_PARTS - len(parts))
    chans = [int(p.shape[-1]) for p in parts] + [0] * (MAX_PARTS - len(parts))
    vec = lambda k: vecs[k].data_ptr() if k in vecs else 0  # noqa: E731
    fn = _build.entry("fused_conv", "dsod_fused_conv", _ARGTYPES)
    with torch.cuda.device(out.device):  # launch on the tensors' card
        status = fn(*ptrs, *chans, len(parts), w.data_ptr(), vec("mean"),
                    vec("mul"), vec("bias"), out.data_ptr(), b, h, wd, cout,
                    kernel[0], kernel[1], int(dilation), MODES.index(mode),
                    int(relu), _DTYPES[x0.dtype],
                    torch.cuda.current_stream(x0.device).cuda_stream)
    _build.check(_build.load("fused_conv"), status, "fused_conv")
    global launches
    launches += 1
    return out


def _flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Stride-1 same-conv transpose weights: spatial flip + io swap,
    contiguous for the kernel (pallas/fused_conv.py ``_flip_transpose``)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


class _FusedConvFn(torch.autograd.Function):
    """``fused_conv`` with the JAX package's closed-form VJP
    (pallas/fused_conv.py ``_fused_conv_bwd``) for modes ``none`` and
    ``bias``."""

    @staticmethod
    def forward(ctx, meta, w, mean, mul, bias, *parts):
        kernel, dilation, mode, relu = meta
        vecs = {k: v for k, v in (("mean", mean), ("mul", mul),
                                  ("bias", bias)) if v is not None}
        y = _forward(list(parts), w, vecs, kernel, dilation, mode, relu)
        ctx.meta = meta
        ctx.splits = [int(p.shape[-1]) for p in parts]
        ctx.save_for_backward(w, y if relu else None, *parts)
        return y

    @staticmethod
    def backward(ctx, g):
        kernel, dilation, mode, relu = ctx.meta
        if mode == "bn":
            raise NotImplementedError(
                "the gradient of fused_conv mode 'bn' needs the forward to "
                "emit the pre-affine conv output (save_preact); training "
                "runs mode 'none' followed by BatchNorm — see ROADMAP.md "
                "Queue 2")
        w, y, *parts = ctx.saved_tensors
        dz = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                               device=g.device)) \
            if relu else g
        dz = dz.contiguous()
        need = ctx.needs_input_grad
        dbias = None
        if mode == "bias" and need[4]:
            dbias = dz.float().sum((0, 1, 2))
        dparts = [None] * len(parts)
        if any(need[5:]):
            # fused_conv resolved through the module at call time, so a
            # wrapper installed around it sees the dx launches too.
            dx = fused_conv([dz], _flip_transpose(w), {}, kernel=kernel,
                            dilation=dilation, mode="none")
            lo = 0
            for i, cw in enumerate(ctx.splits):
                if need[5 + i]:
                    dparts[i] = dx[..., lo:lo + cw]
                lo += cw
        dw = None
        if need[1]:
            dw = conv_dw(parts, dz, kernel=kernel,
                         dilation=dilation).to(w.dtype)
        return (None, dw, None, None, dbias, *dparts)


def fused_conv(parts: Sequence[torch.Tensor], w: torch.Tensor,
               vecs: Optional[Dict[str, torch.Tensor]] = None, *,
               kernel: Tuple[int, int], dilation: int = 1,
               mode: str = "none", relu: bool = False) -> torch.Tensor:
    """Conv over the channel concat of same-spatial NHWC ``parts``.

    ``w`` is the ``(kh, kw, sum(cin), cout)`` HWIO kernel in the parts'
    compute dtype; ``vecs`` holds the epilogue's f32 ``[cout]`` vectors:
    ``bias`` (the conv bias, pre-rounded to the compute dtype) for mode
    ``bias``; ``mean``, ``mul``, ``bias`` (beta) for mode ``bn``.
    Differentiable in modes ``none`` and ``bias``; mode ``bn``'s backward
    raises.
    """
    parts = list(parts)
    vecs = dict(vecs or {})
    _check(parts, w, kernel, mode, vecs)
    meta = (tuple(kernel), int(dilation), mode, bool(relu))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in parts + [w] + list(vecs.values())):
        return _FusedConvFn.apply(meta, w, vecs.get("mean"), vecs.get("mul"),
                                  vecs.get("bias"), *parts)
    return _forward(parts, w, vecs, *meta)


def conv_dw_plain(parts: Sequence[torch.Tensor], g: torch.Tensor, *,
                  kernel: Tuple[int, int], dilation: int = 1
                  ) -> torch.Tensor:
    """The plain version of ``conv_dw``: per tap, the shifted f32 concat
    contracted with the f32 cotangent over every pixel of the batch, as
    ``_dw_kernel`` does (compute-dtype values, f32 accumulation)."""
    kh, kw = kernel
    ph, pw = dilation * (kh // 2), dilation * (kw // 2)
    x = torch.cat([p.float() for p in parts], dim=-1)
    b, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    g2 = g.float().reshape(b * h * wd, -1)
    taps = []
    for u in range(kh):
        for v in range(kw):
            lhs = xp[:, u * dilation:u * dilation + h,
                     v * dilation:v * dilation + wd, :]
            taps.append(lhs.reshape(b * h * wd, cin).t() @ g2)
    return torch.stack(taps).reshape(kh, kw, cin, g2.shape[-1])


def dw_splits(m: int, row_tiles: int, col_tiles: int) -> Tuple[int, int]:
    """``(splits, pixels per split)``: enough pixel slices that the grid
    holds about four blocks per SM, each slice a whole number of the
    kernel's 32-pixel steps and at least 1024 pixels long."""
    tiles = row_tiles * col_tiles
    want = max(1, min(math.ceil(_DW_TARGET_BLOCKS / tiles), m // 1024))
    per = math.ceil(math.ceil(m / want) / _DW_PIXELS) * _DW_PIXELS
    return math.ceil(m / per), per


def conv_dw(parts: Sequence[torch.Tensor], g: torch.Tensor, *,
            kernel: Tuple[int, int], dilation: int = 1) -> torch.Tensor:
    """The weight gradient ``[kh, kw, sum(cin), cout]`` (f32) of
    ``fused_conv(parts, w)`` for the output cotangent ``g``
    ``[B, H, W, cout]``, the parts and ``g`` in one compute dtype."""
    parts = list(parts)
    if not parts or len(parts) > MAX_PARTS:
        raise ValueError(f"expected 1..{MAX_PARTS} parts, got {len(parts)}")
    if g.ndim != 4 or any(tuple(p.shape[:3]) != tuple(g.shape[:3])
                          for p in parts):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match parts "
                         f"{[tuple(p.shape) for p in parts]}")
    kh, kw = kernel
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"fused conv needs odd kernels, got {kernel}")
    if g.device.type == "cpu":
        return conv_dw_plain(parts, g, kernel=kernel, dilation=dilation)
    _check_cuda("conv_dw", parts + [g], g)
    b, h, wd, cout = g.shape
    chans = [int(p.shape[-1]) for p in parts]
    cin = sum(chans)
    row_tiles = kh * kw * sum(math.ceil(c / _DW_ROWS) for c in chans)
    splits, per = dw_splits(b * h * wd, row_tiles, math.ceil(cout / _DW_COLS))
    out = torch.empty((kh, kw, cin, cout), device=g.device,
                      dtype=torch.float32)
    partial = torch.empty((splits if splits > 1 else 0) * out.numel(),
                          device=g.device, dtype=torch.float32)
    ptrs = [p.data_ptr() for p in parts] + [0] * (MAX_PARTS - len(parts))
    chans += [0] * (MAX_PARTS - len(parts))
    fn = _build.entry("fused_conv_dw", "dsod_conv_dw", _DW_ARGTYPES)
    with torch.cuda.device(g.device):
        status = fn(*ptrs, *chans, len(parts), g.data_ptr(),
                    partial.data_ptr(), out.data_ptr(), b, h, wd, cout, kh,
                    kw, int(dilation), splits, per, _DTYPES[g.dtype],
                    torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(_build.load("fused_conv_dw"), status, "conv_dw")
    global dw_launches
    dw_launches += 1
    return out
