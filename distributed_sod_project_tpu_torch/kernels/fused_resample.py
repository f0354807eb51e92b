"""Fused 2x bilinear upsample (+ add / + concat) over NHWC maps, and its
transpose.

Replaces ``distributed_sod_project_tpu/pallas/fused_resample.py``:

- ``_call_up`` with ``_up_kernel``; ``_call_merge`` with
  ``_up_add_kernel`` / ``_up_cat_kernel`` -> ``csrc/fused_resample.cu``:
  bound by bytes, it reads the coarse map and the lateral once and writes
  the merged map once (the note at the top of the source says how).
- ``_call_upT`` with ``_upT_kernel`` -> ``csrc/fused_resample_upT.cu``
  (``upsample2_T``): the transposed upsample, the gradient with respect
  to the coarse map, in gather form; the concat merge's slab of the
  cotangent is read at its channel offset, never copied out.

Numerics (pallas/fused_resample.py:25-40): half-pixel bilinear with the
edge taps clamped, H then W, lerped in f32 and rounded once to the
input dtype; the add merge adds the lateral in f32 before that one
rounding, the concat merge writes the rounded ``up`` beside the lateral.
The transpose applies W then H in f32 and rounds once.  The op is linear
in both operands, so the lateral's gradient is the cotangent (or its
channel slab).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # forward-kernel launches; the plain CPU version never counts
upT_launches = 0  # upsample2_T kernel launches

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"up": 0, "add": 1, "concat": 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_UPT_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _up2_axis_f32(t: torch.Tensor, dim: int) -> torch.Tensor:
    n = t.shape[dim]
    first, last = t.narrow(dim, 0, 1), t.narrow(dim, n - 1, 1)
    prev = torch.cat([first, t.narrow(dim, 0, n - 1)], dim)  # x[i-1]
    nxt = torch.cat([t.narrow(dim, 1, n - 1), last], dim)    # x[i+1]
    even = 0.25 * prev + 0.75 * t
    odd = 0.75 * t + 0.25 * nxt
    shape = list(t.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def resample_plain(x: torch.Tensor, lateral: Optional[torch.Tensor] = None,
                   mode: str = "up", x_first: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel, op for op."""
    up = _up2_axis_f32(_up2_axis_f32(x.float(), 1), 2)
    if mode == "up":
        return up.to(x.dtype)
    if mode == "add":
        return (up + lateral.float()).to(x.dtype)
    up = up.to(x.dtype)
    return torch.cat([up, lateral] if x_first else [lateral, up], dim=-1)


def _check_cuda(name: str, tensors) -> None:
    x = tensors[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not in {list(_DTYPES)}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: operands must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous NHWC")


def _run(x: torch.Tensor, lat: Optional[torch.Tensor], mode: str,
         x_first: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return resample_plain(x, lat, mode, x_first)
    _check_cuda("fused_resample", [x] if lat is None else [x, lat])
    b, h, w, c = x.shape
    cl = 0 if lat is None else lat.shape[-1]
    co = c + cl if mode == "concat" else c
    out = torch.empty((b, 2 * h, 2 * w, co), device=x.device, dtype=x.dtype)
    fn = _build.entry("fused_resample", "dsod_fused_resample", _ARGTYPES)
    with torch.cuda.device(out.device):  # launch on the tensors' card
        status = fn(x.data_ptr(), 0 if lat is None else lat.data_ptr(),
                    out.data_ptr(), b, h, w, c, cl, _MODES[mode], int(x_first),
                    _DTYPES[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_build.load("fused_resample"), status, "fused_resample")
    global launches
    launches += 1
    return out


def _deint_T_plain(g: torch.Tensor, dim: int) -> torch.Tensor:
    """One axis of the transposed upsample, ``2n -> n``
    (pallas/fused_resample.py ``_deint_T``), f32 in and out."""
    n = g.shape[dim] // 2
    ge = g.narrow(dim, 0, 2 * n).unflatten(dim, (n, 2)).select(dim + 1, 0)
    go = g.narrow(dim, 0, 2 * n).unflatten(dim, (n, 2)).select(dim + 1, 1)
    if n == 1:
        return ge + go
    go_shift = torch.cat([ge.narrow(dim, 0, 1), go.narrow(dim, 0, n - 1)],
                         dim)  # go[j-1], with go[-1] := ge[0]
    ge_shift = torch.cat([ge.narrow(dim, 1, n - 1), go.narrow(dim, n - 1, 1)],
                         dim)  # ge[j+1], with ge[n] := go[n-1]
    return 0.75 * (ge + go) + 0.25 * (go_shift + ge_shift)


def upsample2_T_plain(g: torch.Tensor) -> torch.Tensor:
    """The plain version of ``upsample2_T``: W then H in f32, rounded
    once."""
    return _deint_T_plain(_deint_T_plain(g.float(), 2), 1).to(g.dtype)


def upsample2_T(g: torch.Tensor, c_off: int = 0,
                c: Optional[int] = None) -> torch.Tensor:
    """The transposed 2x upsample of channels ``[c_off, c_off + c)`` of
    the NHWC cotangent ``g`` ``[B, 2h, 2w, C] -> [B, h, w, c]``."""
    if g.ndim != 4 or g.shape[1] % 2 or g.shape[2] % 2:
        raise ValueError(f"expected an NHWC map of even size, got "
                         f"{tuple(g.shape)}")
    ctot = int(g.shape[-1])
    c = ctot - c_off if c is None else int(c)
    if c_off < 0 or c < 1 or c_off + c > ctot:
        raise ValueError(f"channels [{c_off}, {c_off + c}) outside {ctot}")
    if g.device.type == "cpu":
        return upsample2_T_plain(g[..., c_off:c_off + c])
    _check_cuda("upsample2_T", [g])
    b, hh, ww, _ = g.shape
    dx = torch.empty((b, hh // 2, ww // 2, c), device=g.device, dtype=g.dtype)
    fn = _build.entry("fused_resample_upT", "dsod_upsample2_T", _UPT_ARGTYPES)
    with torch.cuda.device(g.device):
        status = fn(g.data_ptr(), dx.data_ptr(), b, hh // 2, ww // 2, c,
                    ctot, int(c_off), _DTYPES[g.dtype],
                    torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(_build.load("fused_resample_upT"), status, "upsample2_T")
    global upT_launches
    upT_launches += 1
    return dx


class _ResampleFn(torch.autograd.Function):
    """The upsample(+merge) with the JAX package's closed-form VJPs
    (pallas/fused_resample.py ``_up2_bwd`` / ``_up2_add_bwd`` /
    ``_up2_cat_bwd``)."""

    @staticmethod
    def forward(ctx, mode, x_first, x, lat):
        ctx.mode, ctx.x_first, ctx.c = mode, x_first, int(x.shape[-1])
        return _run(x, lat, mode, x_first)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        gx = glat = None
        need_x, need_lat = ctx.needs_input_grad[2:4]
        c, ctot = ctx.c, int(g.shape[-1])
        x_off = 0 if ctx.mode != "concat" or ctx.x_first else ctot - c
        if need_x:
            # upsample2_T resolved through the module at call time, so a
            # wrapper installed around it sees these launches too.
            gx = upsample2_T(g, x_off, c)
        if need_lat and ctx.mode == "add":
            glat = g
        elif need_lat:
            glat = g[..., c:] if ctx.x_first else g[..., :ctot - c]
        return None, None, gx, glat


def fused_upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NHWC map ``[B,h,w,C] -> [B,2h,2w,C]``."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    return _ResampleFn.apply("up", True, x, None)


def fused_upsample2_merge(x: torch.Tensor, lateral: torch.Tensor,
                          mode: str = "add",
                          x_first: bool = True) -> torch.Tensor:
    """Upsample ``x`` 2x to ``lateral``'s spatial size and merge:
    ``mode='add'`` (``up + lateral``; channels must match) or
    ``mode='concat'`` (``[up, lateral]`` when ``x_first``, else
    ``[lateral, up]``)."""
    if x.ndim != 4 or lateral.ndim != 4:
        raise ValueError(
            f"expected NHWC, got {tuple(x.shape)} / {tuple(lateral.shape)}")
    b, h, w, c = x.shape
    if lateral.shape[0] != b or tuple(lateral.shape[1:3]) != (2 * h, 2 * w):
        raise ValueError(f"lateral {tuple(lateral.shape)} is not the 2x "
                         f"target of {tuple(x.shape)}")
    if mode == "add":
        if lateral.shape[-1] != c:
            raise ValueError(f"add merge needs matching channels, got {c} "
                             f"vs {lateral.shape[-1]}")
    elif mode != "concat":
        raise ValueError(f"mode must be 'add' or 'concat', got {mode!r}")
    return _ResampleFn.apply(mode, x_first, x, lateral)
