"""Fused 2x bilinear upsample (+ add / + concat) over NHWC maps.

Replaces ``distributed_sod_project_tpu/pallas/fused_resample.py``
(``_call_up`` with ``_up_kernel``; ``_call_merge`` with
``_up_add_kernel`` / ``_up_cat_kernel``).  The CUDA kernel is
``csrc/fused_resample.cu``: it is bound by bytes, and reads the coarse
map and the lateral once and writes the merged map once (the note at the
top of the source says how).

Numerics (pallas/fused_resample.py:25-26): half-pixel bilinear with the
edge taps clamped, H then W, lerped in f32 and rounded once to the
input dtype; the add merge adds the lateral in f32 before that one
rounding, the concat merge writes the rounded ``up`` beside the lateral.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches; the plain CPU version never counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"up": 0, "add": 1, "concat": 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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


def _run(x: torch.Tensor, lat: Optional[torch.Tensor], mode: str,
         x_first: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return resample_plain(x, lat, mode, x_first)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resample: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_resample: dtype {x.dtype} not in "
                        f"{list(_DTYPES)}")
    ops = [x] if lat is None else [x, lat]
    for t in ops:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("fused_resample: x and lateral must share "
                             "device and dtype")
        if not t.is_contiguous():
            raise ValueError("fused_resample: operands must be contiguous "
                             "NHWC")
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


def fused_upsample2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of an NHWC map ``[B,h,w,C] -> [B,2h,2w,C]``."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    return _run(x, None, "up", True)


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
    return _run(x, lateral, mode, x_first)
