"""Fused conv(+concat)(+affine)(+ReLU) over NHWC parts, forward only.

Replaces ``distributed_sod_project_tpu/pallas/fused_conv.py``
(``_call_fwd`` with ``_fwd_kernel``).  The CUDA kernel is
``csrc/fused_conv.cu``: an implicit GEMM that reads every part at its
own channel offset, so the decoder's channel concat is never built; it
is bound by operations at the wide layers and runs bf16 on the tensor
cores (the note at the top of the source says how).

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
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # kernel launches; the plain CPU version never counts

MAX_PARTS = 4
MODES = ("none", "bias", "bn")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])


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


def fused_conv(parts: Sequence[torch.Tensor], w: torch.Tensor,
               vecs: Optional[Dict[str, torch.Tensor]] = None, *,
               kernel: Tuple[int, int], dilation: int = 1,
               mode: str = "none", relu: bool = False) -> torch.Tensor:
    """Conv over the channel concat of same-spatial NHWC ``parts``.

    ``w`` is the ``(kh, kw, sum(cin), cout)`` HWIO kernel in the parts'
    compute dtype; ``vecs`` holds the epilogue's f32 ``[cout]`` vectors:
    ``bias`` (the conv bias, pre-rounded to the compute dtype) for mode
    ``bias``; ``mean``, ``mul``, ``bias`` (beta) for mode ``bn``.
    """
    parts = list(parts)
    vecs = dict(vecs or {})
    _check(parts, w, kernel, mode, vecs)
    x0 = parts[0]
    if x0.device.type == "cpu":
        return conv_plain(parts, w, vecs, dilation=dilation, mode=mode,
                          relu=relu)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_conv: unsupported device {x0.device}")
    if x0.dtype not in _DTYPES:
        raise TypeError(f"fused_conv: dtype {x0.dtype} not in {list(_DTYPES)}")
    for t in parts + [w]:
        if t.device != x0.device or t.dtype != x0.dtype:
            raise ValueError("fused_conv: parts and weight must share "
                             "device and dtype")
        if not t.is_contiguous():
            raise ValueError("fused_conv: operands must be contiguous")
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
