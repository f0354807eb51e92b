"""Fused SSIM: the per-image sum of the SSIM map and its gradient.

Replaces ``distributed_sod_project_tpu/pallas/fused_ssim.py`` (``_run``
with ``_fwd_kernel`` and ``_bwd_kernel``) -> ``csrc/fused_ssim.cu``: a
separable blur over an image tile with an r-pixel halo in shared memory,
zero outside the image (the band matrices' "SAME" zero padding), H then
W; the backward writes the closed-form pointwise partials, then blurs and
combines them (the note at the top of the source says how).
``fused_ssim_mean`` / ``fused_ssim_loss`` are the differentiable
functions the loss calls, as in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

launches = 0  # forward-kernel launches; the plain CPU version never counts
bwd_launches = 0  # backward-kernel launches

C1 = 0.01 ** 2
C2 = 0.03 ** 2
MAX_PIXELS = 448 * 448  # the JAX gate's envelope (fused_ssim.py:39,131)
MAX_WINDOW = 31  # csrc/fused_ssim.cu holds windows up to 31 taps
_TW, _TH = 32, 16  # csrc/fused_ssim.cu tile
_FWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def ssim_taps(window: int, sigma: float) -> np.ndarray:
    """The window's taps, computed in f64 and cast to f32 (JAX
    ``fused_ssim._taps``); odd windows only: the backward relies on the
    blur being its own transpose."""
    if window % 2 == 0:
        raise ValueError(f"fused SSIM needs an odd window, got {window}")
    x = np.arange(window, dtype=np.float64) - window // 2
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def fused_ssim_available(shape) -> bool:
    """The JAX package's gate (``fused_ssim_available``): one channel and
    at most 448 x 448 pixels."""
    shape = tuple(shape)
    if len(shape) == 4 and shape[-1] != 1:
        return False
    if len(shape) not in (3, 4):
        return False
    return shape[1] * shape[2] <= MAX_PIXELS


def _blur_plain(m: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable zero-padded blur of ``[B, C, H, W]`` maps, H then W."""
    c, r = m.shape[1], len(taps) // 2
    k = torch.from_numpy(taps).to(device=m.device, dtype=m.dtype)
    kh = k.view(1, 1, -1, 1).expand(c, 1, -1, 1)
    kw = k.view(1, 1, 1, -1).expand(c, 1, 1, -1)
    m = F.conv2d(m, kh, padding=(r, 0), groups=c)
    return F.conv2d(m, kw, padding=(0, r), groups=c)


def _moments(a: torch.Tensor, b: torch.Tensor, taps: np.ndarray):
    stack = torch.stack([a, b, a * a, b * b, a * b], dim=1)
    return _blur_plain(stack, taps).unbind(1)


def _factors(mu_a, mu_b, e_aa, e_bb, e_ab):
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    a1 = 2.0 * mu_ab + C1
    a2 = 2.0 * (e_ab - mu_ab) + C2
    b1 = mu_aa + mu_bb + C1
    b2 = (e_aa - mu_aa) + (e_bb - mu_bb) + C2
    return a1, a2, b1, b2, (a1 * a2) / (b1 * b2)


def ssim_sums_plain(a: torch.Tensor, b: torch.Tensor, taps: np.ndarray
                    ) -> torch.Tensor:
    """The plain version of the forward kernel: per-image sum of the
    SSIM map of ``[B, H, W]`` f32 maps."""
    return _factors(*_moments(a, b, taps))[-1].sum((1, 2))


def ssim_grads_plain(a: torch.Tensor, b: torch.Tensor, taps: np.ndarray,
                     need_b: bool
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version of the backward kernels: the gradient of the
    per-image sums with respect to ``a`` (and ``b``), in the kernel's
    closed form."""
    mu_a, mu_b, e_aa, e_bb, e_ab = _moments(a, b, taps)
    a1, a2, b1, b2, s = _factors(mu_a, mu_b, e_aa, e_bb, e_ab)
    inv = 1.0 / (b1 * b2)
    t = s * (1.0 / b1 - 1.0 / b2)
    maps = [2.0 * mu_b * (a2 - a1) * inv - 2.0 * mu_a * t, -s / b2,
            2.0 * a1 * inv]
    if need_b:
        maps.append(2.0 * mu_a * (a2 - a1) * inv - 2.0 * mu_b * t)
    g = _blur_plain(torch.stack(maps, dim=1), taps).unbind(1)
    ga = (g[0] + 2.0 * a * g[1]) + b * g[2]
    gb = (g[3] + 2.0 * b * g[1]) + a * g[2] if need_b else None
    return ga, gb


def _on_card(a: torch.Tensor, b: torch.Tensor, window: int,
             name: str) -> bool:
    """Checks the operands; False for CPU tensors (the plain version),
    True for CUDA tensors the kernel takes."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"{name}: expected two [B,H,W] maps, got "
                         f"{tuple(a.shape)} / {tuple(b.shape)}")
    if a.shape[1] * a.shape[2] > MAX_PIXELS:
        raise ValueError(f"{name}: {a.shape[1]}x{a.shape[2]} exceeds the "
                         f"fused-SSIM envelope of {MAX_PIXELS} px; use "
                         "losses.ssim instead")
    if window > MAX_WINDOW:
        raise ValueError(f"{name}: window {window} > {MAX_WINDOW}")
    if a.device.type == "cpu":
        return False
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: unsupported devices {a.device} / "
                         f"{b.device}")
    for t in (a, b):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous float32")
    return True


def ssim_sums(a: torch.Tensor, b: torch.Tensor, window: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """Per-image sum ``[B]`` of the SSIM map of ``[B, H, W]`` f32 maps."""
    taps = ssim_taps(window, sigma)
    if not _on_card(a, b, window, "ssim_sums"):
        return ssim_sums_plain(a, b, taps)
    bsz, h, w = a.shape
    tiles = -(-w // _TW) * -(-h // _TH)
    partial = torch.empty(bsz * tiles, device=a.device, dtype=torch.float32)
    out = torch.empty(bsz, device=a.device, dtype=torch.float32)
    host_taps = (ctypes.c_float * window)(*taps.tolist())
    fn = _build.entry("fused_ssim", "dsod_ssim_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), b.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), bsz, h, w, ctypes.addressof(host_taps),
                    window, C1, C2,
                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(_build.load("fused_ssim"), status, "ssim_sums")
    global launches
    launches += 1
    return out


def ssim_grads(a: torch.Tensor, b: torch.Tensor, window: int = 11,
               sigma: float = 1.5, need_b: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The gradient of ``ssim_sums(a, b)`` (summed over images) with
    respect to ``a``, and to ``b`` when ``need_b``."""
    taps = ssim_taps(window, sigma)
    if not _on_card(a, b, window, "ssim_grads"):
        return ssim_grads_plain(a, b, taps, need_b)
    bsz, h, w = a.shape
    maps = torch.empty(((4 if need_b else 3) * a.numel(),), device=a.device,
                       dtype=torch.float32)
    ga = torch.empty_like(a)
    gb = torch.empty_like(b) if need_b else None
    host_taps = (ctypes.c_float * window)(*taps.tolist())
    fn = _build.entry("fused_ssim", "dsod_ssim_bwd", _BWD_ARGTYPES)
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), b.data_ptr(), maps.data_ptr(),
                    ga.data_ptr(), 0 if gb is None else gb.data_ptr(), bsz,
                    h, w, ctypes.addressof(host_taps), window, C1, C2,
                    int(need_b),
                    torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(_build.load("fused_ssim"), status, "ssim_grads")
    global bwd_launches
    bwd_launches += 1
    return ga, gb


def _as3(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 4:
        if x.shape[-1] != 1:
            raise ValueError(f"fused SSIM is single-channel, got "
                             f"{tuple(x.shape)}")
        x = x[..., 0]
    if x.ndim != 3:
        raise ValueError(f"expected [B,H,W,1] or [B,H,W], got "
                         f"{tuple(x.shape)}")
    return x.float().contiguous()


class _SsimMeanFn(torch.autograd.Function):
    """fused_ssim.py ``fused_ssim_mean`` with its custom VJP."""

    @staticmethod
    def forward(ctx, a, b, window, sigma):
        a3, b3 = _as3(a), _as3(b)
        ctx.window, ctx.sigma = window, sigma
        ctx.save_for_backward(a3, b3)
        ctx.like = ((a.shape, a.dtype), (b.shape, b.dtype))
        return ssim_sums(a3, b3, window, sigma).sum() / a3.numel()

    @staticmethod
    def backward(ctx, g):
        a3, b3 = ctx.saved_tensors
        need_b = ctx.needs_input_grad[1]
        # ssim_grads resolved through the module at call time, so a
        # wrapper installed around it sees these launches too.
        ga, gb = ssim_grads(a3, b3, ctx.window, ctx.sigma, need_b)
        scale = g / a3.numel()
        (a_shape, a_dtype), (b_shape, b_dtype) = ctx.like
        ga = (scale * ga).reshape(a_shape).to(a_dtype)
        gb = None if gb is None else (scale * gb).reshape(b_shape).to(b_dtype)
        return ga, gb, None, None


def fused_ssim_mean(a: torch.Tensor, b: torch.Tensor, window: int = 11,
                    sigma: float = 1.5) -> torch.Tensor:
    """mean SSIM(a, b) of single-channel maps, one kernel pass."""
    return _SsimMeanFn.apply(a, b, window, sigma)


def fused_ssim_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                    window_size: int = 11, sigma: float = 1.5
                    ) -> torch.Tensor:
    """1 - SSIM(sigmoid(logits), targets), drop-in for the plain
    ``losses.ssim.ssim_loss`` on single-channel maps."""
    p = torch.sigmoid(logits.float())
    return 1.0 - fused_ssim_mean(p, targets.float(), window_size, sigma)
