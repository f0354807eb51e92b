"""SSIM structural loss (JAX ``losses/ssim.py``): ``1 - SSIM`` with a
Gaussian window on sigmoid probabilities, the five moment maps blurred
by one separable depthwise conv pair with zero "SAME" padding, in f32.
The fused kernel (``kernels/fused_ssim.py``) replaces it where the JAX
gate admits a map; this is the plain path for every other shape."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01 ** 2
_C2 = 0.03 ** 2


def gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """1-D Gaussian taps summing to 1, computed in f32 as the JAX
    ``gaussian_window`` computes them."""
    x = torch.arange(size, dtype=torch.float32) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim(a: torch.Tensor, b: torch.Tensor, *, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM map between NHWC ``a`` and ``b`` (any channel count)."""
    a, b = a.float(), b.float()
    c = a.shape[-1]
    win = gaussian_window(window_size, sigma).to(a.device)
    r = window_size // 2
    stack = torch.cat([a, b, a * a, b * b, a * b], dim=-1).permute(0, 3, 1, 2)
    n = stack.shape[1]
    stack = F.conv2d(stack, win.view(1, 1, -1, 1).expand(n, 1, -1, 1),
                     padding=(r, 0), groups=n)
    stack = F.conv2d(stack, win.view(1, 1, 1, -1).expand(n, 1, 1, -1),
                     padding=(0, r), groups=n)
    mu_a, mu_b, e_aa, e_bb, e_ab = stack.split(c, dim=1)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    num = (2.0 * mu_ab + _C1) * (2.0 * (e_ab - mu_ab) + _C2)
    den = (mu_aa + mu_bb + _C1) * ((e_aa - mu_aa) + (e_bb - mu_bb) + _C2)
    return (num / den).mean()


def ssim_loss(logits: torch.Tensor, targets: torch.Tensor, *,
              window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """``1 - SSIM(sigmoid(logits), targets)``."""
    return 1.0 - ssim(torch.sigmoid(logits.float()), targets.float(),
                      window_size=window_size, sigma=sigma)
