"""The one device rule of the port's entry points.

``None`` means the card: the port exists to run its kernels on an
NVIDIA GPU, so an entry point never drifts onto the CPU on its own.
The CPU is used only when the caller asks for it (the tests do), and
then every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None``/``"cuda[:i]"`` -> a CUDA device (raises without a GPU);
    ``"cpu"`` -> the CPU.  Any other device type raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
