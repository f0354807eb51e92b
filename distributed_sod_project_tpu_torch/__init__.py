"""PyTorch/CUDA port of ``distributed_sod_project_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names (``configs``, ``models``, ``eval``, ``serve``) so each counterpart
is easy to find.  Every Pallas kernel on a ported path is a CUDA kernel
written for ``sm_90a`` under ``kernels/csrc/``, built at first use and
bound with ``ctypes`` (``kernels/_build.py``).

This package imports torch, numpy and PIL only: never ``jax`` and
nothing of ``distributed_sod_project_tpu``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without that explicit request they raise (``utils/device.py``).
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
