"""Model registry: ``build_model(cfg.model)`` -> an initialised module.

Counterpart of the JAX ``models/registry.py``.  Loud on every knob the
port does not implement, as the JAX registry is (registry.py:41-68): a
value that would silently do nothing, or silently route a conv or a
resample through a library call, raises instead.
"""

from __future__ import annotations

from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ROADMAP = "ROADMAP.md Queue 1"


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]


def build_model(model_cfg, generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """Construct and initialise the module a ModelConfig describes, on
    the CPU, with flax's initialisers drawn from ``generator`` (seed 0
    when None)."""
    if model_cfg.conv_impl != "fused":
        raise NotImplementedError(
            f"model.conv_impl={model_cfg.conv_impl!r}: the port's only conv "
            f"is the fused kernel ('fused'); see {_ROADMAP}")
    if model_cfg.resample_impl != "fused":
        raise NotImplementedError(
            f"model.resample_impl={model_cfg.resample_impl!r}: the port's "
            f"only resample is the fused kernel ('fused'); see {_ROADMAP}")
    if model_cfg.name != "minet":
        raise NotImplementedError(
            f"model {model_cfg.name!r} is not ported yet; see {_ROADMAP}")
    if model_cfg.backbone != "vgg16":
        raise NotImplementedError(
            f"minet backbone {model_cfg.backbone!r} is not ported yet "
            f"(vgg16 is); see {_ROADMAP}")
    from .minet import MINet

    model = MINet(bn_momentum=model_cfg.bn_momentum,
                  backbone_bn=model_cfg.backbone_bn,
                  dtype=_torch_dtype(model_cfg.compute_dtype))
    model.reset_parameters(generator or torch.Generator().manual_seed(0))
    return model.to(_torch_dtype(model_cfg.param_dtype)).eval()
