"""Load the JAX package's MINet variables into the port's module.

``from_jax_variables`` takes the flax ``{"params", "batch_stats"}`` tree
as nested dicts of numpy arrays, e.g.::

    params/VGG16_0/ConvBNAct_3/Conv_0/kernel      (3, 3, 64, 128)  HWIO
    params/AIM_1/ConvBNAct_0/BatchNorm_0/scale    (64,)
    batch_stats/SIM_4/ConvBNAct_6/BatchNorm_0/var (64,)
    params/Conv_0/bias                            (1,)             head

The port keeps flax's layouts (HWIO kernels) and leaf names, so a leaf
is copied as it is; only the scope names map onto module attributes.
Every leaf of the port must be found and every leaf of the tree
consumed, else the call raises naming the leaves.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# Port module path prefix -> flax scope path prefix (regex, replacement).
_SCOPES = (
    (r"^backbone\.convs\.(\d+)\.", r"VGG16_0/ConvBNAct_\1/"),
    (r"^aims\.(\d+)\.cbas\.(\d+)\.", r"AIM_\1/ConvBNAct_\2/"),
    (r"^sims\.(\d+)\.cbas\.(\d+)\.", r"SIM_\1/ConvBNAct_\2/"),
    (r"^head_cba\.", r"ConvBNAct_0/"),
    (r"^head_conv\.", r"Conv_0/"),
)
_LEAVES = (
    (r"conv\.(kernel|bias)$", r"Conv_0/\1"),
    (r"bn\.(scale|bias|mean|var)$", r"BatchNorm_0/\1"),
)


def flax_path(name: str, is_buffer: bool) -> Tuple[str, ...]:
    """``"aims.1.cbas.0.bn.var"`` -> ``("batch_stats", "AIM_1",
    "ConvBNAct_0", "BatchNorm_0", "var")``."""
    path = name
    for pat, rep in _SCOPES:
        path, n = re.subn(pat, rep, path)
        if n:
            break
    else:
        raise KeyError(f"no flax scope for port parameter {name!r}")
    for pat, rep in _LEAVES:
        path = re.sub(pat, rep, path)
    return ("batch_stats" if is_buffer else "params",) + tuple(path.split("/"))


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def from_jax_variables(variables_np: Mapping, model: torch.nn.Module
                       ) -> torch.nn.Module:
    """Copy the flax variables into ``model`` (in place; returns it).
    Raises ``KeyError`` for a leaf the tree lacks, ``ValueError`` for a
    shape mismatch or for leaves of the tree that nothing consumed."""
    flat = _flatten(variables_np)
    targets = [(n, t, False) for n, t in model.named_parameters()]
    targets += [(n, t, True) for n, t in model.named_buffers()]
    missing = []
    with torch.no_grad():
        for name, t, is_buf in targets:
            path = flax_path(name, is_buf)
            if path not in flat:
                missing.append("/".join(path))
                continue
            arr = flat.pop(path)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                                 f"port {tuple(t.shape)} ({name})")
            t.copy_(torch.from_numpy(np.array(arr, np.float32)))
    if missing:
        raise KeyError(f"JAX variables lack {len(missing)} leaves: "
                       f"{missing[:8]}")
    if flat:
        extra = ["/".join(p) for p in flat]
        raise ValueError(f"{len(extra)} JAX leaves were not consumed: "
                         f"{extra[:8]}")
    return model
