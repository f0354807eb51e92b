"""The port's own copies of the config fields its slice reads.

Field names and defaults follow ``distributed_sod_project_tpu/configs/
base.py`` so a config reads the same on both sides; only the fields the
ported serving path consumes are copied.  Two defaults differ on
purpose: ``ModelConfig.conv_impl`` and ``resample_impl`` are ``"fused"``,
the only implementation the port has (the hand-written kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input geometry and normalisation (JAX ``DataConfig`` subset)."""

    image_size: Tuple[int, int] = (320, 320)  # H, W
    use_depth: bool = False  # RGB-D input; not ported yet (raises)
    normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model selection (JAX ``ModelConfig`` subset)."""

    name: str = "minet"
    backbone: str = "vgg16"
    backbone_bn: bool = True
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # The kernels are the port's only path: any other value raises in
    # models/registry.py rather than mapping onto a library call.
    resample_impl: str = "fused"
    conv_impl: str = "fused"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Online serving (JAX ``ServeConfig`` subset, configs/base.py:288-340).

    One warmed forward per (resolution bucket, batch bucket, precision
    arm); requests are grouped per (resolution, arm) and zero-padded up
    to the smallest batch bucket that fits.
    """

    batch_buckets: Tuple[int, ...] = (1, 4, 8)
    # Square resolutions; empty = one bucket at max(data.image_size).
    resolution_buckets: Tuple[int, ...] = ()
    precision: str = "f32"  # default arm
    precision_arms: Tuple[str, ...] = ("f32", "bf16")
    max_wait_ms: float = 5.0  # coalescing window of the oldest request
    max_queue: int = 64  # admission bound; beyond it submit raises
    max_inflight: int = 2  # dispatched-but-unfetched device batches
    post_workers: int = 2  # host pool for the resize back to original size


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    seed: int = 0


_REGISTRY: Dict[str, Callable[[], ExperimentConfig]] = {}


def register_config(name: str):
    """Decorator: register a zero-arg factory under ``name``."""

    def deco(fn: Callable[[], ExperimentConfig]):
        if name in _REGISTRY:
            raise KeyError(f"config {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str, **overrides) -> ExperimentConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
