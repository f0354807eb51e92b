"""The port's own copies of the config fields its slices read.

Field names and defaults follow ``distributed_sod_project_tpu/configs/
base.py`` (DataConfig :16-82, LossConfig/OptimConfig :150-194, the
``--set`` machinery :1289-1381) so a config reads the same on both
sides; only the fields the ported serving and training paths consume
are copied, so an override naming any other field raises.  Three
defaults differ on purpose: ``ModelConfig.conv_impl`` and
``resample_impl`` are ``"fused"`` and ``LossConfig.fused_kernel`` is
true, the hand-written kernels being the port's path on the card.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input geometry, normalisation and host augmentation (JAX
    ``DataConfig`` subset).  The augmentations are not ported yet: the
    trainer raises on any that is on (ROADMAP.md Queue 1 item 7).  There
    is no ``root``: the port trains on ``SyntheticSOD`` only, so naming a
    real-data root raises as any uncopied field does."""

    image_size: Tuple[int, int] = (320, 320)  # H, W
    use_depth: bool = False  # RGB-D input; not ported yet (raises)
    hflip: bool = True
    rotate_degrees: float = 0.0
    normalize_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    normalize_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    synthetic_size: int = 256  # virtual dataset length when synthetic


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model selection (JAX ``ModelConfig`` subset)."""

    name: str = "minet"
    backbone: str = "vgg16"
    backbone_bn: bool = True
    bn_momentum: float = 0.9
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
class LossConfig:
    """Loss weighting (JAX ``LossConfig``)."""

    bce: float = 1.0
    iou: float = 1.0
    ssim: float = 1.0
    cel: float = 0.0  # MINet's consistency-enhanced loss
    ssim_window: int = 11
    deep_supervision: bool = True  # sum the loss over every side output
    fused_kernel: bool = True  # route through the fused loss/SSIM kernels


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimizer + schedule (JAX ``OptimConfig`` subset).  The port
    trains with SGD: another ``optimizer`` raises in ``train/optim.py``,
    and the JAX fields for clipping, accumulation, non-finite skipping,
    EMA, layer decay and ZeRO are not copied, so setting one raises."""

    optimizer: str = "sgd"  # sgd | adamw | lars
    lr: float = 0.005
    momentum: float = 0.9
    weight_decay: float = 5e-4
    nesterov: bool = True
    schedule: str = "poly"  # poly | cosine | constant
    poly_power: float = 0.9
    warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    global_batch_size: int = 8
    num_epochs: int = 50
    steps_per_epoch: Optional[int] = None  # None -> from the dataset size
    seed: int = 0
    log_every_steps: int = 20


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


def _coerce(value: str, ftype):
    """Parse a CLI string into a dataclass field's annotated type."""
    origin = typing.get_origin(ftype)
    if origin is typing.Union:  # Optional[X]
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if value.lower() in ("none", "null"):
            return None
        return _coerce(value, args[0])
    if origin is tuple:
        parts = [p for p in value.replace("(", "").replace(")", "").split(",")
                 if p]
        args = typing.get_args(ftype)
        elem = args[0] if args else str
        return tuple(_coerce(p, elem) for p in parts)
    if ftype is bool:
        if value.lower() in ("1", "true", "yes"):
            return True
        if value.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"expected bool, got {value!r}")
    if ftype in (int, float, str):
        return ftype(value)
    raise ValueError(f"cannot coerce {value!r} onto {ftype!r}")


def apply_overrides(cfg: ExperimentConfig, overrides) -> ExperimentConfig:
    """Apply ``section.field=value`` overrides (the JAX ``--set``):
    ``data.image_size=64,64 optim.lr=0.01 model.backbone=vgg16``;
    top-level fields take no dot (``global_batch_size=16``).  A field the
    port does not copy raises ``KeyError``."""
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} is not key=value")
        path, value = ov.split("=", 1)
        keys = path.strip().split(".")
        objs = [cfg]
        for k in keys[:-1]:
            if not dataclasses.is_dataclass(getattr(objs[-1], k, None)):
                raise KeyError(f"no config field {path!r}")
            objs.append(getattr(objs[-1], k))
        hints = typing.get_type_hints(type(objs[-1]))
        if keys[-1] not in {f.name for f in dataclasses.fields(objs[-1])}:
            raise KeyError(
                f"no config field {path!r} in the port (it copies only the "
                "fields its ported paths read; see ROADMAP.md Queue 1)")
        new = _coerce(value.strip(), hints[keys[-1]])
        for obj, key in zip(reversed(objs), reversed(keys)):
            new = dataclasses.replace(obj, **{key: new})
        cfg = new
    return cfg
