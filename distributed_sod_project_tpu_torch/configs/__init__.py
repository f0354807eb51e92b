from . import experiments  # noqa: F401  (registers the configs)
from .base import (DataConfig, ExperimentConfig, LossConfig, ModelConfig,
                   OptimConfig, ServeConfig, apply_overrides, get_config,
                   register_config)

__all__ = ["DataConfig", "ExperimentConfig", "LossConfig", "ModelConfig",
           "OptimConfig", "ServeConfig", "apply_overrides", "get_config",
           "register_config"]
