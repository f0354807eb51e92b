from . import experiments  # noqa: F401  (registers the configs)
from .base import (DataConfig, ExperimentConfig, ModelConfig, ServeConfig,
                   get_config, register_config)

__all__ = ["DataConfig", "ExperimentConfig", "ModelConfig", "ServeConfig",
           "get_config", "register_config"]
