"""Registered configs of the port (JAX ``configs/experiments.py`` names)."""

from .base import (DataConfig, ExperimentConfig, ModelConfig,
                   register_config)


@register_config("minet_vgg16_ref")
def minet_vgg16_ref() -> ExperimentConfig:
    """Config 1: MINet-VGG16 single-image forward reference, served at
    320 px through the fused conv and resample kernels."""
    return ExperimentConfig(
        name="minet_vgg16_ref",
        data=DataConfig(image_size=(320, 320)),
        model=ModelConfig(name="minet", backbone="vgg16",
                          conv_impl="fused", resample_impl="fused"),
    )
