"""Registered configs of the port (JAX ``configs/experiments.py`` names)."""

from .base import (DataConfig, ExperimentConfig, LossConfig, ModelConfig,
                   OptimConfig, register_config)


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


@register_config("minet_r50_dp")
def minet_r50_dp() -> ExperimentConfig:
    """Config 2: MINet-ResNet50 data-parallel training.  The port trains
    it on one card with ``--set model.backbone=vgg16`` (the ResNet50
    backbone and DDP are not ported yet) and with the host augmentations
    off (``--set data.hflip=false --set data.rotate_degrees=0``)."""
    return ExperimentConfig(
        name="minet_r50_dp",
        data=DataConfig(image_size=(320, 320), rotate_degrees=10.0),
        model=ModelConfig(name="minet", backbone="resnet50"),
        loss=LossConfig(cel=1.0),
        optim=OptimConfig(lr=0.005, schedule="poly"),
        global_batch_size=32,
        num_epochs=50,
    )
