from .vgg import VGG16

__all__ = ["VGG16"]
