from .admission import EngineStopped, QueueFull
from .engine import InferenceEngine, preprocess_image

__all__ = ["EngineStopped", "InferenceEngine", "QueueFull",
           "preprocess_image"]
