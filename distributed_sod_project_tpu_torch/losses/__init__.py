from .deep_supervision import deep_supervision_loss
from .elementwise import bce_with_logits
from .region import cel_loss, iou_loss
from .ssim import ssim, ssim_loss

__all__ = ["bce_with_logits", "cel_loss", "deep_supervision_loss",
           "iou_loss", "ssim", "ssim_loss"]
