"""Utilities: float32 quaternion/SE(3) math (``spatial``), shared by
streaming, the pose loss and augmentation; the trainer's ``AverageMeter``
and app logger."""

from deeplio_tpu_torch.utils.logger import get_app_logger
from deeplio_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter", "get_app_logger"]
