"""Training: the optimizer and schedule, the train state, the train and
eval steps, checkpoints, the ``Trainer`` loop and PointSeg pretraining
(``train/pretrain.py``)."""

from deeplio_tpu_torch.train.loop import Trainer

__all__ = ["Trainer"]
