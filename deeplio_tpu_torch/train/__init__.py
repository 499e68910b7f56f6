"""Training: the optimizer and schedule, the train state, the train and
eval steps, checkpoints and the ``Trainer`` loop."""

from deeplio_tpu_torch.train.loop import Trainer

__all__ = ["Trainer"]
