"""The ``train_darknet`` loop: the ``train`` loop (``loops/train.py``) on a
configuration whose LiDAR tower is ``lidar-feat-darknet``.

The same closed loop of ``build_train_step``'s ``train_step``, the same
checked first steps and the same comparison; what differs is the model
on the benchmark's side: the weights' names and shapes, the reference
(``reference/darknet.py``) and the model FLOPs a step, counted here with
``FlopCounterMode`` over that reference on meta tensors.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import gen, layers, weights
from portbench.loops import train
from portbench.reference import darknet as rdk
from portbench.reference.loss import pose_loss


# the step's layer spans are the ``train`` loop's (``layers.issue_split``)
layers.MAP.setdefault("train_darknet", layers.MAP["train"])


def model_flops(spec: Dict, windows: int, pairs: int, H: int, W: int,
                imu_len: int, train: bool) -> int:
    """``counts.model_flops`` over the Darknet reference, every activation
    kept (no recomputation counted)."""
    with torch.device("meta"):
        model = rdk.DeepLIO(spec).recompute(False)
        imgs = torch.empty(windows, pairs, H, W, 2 * spec["image_channels"])
        imu = torch.empty(windows, pairs, imu_len, 6)
        mask = torch.empty(windows, pairs, imu_len)
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter:
        x, q = model(imgs, imu, mask)
        if train:
            sx = torch.zeros((), device="meta", requires_grad=True)
            total = pose_loss(x, q, torch.empty_like(x), torch.empty_like(q),
                              sx, sx)[0]
            total.backward()
    return int(counter.get_total_flops())


class Loop(train.Loop):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.spec = rdk.model_spec(cell.cfg)

    def make_weights(self) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            shapes = rdk.DeepLIO(self.spec)
        g = gen.device_generator(self.seed, self.device, 3)
        return weights.make_state(shapes, g, self.device)

    def reference(self, state: Dict[str, torch.Tensor],
                  precision: str = "float32") -> rdk.DeepLIO:
        ref = rdk.DeepLIO(self.spec).to(self.device)
        ref.load_state_dict(state, strict=True)
        return ref.set_precision(precision)

    def setup(self) -> None:
        super().setup()
        # ``train.Loop.setup`` counts the PointSeg reference's FLOPs
        self.flops_per_unit = model_flops(self.spec, self.windows,
                                          len(self.combos), self.H, self.W,
                                          self.T, train=True)
