"""The ``train_rangevit`` loop: the ``train`` loop (``loops/train.py``) on a
configuration whose LiDAR tower is ``lidar-feat-rangevit``.

The same closed loop of ``build_train_step``'s ``train_step`` and the
same checked first steps; the comparison adds one number to the
``train`` loop's (:meth:`Loop.compare`). What differs besides is the
model on the benchmark's side: the weights' names and shapes (with the
transformer's LayerNorms, position embedding and class token made as
``reference/rangevit.py::fill_state`` says), the reference
(``reference/rangevit.py``), the model FLOPs a step, counted here with
``FlopCounterMode`` over that reference on meta tensors, and the
attention's FLOPs a step (:func:`attention_flops`), which
``metrics/attention_roofline.py`` reads.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import gen, layers, weights
from portbench.loops import train
from portbench.loops.common import leaf_gaps
from portbench.reference import rangevit as rvt
from portbench.reference.loss import pose_loss

# the step's layer spans are the ``train`` loop's; the tower's stem and
# encoder spans are named, and read by no metric while the step replays
# its CUDA graph (the spans then never open)
layers.MAP.setdefault("train_rangevit", dict(
    layers.MAP["train"], stem=("lidar.stem",), encoder=("lidar.encoder",)))


def model_flops(spec: Dict, windows: int, pairs: int, H: int, W: int,
                imu_len: int, train: bool) -> int:
    """``counts.model_flops`` over the RangeViT reference, every
    activation kept (no recomputation counted)."""
    with torch.device("meta"):
        model = rvt.DeepLIO(spec).recompute(False)
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


def attention_flops(spec: Dict, images: int, train: bool) -> int:
    """The attention's FLOPs over ``images`` pair images: per block and
    image ``4 T^2 D`` forward (``Q K^T`` and ``P V``, two a multiply-add)
    and ``8 T^2 D`` backward (each product's two gradients), with T the
    tokens (class token included) and D the width; a backward's
    recomputation is not counted."""
    v = spec["rangevit"]
    h, w = spec["image"]
    tokens = 1 + (h // v["patch"][0]) * (w // v["patch"][1])
    per_block = (12 if train else 4) * tokens ** 2 * v["embed_dim"]
    return per_block * v["depth"] * images


def tail_leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """The gap (:func:`~portbench.loops.common.leaf_gaps`) that a tenth of
    the leaves, rounded down, exceed: at the cell's size the 24th worst
    of 232."""
    g = leaf_gaps(prog, ref)
    return g[len(g) // 10][0]


class Loop(train.Loop):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.spec = rvt.model_spec(cell.cfg)
        self.attention_flops_per_unit = attention_flops(
            self.spec, self.pairs, train=True)

    def make_weights(self) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            shapes = rvt.DeepLIO(self.spec)
        g = gen.device_generator(self.seed, self.device, 3)
        return rvt.fill_state(weights.make_state(shapes, g, self.device), g)

    def reference(self, state: Dict[str, torch.Tensor],
                  precision: str = "float32") -> rvt.DeepLIO:
        ref = rvt.DeepLIO(self.spec).to(self.device)
        ref.load_state_dict(state, strict=True)
        return ref.set_precision(precision)

    def setup(self) -> None:
        super().setup()
        # ``train.Loop.setup`` counts the PointSeg reference's FLOPs
        self.flops_per_unit = model_flops(self.spec, self.windows,
                                          len(self.combos), self.H, self.W,
                                          self.T, train=True)

    def compare(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """The ``train`` loop's numbers and ``grad_gap_p90``, the first
        gradient's gap at the leaf a tenth of the way from the worst
        (:func:`tail_leaf_gap`). The float8 control's smallest reading
        of the median leaf is 2.1x the system's largest here, and of the
        worst leaf 3.7x (one small stem leaf's noise); of this leaf 10x:
        the control's worst tenth are all leaves of the stem, whose
        full-resolution layers float8 rounds one after another (PERF.md)."""
        numbers = super().compare(prog, ref)
        numbers["grad_gap_p90"] = tail_leaf_gap(prog["grad"], ref["grad"])
        return numbers
