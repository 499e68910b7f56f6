"""Plain PyTorch DeepLIO on RangeNet++'s Darknet encoder: the benchmark's
reference for the ``deeplio_darknet53`` configuration.

A frozen copy of the tower (Milioto, Vizzo, Behley and Stachniss,
RangeNet++, IROS 2019; lidar-bonnetal's ``train/backbones/darknet.py``
with ``darknet53.yaml``): a 3x3 stem to 32 channels, five stages of
widths 64 to 1024 with 1, 2, 8, 8 and 4 residual units (21: 1, 1, 2, 2,
1), each stage a (1, 2)-strided 3x3 entry, a unit ``x + LReLU(BN(conv3x3(
LReLU(BN(conv1x1(x, C / 2))), C)))``, every conv without bias and with
symmetric ``padding=1``, LeakyReLU 0.1, channel dropout after each stage.
Then DeepLIO's tail and the rest of the model from ``model.py``: the
SAME-padded strided ConvBNs, mean and Dense of the LiDAR tower, the LSTMs,
the soft fusion and the pose heads, with ``model.py``'s ``Ref``
(precision), ``BatchNorm``, ``Conv``, ``init_kinds`` and the float8
control, so that the benchmark's weights and its control work unchanged.
Parameter names are the system's state-dict names. Nothing here imports
the system under test.

Departures from lidar-bonnetal, as in the system: BatchNorm with flax's
semantics (the running variance updated with the biased batch variance;
PyTorch keeps the unbiased one), the 10-channel pair stack as input, and
DeepLIO's tail in place of RangeNet's decoder. Channel dropout is inverted
(kept channels over the keep probability), one ``torch.bernoulli`` draw a
sample and channel from the generator passed in, stage 1 to 5, before the
tower's and the heads' draws.

Memory: the float32 step at the configuration's 64 pairs does not fit the
card with every activation kept. In training, each stage is recomputed
in its backward (``torch.utils.checkpoint``, non-reentrant); its channel
dropout stays outside the recomputed part, so each mask is drawn once.
The recomputation runs each stage's BatchNorms a second time, so their
running statistics, which the check does not compare, update twice.
``checkpoint=False`` keeps every activation (the FLOP count: a count
under recomputation would add a forward).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint as recompute

from portbench.reference import model as m

UNITS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
WIDTHS = (64, 128, 256, 512, 1024)
SLOPE = 0.1


class SymConv(m.Conv):
    """A convolution without bias and with symmetric padding ``k // 2``
    (lidar-bonnetal's ``padding=1`` of a 3x3)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride=(1, 1)):
        super().__init__(cin, cout, (kernel, kernel), stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.weight.shape[-1] // 2
        return self.q(F.conv2d(self.q(x), self.q(self.weight), None,
                               self.stride, pad))


class ConvBNLeaky(m.Ref):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride=(1, 1)):
        super().__init__()
        self.Conv_0 = SymConv(cin, cout, kernel, stride)
        self.BatchNorm_0 = m.BatchNorm(cout)

    def forward(self, x):
        return self.q(F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), SLOPE))


class Residual(m.Ref):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBNLeaky(c, c // 2, 1)
        self.ConvBN_1 = ConvBNLeaky(c // 2, c, 3)

    def forward(self, x):
        return self.q(x + self.ConvBN_1(self.ConvBN_0(x)))


class Stage(nn.Module):
    def __init__(self, cin: int, width: int, units: int):
        super().__init__()
        self.ConvBN_0 = ConvBNLeaky(cin, width, 3, (1, 2))
        self.units = units
        for k in range(units):
            setattr(self, f"Residual_{k}", Residual(width))

    def forward(self, x):
        x = self.ConvBN_0(x)
        for k in range(self.units):
            x = getattr(self, f"Residual_{k}")(x)
        return x


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted ``Dropout2d``: one draw a sample and channel."""
    if not training or rate <= 0.0:
        return x
    keep = torch.bernoulli(torch.full(x.shape[:2] + (1, 1), 1.0 - rate,
                                      device=x.device),
                           generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Darknet(nn.Module):
    def __init__(self, cin: int, layers: int, stage_dropout: float):
        super().__init__()
        self.rate, self.n = stage_dropout, len(WIDTHS)
        self.out_channels = WIDTHS[-1]
        self.checkpoint = True
        self.ConvBN_0 = ConvBNLeaky(cin, 32, 3)
        c = 32
        for i, (w, n) in enumerate(zip(WIDTHS, UNITS[layers])):
            setattr(self, f"Stage_{i}", Stage(c, w, n))
            c = w

    def forward(self, x, generator=None):
        x = self.ConvBN_0(x)
        for i in range(self.n):
            stage = getattr(self, f"Stage_{i}")
            if self.checkpoint and self.training and torch.is_grad_enabled():
                x = recompute(stage, x, use_reentrant=False)
            else:
                x = stage(x)
            x = channel_dropout(x, self.rate, self.training, generator)
        return x


class LidarFeat(nn.Module):
    """Darknet, then the PointSeg tower's tail (``model.LidarFeat``)."""

    def __init__(self, cin: int, feature_size: int, layers: int,
                 stage_dropout: float, rate: float):
        super().__init__()
        self.rate = rate
        self.darknet = Darknet(cin, layers, stage_dropout)
        self.ConvBN_0 = m.ConvBN(self.darknet.out_channels, 256, (3, 3),
                                 (2, 2))
        self.ConvBN_1 = m.ConvBN(256, 256, (3, 3), (2, 2))
        self.Dense_0 = m.Linear(256, feature_size)

    def forward(self, x, generator=None):
        f = self.ConvBN_1(self.ConvBN_0(self.darknet(x, generator)))
        f = F.relu(self.Dense_0(f.mean(dim=(-2, -1))))
        return m.dropout(f, self.rate, self.training, generator)


class DeepLIO(m.DeepLIO):
    """``model.DeepLIO`` with the Darknet tower: the same forward, the same
    precision switch."""

    def __init__(self, spec: Dict):
        nn.Module.__init__(self)
        ls, im, od = spec["lidar"], spec["imu"], spec["odom"]
        dk = spec["darknet"]
        self.lidar_feat = LidarFeat(2 * spec["image_channels"],
                                    ls["feature_size"], dk["layers"],
                                    dk["stage_dropout"], ls["dropout"])
        self.imu_feat = m.ImuFeat(im["input_size"], im["hidden_size"],
                                  im["num_layers"])
        self.fusion = m.Fusion(ls["feature_size"], im["hidden_size"])
        self.odom_feat = m.OdomFeat(ls["feature_size"] + im["hidden_size"],
                                    od["hidden_size"], od["num_layers"])
        self.heads = m.Heads(od["hidden_size"], spec["dropout"])

    def recompute(self, on: bool) -> "DeepLIO":
        """Stages recomputed in the backward (default) or kept."""
        self.lidar_feat.darknet.checkpoint = on
        return self


def model_spec(cfg: Dict) -> Dict:
    """``model.model_spec`` of a configuration whose LiDAR tower is
    ``lidar-feat-darknet``, with its ``darknet`` sizes: ``layers`` and
    ``stage_dropout``."""
    block = cfg["deeplio"]
    lname = block["lidar-feat-net"]["name"]
    if lname != "lidar-feat-darknet":
        raise ValueError(f"the Darknet reference's tower is "
                         f"lidar-feat-darknet, not {lname!r}")
    ls = cfg.get(lname, {})
    spec = m.model_spec(cfg)
    spec["darknet"] = {"layers": int(ls.get("layers", 53)),
                       "stage_dropout": float(ls.get("stage-dropout", 0.01))}
    return spec
