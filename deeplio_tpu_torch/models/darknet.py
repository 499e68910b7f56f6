"""RangeNet++'s Darknet encoder (Milioto, Vizzo, Behley and Stachniss,
"RangeNet++: Fast and Accurate LiDAR Semantic Segmentation", IROS 2019;
``train/backbones/darknet.py`` of github.com/PRBonn/lidar-bonnetal, with
the settings of ``darknet53.yaml``), the port's own LiDAR backbone: the
JAX package has no counterpart.

With C a stage's width, "conv" a 2-D convolution without bias, BN a
BatchNorm and LReLU a LeakyReLU of slope 0.1:

- stem: ``x = LReLU(BN(conv3x3(x, 32)))``;
- five stages of widths 64, 128, 256, 512 and 1024 with 1, 2, 8, 8 and 4
  residual units (Darknet-53; Darknet-21 has 1, 1, 2, 2 and 1). A
  stage's entry is ``LReLU(BN(conv3x3(x, C, stride (1, 2))))``: rows are
  never strided, so the output stride of 32 falls on the width alone. A
  residual unit is ``x + LReLU(BN(conv3x3(LReLU(BN(conv1x1(x, C / 2))),
  C)))``;
- after each stage, channel dropout (``Dropout2d``: one mask entry a
  sample and channel) at ``stage_dropout``, training only.

Padding is PyTorch's symmetric ``padding=1`` of the 3x3 convolutions, as
published (not flax's SAME, which pads a stride-2 conv at the right only,
:class:`models.blocks.SameConv2d`). The BatchNorms are
:class:`models.blocks.FlaxBatchNorm2d` (momentum 0.01, RangeNet's
``bn_d``; the running variance updated with the biased batch variance,
as every BatchNorm of the port), so that ``models/zoo.py::
sync_batchnorm``, the training step's CUDA graph and checkpoints take
them as they take every tower's. The dropout masks are drawn from the
generator the caller passes, stage 1 to 5, in the forward's order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deeplio_tpu_torch.models.blocks import FlaxBatchNorm2d, inverted_dropout

# residual units a stage, by depth
UNITS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
WIDTHS = (64, 128, 256, 512, 1024)
STEM_WIDTH = 32
SLOPE = 0.1


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """``Dropout2d`` with flax's inverted arithmetic: one keep draw per
    sample and channel of an NCHW ``x`` (``blocks.inverted_dropout``)."""
    return inverted_dropout(x, rate, training, generator,
                            x.shape[:2] + (1, 1))


class ConvBNLeaky(nn.Module):
    """conv (no bias, symmetric padding) -> BatchNorm -> LeakyReLU(0.1)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride=(1, 1)):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel, stride,
                                padding=kernel // 2, bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in place: the BatchNorm's backward reads its input, not its
        # output, so the activation is stored once
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), SLOPE,
                            inplace=True)


class Residual(nn.Module):
    """``x + ConvBNLeaky_3x3(ConvBNLeaky_1x1(x, C / 2), C)``."""

    def __init__(self, channels: int):
        super().__init__()
        self.ConvBN_0 = ConvBNLeaky(channels, channels // 2, 1)
        self.ConvBN_1 = ConvBNLeaky(channels // 2, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ConvBN_1(self.ConvBN_0(x))


class Stage(nn.Module):
    """The (1, 2)-strided 3x3 entry to ``width``, then ``units`` residual
    units."""

    def __init__(self, in_channels: int, width: int, units: int):
        super().__init__()
        self.ConvBN_0 = ConvBNLeaky(in_channels, width, 3, (1, 2))
        self.units = units
        for k in range(units):
            setattr(self, f"Residual_{k}", Residual(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvBN_0(x)
        for k in range(self.units):
            x = getattr(self, f"Residual_{k}")(x)
        return x


class DarknetBackbone(nn.Module):
    """RangeNet++'s Darknet encoder (module docstring): NCHW [B, Cin, H,
    W] -> [B, 1024, H, W / 32]. ``layers`` (21 or 53) picks the published
    unit counts."""

    def __init__(self, in_channels: int, layers: int = 53,
                 stage_dropout: float = 0.01):
        super().__init__()
        if layers not in UNITS:
            raise ValueError(f"darknet layers must be 21|53, got {layers}")
        self.stage_dropout = stage_dropout
        self.n_stages = len(WIDTHS)
        self.out_channels = WIDTHS[-1]
        self.ConvBN_0 = ConvBNLeaky(in_channels, STEM_WIDTH, 3)
        c = STEM_WIDTH
        for i, (w, n) in enumerate(zip(WIDTHS, UNITS[layers])):
            setattr(self, f"Stage_{i}", Stage(c, w, n))
            c = w

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = self.ConvBN_0(x)
        for i in range(self.n_stages):
            x = channel_dropout(getattr(self, f"Stage_{i}")(x),
                                self.stage_dropout, self.training, generator)
        return x
