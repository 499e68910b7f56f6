"""PointSeg encoder (counterpart of ``deeplio_tpu/models/pointseg.py``:
``PointSegEncoder`` at ``stem=classic``, ``pool=stride``, and
``PointSegNet`` at ``part=encoder``).

``pool=stride``: no pooling ops; each stage's entry Fire downsamples the
azimuth with a (1, 2)-strided squeeze conv. NCHW in, NCHW out.
"""

from __future__ import annotations

import torch
from torch import nn

from deeplio_tpu_torch.models.blocks import ASPP, ConvBN, Fire, SELayer


class PointSegEncoder(nn.Module):
    """Strided 3x3 stem + eight Fires (two SE blocks, two residuals) + ASPP.

    Output: [B, 512, H / h_stride, W / (8 * w_stride)].
    """

    def __init__(self, in_channels: int, h_stride: int = 1, w_stride: int = 2,
                 with_se: bool = True, el_squeeze: int = 0):
        super().__init__()
        entry = (1, 2)
        self.ConvBN_0 = ConvBN(in_channels, 64, (3, 3), (h_stride, w_stride))
        spec = [  # (squeeze, expand1, expand3, strides)
            (16, 64, 64, entry), (16, 64, 64, (1, 1)),
            (32, 128, 128, entry), (32, 128, 128, (1, 1)),
            (48, 192, 192, entry), (48, 192, 192, (1, 1)),
            (64, 256, 256, (1, 1)), (64, 256, 256, (1, 1)),
        ]
        c = 64
        for i, (sq, e1, e3, st) in enumerate(spec):
            setattr(self, f"Fire_{i}", Fire(c, sq, e1, e3, st))
            c = e1 + e3
        self.with_se = with_se
        if with_se:
            self.SELayer_0 = SELayer(128)
            self.SELayer_1 = SELayer(256)
        self.ASPP_0 = ASPP(512, 512, squeeze=el_squeeze)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1 = self.ConvBN_0(x)
        f2 = self.Fire_0(c1)
        f3 = self.Fire_1(f2)
        if self.with_se:
            f3 = self.SELayer_0(f3)
        f3 = f3 + f2
        f4 = self.Fire_2(f3)
        f5 = self.Fire_3(f4)
        if self.with_se:
            f5 = self.SELayer_1(f5)
        f5 = f5 + f4
        f6 = self.Fire_4(f5)
        f7 = self.Fire_5(f6)
        f8 = self.Fire_6(f7)
        f9 = self.Fire_7(f8)
        return self.ASPP_0(f9)


class PointSegNet(nn.Module):
    """PointSeg at ``part=encoder``: the bottleneck feature map."""

    def __init__(self, in_channels: int, **encoder_kw):
        super().__init__()
        self.encoder = PointSegEncoder(in_channels, **encoder_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)
