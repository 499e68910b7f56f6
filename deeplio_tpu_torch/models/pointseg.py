"""PointSeg (counterpart of ``deeplio_tpu/models/pointseg.py``:
``PointSegEncoder`` with every stem (``classic``, ``pair-split``,
``s2d``, ``s2d-pre``, ``factorized``), every Fire (``classic``,
``fused``, ``mixed``) and the ``classic``, ``cheap``, ``stride`` and
``stride-fold`` pools, the ``PointSegDecoder`` and ``PointSegNet``).

The pools halve the azimuth three times after the stem, as in JAX:
``classic`` with 3x3 max-pools at stride (1, 2) after ``c1``, ``f3`` and
``f5``; ``cheap`` with (1, 2) windows there; ``stride`` with no pooling
op, each stage's entry Fire downsampling with a (1, 2)-strided squeeze
conv. All three give the same parameters and the skips at the same
widths. ``stride-fold`` is ``stride`` with the first entry's (1, 2)
folded into the stem: a (1, 2)-strided 1x1 conv after the stem reads only
its even columns, so the stem at the composed stride (h, 2 w), padded as
the unfolded stem's SAME pads, computes the same function without the odd
columns. Its skip ``c1`` is at half the width, so it serves the encoder
alone (``part="encoder"``); its parameters are those of ``stride``.

The stems, all with the same output grid (H / h_stride, W / w_stride):
``classic``, a strided 3x3 ConvBN on the pair stack; ``pair-split``, the
same on the ``(a, b)`` frames of each pair, whose channel concat its
``SplitInputConv`` never builds; ``s2d``, the pair stack's (h, w) blocks
moved into channels (``blocks.py::space_to_depth``), then a 2x2 ConvBN at
stride 1 (SAME: pads (0, 1) on each axis); ``s2d-pre``, the same conv on
input the data side laid out so (``space_to_depth_pairs``), the same
parameters; ``factorized``, ``FactorizedStem_0`` on the frames [B, S, C,
H, W] of each window, the pairs given by ``combos``. The Fires:
``classic``; ``fused``, each Fire one 3x3 ConvBN; ``mixed``, fused for the
shallow ``Fire_0`` to ``Fire_3`` and classic for the deep ``Fire_4`` to
``Fire_7``. The input is NCHW (an NCHW view of NHWC memory), NCHW out.

``PointSegNet`` is used two ways, as in the JAX package: as the odometry
model's LiDAR encoder (``part="encoder"``, no classes: the bottleneck
feature map, with exactly the encoder's parameters), and as the
standalone segmentation net that pretrains that encoder
(``part="encoder+decoder"`` with ``num_classes``: per-pixel logits at the
input's resolution, ``train/pretrain.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deeplio_tpu_torch.config.schema import FIRES, STEMS
from deeplio_tpu_torch.models.blocks import (
    ASPP,
    ConvBN,
    ConvInput,
    FactorizedStem,
    Fire,
    FireDeconv,
    SameConv2d,
    SameConvTranspose2d,
    SELayer,
    same_max_pool,
    same_pads,
    space_to_depth,
)

PARTS = ("encoder", "encoder+decoder")
Combos = Tuple[Tuple[int, int], ...]
# pool -> (max-pool window or None, the stage-entry Fires' strides)
POOLS = {"classic": ((3, 3), (1, 1)), "cheap": ((1, 2), (1, 1)),
         "stride": (None, (1, 2)), "stride-fold": (None, (1, 2))}


class PointSegEncoder(nn.Module):
    """Stem + eight Fires (two SE blocks, two residuals) + ASPP.

    ``in_channels`` is the pair stack's width 2C for every stem.
    Output: the bottleneck [B, 512, H / h_stride, W / (8 * w_stride)] and
    the skips (c1, f3, f5) at widths W / w_stride, / 2 and / 4 of that.
    """

    def __init__(self, in_channels: int, h_stride: int = 1, w_stride: int = 2,
                 with_se: bool = True, el_squeeze: int = 0,
                 pool: str = "stride", stem: str = "classic",
                 fire: str = "classic"):
        super().__init__()
        if pool not in POOLS:
            raise ValueError(f"pool must be {'|'.join(POOLS)}, got {pool!r}")
        if stem not in STEMS:
            raise ValueError(f"stem must be {'|'.join(STEMS)}, got {stem!r}")
        if fire not in FIRES:
            raise ValueError(f"fire must be {'|'.join(FIRES)}, got {fire!r}")
        self.pool_window, entry = POOLS[pool]
        self.fold = pool == "stride-fold"
        if self.fold and stem not in ("classic", "pair-split"):
            raise ValueError(f"pool=stride-fold folds a strided 3x3 stem, "
                             f"not stem={stem!r}")
        self.stem = stem
        self.strides = (h_stride, w_stride)
        if stem == "factorized":
            self.FactorizedStem_0 = FactorizedStem(
                in_channels // 2, 64, (3, 3), (h_stride, w_stride))
        elif stem in ("s2d", "s2d-pre"):
            self.ConvBN_0 = ConvBN(h_stride * w_stride * in_channels, 64,
                                   (2, 2), (1, 1))
        else:
            self.ConvBN_0 = ConvBN(in_channels, 64, (3, 3),
                                   (h_stride, (1 + self.fold) * w_stride))
        spec = [  # (squeeze, expand1, expand3, strides)
            (16, 64, 64, (1, 1) if self.fold else entry),
            (16, 64, 64, (1, 1)),
            (32, 128, 128, entry), (32, 128, 128, (1, 1)),
            (48, 192, 192, entry), (48, 192, 192, (1, 1)),
            (64, 256, 256, (1, 1)), (64, 256, 256, (1, 1)),
        ]
        c = 64
        for i, (sq, e1, e3, st) in enumerate(spec):
            # mixed: the four shallow Fires fused, the deep ones classic
            fused = fire == "fused" or (fire == "mixed" and i < 4)
            setattr(self, f"Fire_{i}", Fire(c, sq, e1, e3, st, fused))
            c = e1 + e3
        self.with_se = with_se
        if with_se:
            self.SELayer_0 = SELayer(128)
            self.SELayer_1 = SELayer(256)
        self.ASPP_0 = ASPP(512, 512, squeeze=el_squeeze)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool_window is None:
            return x          # the stage-entry Fires downsample instead
        return same_max_pool(x, self.pool_window, (1, 2))

    def _fold_pads(self, x: ConvInput):
        """The unfolded stem's SAME pads, for the stem at the composed
        stride; raises where the composed stride changes the width."""
        ref = x if isinstance(x, torch.Tensor) else x[0]
        (hs, ws), (h, w) = self.strides, ref.shape[-2:]
        pads = (same_pads(h, 3, hs), same_pads(w, 3, ws))
        want = -(-(-(-w // ws)) // 2)          # ceil(ceil(W / w) / 2)
        got = (w + sum(pads[1]) - 3) // (2 * ws) + 1
        if got != want:
            raise ValueError(f"stride-fold width mismatch: W={w}, w_stride="
                             f"{ws} -> {got} != {want}; use pool=stride")
        return pads

    def _stem(self, x: ConvInput, combos: Combos) -> torch.Tensor:
        if self.stem == "factorized":
            return self.FactorizedStem_0(x, combos)
        if self.stem == "s2d":
            hs, ws = self.strides
            x = space_to_depth(x.permute(0, 2, 3, 1), hs, ws)
            return self.ConvBN_0(x.permute(0, 3, 1, 2))
        return self.ConvBN_0(x, self._fold_pads(x) if self.fold else None)

    def forward(self, x: ConvInput, combos: Combos = ()
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """``x``: NCHW pair images, the ``(a, b)`` frames of each pair
        under ``pair-split``, or the frames [B, S, C, H, W] and their
        ``combos`` under ``factorized``."""
        c1 = self._stem(x, combos)
        f2 = self.Fire_0(self._pool(c1))
        f3 = self.Fire_1(f2)
        if self.with_se:
            f3 = self.SELayer_0(f3)
        f3 = f3 + f2
        f4 = self.Fire_2(self._pool(f3))
        f5 = self.Fire_3(f4)
        if self.with_se:
            f5 = self.SELayer_1(f5)
        f5 = f5 + f4
        f6 = self.Fire_4(self._pool(f5))
        f7 = self.Fire_5(f6)
        f8 = self.Fire_6(f7)
        f9 = self.Fire_7(f8)
        return self.ASPP_0(f9), (c1, f3, f5)


class PointSegDecoder(nn.Module):
    """Three FireDeconvs, each doubling the width, with the encoder's skips
    added back: bottleneck -> [B, 64, H / h_stride, W / w_stride]."""

    def __init__(self):
        super().__init__()
        self.FireDeconv_0 = FireDeconv(512, 64, 128, 128)
        self.FireDeconv_1 = FireDeconv(256, 32, 64, 64)
        self.FireDeconv_2 = FireDeconv(128, 16, 32, 32)

    def forward(self, x: torch.Tensor,
                skips: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        c1, f3, f5 = skips
        d10 = self.FireDeconv_0(x) + f5
        d11 = self.FireDeconv_1(d10) + f3
        return self.FireDeconv_2(d11) + c1


def head_kernel(h_stride: int, w_stride: int) -> Tuple[int, int]:
    """The classifier's transposed-conv kernel: (1, 4) at strides (1, 2),
    as existing checkpoints have it, else (2 h or 1, 2 w)."""
    if (h_stride, w_stride) == (1, 2):
        return 1, 4
    return (1 if h_stride == 1 else 2 * h_stride), 2 * w_stride


class PointSegNet(nn.Module):
    """Encoder (+ decoder) (+ classifier head).

    ``part="encoder"`` with no classes: the bottleneck feature map.
    ``part="encoder+decoder"``: the decoder's per-pixel features.
    ``num_classes``: the decoder, then ``ConvTranspose_0`` (the stem's
    strides) back to the input's resolution and the 1x1 ``Conv_0`` to
    [B, num_classes, H, W] logits. ``Conv_0`` runs in float32 outside any
    autocast region, on a float32 input, as the JAX package's
    ``dtype=float32`` head does; ``ConvTranspose_0`` runs in the compute
    dtype.
    """

    def __init__(self, in_channels: int, part: str = "encoder",
                 num_classes: Optional[int] = None, h_stride: int = 1,
                 w_stride: int = 2, with_se: bool = True,
                 el_squeeze: int = 0, pool: str = "stride",
                 stem: str = "classic", fire: str = "classic"):
        super().__init__()
        if part not in PARTS:
            raise ValueError(f"part must be {'|'.join(PARTS)}, got {part!r}")
        if pool == "stride-fold" and (part != "encoder" or num_classes):
            raise ValueError("pool=stride-fold serves the encoder alone: "
                             "its skip c1 is at half the decoder's width")
        self.part, self.num_classes = part, num_classes
        self.encoder = PointSegEncoder(in_channels, h_stride, w_stride,
                                       with_se, el_squeeze, pool, stem, fire)
        if part == "encoder" and num_classes is None:
            return
        self.decoder = PointSegDecoder()
        if num_classes is not None:
            self.ConvTranspose_0 = SameConvTranspose2d(
                64, 64, head_kernel(h_stride, w_stride),
                (h_stride, w_stride))
            self.Conv_0 = SameConv2d(64, num_classes, (1, 1))

    def forward(self, x: ConvInput, combos: Combos = ()) -> torch.Tensor:
        feat, skips = self.encoder(x, combos)
        if self.part == "encoder" and self.num_classes is None:
            return feat
        dec = self.decoder(feat, skips)
        if self.num_classes is None:
            return dec
        up = self.ConvTranspose_0(dec)
        with torch.autocast(up.device.type, enabled=False):
            return self.Conv_0(up.float())
