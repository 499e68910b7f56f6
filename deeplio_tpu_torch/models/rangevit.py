"""RangeViT's encoder (Ando, Gidaris, Bursuc, Puy, Boulch and Marlet,
"RangeViT: Towards Vision Transformers for 3D Semantic Segmentation in
Autonomous Driving", CVPR 2023; github.com/valeoai/rangevit), the port's
own LiDAR backbone: the JAX package has no counterpart.

A convolutional stem of SalsaNext's residual blocks (Cortinhal, Tzelepis
and Aksoy, arXiv:2003.03653) stands in for ViT's linear patch embedding;
a ViT (DeiT-S widths by default: 384 wide, 12 blocks, 6 heads of 64, MLP
1,536) then runs over the range image's patches. With C a width, conv a
2-D convolution with bias, LReLU a LeakyReLU of slope 0.01 (SalsaNext's)
and BN a :class:`models.blocks.FlaxBatchNorm2d`:

- ``ResContext(cin, C)``: ``s = LReLU(conv1x1(x))``; ``a =
  BN(LReLU(conv3x3(s)))``; ``b = BN(LReLU(conv3x3_dil2(a)))``; ``s + b``;
- ``ResBlock(cin, C)``, without SalsaNext's pooling and dropout: ``s =
  LReLU(conv1x1(x))``; ``a1 = BN(LReLU(conv3x3(x)))``; ``a2 =
  BN(LReLU(conv3x3_dil2(a1)))``; ``a3 = BN(LReLU(conv2x2_dil2(a2)))``
  (padding 1); ``s + BN(LReLU(conv1x1(cat(a1, a2, a3))))``;
- the stem: ``ResContext(cin, W)``, two ``ResContext(W, W)`` and
  ``ResBlock(W, Hs)`` at full resolution (``W``, ``Hs`` =
  ``stem_width``, ``stem_hidden``), then for a patch (ph, pw) an
  ``AvgPool2d`` at stride (ph, pw) with the odd kernel (2 (ph // 2) + 1,
  2 (pw // 2) + 1) and padding (ph // 2, pw // 2) (padding counted in the
  mean), (3, 9) and (1, 4) for 2 x 8, and ``conv1x1(Hs, D)``: an H x W
  image becomes an (H / ph) x (W / pw) grid of D-wide tokens;
- the encoder: a class token before the tokens and a learned position
  embedding added to all 1 + HW / (ph pw) of them; ``depth`` pre-norm
  blocks ``x += DropPath(Attn(LN(x)))``, ``x += DropPath(MLP(LN(x)))``
  (LayerNorm epsilon 1e-6; ``qkv`` Linear(D, 3D), ``heads`` heads,
  ``softmax(Q K^T / sqrt(D / heads)) V``, ``proj`` Linear(D, D); MLP
  Linear(D, r D), exact GELU, Linear(r D, D)); drop-path rates rising
  linearly from 0 at the first block to ``drop_path`` at the last, as in
  timm; a final LayerNorm; the class token dropped and the tokens laid
  back out as a [B, D, H / ph, W / pw] map.

Attention is ``F.scaled_dot_product_attention`` with no mask and no
dropout, so that a bfloat16 call on the card takes a fused kernel and
never holds the [B, heads, T, T] scores. Drop-path is inverted (a kept
sample's branch over the keep probability), one ``torch.bernoulli``
draw a sample, from the generator the caller passes, block 1 to
``depth`` and in each the attention's before the MLP's; a block at rate 0
draws nothing. The stem runs under the span ``lidar.stem``, the tokens
and the encoder under ``lidar.encoder``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deeplio_tpu_torch.models.blocks import FlaxBatchNorm2d, inverted_dropout
from deeplio_tpu_torch.utils.timing import span

SLOPE = 0.01
LN_EPS = 1e-6


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on a residual branch ``x`` [B, ...]: one keep draw
    a sample (``blocks.inverted_dropout``)."""
    return inverted_dropout(x, rate, training, generator,
                            (x.shape[0],) + (1,) * (x.dim() - 1))


class ConvLeakyBN(nn.Module):
    """conv (with bias) -> LeakyReLU(0.01) -> BatchNorm, SalsaNext's
    order."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 dilation: int = 1, padding: Optional[int] = None):
        super().__init__()
        if padding is None:
            padding = dilation * (kernel // 2)
        self.Conv_0 = nn.Conv2d(in_channels, features, kernel,
                                padding=padding, dilation=dilation)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in place: the convolution's backward reads its input, and the
        # LeakyReLU's its output, which the BatchNorm keeps as its input
        return self.BatchNorm_0(F.leaky_relu(self.Conv_0(x), SLOPE,
                                             inplace=True))


class ResContext(nn.Module):
    """SalsaNext's ``ResContextBlock`` (module docstring)."""

    def __init__(self, in_channels: int, width: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, width, 1)
        self.ConvBN_0 = ConvLeakyBN(width, width, 3)
        self.ConvBN_1 = ConvLeakyBN(width, width, 3, dilation=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.leaky_relu(self.Conv_0(x), SLOPE, inplace=True)
        return s + self.ConvBN_1(self.ConvBN_0(s))


class ResBlock(nn.Module):
    """SalsaNext's ``ResBlock`` without its pooling and dropout (module
    docstring)."""

    def __init__(self, in_channels: int, width: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, width, 1)
        self.ConvBN_0 = ConvLeakyBN(in_channels, width, 3)
        self.ConvBN_1 = ConvLeakyBN(width, width, 3, dilation=2)
        self.ConvBN_2 = ConvLeakyBN(width, width, 2, dilation=2, padding=1)
        self.ConvBN_3 = ConvLeakyBN(3 * width, width, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.leaky_relu(self.Conv_0(x), SLOPE, inplace=True)
        a1 = self.ConvBN_0(x)
        a2 = self.ConvBN_1(a1)
        a3 = self.ConvBN_2(a2)
        return s + self.ConvBN_3(torch.cat([a1, a2, a3], dim=1))


def pool_geometry(patch: Tuple[int, int]) -> Tuple[tuple, tuple]:
    """(kernel, padding) of the stem's average pool at stride ``patch``:
    an odd kernel centred on each patch, so that a size the patch divides
    is divided exactly."""
    return (tuple(2 * (p // 2) + 1 for p in patch),
            tuple(p // 2 for p in patch))


class ConvStem(nn.Module):
    """Three ``ResContext`` blocks and a ``ResBlock`` at full resolution,
    the patch's average pool and a 1x1 conv to the token width: NCHW [B,
    Cin, H, W] -> [B, D, H / ph, W / pw]."""

    def __init__(self, in_channels: int, embed_dim: int,
                 patch: Tuple[int, int], width: int, hidden: int):
        super().__init__()
        self.ResContext_0 = ResContext(in_channels, width)
        self.ResContext_1 = ResContext(width, width)
        self.ResContext_2 = ResContext(width, width)
        self.ResBlock_0 = ResBlock(width, hidden)
        kernel, padding = pool_geometry(patch)
        self.pool = nn.AvgPool2d(kernel, tuple(patch), padding)
        self.Conv_0 = nn.Conv2d(hidden, embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ResContext_2(self.ResContext_1(self.ResContext_0(x)))
        return self.Conv_0(self.pool(self.ResBlock_0(x)))


class Attention(nn.Module):
    """Multi-head self-attention over [B, T, D] through
    ``F.scaled_dot_product_attention`` (no mask, no dropout)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self.qkv(x).view(b, t, 3, self.heads,
                                   d // self.heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return self.proj(o.transpose(1, 2).reshape(b, t, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A pre-norm transformer block with drop-path at ``rate``."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + drop_path(self.attn(self.norm1(x)), self.rate,
                          self.training, generator)
        return x + drop_path(self.mlp(self.norm2(x)), self.rate,
                             self.training, generator)


class RangeViT(nn.Module):
    """RangeViT's encoder (module docstring): NCHW [B, Cin, H, W] -> [B, D,
    H / ph, W / pw]. ``image`` (H, W) sizes the position embedding."""

    def __init__(self, in_channels: int, image: Tuple[int, int],
                 embed_dim: int = 384, depth: int = 12, heads: int = 6,
                 mlp_ratio: int = 4, patch: Tuple[int, int] = (2, 8),
                 stem_width: int = 32, stem_hidden: int = 256,
                 drop_path: float = 0.1):
        super().__init__()
        self.out_channels = embed_dim
        self.grid = (image[0] // patch[0], image[1] // patch[1])
        self.depth = depth
        self.stem = ConvStem(in_channels, embed_dim, patch, stem_width,
                             stem_hidden)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + self.grid[0] * self.grid[1], embed_dim))
        rates = torch.linspace(0, drop_path, depth, device="cpu").tolist()
        for i, r in enumerate(rates):
            setattr(self, f"Block_{i}", Block(embed_dim, heads, mlp_ratio,
                                              r))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """timm's ViT init: truncated-normal (std 0.02) position embedding,
        class token and Linear weights, zero Linear biases, unit
        LayerNorm. The stem is left as it is."""
        with torch.no_grad():
            for t in (self.pos_embed, self.cls_token):
                nn.init.trunc_normal_(t, 0.0, 0.02, generator=generator)
            for mod in self.modules():
                if isinstance(mod, nn.Linear):
                    nn.init.trunc_normal_(mod.weight, 0.0, 0.02,
                                          generator=generator)
                    mod.bias.zero_()
                elif isinstance(mod, nn.LayerNorm):
                    mod.reset_parameters()

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        with span("lidar.stem"):
            x = self.stem(x)
        with span("lidar.encoder"):
            b, d, h, w = x.shape
            x = torch.cat([self.cls_token.expand(b, -1, -1),
                           x.flatten(2).transpose(1, 2)], dim=1)
            x = x + self.pos_embed
            for i in range(self.depth):
                x = getattr(self, f"Block_{i}")(x, generator)
            # the tokens as an NCHW view of their [B, h, w, D] memory
            x = self.norm(x)[:, 1:].reshape(b, h, w, d)
            return x.permute(0, 3, 1, 2)
