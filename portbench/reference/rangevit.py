"""Plain PyTorch DeepLIO on RangeViT's encoder: the benchmark's reference
for the ``deeplio_rangevit`` configuration, and the CPU tests' reference
for the port's ``lidar-feat-rangevit`` tower.

A frozen copy of the tower (Ando, Gidaris, Bursuc, Puy, Boulch and
Marlet, "RangeViT", CVPR 2023, arXiv:2301.10222; github.com/valeoai/
rangevit), written from the paper's equations and not from the port. A
convolutional stem of SalsaNext's blocks (Cortinhal et al.,
arXiv:2003.03653), every conv with bias and symmetric padding, LeakyReLU
0.01 before each BatchNorm:

- ``ResContext(cin, C)``: ``s = LReLU(conv1x1(x))``, ``a =
  BN(LReLU(conv3x3(s)))``, ``b = BN(LReLU(conv3x3_dil2(a)))``, ``s + b``;
- ``ResBlock(cin, C)``: ``s = LReLU(conv1x1(x))``, ``a1 =
  BN(LReLU(conv3x3(x)))``, ``a2 = BN(LReLU(conv3x3_dil2(a1)))``, ``a3 =
  BN(LReLU(conv2x2_dil2_pad1(a2)))``, ``s + BN(LReLU(conv1x1(cat(a1, a2,
  a3))))``;
- three ``ResContext`` to the stem width, a ``ResBlock`` to the stem's
  hidden width at full resolution, an average pool at the patch's stride
  (kernel 2 (p // 2) + 1, padding p // 2 on each axis, padding counted),
  ``conv1x1`` to the token width D.

Then ViT-S (DeiT-S, arXiv:2012.12877): a class token, a learned position
embedding over the 1 + HW / (ph pw) tokens, ``depth`` pre-norm blocks
``x += DropPath(Attn(LN(x)))``, ``x += DropPath(MLP(LN(x)))`` (LayerNorm
epsilon 1e-6, written out; ``heads`` heads, ``softmax(Q K^T / sqrt(D /
heads)) V`` written out, in blocks of ``QUERY_BLOCK`` queries; exact
GELU), drop-path rates linear from 0 to the configured one, a final
LayerNorm, the class token dropped and the tokens laid out as a [B, D, H
/ ph, W / pw] map.

Departures from RangeViT, as in the system: no decoder and no KPConv 3D
refiner (segmentation heads; DeepLIO takes the encoder only); the input
is DeepLIO's 10-channel pair stack; DeepLIO's tail follows the encoder
(``model.py``'s SAME-padded strided ConvBNs, mean and Dense, the LSTMs,
the soft fusion and the pose heads); SalsaNext's ResBlock loses its
pooling and dropout; BatchNorm has flax's semantics (``model.BatchNorm``).
Drop-path is inverted, one ``torch.bernoulli`` draw a sample from the
generator passed in, block 1 to ``depth``, the attention's before the
MLP's, a block at rate 0 drawing nothing; then the tower's and the heads'
dropout. ``model.py``'s ``Ref`` precision switch holds: under the float8
control every tensor the system holds in bfloat16 (the convolutions',
Linears' and attention's inputs, weights and outputs, BatchNorm and
LayerNorm outputs, the stem's sums, the attention probabilities, GELU's
output) is rounded through float8; the residual stream, which the system
holds in float32, is not.

Memory: the float32 step at the configuration's 32 pairs keeps no whole
stem or encoder. In training each stem unit (a conv, its LeakyReLU and
BatchNorm) and each transformer block is recomputed in its backward
(``torch.utils.checkpoint``, non-reentrant), and inside each block each
query block of the attention again, so that no more than one query
block's [B, heads, QUERY_BLOCK, T] probabilities exist at once. The
drop-path masks are drawn before each block, outside the recomputed
part, so each is drawn once. The recomputation runs the stem's
BatchNorms a second time, so their running statistics, which the check
does not compare, update twice. ``recompute(False)`` keeps every
activation (the FLOP count: a count under recomputation would add
forwards).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference import model as m

SLOPE = 0.01
LN_EPS = 1e-6
QUERY_BLOCK = 512


class Conv(m.Ref):
    """A convolution with bias, stride 1 and symmetric padding."""

    def __init__(self, cin: int, cout: int, kernel: int, dilation: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        self.dilation = dilation
        self.padding = dilation * (kernel // 2) if padding is None \
            else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return self.q(F.conv2d(self.q(x), self.q(self.weight), self.bias, 1,
                               self.padding, self.dilation))


class ConvLeakyBN(m.Ref):
    def __init__(self, cin: int, cout: int, kernel: int, dilation: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, dilation, padding)
        self.BatchNorm_0 = m.BatchNorm(cout)

    def forward(self, x):
        return self.BatchNorm_0(self.q(F.leaky_relu(self.Conv_0(x), SLOPE)))


class Recomputed(nn.Module):
    """A module whose parts :meth:`unit` recomputes in the backward while
    ``checkpoint`` is set and the module trains with grad on."""

    checkpoint = True

    def unit(self, fn, *args):
        if self.checkpoint and self.training and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)


class ResContext(Recomputed, m.Ref):
    def __init__(self, cin: int, width: int):
        super().__init__()
        self.Conv_0 = Conv(cin, width, 1)
        self.ConvBN_0 = ConvLeakyBN(width, width, 3)
        self.ConvBN_1 = ConvLeakyBN(width, width, 3, 2)

    def forward(self, x):
        s = self.q(F.leaky_relu(self.Conv_0(x), SLOPE))
        b = self.unit(self.ConvBN_1, self.unit(self.ConvBN_0, s))
        return self.q(s + b)


class ResBlock(Recomputed, m.Ref):
    def __init__(self, cin: int, width: int):
        super().__init__()
        self.Conv_0 = Conv(cin, width, 1)
        self.ConvBN_0 = ConvLeakyBN(cin, width, 3)
        self.ConvBN_1 = ConvLeakyBN(width, width, 3, 2)
        self.ConvBN_2 = ConvLeakyBN(width, width, 2, 2, 1)
        self.ConvBN_3 = ConvLeakyBN(3 * width, width, 1)

    def _shortcut(self, x):
        return self.q(F.leaky_relu(self.Conv_0(x), SLOPE))

    def forward(self, x):
        s = self.unit(self._shortcut, x)
        a1 = self.unit(self.ConvBN_0, x)
        a2 = self.unit(self.ConvBN_1, a1)
        a3 = self.unit(self.ConvBN_2, a2)
        y = self.unit(self.ConvBN_3, torch.cat([a1, a2, a3], 1))
        return self.q(s + y)


class ConvStem(m.Ref):
    def __init__(self, cin: int, dim: int, patch: Tuple[int, int],
                 width: int, hidden: int):
        super().__init__()
        self.ResContext_0 = ResContext(cin, width)
        self.ResContext_1 = ResContext(width, width)
        self.ResContext_2 = ResContext(width, width)
        self.ResBlock_0 = ResBlock(width, hidden)
        self.patch = tuple(patch)
        self.Conv_0 = Conv(hidden, dim, 1)

    def forward(self, x):
        x = self.ResContext_2(self.ResContext_1(self.ResContext_0(x)))
        x = self.ResBlock_0(x)
        kernel = tuple(2 * (p // 2) + 1 for p in self.patch)
        pad = tuple(p // 2 for p in self.patch)
        return self.Conv_0(self.q(F.avg_pool2d(x, kernel, self.patch, pad)))


class LayerNorm(m.Ref):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
        return self.q((x - mean) * torch.rsqrt(var + LN_EPS) * self.weight
                      + self.bias)


def _attend(q, k, v, scale: float, rnd):
    """``softmax(q k^T * scale) v`` for one block of queries."""
    p = rnd(torch.softmax((q @ k.transpose(-2, -1)) * scale, dim=-1))
    return p @ v


class Attention(Recomputed, m.Ref):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = m.Linear(dim, 3 * dim)
        self.proj = m.Linear(dim, dim)

    def forward(self, x):
        b, t, d = x.shape
        hd = d // self.heads
        q, k, v = (self.q(u) for u in self.qkv(x).view(
            b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4))
        scale = 1.0 / math.sqrt(hd)
        o = self.q(torch.cat([
            self.unit(_attend, q[:, :, i:i + QUERY_BLOCK], k, v, scale,
                      self.q) for i in range(0, t, QUERY_BLOCK)], 2))
        return self.proj(o.transpose(1, 2).reshape(b, t, d))


class Mlp(m.Ref):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = m.Linear(dim, hidden)
        self.fc2 = m.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.q(F.gelu(self.fc1(x))))


def _keep(b: int, rate: float, device, generator):
    """The drop-path draw of one branch: [B, 1, 1], True where kept."""
    return torch.bernoulli(torch.full((b, 1, 1), 1.0 - rate, device=device),
                           generator=generator).bool()


def _branch(y, keep, rate: float):
    """A branch through its drop-path mask (None: no drop-path)."""
    if keep is None:
        return y
    return torch.where(keep, y / (1.0 - rate), torch.zeros_like(y))


class Block(Recomputed):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, rate: float):
        super().__init__()
        self.rate = rate
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, mlp_ratio * dim)

    def body(self, x, k1, k2):
        x = x + _branch(self.attn(self.norm1(x)), k1, self.rate)
        return x + _branch(self.mlp(self.norm2(x)), k2, self.rate)

    def forward(self, x, generator=None):
        k1 = k2 = None
        if self.training and self.rate > 0.0:
            k1 = _keep(x.shape[0], self.rate, x.device, generator)
            k2 = _keep(x.shape[0], self.rate, x.device, generator)
        return self.unit(self.body, x, k1, k2)


class RangeViT(nn.Module):
    def __init__(self, cin: int, image: Tuple[int, int], vit: Dict):
        super().__init__()
        patch = tuple(vit["patch"])
        dim, self.depth = vit["embed_dim"], vit["depth"]
        self.grid = (image[0] // patch[0], image[1] // patch[1])
        self.stem = ConvStem(cin, dim, patch, vit["stem_width"],
                             vit["stem_hidden"])
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, 1 + self.grid[0] * self.grid[1], dim))
        rates = torch.linspace(0, vit["drop_path"], self.depth,
                               device="cpu").tolist()
        for i, r in enumerate(rates):
            setattr(self, f"Block_{i}", Block(dim, vit["heads"],
                                              vit["mlp_ratio"], r))
        self.norm = LayerNorm(dim)

    def forward(self, x, generator=None):
        x = self.stem(x)
        b, d, h, w = x.shape
        x = torch.cat([self.cls_token.expand(b, -1, -1),
                       x.flatten(2).transpose(1, 2)], 1) + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"Block_{i}")(x, generator)
        x = self.norm(x)[:, 1:]
        return x.transpose(1, 2).reshape(b, d, h, w)


class LidarFeat(nn.Module):
    """RangeViT, then the PointSeg tower's tail (``model.LidarFeat``)."""

    def __init__(self, cin: int, image: Tuple[int, int], vit: Dict,
                 feature_size: int, rate: float):
        super().__init__()
        self.rate = rate
        self.rangevit = RangeViT(cin, image, vit)
        self.ConvBN_0 = m.ConvBN(vit["embed_dim"], 256, (3, 3), (2, 2))
        self.ConvBN_1 = m.ConvBN(256, 256, (3, 3), (2, 2))
        self.Dense_0 = m.Linear(256, feature_size)

    def forward(self, x, generator=None):
        f = self.ConvBN_1(self.ConvBN_0(self.rangevit(x, generator)))
        f = F.relu(self.Dense_0(f.mean(dim=(-2, -1))))
        return m.dropout(f, self.rate, self.training, generator)


class DeepLIO(m.DeepLIO):
    """``model.DeepLIO`` with the RangeViT tower: the same forward, the
    same precision switch."""

    def __init__(self, spec: Dict):
        nn.Module.__init__(self)
        ls, im, od = spec["lidar"], spec["imu"], spec["odom"]
        self.lidar_feat = LidarFeat(2 * spec["image_channels"],
                                    spec["image"], spec["rangevit"],
                                    ls["feature_size"], ls["dropout"])
        self.imu_feat = m.ImuFeat(im["input_size"], im["hidden_size"],
                                  im["num_layers"])
        self.fusion = m.Fusion(ls["feature_size"], im["hidden_size"])
        self.odom_feat = m.OdomFeat(ls["feature_size"] + im["hidden_size"],
                                    od["hidden_size"], od["num_layers"])
        self.heads = m.Heads(od["hidden_size"], spec["dropout"])

    def recompute(self, on: bool) -> "DeepLIO":
        """Stem units, blocks and attention recomputed in the backward
        (default) or kept."""
        for mod in self.modules():
            if isinstance(mod, Recomputed):
                mod.checkpoint = on
        return self


def model_spec(cfg: Dict) -> Dict:
    """``model.model_spec`` of a configuration whose LiDAR tower is
    ``lidar-feat-rangevit``, with the image (H, W) and its ``rangevit``
    sizes."""
    block = cfg["deeplio"]
    lname = block["lidar-feat-net"]["name"]
    if lname != "lidar-feat-rangevit":
        raise ValueError(f"the RangeViT reference's tower is "
                         f"lidar-feat-rangevit, not {lname!r}")
    ls = cfg.get(lname, {})
    ds = cfg["datasets"]
    spec = m.model_spec(cfg)
    spec["image"] = (int(ds.get("image-height", 64)),
                     int(ds.get("image-width", 1024)))
    spec["rangevit"] = {
        "embed_dim": int(ls.get("embed-dim", 384)),
        "depth": int(ls.get("depth", 12)),
        "heads": int(ls.get("heads", 6)),
        "mlp_ratio": int(ls.get("mlp-ratio", 4)),
        "patch": tuple(int(p) for p in ls.get("patch", (2, 8))),
        "stem_width": int(ls.get("stem-width", 32)),
        "stem_hidden": int(ls.get("stem-hidden", 256)),
        "drop_path": float(ls.get("drop-path", 0.1))}
    return spec


def fill_state(state: Dict[str, torch.Tensor],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """``weights.make_state``'s dict made right for the transformer, in
    place: unit LayerNorm scales (``make_state`` draws them as kernels),
    and the position embedding and class token truncated-normal at std
    0.02 (timm's ViT init; ``make_state`` leaves them zero)."""
    for k, t in state.items():
        if ".norm" in k and k.endswith(".weight"):
            t.fill_(1.0)
        elif k.endswith(("pos_embed", "cls_token")):
            nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                  generator=generator)
    return state
