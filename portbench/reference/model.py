"""Plain PyTorch DeepLIO: the benchmark's reference model.

A frozen, self-contained copy of the model the two KITTI configurations
build: the PointSeg encoder (classic 3x3 stem at (h, w) strides, eight
classic Fires, two squeeze-excitation blocks, the ``classic`` 3x3
max-pools or the ``stride`` pool's (1, 2)-strided stage entries, the
enlargement layer full width or squeezed), the two strided ConvBNs, mean
and Dense of the LiDAR tower, the masked two-layer LSTMs over the IMU
window and over the window's pairs, the soft fusion, and the pose heads
with their dropout. Parameter names are the ones a state dict of the
system under test uses, so one set of weights made by the benchmark loads
into both. Nothing here imports the system under test.

Semantics (flax's, as the system under test documents them): SAME
padding (the extra row or column at the bottom or right), BatchNorm with
the biased batch variance in training and the running statistics updated
with it at momentum 0.01, inverted dropout whose masks come from the
``torch.bernoulli`` draws of the generator passed in, pose output layers
and the quaternion normalisation in float32.

Precision: ``precision="float32"`` computes everything in float32 (the
caller turns TF32 off). ``precision="fp8"`` is the control, one precision
below the bfloat16 the configurations state, through the whole model as
the system's bfloat16 runs: every tensor the system holds in bfloat16 is
held in float8 here. The input, the weight and the output of every
convolution and matrix product, the BatchNorm outputs, the sums and
products between blocks, the LSTMs' gates and states and the fusion's
outputs are rounded through float8 e4m3 in the forward, and the gradient
that flows back through each of those points through float8 e5m2 (the
usual split of the two float8 formats in training), each with a
per-tensor scale.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("float32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded through the float8 ``dtype``, scaled so its largest
    magnitude maps to the format's largest finite value ``top``."""
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    """The value through e4m3 forward, its gradient through e5m2 back."""

    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3, and the gradient that flows back
    through it through float8 e5m2 (per-tensor scales)."""
    return _Fp8.apply(t)


class Ref(nn.Module):
    """A module whose tensors follow ``self.precision``."""

    precision = "float32"

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t) if self.precision == "fp8" else t


def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> Tuple[int, int]:
    """SAME padding (before, after) along one axis."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(Ref):
    """A SAME convolution, NCHW."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1),
                 dilation=(1, 1), bias: bool = True):
        super().__init__()
        self.stride, self.dilation = tuple(stride), tuple(dilation)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-2:]
        ph = same_pads(x.shape[-2], k[0], self.stride[0], self.dilation[0])
        pw = same_pads(x.shape[-1], k[1], self.stride[1], self.dilation[1])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return self.q(F.conv2d(self.q(x), self.q(self.weight), self.bias,
                               self.stride, 0, self.dilation))


class Linear(Ref):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(F.linear(self.q(x), self.q(self.weight), self.bias))


class BatchNorm(Ref, nn.BatchNorm2d):
    """Batch statistics with the biased variance in training, which also
    updates the running statistics (momentum 0.01); running statistics in
    eval mode."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(self._normalize(x))

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(mean.detach(), alpha=0.01)
            self.running_var.mul_(0.99).add_(var.detach(), alpha=0.01)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Fire(nn.Module):
    def __init__(self, cin: int, squeeze: int, e1: int, e3: int, stride):
        super().__init__()
        self.ConvBN_0 = ConvBN(cin, squeeze, (1, 1), stride)
        self.Conv_0 = Conv(squeeze, e1, (1, 1))
        self.Conv_1 = Conv(squeeze, e3, (3, 3))

    def forward(self, x):
        s = self.ConvBN_0(x)
        return F.relu(torch.cat([self.Conv_0(s), self.Conv_1(s)], 1))


class SELayer(Ref):
    def __init__(self, channels: int):
        super().__init__()
        hidden = max(channels // 16, 4)
        self.Dense_0 = Linear(channels, hidden)
        self.Dense_1 = Linear(hidden, channels)

    def forward(self, x):
        s = x.mean(dim=(-2, -1))
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        return self.q(x * s[..., None, None])


class ASPP(Ref):
    RATES = (1, 2, 4)

    def __init__(self, cin: int, features: int, squeeze: int):
        super().__init__()
        self.squeeze_width = squeeze
        width = squeeze if squeeze > 0 else features
        src = squeeze if squeeze > 0 else cin
        if squeeze > 0:
            self.squeeze = Conv(cin, squeeze, (1, 1))
        self.Conv_0 = Conv(src, width, (1, 1))
        for i, r in enumerate(self.RATES):
            setattr(self, f"Conv_{i + 1}", Conv(src, width, (3, 3),
                                                dilation=(r, r)))
        if squeeze > 0:
            self.expand = Conv(squeeze * 4, features, (1, 1))

    def forward(self, x):
        convs = [getattr(self, f"Conv_{i}") for i in range(4)]
        if self.squeeze_width > 0:
            s = F.relu(self.squeeze(x))
            y = F.relu(torch.cat([c(s) for c in convs], 1))
            return F.relu(self.expand(y))
        out = convs[0](x)
        for c in convs[1:]:
            out = self.q(out + c(x))
        return F.relu(out)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool at stride (1, 2), SAME padding filled with -inf."""
    ph = same_pads(x.shape[-2], 3, 1)
    pw = same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, (3, 3), (1, 2))


class Encoder(Ref):
    """PointSeg's encoder: stem, eight Fires, SE, ASPP -> [B, 512, h, w]."""

    def __init__(self, cin: int, h_stride: int, w_stride: int,
                 el_squeeze: int, pool: str):
        super().__init__()
        if pool not in ("classic", "stride"):
            raise ValueError(f"the reference has the classic and stride "
                             f"pools, not {pool!r}")
        self.pool = pool
        entry = (1, 2) if pool == "stride" else (1, 1)
        self.ConvBN_0 = ConvBN(cin, 64, (3, 3), (h_stride, w_stride))
        spec = [(16, 64, 64, entry), (16, 64, 64, (1, 1)),
                (32, 128, 128, entry), (32, 128, 128, (1, 1)),
                (48, 192, 192, entry), (48, 192, 192, (1, 1)),
                (64, 256, 256, (1, 1)), (64, 256, 256, (1, 1))]
        c = 64
        for i, (sq, e1, e3, st) in enumerate(spec):
            setattr(self, f"Fire_{i}", Fire(c, sq, e1, e3, st))
            c = e1 + e3
        self.SELayer_0 = SELayer(128)
        self.SELayer_1 = SELayer(256)
        self.ASPP_0 = ASPP(512, 512, el_squeeze)

    def _pool(self, x):
        return max_pool_same(x) if self.pool == "classic" else x

    def forward(self, x):
        c1 = self.ConvBN_0(x)
        f2 = self.Fire_0(self._pool(c1))
        f3 = self.q(self.SELayer_0(self.Fire_1(f2)) + f2)
        f4 = self.Fire_2(self._pool(f3))
        f5 = self.q(self.SELayer_1(self.Fire_3(f4)) + f4)
        f6 = self.Fire_4(self._pool(f5))
        return self.ASPP_0(self.Fire_7(self.Fire_6(self.Fire_5(f6))))


class PointSegNet(nn.Module):
    def __init__(self, *a):
        super().__init__()
        self.encoder = Encoder(*a)

    def forward(self, x):
        return self.encoder(x)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: kept values over the keep probability."""
    if not training or rate <= 0.0:
        return x
    keep = torch.bernoulli(torch.full(x.shape, 1.0 - rate, device=x.device),
                           generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LidarFeat(nn.Module):
    def __init__(self, cin: int, feature_size: int, h_stride: int,
                 w_stride: int, el_squeeze: int, pool: str, rate: float):
        super().__init__()
        self.rate = rate
        self.pointseg = PointSegNet(cin, h_stride, w_stride, el_squeeze,
                                    pool)
        self.ConvBN_0 = ConvBN(512, 256, (3, 3), (2, 2))
        self.ConvBN_1 = ConvBN(256, 256, (3, 3), (2, 2))
        self.Dense_0 = Linear(256, feature_size)

    def forward(self, x, generator):
        f = self.ConvBN_1(self.ConvBN_0(self.pointseg(x)))
        f = F.relu(self.Dense_0(f.mean(dim=(-2, -1))))
        return dropout(f, self.rate, self.training, generator)


class Lstm(Ref):
    """One masked LSTM layer: a masked step keeps the state."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden_size = hidden
        self.w_ih = nn.Parameter(torch.empty(cin, 4 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, x, mask):
        b, t, _ = x.shape
        q = self.q
        xp = q(q(x) @ q(self.w_ih) + self.b)
        h = xp.new_zeros(b, self.hidden_size)
        c = xp.new_zeros(b, self.hidden_size)
        ys = []
        for k in range(t):
            i, f, g, o = q(xp[:, k] + q(q(h) @ q(self.w_hh))).chunk(4, -1)
            c_new = q(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
            h_new = q(torch.sigmoid(o) * torch.tanh(c_new))
            m = mask[:, k, None].to(h_new.dtype)
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            ys.append(h)
        return torch.stack(ys, 1), h


class MaskedRNN(nn.Module):
    def __init__(self, cin: int, hidden: int, layers: int):
        super().__init__()
        self.layers = layers
        for k in range(layers):
            setattr(self, f"l{k}_fwd", Lstm(cin if k == 0 else hidden,
                                            hidden))

    def forward(self, x, mask=None):
        if mask is None:
            mask = x.new_ones(x.shape[:2])
        final = None
        for k in range(self.layers):
            x, final = getattr(self, f"l{k}_fwd")(x, mask)
        return x, final


class ImuFeat(nn.Module):
    def __init__(self, cin: int, hidden: int, layers: int):
        super().__init__()
        self.MaskedRNN_0 = MaskedRNN(cin, hidden, layers)

    def forward(self, imu, mask):
        return self.MaskedRNN_0(imu, mask)[1]


class OdomFeat(nn.Module):
    def __init__(self, cin: int, hidden: int, layers: int):
        super().__init__()
        self.MaskedRNN_0 = MaskedRNN(cin, hidden, layers)

    def forward(self, x):
        return self.MaskedRNN_0(x)[0]


class Fusion(Ref):
    def __init__(self, lidar: int, imu: int):
        super().__init__()
        self.gate_lidar = Linear(lidar + imu, lidar)
        self.gate_imu = Linear(lidar + imu, imu)

    def forward(self, lidar, imu):
        both = torch.cat([lidar, imu], -1)
        return self.q(torch.cat(
            [lidar * torch.sigmoid(self.gate_lidar(both)),
             imu * torch.sigmoid(self.gate_imu(both))], -1))


class Heads(nn.Module):
    """The pose heads. ``x_scale`` [B, 3] holds, after each forward, the
    translation head's scale: the sum of the magnitudes of the terms it
    adds up, ``|W| |h| + |b|``, by which a check measures a translation's
    error whatever its terms cancel."""

    def __init__(self, cin: int, rate: float):
        super().__init__()
        self.rate = rate
        self.x_fc = Linear(cin, 128)
        self.q_fc = Linear(cin, 128)
        self.x_out = Linear(128, 3)
        self.q_out = Linear(128, 4)

    def forward(self, x, generator):
        x = dropout(x, self.rate, self.training, generator)
        hx = F.relu(self.x_fc(x))
        xo = self.x_out(hx)
        # elementwise, so the FLOP count (counts.py) stays the model's
        self.x_scale = (hx.detach().abs()[..., None, :]
                        * self.x_out.weight.detach().abs()).sum(-1) + \
            self.x_out.bias.detach().abs()
        qo = self.q_out(F.relu(self.q_fc(x)))
        n = torch.linalg.vector_norm(qo, dim=-1, keepdim=True)
        return xo, qo / torch.clamp_min(n, 1e-8)


class DeepLIO(nn.Module):
    """``forward(images [B, P, H, W, 2C], imu [B, P, T, 6], imu_mask [B,
    P, T]) -> (x [B, P, 3], q [B, P, 4])``."""

    def __init__(self, spec: Dict):
        super().__init__()
        ls, im, od = spec["lidar"], spec["imu"], spec["odom"]
        self.lidar_feat = LidarFeat(2 * spec["image_channels"],
                                    ls["feature_size"], ls["h_stride"],
                                    ls["w_stride"], ls["el_squeeze"],
                                    ls["pool"], ls["dropout"])
        self.imu_feat = ImuFeat(im["input_size"], im["hidden_size"],
                                im["num_layers"])
        self.fusion = Fusion(ls["feature_size"], im["hidden_size"])
        self.odom_feat = OdomFeat(ls["feature_size"] + im["hidden_size"],
                                  od["hidden_size"], od["num_layers"])
        self.heads = Heads(od["hidden_size"], spec["dropout"])

    def set_precision(self, precision: str) -> "DeepLIO":
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be {'|'.join(PRECISIONS)}")
        for m in self.modules():
            if isinstance(m, Ref):
                m.precision = precision
        return self

    def forward(self, images, imu, imu_mask,
                generator: Optional[torch.Generator] = None):
        b, p = images.shape[:2]
        x = images.flatten(0, 1).permute(0, 3, 1, 2).float().contiguous()
        lidar = self.lidar_feat(x, generator)
        imu_f = self.imu_feat(imu.flatten(0, 1).float(),
                              imu_mask.flatten(0, 1).float())
        feat = self.odom_feat(self.fusion(lidar, imu_f).reshape(b, p, -1))
        xo, qo = self.heads(feat.flatten(0, 1), generator)
        return xo.reshape(b, p, 3), qo.reshape(b, p, 4)


def model_spec(cfg: Dict) -> Dict:
    """The reference's sizes from a configuration file's dictionary (the
    keys and defaults of the repository's YAML files)."""
    ds = cfg["datasets"]
    block = cfg["deeplio"]
    lname = block["lidar-feat-net"]["name"]
    ls = cfg.get(lname, {})
    im = cfg.get(block["imu-feat-net"]["name"], {})
    od = cfg.get(block["odom-feat-net"]["name"], {})
    for name, net in (("imu", im), ("odom", od)):
        if net.get("type", "lstm") != "lstm" or net.get("bidirectional"):
            raise ValueError(f"the reference's {name} net is a "
                             f"one-direction LSTM")
    if block["fusion-net"].get("type", "soft") != "soft":
        raise ValueError("the reference's fusion is soft")
    if ls.get("part", "encoder") != "encoder" or not ls.get("se", True) or \
            ls.get("stem", "classic") != "classic" or \
            ls.get("fire", "classic") != "classic":
        raise ValueError("the reference's PointSeg is the classic-stem, "
                         "classic-Fire encoder with SE")
    return {
        "image_channels": len(ds["channels"]),
        "dropout": float(block.get("dropout", 0.25)),
        "lidar": {"feature_size": int(ls.get("feature-size", 512)),
                  "h_stride": int(ls.get("h-stride", 1)),
                  "w_stride": int(ls.get("w-stride", 2)),
                  "el_squeeze": int(ls.get("el-squeeze", 0)),
                  "pool": str(ls.get("pool", "classic")),
                  "dropout": float(ls.get("dropout", 0.0))},
        "imu": {"input_size": int(im.get("input-size", 6)),
                "hidden_size": int(im.get("hidden-size", 128)),
                "num_layers": int(im.get("num-layers", 2))},
        "odom": {"hidden_size": int(od.get("hidden-size", 256)),
                 "num_layers": int(od.get("num-layers", 2))},
    }


def init_kinds(model: nn.Module) -> Sequence[Tuple[str, str, float]]:
    """(name, kind, scale) for every entry of ``model.state_dict()``:
    ``normal`` (a conv or dense kernel: lecun normal, truncated at two
    sigma, ``scale`` its sigma), ``uniform`` (an LSTM tensor: +-scale),
    ``zero``, ``one``, or ``quat`` (the ``q_out`` bias, the identity
    quaternion)."""
    out = []
    owners = dict(model.named_modules())
    for name, t in model.state_dict().items():
        mod_name, _, leaf = name.rpartition(".")
        mod = owners[mod_name]
        if isinstance(mod, Lstm):
            out.append((name, "uniform", 1.0 / math.sqrt(mod.hidden_size)))
        elif isinstance(mod, BatchNorm):
            kind = "one" if leaf in ("weight", "running_var") else "zero"
            out.append((name, kind, 0.0))
        elif leaf == "weight":
            sigma = math.sqrt(1.0 / t[0].numel()) / .87962566103423978
            out.append((name, "normal", sigma))
        elif name.endswith("heads.q_out.bias"):
            out.append((name, "quat", 0.0))
        else:
            out.append((name, "zero", 0.0))
    return out
