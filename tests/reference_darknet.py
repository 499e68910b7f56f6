"""Plain PyTorch DeepLIO on RangeNet++'s Darknet encoder: the CPU tests'
reference for the port's ``lidar-feat-darknet`` tower
(``deeplio_tpu_torch/models/darknet.py``) and the model around it.

Plain ``torch`` in float32 (a caller on a card turns TF32 off); it
imports neither the port nor JAX. Parameter and buffer names are the
port's state-dict names, so a port model's state dict loads here
(``load_state_dict(..., strict=True)``).

The tower is lidar-bonnetal's ``train/backbones/darknet.py``
(github.com/PRBonn/lidar-bonnetal) with ``darknet53.yaml``'s settings:
a 3x3 stem to 32 channels, five stages of widths 64 to 1024, each a
(1, 2)-strided 3x3 entry and 1, 2, 8, 8, 4 residual units (1x1 to C/2,
3x3 back to C, added), every conv without bias and symmetric padding
(``padding=1``), BatchNorm at momentum 0.01 (``bn_d``), LeakyReLU 0.1,
and ``Dropout2d`` after each stage. Where it departs from lidar-bonnetal:

- BatchNorm has flax's semantics, as every BatchNorm of the port: the
  running variance is updated with the biased batch variance, where
  PyTorch's ``BatchNorm2d`` keeps the unbiased one; epsilon 1e-5;
- the input is DeepLIO's pair stack, the two 5-channel frames of a pair
  concatenated (10 channels), where RangeNet++ takes one 5-channel scan;
- DeepLIO's tail (two (2, 2)-strided 3x3 ConvBNs with SAME padding and
  ReLU, the spatial mean, Dense, ReLU, dropout) replaces RangeNet's
  decoder and segmentation head; then the IMU LSTM, the soft fusion, the
  odometry LSTM and the pose heads;
- dropout (channel dropout in the stages, element dropout after the
  tower's Dense and before the heads) is inverted, as flax's: kept values
  divided by the keep probability, the masks drawn with
  ``torch.bernoulli`` from the generator passed in, in the forward's
  order (stage 1 to 5, the tower's, the heads').

``pose_loss``, ``clip_`` and ``Adam`` are the training step's LWS loss,
global-norm clip and Adam, in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

UNITS = {21: (1, 1, 2, 2, 1), 53: (1, 2, 8, 8, 4)}
WIDTHS = (64, 128, 256, 512, 1024)
SLOPE = 0.1


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted element dropout."""
    if not training or rate <= 0.0:
        return x
    keep = torch.bernoulli(torch.full(x.shape, 1.0 - rate, device=x.device),
                           generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout2d(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted channel dropout on NCHW: one draw a sample and channel."""
    if not training or rate <= 0.0:
        return x
    n, c = x.shape[:2]
    keep = torch.bernoulli(torch.full((n, c, 1, 1), 1.0 - rate,
                                      device=x.device),
                           generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class BatchNorm(nn.BatchNorm2d):
    """Batch mean and biased variance in training, which also update the
    running statistics at momentum 0.01; running statistics in eval."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        with torch.no_grad():
            self.running_mean.mul_(0.99).add_(mean, alpha=0.01)
            self.running_var.mul_(0.99).add_(var, alpha=0.01)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * inv[:, None, None]
                + self.bias[:, None, None])


class Conv(nn.Module):
    """A conv without bias, symmetric padding ``kernel // 2``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride=(1, 1)):
        super().__init__()
        self.stride = tuple(stride)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def forward(self, x):
        return F.conv2d(x, self.weight, None, self.stride,
                        self.weight.shape[-1] // 2)


class ConvBNLeaky(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride)
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        return F.leaky_relu(self.BatchNorm_0(self.Conv_0(x)), SLOPE)


class Residual(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBNLeaky(c, c // 2, 1)
        self.ConvBN_1 = ConvBNLeaky(c // 2, c, 3)

    def forward(self, x):
        return x + self.ConvBN_1(self.ConvBN_0(x))


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


class Darknet(nn.Module):
    def __init__(self, cin: int, layers: int = 53,
                 stage_dropout: float = 0.01):
        super().__init__()
        self.rate, self.n = stage_dropout, len(WIDTHS)
        self.out_channels = WIDTHS[-1]
        self.ConvBN_0 = ConvBNLeaky(cin, 32, 3)
        c = 32
        for i, (w, n) in enumerate(zip(WIDTHS, UNITS[layers])):
            setattr(self, f"Stage_{i}", Stage(c, w, n))
            c = w

    def forward(self, x, generator=None):
        x = self.ConvBN_0(x)
        for i in range(self.n):
            x = dropout2d(getattr(self, f"Stage_{i}")(x), self.rate,
                          self.training, generator)
        return x


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """SAME padding (before, after): the extra one after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConvBN(nn.Module):
    """The tail's SAME 3x3 conv without bias -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, stride=(2, 2)):
        super().__init__()
        self.stride = tuple(stride)
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.BatchNorm_0 = BatchNorm(cout)

    def forward(self, x):
        ph = same_pads(x.shape[-2], 3, self.stride[0])
        pw = same_pads(x.shape[-1], 3, self.stride[1])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = F.conv2d(x, self.Conv_0.weight, None, self.stride)
        return F.relu(self.BatchNorm_0(x))


class LidarDarknet(nn.Module):
    def __init__(self, cin: int, feature_size: int, layers: int,
                 rate: float, stage_dropout: float):
        super().__init__()
        self.rate = rate
        self.darknet = Darknet(cin, layers, stage_dropout)
        self.ConvBN_0 = SameConvBN(self.darknet.out_channels, 256)
        self.ConvBN_1 = SameConvBN(256, 256)
        self.Dense_0 = nn.Linear(256, feature_size)

    def forward(self, x, generator=None):
        f = self.ConvBN_1(self.ConvBN_0(self.darknet(x, generator)))
        f = F.relu(self.Dense_0(f.mean(dim=(-2, -1))))
        return dropout(f, self.rate, self.training, generator)


class Lstm(nn.Module):
    """One masked LSTM layer (gates i, f, g, o): a masked step keeps the
    state."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_ih = nn.Parameter(torch.empty(cin, 4 * hidden))
        self.w_hh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.empty(4 * hidden))

    def forward(self, x, mask):
        b, t, _ = x.shape
        xp = x @ self.w_ih + self.b
        h = xp.new_zeros(b, self.hidden)
        c = xp.new_zeros(b, self.hidden)
        ys = []
        for k in range(t):
            i, f, g, o = (xp[:, k] + h @ self.w_hh).chunk(4, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
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
        mask = x.new_ones(x.shape[:2]) if mask is None else mask
        final = None
        for k in range(self.layers):
            x, final = getattr(self, f"l{k}_fwd")(x, mask)
        return x, final


class _Rnn(nn.Module):
    def __init__(self, cin: int, hidden: int, layers: int):
        super().__init__()
        self.MaskedRNN_0 = MaskedRNN(cin, hidden, layers)


class Fusion(nn.Module):
    def __init__(self, lidar: int, imu: int):
        super().__init__()
        self.gate_lidar = nn.Linear(lidar + imu, lidar)
        self.gate_imu = nn.Linear(lidar + imu, imu)

    def forward(self, lidar, imu):
        both = torch.cat([lidar, imu], -1)
        return torch.cat([lidar * torch.sigmoid(self.gate_lidar(both)),
                          imu * torch.sigmoid(self.gate_imu(both))], -1)


class Heads(nn.Module):
    def __init__(self, cin: int, rate: float):
        super().__init__()
        self.rate = rate
        self.x_fc = nn.Linear(cin, 128)
        self.q_fc = nn.Linear(cin, 128)
        self.x_out = nn.Linear(128, 3)
        self.q_out = nn.Linear(128, 4)

    def forward(self, x, generator=None):
        x = dropout(x, self.rate, self.training, generator)
        xo = self.x_out(F.relu(self.x_fc(x)))
        qo = self.q_out(F.relu(self.q_fc(x)))
        n = torch.linalg.vector_norm(qo, dim=-1, keepdim=True)
        return xo, qo / torch.clamp_min(n, 1e-8)


class DeepLIO(nn.Module):
    """``forward(images [B, P, H, W, 2C], imu [B, P, T, 6], imu_mask [B,
    P, T], generator) -> (x [B, P, 3], q [B, P, 4])`` on the Darknet
    tower; ``imu=False`` builds DeepLO (no IMU net, no fusion)."""

    def __init__(self, image_channels: int = 5, feature_size: int = 512,
                 layers: int = 53, stage_dropout: float = 0.01,
                 lidar_dropout: float = 0.0, dropout: float = 0.25,
                 imu: bool = True, imu_hidden: int = 128,
                 odom_hidden: int = 256):
        super().__init__()
        self.imu = imu
        self.lidar_feat = LidarDarknet(2 * image_channels, feature_size,
                                       layers, lidar_dropout, stage_dropout)
        odom_in = feature_size
        if imu:
            self.imu_feat = _Rnn(6, imu_hidden, 2)
            self.fusion = Fusion(feature_size, imu_hidden)
            odom_in += imu_hidden
        self.odom_feat = _Rnn(odom_in, odom_hidden, 2)
        self.heads = Heads(odom_hidden, dropout)

    def forward(self, images, imu=None, imu_mask=None, generator=None):
        b, p = images.shape[:2]
        dt = self.heads.x_fc.weight.dtype           # float32 (or float64)
        x = images.flatten(0, 1).permute(0, 3, 1, 2).to(dt)
        feat = self.lidar_feat(x, generator)
        if self.imu:
            imu_f = self.imu_feat.MaskedRNN_0(
                imu.flatten(0, 1).to(dt), imu_mask.flatten(0, 1).to(dt))[1]
            feat = self.fusion(feat, imu_f)
        feat = self.odom_feat.MaskedRNN_0(feat.reshape(b, p, -1))[0]
        xo, qo = self.heads(feat.flatten(0, 1), generator)
        return xo.reshape(b, p, 3), qo.reshape(b, p, 4)


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        1e-12)


def pose_loss(x, q, x_gt, q_gt, sx, sq, valid=None):
    """LWS with squared-L2 norms: ``Lx exp(-sx) + sx + Lq exp(-sq) + sq``,
    each term the mean over valid pairs, ``q`` against the unit target on
    its hemisphere."""
    q, q_gt = _unit(q), _unit(q_gt.to(q.dtype))
    v = (torch.ones(x.shape[:-1], dtype=x.dtype) if valid is None
         else valid.to(x.dtype))
    lx = (((x - x_gt) ** 2).sum(-1) * v).sum() / v.sum().clamp_min(1.0)
    q_t = torch.where((q * q_gt).sum(-1, keepdim=True) < 0, -q_gt, q_gt)
    lq = (((q - q_t) ** 2).sum(-1) * v).sum() / v.sum().clamp_min(1.0)
    return lx * torch.exp(-sx) + sx + lq * torch.exp(-sq) + sq


def clip_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale by ``max_norm / |g|`` where the global norm reaches it."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if max_norm > 0 and norm >= max_norm:
        for g in grads:
            g.mul_(max_norm / norm)
    return norm


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8), one step at a time."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr = params, lr
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + 1e-8))


def param_count(model: nn.Module) -> Dict[str, int]:
    """Parameters of the whole model and of its Darknet encoder."""
    return {"all": sum(p.numel() for p in model.parameters()),
            "darknet": sum(p.numel()
                           for p in model.lidar_feat.darknet.parameters())}

