"""PointSeg building blocks (counterpart of ``deeplio_tpu/models/blocks.py``:
``SplitInputConv``, ``ConvBN``, ``SELayer``, ``Fire`` (classic and
fused), ``FactorizedStem``, ``space_to_depth`` and
``space_to_depth_pairs``, ``FireDeconv`` and ``ASPP``, and flax's SAME
max-pool), and the inverted dropout every tower draws its masks with.

Modules take NCHW tensors. Submodules carry the names flax gives the
matching parameters (``Conv_0``, ``BatchNorm_0``, ``Dense_0``...), so
``models/from_flax.py`` maps a flax variable tree onto them path by path.

Convolutions use flax's SAME padding, which is asymmetric for a strided
kernel (the extra row or column goes at the bottom/right); PyTorch's
``padding=`` is symmetric, so :class:`SameConv2d` pads explicitly.
Transposed convolutions follow flax's ``ConvTranspose(padding="SAME")``
(:class:`SameConvTranspose2d`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Pair = Tuple[int, int]
# explicit ((top, bottom), (left, right)) padding of a conv
Pads = Tuple[Pair, Pair]
# a conv's input: one NCHW tensor, or the (a, b) halves of its channels
ConvInput = Union[torch.Tensor, Sequence[torch.Tensor]]


def inverted_dropout(x: torch.Tensor, rate: float, training: bool,
                     generator: Optional[torch.Generator] = None,
                     mask_shape: Optional[Sequence[int]] = None
                     ) -> torch.Tensor:
    """Inverted dropout with flax's arithmetic: one ``torch.bernoulli``
    keep draw for each entry of ``mask_shape`` (``x``'s own shape by
    default; a shape of ones broadcasts a draw over those axes), from
    ``generator``; kept values are divided by the keep probability,
    dropped ones are zero. The identity unless training with a positive
    rate."""
    if not training or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.bernoulli(
        torch.full(tuple(x.shape if mask_shape is None else mask_shape),
                   keep_prob, device=x.device),
        generator=generator).bool()
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _pair(v) -> Pair:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int,
              dilation: int = 1) -> Pair:
    """flax/XLA SAME padding (before, after) along one axis."""
    k = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def same_max_pool(x: torch.Tensor, kernel: Pair, stride: Pair
                  ) -> torch.Tensor:
    """flax's ``nn.max_pool(padding="SAME")`` on NCHW: the padding of
    :func:`same_pads` (the extra row or column at the bottom/right) filled
    with -inf. ``F.max_pool2d``'s own padding is symmetric, so it pads
    here."""
    ph = same_pads(x.shape[-2], kernel[0], stride[0])
    pw = same_pads(x.shape[-1], kernel[1], stride[1])
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's SAME padding for any stride/dilation, or
    an explicit ``((top, bottom), (left, right))`` padding given to
    ``forward``."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(3, 3),
                 stride=(1, 1), dilation=(1, 1), bias: bool = True):
        super().__init__(in_channels, out_channels, _pair(kernel),
                         stride=_pair(stride), dilation=_pair(dilation),
                         padding=0, bias=bias)

    def _conv(self, x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], pads: Optional[Pads]
              ) -> torch.Tensor:
        if pads is None:
            pads = tuple(same_pads(x.shape[-2 + i], self.kernel_size[i],
                                   self.stride[i], self.dilation[i])
                         for i in range(2))
        (pt, pb), (pl, pr) = pads
        if pt == pb and pl == pr:
            return F.conv2d(x, weight, bias, self.stride, (pt, pl),
                            self.dilation)
        x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(x, weight, bias, self.stride, 0, self.dilation)

    def forward(self, x: torch.Tensor,
                pads: Optional[Pads] = None) -> torch.Tensor:
        return self._conv(x, self.weight, self.bias, pads)


class SplitInputConv(SameConv2d):
    """A :class:`SameConv2d` that also takes its input as two tensors
    ``(a, b)``, the halves of its channels: ``conv(cat(a, b), W)`` computed
    as ``conv(a, W[:, :Ca]) + conv(b, W[:, Ca:])``, the weight split along
    its input channels (dim 1 of ``[O, I, kh, kw]``), so the channel
    concat is never built. The parameters are those of ``nn.Conv2d``, so
    a checkpoint of a one-input conv loads unchanged."""

    def forward(self, x: ConvInput,
                pads: Optional[Pads] = None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return super().forward(x, pads)
        a, b = x
        ca = a.shape[1]
        y = (self._conv(a, self.weight[:, :ca], None, pads)
             + self._conv(b, self.weight[:, ca:], None, pads))
        if self.bias is None:
            return y
        return y + self.bias.to(y.dtype)[:, None, None]


def transpose_pads(kernel: int, stride: int) -> Pair:
    """``lax.conv_transpose``'s SAME padding (before, after) of the
    stride-dilated input along one axis."""
    total = kernel + stride - 2
    before = kernel - 1 if stride > kernel - 1 else -(-total // 2)
    return before, total - before


class SameConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing flax's ``ConvTranspose`` with SAME
    padding: output size = input size x stride.

    Flax cross-correlates the stride-dilated input, padded (a, b) as
    :func:`transpose_pads` says, with its kernel ``[kh, kw, I, O]`` as it
    stands; PyTorch's transposed convolution runs the same correlation
    with its ``weight [I, O, kh, kw]`` flipped in both spatial dims and
    ``padding = k - 1 - a`` on each side, plus ``output_padding = b - a``
    at the bottom/right. So ``weight = kernel[::-1, ::-1]`` laid out as
    ``[I, O, kh, kw]`` (``models/from_flax.py`` converts).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 4),
                 stride=(1, 2)):
        kernel, stride = _pair(kernel), _pair(stride)
        pads = [transpose_pads(k, s) for k, s in zip(kernel, stride)]
        for k, s, (a, b) in zip(kernel, stride, pads):
            if a > k - 1 or not 0 <= b - a < s:
                raise ValueError(f"SAME transposed conv kernel {k} stride "
                                 f"{s}: pads ({a}, {b}) have no PyTorch "
                                 f"padding")
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=tuple(k - 1 - a for k, (a, _) in
                                       zip(kernel, pads)),
                         output_padding=tuple(b - a for a, b in pads))


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training semantics.

    In training mode it normalises with the batch mean and the BIASED batch
    variance, as stock BatchNorm does, but updates the running statistics
    with the biased variance too, as flax does (stock BatchNorm updates
    them with the unbiased one): ``ra = (1 - m) * ra + m * stat`` with
    ``m = 0.01`` (flax ``momentum=0.99``). The statistics are taken in
    float32 whatever the activation dtype. Eval mode is stock BatchNorm.

    With a process ``group`` (set by ``models/zoo.py::sync_batchnorm``)
    the statistics are the whole data axis's, as flax's
    ``BatchNorm(axis_name="data")`` computes them: the float32 ``mean(x)``
    and ``mean(x * x)`` over (N, H, W), stacked and averaged over the
    group in one autograd-aware ``all_reduce`` (its backward sums the
    cotangents over the ranks, the transpose of ``pmean``), the variance
    ``max(mu2 - mu * mu, 0)``; ``(x - mu) * (rsqrt(var + eps) * scale) +
    bias`` in float32, cast back to the input's dtype. The running update
    takes the same global statistics, so it stays equal on every rank.
    """

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.01)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is not None:
            return self._group_forward(x)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            self._update_running(mean, var)
        return y

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)

    def _group_forward(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        stats = torch.stack([xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))])
        stats = all_reduce(stats, group=self.group) / dist.get_world_size(
            self.group)
        mean, mu2 = stats[0], stats[1]
        var = (mu2 - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        with torch.no_grad():
            self._update_running(mean, var)
        return y.to(x.dtype)


class ConvBN(nn.Module):
    """SAME conv without bias -> BatchNorm (flax semantics) -> ReLU,
    with flax's epsilon 1e-5. The input is one tensor or the ``(a, b)``
    halves of its channels (:class:`SplitInputConv`); ``pads`` replaces
    SAME by an explicit ``((top, bottom), (left, right))`` padding."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3),
                 strides=(1, 1)):
        super().__init__()
        self.Conv_0 = SplitInputConv(in_channels, features, kernel, strides,
                                     bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, x: ConvInput,
                pads: Optional[Pads] = None) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x, pads)))


class SELayer(nn.Module):
    """Squeeze-and-excitation channel attention (reduction 16)."""

    def __init__(self, channels: int):
        super().__init__()
        hidden = max(channels // 16, 4)
        self.Dense_0 = nn.Linear(channels, hidden)
        self.Dense_1 = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(-2, -1))
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        return x * s[..., None, None]


class Fire(nn.Module):
    """Fire module: strided 1x1 squeeze ConvBN -> parallel 1x1 and 3x3
    expands, concatenated, ReLU (the classic form). ``fused``: one 3x3
    ConvBN at the stage's stride to ``expand1 + expand3`` channels, ReLU
    inside, and nothing else; its parameters are not the classic Fire's,
    so a reference checkpoint does not load into it."""

    def __init__(self, in_channels: int, squeeze: int, expand1: int,
                 expand3: int, strides=(1, 1), fused: bool = False):
        super().__init__()
        self.fused = fused
        if fused:
            self.ConvBN_0 = ConvBN(in_channels, expand1 + expand3, (3, 3),
                                   strides)
            return
        self.ConvBN_0 = ConvBN(in_channels, squeeze, (1, 1), strides)
        self.Conv_0 = SameConv2d(squeeze, expand1, (1, 1))
        self.Conv_1 = SameConv2d(squeeze, expand3, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.ConvBN_0(x)
        if self.fused:
            return s
        return F.relu(torch.cat([self.Conv_0(s), self.Conv_1(s)], dim=1))


class FactorizedStem(nn.Module):
    """The pair stem run per frame: ``conv(cat(a_i, a_j), W) = conv(a_i,
    W[:C]) + conv(a_j, W[C:])``, so one conv from C to 2F channels over
    the S frames of each window (output channels [0, F) the first-frame
    half of the kernel, [F, 2F) the second's), then ``u_i + v_j`` for each
    pair on the conv's (downsampled) grid, then BatchNorm and ReLU. No
    bias under the BatchNorm. The same function as the classic stem on the
    pair stack; the parameters differ in layout (``models/zoo.py::
    factorize_stem_variables`` converts).

    Input: frames [B, S, C, H, W] (a permuted view of NHWC frames works).
    Output: [B * P, F, H', W'] with P = ``len(combos)``, pairs in the
    order given; the parameters do not depend on ``combos``."""

    def __init__(self, channels: int, features: int = 64, kernel=(3, 3),
                 strides=(1, 1)):
        super().__init__()
        self.features = features
        self.Conv_0 = SameConv2d(channels, 2 * features, kernel, strides,
                                 bias=False)
        self.BatchNorm_0 = FlaxBatchNorm2d(features)

    def forward(self, frames: torch.Tensor,
                combos: Sequence[Pair]) -> torch.Tensor:
        b, s = frames.shape[:2]
        y = self.Conv_0(frames.flatten(0, 1))              # [B*S, 2F, h, w]
        y = y.permute(0, 2, 3, 1)                          # NHWC view
        y = y.reshape((b, s) + tuple(y.shape[1:]))
        f = self.features
        u, v = y[..., :f], y[..., f:]
        pre = torch.stack([u[:, i] + v[:, j] for i, j in combos], 1)
        pre = pre.flatten(0, 1).permute(0, 3, 1, 2)        # NCHW view
        return F.relu(self.BatchNorm_0(pre))


def space_to_depth(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H / h, W / w, h * w * C], each (h, w)
    block into channels in the JAX package's order ``(h_i * w + w_i) * C
    + c`` (weights cross between the frameworks on it). ``ValueError``
    where ``h`` or ``w`` does not divide the image."""
    b, H, W, c = x.shape
    if H % h or W % w:
        raise ValueError(f"space_to_depth: {h}x{w} blocks do not tile a "
                         f"{H}x{W} image")
    x = x.reshape(b, H // h, h, W // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, H // h, W // w, h * w * c)


def space_to_depth_pairs(frames: torch.Tensor, combos: Sequence[Pair],
                         h: int, w: int) -> torch.Tensor:
    """Frames [B, S, H, W, C] -> the pairs' space-to-depth stack [B, P, H
    / h, W / w, h * w * 2C], equal bit for bit to ``space_to_depth(cat(
    f_i, f_j), h, w)`` for each pair (i, j) of ``combos``: each frame laid
    out once, the full-resolution pair stack never built."""
    b, s, H, W, c = frames.shape
    fr = space_to_depth(frames.reshape(b * s, H, W, c), h, w)
    fr = fr.reshape(b, s, H // h, W // w, h * w, c)
    return torch.stack([torch.cat([fr[:, i], fr[:, j]], -1).reshape(
        b, H // h, W // w, h * w * 2 * c) for i, j in combos], 1)


class FireDeconv(nn.Module):
    """Decoder Fire that doubles the width: 1x1 squeeze -> ReLU -> (1, 4)
    transposed conv at stride (1, 2) -> ReLU -> parallel 1x1 and 3x3
    expands, concatenated, ReLU. Every conv has a bias; no BatchNorm."""

    def __init__(self, in_channels: int, squeeze: int, expand1: int,
                 expand3: int):
        super().__init__()
        self.Conv_0 = SameConv2d(in_channels, squeeze, (1, 1))
        self.ConvTranspose_0 = SameConvTranspose2d(squeeze, squeeze, (1, 4),
                                                   (1, 2))
        self.Conv_1 = SameConv2d(squeeze, expand1, (1, 1))
        self.Conv_2 = SameConv2d(squeeze, expand3, (3, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.ConvTranspose_0(F.relu(self.Conv_0(x))))
        return F.relu(torch.cat([self.Conv_1(s), self.Conv_2(s)], dim=1))


class ASPP(nn.Module):
    """Atrous pyramid "enlargement layer": a 1x1 and 3x3 branches dilated
    by 1, 2 and 4.

    ``squeeze > 0``: 1x1 squeeze -> branches at the squeeze width,
    concatenated, ReLU -> 1x1 expand -> ReLU. ``squeeze == 0``: full-width
    branches summed, ReLU.
    """

    RATES = (1, 2, 4)

    def __init__(self, in_channels: int, features: int, squeeze: int = 0):
        super().__init__()
        self.squeeze_width = squeeze
        width = squeeze if squeeze > 0 else features
        src = squeeze if squeeze > 0 else in_channels
        if squeeze > 0:
            self.squeeze = SameConv2d(in_channels, squeeze, (1, 1))
        self.Conv_0 = SameConv2d(src, width, (1, 1))
        for i, r in enumerate(self.RATES):
            setattr(self, f"Conv_{i + 1}",
                    SameConv2d(src, width, (3, 3), dilation=(r, r)))
        self.n_branches = 1 + len(self.RATES)
        if squeeze > 0:
            self.expand = SameConv2d(squeeze * self.n_branches, features,
                                     (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"Conv_{i}") for i in range(self.n_branches)]
        if self.squeeze_width > 0:
            s = F.relu(self.squeeze(x))
            y = F.relu(torch.cat([conv(s) for conv in branches], dim=1))
            return F.relu(self.expand(y))
        out = branches[0](x)
        for conv in branches[1:]:
            out = out + conv(x)
        return F.relu(out)
