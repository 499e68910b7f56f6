"""Feature nets of the model zoo (counterpart of
``deeplio_tpu/models/feat_nets.py``: ``LidarPointSegFeat``,
``LidarSimpleFeat0``, ``LidarSimpleFeat1``, ``ImuFeatRnn``, ``ImuFeatFC``,
``FusionLayer``, ``OdomFeatRNN``, ``OdomFeatFC``, ``PoseHeads``; and the
port's own ``LidarDarknetFeat`` and ``LidarRangeViTFeat``, which the JAX
package does not have).

Dropout (the LiDAR towers after their Dense, ``PoseHeads`` before its
layers) acts in training mode only, draws its masks from the generator
the caller passes, and scales what it keeps by 1 / (1 - rate), as flax's
``nn.Dropout`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deeplio_tpu_torch.models.blocks import ConvBN, ConvInput, inverted_dropout
from deeplio_tpu_torch.models.darknet import DarknetBackbone
from deeplio_tpu_torch.models.pointseg import PointSegNet
from deeplio_tpu_torch.models.rangevit import RangeViT
from deeplio_tpu_torch.ops.rnn import MaskedRNN


class _PointSegTail(nn.Module):
    """PointSeg's tail, which every deep tower ends in: two (2, 2)-strided
    3x3 ConvBNs to 256 channels, spatial mean, Dense to ``feature_size``,
    ReLU, dropout -> [B, F]. A tower registers it after its backbone
    (:meth:`_tail_init`), so its parameters follow the backbone's."""

    def _tail_init(self, width: int, feature_size: int,
                   dropout: float) -> None:
        self.dropout = dropout
        self.ConvBN_0 = ConvBN(width, 256, (3, 3), (2, 2))
        self.ConvBN_1 = ConvBN(256, 256, (3, 3), (2, 2))
        self.Dense_0 = nn.Linear(256, feature_size)

    def _tail(self, feat: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        feat = self.ConvBN_1(self.ConvBN_0(feat))
        feat = F.relu(self.Dense_0(feat.mean(dim=(-2, -1))))
        return inverted_dropout(feat, self.dropout, self.training, generator)


class LidarPointSegFeat(_PointSegTail):
    """PointSeg over pair-stacked images [B, 2C, H, W] (or, for the
    ``pair-split`` stem, the pair's two [B, C, H, W] frames; for the
    ``factorized`` stem the frames [B, S, C, H, W] and the pairs'
    ``combos``), then PointSeg's tail -> [B * P, F]. ``part="encoder"``
    reads the bottleneck map (512 channels), ``"encoder+decoder"`` the
    decoder's per-pixel map (64 channels, at the stem's resolution).
    ``in_channels`` is the pair stack's width 2C for every stem."""

    def __init__(self, in_channels: int, feature_size: int = 512,
                 h_stride: int = 1, w_stride: int = 2, se: bool = True,
                 el_squeeze: int = 0, dropout: float = 0.0,
                 pool: str = "stride", part: str = "encoder",
                 stem: str = "classic", fire: str = "classic"):
        super().__init__()
        self.pointseg = PointSegNet(in_channels, part=part,
                                    h_stride=h_stride, w_stride=w_stride,
                                    with_se=se, el_squeeze=el_squeeze,
                                    pool=pool, stem=stem, fire=fire)
        self._tail_init(512 if part == "encoder" else 64, feature_size,
                        dropout)

    def forward(self, x: ConvInput,
                generator: Optional[torch.Generator] = None,
                combos: Tuple[Tuple[int, int], ...] = ()) -> torch.Tensor:
        return self._tail(self.pointseg(x, combos), generator)


class LidarDarknetFeat(_PointSegTail):
    """RangeNet++'s Darknet encoder (``models/darknet.py``) over
    pair-stacked images [B, 2C, H, W], then PointSeg's tail -> [B * P,
    F]. The masks are drawn in the forward's order: the five stages'
    channel dropout, then the tower's."""

    def __init__(self, in_channels: int, feature_size: int = 512,
                 layers: int = 53, dropout: float = 0.0,
                 stage_dropout: float = 0.01):
        super().__init__()
        self.darknet = DarknetBackbone(in_channels, layers, stage_dropout)
        self._tail_init(self.darknet.out_channels, feature_size, dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._tail(self.darknet(x, generator), generator)


class LidarRangeViTFeat(_PointSegTail):
    """RangeViT's convolutional stem and ViT encoder
    (``models/rangevit.py``) over pair-stacked images [B, 2C, H, W], its
    tokens laid out as a [B, D, H / ph, W / pw] map, then PointSeg's tail
    -> [B * P, F]. The masks are drawn in the forward's order: the
    blocks' drop-path, then the tower's dropout."""

    def __init__(self, in_channels: int, image: Tuple[int, int],
                 feature_size: int = 512, dropout: float = 0.0, **vit):
        super().__init__()
        self.rangevit = RangeViT(in_channels, image, **vit)
        self._tail_init(self.rangevit.out_channels, feature_size, dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._tail(self.rangevit(x, generator), generator)


def _tower_head(tower: nn.Module, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """A simple tower's tail: spatial mean -> Dense -> ReLU -> dropout."""
    x = F.relu(tower.Dense_0(x.mean(dim=(-2, -1))))
    return inverted_dropout(x, tower.dropout, tower.training, generator)


class LidarSimpleFeat0(nn.Module):
    """Plain strided ConvBN tower (the reference's simple variant 0): five
    ConvBNs, widths ``base_channels * 2**i`` up to 256, kernels (3, 7),
    (3, 5) at stride (1, 2), then three 3x3 at (2, 2) -> [B, F]."""

    SPEC = (((3, 7), (1, 2)), ((3, 5), (1, 2)), ((3, 3), (2, 2)),
            ((3, 3), (2, 2)), ((3, 3), (2, 2)))

    def __init__(self, in_channels: int, feature_size: int = 256,
                 base_channels: int = 32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        c = in_channels
        for i, (k, s) in enumerate(self.SPEC):
            ch = min(base_channels * 2 ** i, 256)
            setattr(self, f"ConvBN_{i}", ConvBN(c, ch, k, s))
            c = ch
        self.Dense_0 = nn.Linear(c, feature_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(len(self.SPEC)):
            x = getattr(self, f"ConvBN_{i}")(x)
        return _tower_head(self, x, generator)


class LidarSimpleFeat1(nn.Module):
    """Deeper simple tower (variant 1): four stages, each a strided 3x3
    ConvBN ((1, 2) twice, then (2, 2)) and a residual 3x3 ConvBN, widths
    ``base_channels * 2**i`` up to 256 -> [B, F]."""

    STAGES = 4

    def __init__(self, in_channels: int, feature_size: int = 256,
                 base_channels: int = 32, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        c = in_channels
        for i in range(self.STAGES):
            ch = min(base_channels * 2 ** i, 256)
            setattr(self, f"ConvBN_{2 * i}",
                    ConvBN(c, ch, (3, 3), (1, 2) if i < 2 else (2, 2)))
            setattr(self, f"ConvBN_{2 * i + 1}", ConvBN(ch, ch, (3, 3)))
            c = ch
        self.Dense_0 = nn.Linear(c, feature_size)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.STAGES):
            x = getattr(self, f"ConvBN_{2 * i}")(x)
            x = x + getattr(self, f"ConvBN_{2 * i + 1}")(x)
        return _tower_head(self, x, generator)


class ImuFeatRnn(nn.Module):
    """Masked LSTM or GRU over each pair's padded IMU window -> final
    hidden, both directions' when bidirectional."""

    def __init__(self, input_size: int = 6, hidden_size: int = 128,
                 num_layers: int = 2, cell: str = "lstm",
                 bidirectional: bool = False):
        super().__init__()
        self.MaskedRNN_0 = MaskedRNN(input_size, hidden_size, num_layers,
                                     cell, bidirectional)

    def forward(self, imu: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """imu [B, T, 6], mask [B, T] -> [B, H * dirs]."""
        return self.MaskedRNN_0(imu, mask)[1]


class ImuFeatFC(nn.Module):
    """The IMU window with its masked samples zeroed, flattened, through
    ``num_layers`` Dense + ReLU: [B, T, 6], [B, T] -> [B, H]."""

    def __init__(self, window: int, input_size: int = 6,
                 hidden_size: int = 128, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            setattr(self, f"Dense_{k}", nn.Linear(
                window * input_size if k == 0 else hidden_size, hidden_size))

    def forward(self, imu: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = (imu * mask[..., None]).flatten(1)
        for k in range(self.num_layers):
            x = F.relu(getattr(self, f"Dense_{k}")(x))
        return x


class FusionLayer(nn.Module):
    """hard: concat(lidar, imu). soft: each modality gated by a learned
    sigmoid mask computed from both, then concatenated."""

    def __init__(self, lidar_size: int, imu_size: int, kind: str = "soft"):
        super().__init__()
        if kind not in ("soft", "hard"):
            raise ValueError(f"fusion kind must be soft|hard, got {kind!r}")
        self.kind = kind
        if kind == "soft":
            self.gate_lidar = nn.Linear(lidar_size + imu_size, lidar_size)
            self.gate_imu = nn.Linear(lidar_size + imu_size, imu_size)

    def forward(self, lidar: torch.Tensor, imu: torch.Tensor) -> torch.Tensor:
        both = torch.cat([lidar, imu], dim=-1)
        if self.kind == "hard":
            return both
        gl = torch.sigmoid(self.gate_lidar(both))
        gi = torch.sigmoid(self.gate_imu(both))
        return torch.cat([lidar * gl, imu * gi], dim=-1)


class OdomFeatRNN(nn.Module):
    """LSTM or GRU over the window's pair sequence: [B, P, F] -> [B, P,
    H]."""

    def __init__(self, input_size: int, hidden_size: int = 256,
                 num_layers: int = 2, cell: str = "lstm"):
        super().__init__()
        self.MaskedRNN_0 = MaskedRNN(input_size, hidden_size, num_layers,
                                     cell)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MaskedRNN_0(x, None)[0]


class OdomFeatFC(nn.Module):
    """Per pair, ``num_layers`` Dense + ReLU, no recurrence: [B, P, F] ->
    [B, P, H]."""

    def __init__(self, input_size: int, hidden_size: int = 256,
                 num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            setattr(self, f"Dense_{k}", nn.Linear(
                input_size if k == 0 else hidden_size, hidden_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_layers):
            x = F.relu(getattr(self, f"Dense_{k}")(x))
        return x


class PoseHeads(nn.Module):
    """Dropout, then twin heads: translation R^3 and a unit quaternion R^4.

    The hidden layers run in the compute dtype; the output layers run in
    float32 outside any autocast region, as in the JAX package. The
    ``q_out`` bias starts at [1, 0, 0, 0] (identity rotation)."""

    def __init__(self, in_features: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        hidden = 128
        self.x_fc = nn.Linear(in_features, hidden)
        self.q_fc = nn.Linear(in_features, hidden)
        self.x_out = nn.Linear(hidden, 3)
        self.q_out = nn.Linear(hidden, 4)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = inverted_dropout(x, self.dropout, self.training, generator)
        hx = F.relu(self.x_fc(x))
        hq = F.relu(self.q_fc(x))
        with torch.autocast(x.device.type, enabled=False):
            x_out = self.x_out(hx.float())
            q_raw = self.q_out(hq.float())
        norm = torch.linalg.vector_norm(q_raw, dim=-1, keepdim=True)
        return x_out, q_raw / torch.clamp_min(norm, 1e-8)
