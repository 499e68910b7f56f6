"""The model zoo and its factory (counterpart of
``deeplio_tpu/models/zoo.py``: ``DeepIO``, ``DeepLO``, ``DeepLIO`` with
every IMU and odometry net (LSTM, GRU, bidirectional, FC), every stem's
path of ``_lidar_features``, ``build_model`` and
``factorize_stem_variables``; ``sync_batchnorm`` is the counterpart of
``init_model(axis_name="data")``). The LiDAR archs also take the port's
own ``lidar-feat-darknet`` (``models/darknet.py``) and
``lidar-feat-rangevit`` (``models/rangevit.py``) towers, which the JAX
package does not have.

Forward contract, as in the JAX package::

    model(batch) -> (x_pred [B, P, 3], q_pred [B, P, 4])

with ``batch`` holding, for the LiDAR archs (DeepLO, DeepLIO), ``images``
[B, P, H, W, 2C] (NHWC pair stacks); under ``stem: pair-split`` the
frame-i and frame-j stacks ``images`` and ``images2`` [B, P, H, W, C];
under ``s2d-pre`` ``images`` [B, P, H / h, W / w, h * w * 2C]
(``blocks.py::space_to_depth_pairs``); under ``factorized`` the window's
``frames`` [B, S, H, W, C], paired by the model's ``combos`` (the
config's effective combinations, or the ``combos`` passed to
``forward``); and ``imu`` [B, P, T, 6] and ``imu_mask`` [B, P, T] for the
IMU archs (DeepIO, DeepLIO).

Layout: the images stay NHWC in memory. The tower sees them through a
permuted view, NCHW by shape and channels-last by strides, so cuDNN runs
its NHWC convolutions on the card with no copy.

Modes: ``build_model`` returns the model in eval mode (running BatchNorm
statistics, no dropout); ``model.train()`` switches BatchNorm to batch
statistics with the flax update of the running ones and turns dropout on,
with masks drawn from the generator passed to ``forward``.

Precision: ``compute_dtype`` bfloat16 (or float16) runs the body under
``torch.autocast`` with float32 parameters, as flax's ``dtype`` does; the
pose output layers stay float32. The reduced-precision path is meant for
the card: PyTorch's CPU autocast (2.13) gives run-to-run different results
for some small strided bfloat16 convolutions, so CPU runs use float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplio_tpu_torch.config.schema import Config, ModelConfig
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.models.blocks import FlaxBatchNorm2d
from deeplio_tpu_torch.models.feat_nets import (
    FusionLayer,
    ImuFeatFC,
    ImuFeatRnn,
    LidarDarknetFeat,
    LidarPointSegFeat,
    LidarRangeViTFeat,
    LidarSimpleFeat0,
    LidarSimpleFeat1,
    OdomFeatFC,
    OdomFeatRNN,
    PoseHeads,
)
from deeplio_tpu_torch.models.rangevit import RangeViT
from deeplio_tpu_torch.ops.rnn import GruCellScan, LstmCellScan
from deeplio_tpu_torch.utils.timing import span

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


Combos = Tuple[Tuple[int, int], ...]


def _lidar_net(cfg: ModelConfig, image_channels: int,
               image: Tuple[int, int]) -> nn.Module:
    """The LiDAR tower a config names, over pair-stacked images (or their
    frames, for the factorized stem) of ``image`` (H, W)."""
    lc = cfg.lidar
    if lc.name == "lidar-feat-pointseg":
        return LidarPointSegFeat(
            2 * image_channels, lc.feature_size, lc.h_stride, lc.w_stride,
            lc.se, lc.el_squeeze, lc.dropout, lc.pool, lc.part, lc.stem,
            lc.fire)
    if lc.name == "lidar-feat-darknet":
        return LidarDarknetFeat(2 * image_channels, lc.feature_size,
                                lc.layers, lc.dropout, lc.stage_dropout)
    if lc.name == "lidar-feat-rangevit":
        return LidarRangeViTFeat(
            2 * image_channels, image, lc.feature_size, lc.dropout,
            embed_dim=lc.embed_dim, depth=lc.depth, heads=lc.heads,
            mlp_ratio=lc.mlp_ratio, patch=lc.patch,
            stem_width=lc.stem_width, stem_hidden=lc.stem_hidden,
            drop_path=lc.drop_path)
    simple = {"lidar-feat-simple-0": LidarSimpleFeat0,
              "lidar-feat-simple-1": LidarSimpleFeat1}.get(lc.name)
    if simple is None:
        raise ValueError(f"unknown lidar feat net {lc.name!r}")
    return simple(2 * image_channels, lc.feature_size, lc.base_channels,
                  lc.dropout)


def _imu_net(cfg: ModelConfig, window: int) -> nn.Module:
    """The IMU net a config names, over windows of ``window`` samples."""
    ic = cfg.imu
    if ic.name == "imu-feat-fc":
        return ImuFeatFC(window, ic.input_size, ic.hidden_size,
                         ic.num_layers)
    return ImuFeatRnn(ic.input_size, ic.hidden_size, ic.num_layers,
                      ic.rnn_type, ic.bidirectional)


class _Odometry(nn.Module):
    """What the three archs share: the compute dtype, the odometry RNN
    over the window's pairs and the pose heads (registered last, after
    the feature nets, in the JAX package's order)."""

    # the LiDAR archs' stem (``pair-split``: the tower takes each pair's
    # two frames apart, ``images`` and ``images2``; ``factorized``: the
    # window's ``frames``, paired by ``combos``)
    stem = "classic"
    combos: Combos = ()

    def _tail(self, cfg: ModelConfig, feature_size: int) -> None:
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        oc = cfg.odom
        if oc.name == "odom-feat-fc":
            self.odom_feat = OdomFeatFC(feature_size, oc.hidden_size,
                                        oc.num_layers)
        else:
            self.odom_feat = OdomFeatRNN(feature_size, oc.hidden_size,
                                         oc.num_layers, oc.rnn_type)
        self.heads = PoseHeads(oc.hidden_size, cfg.dropout)

    def _autocast(self, device: torch.device):
        low = self.compute_dtype != torch.float32
        return torch.autocast(device.type, dtype=self.compute_dtype,
                              enabled=low)

    def _lidar_init(self, cfg: ModelConfig, image_channels: int,
                    combos: Combos, image: Tuple[int, int]) -> None:
        self.lidar_feat = _lidar_net(cfg, image_channels, image)
        self.stem = cfg.lidar.stem
        self.combos = tuple(tuple(c) for c in combos)

    def _pairs(self, batch: Dict[str, torch.Tensor],
               combos: Optional[Combos]) -> Tuple[int, int]:
        """(windows B, pairs P) of a LiDAR batch."""
        if self.stem == "factorized":
            return (batch["frames"].shape[0],
                    len(self.combos if combos is None else combos))
        return tuple(batch["images"].shape[:2])

    def _lidar(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator],
               combos: Optional[Combos] = None) -> torch.Tensor:
        """The LiDAR tower on the pair images: [B * P, F]. Under
        ``pair-split`` the stem takes the two frames of each pair apart;
        under ``factorized`` it takes the window's frames [B, S, C, H, W]
        (a permuted view) and pairs them by ``combos`` (default the
        model's). Runs under the span ``model.lidar``, inside the step's
        or the tick's model span."""
        with span("model.lidar"):
            if self.stem == "factorized":
                return self.lidar_feat(
                    batch["frames"].permute(0, 1, 4, 2, 3), generator,
                    self.combos if combos is None else combos)

            def nchw(key):                                    # NCHW view
                return batch[key].flatten(0, 1).permute(0, 3, 1, 2)

            x = nchw("images")
            if self.stem == "pair-split":
                x = (x, nchw("images2"))
            return self.lidar_feat(x, generator)

    def _imu(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The IMU encoder on each pair's window: [B * P, H]."""
        return self.imu_feat(batch["imu"].flatten(0, 1),
                             batch["imu_mask"].flatten(0, 1))

    def _pose(self, feat: torch.Tensor, b: int, p: int,
              generator: Optional[torch.Generator]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.odom_feat(feat.reshape(b, p, -1))
        x_out, q_out = self.heads(feat.flatten(0, 1), generator)
        return x_out.reshape(b, p, 3), q_out.reshape(b, p, 4)


class DeepIO(_Odometry):
    """IMU-only: imu-feat -> odom-feat -> pose heads."""

    def __init__(self, cfg: ModelConfig, image_channels: int = 0,
                 imu_window: int = 16, combos: Combos = (),
                 image: Tuple[int, int] = (64, 1024)):
        super().__init__()
        self.imu_feat = _imu_net(cfg, imu_window)
        self._tail(cfg, cfg.imu.feature_size)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, p = batch["imu"].shape[:2]
        with self._autocast(batch["imu"].device):
            return self._pose(self._imu(batch), b, p, generator)


class DeepLO(_Odometry):
    """LiDAR-only: lidar-feat -> odom-feat -> pose heads."""

    def __init__(self, cfg: ModelConfig, image_channels: int,
                 imu_window: int = 16, combos: Combos = (),
                 image: Tuple[int, int] = (64, 1024)):
        super().__init__()
        self._lidar_init(cfg, image_channels, combos, image)
        self._tail(cfg, cfg.lidar.feature_size)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                combos: Optional[Combos] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, p = self._pairs(batch, combos)
        key = "frames" if self.stem == "factorized" else "images"
        with self._autocast(batch[key].device):
            return self._pose(self._lidar(batch, generator, combos), b, p,
                              generator)


class DeepLIO(_Odometry):
    """lidar-feat (+) imu-feat -> fusion -> odom-feat -> pose heads."""

    def __init__(self, cfg: ModelConfig, image_channels: int,
                 imu_window: int = 16, combos: Combos = (),
                 image: Tuple[int, int] = (64, 1024)):
        super().__init__()
        lc, ic = cfg.lidar, cfg.imu
        self._lidar_init(cfg, image_channels, combos, image)
        self.imu_feat = _imu_net(cfg, imu_window)
        self.fusion = FusionLayer(lc.feature_size, ic.feature_size,
                                  cfg.fusion.kind)
        self._tail(cfg, lc.feature_size + ic.feature_size)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None,
                combos: Optional[Combos] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, p = self._pairs(batch, combos)
        with self._autocast(batch["imu"].device):
            lidar = self._lidar(batch, generator, combos)
            fused = self.fusion(lidar, self._imu(batch))
            return self._pose(fused, b, p, generator)


ARCHS = {"deepio": DeepIO, "deeplo": DeepLO, "deeplio": DeepLIO}


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded from-scratch init in flax's families: lecun-normal kernels
    (truncated at two sigma), zero biases, unit BatchNorm, LSTM and GRU
    uniform +-1/sqrt(H), and the ``q_out`` bias at the identity
    quaternion. The FC nets' Dense layers are Linears: flax's Dense init
    too. A RangeViT encoder's position embedding, class token, Linears and
    LayerNorms then take timm's ViT init (``RangeViT.reset_parameters``)."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                # a transposed conv's weight is [I, O, kh, kw]; flax's
                # kernel [kh, kw, I, O] has fan-in kh * kw * I
                fan_in = (mod.weight[:, 0].numel()
                          if isinstance(mod, nn.ConvTranspose2d)
                          else mod.weight[0].numel())
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()
            elif isinstance(mod, (LstmCellScan, GruCellScan)):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for prm in mod.parameters():
                    nn.init.uniform_(prm, -k, k, generator=generator)
            if name.endswith("heads.q_out"):
                mod.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
    for mod in model.modules():
        if isinstance(mod, RangeViT):
            mod.reset_parameters(generator)


def build_model(cfg: Config, device: DeviceLike = None,
                seed: Optional[int] = 0) -> nn.Module:
    """Config -> the arch's model (DeepIO, DeepLO or DeepLIO) in eval mode
    on ``device`` (CUDA by default).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same values on every device); ``seed=None`` leaves them
    uninitialised for a caller that loads a checkpoint."""
    dev = resolve_device(device)
    proj = cfg.datasets.projection
    model = ARCHS[cfg.model.arch](cfg.model,
                                  cfg.datasets.num_image_channels,
                                  cfg.datasets.max_imu_per_pair,
                                  cfg.datasets.effective_combinations,
                                  (proj.height, proj.width))
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def sync_batchnorm(model: nn.Module, group) -> nn.Module:
    """Hand every ``FlaxBatchNorm2d`` of ``model`` the process group whose
    ranks share its batch statistics (``None`` takes them back to one
    rank's): the counterpart of building the JAX model with
    ``axis_name="data"``, and of ``nn.SyncBatchNorm.convert_sync_batchnorm``
    for the port's own BatchNorm. Returns ``model``."""
    for mod in model.modules():
        if isinstance(mod, FlaxBatchNorm2d):
            mod.group = group
    return model


def factorize_stem_variables(variables: Dict[str, Any],
                             channels_per_frame: int) -> Dict[str, Any]:
    """Flax-layout variables of a classic-stem PointSeg -> the
    ``factorized`` stem's layout (the JAX package's function, on numpy
    trees such as ``from_flax.to_flax_variables`` gives and
    ``import_torch.import_state_dict`` returns).

    Every ``encoder`` holding a ``ConvBN_0`` gets ``FactorizedStem_0`` in
    its place: the classic kernel [kh, kw, 2C, F] splits by input-channel
    half into [kh, kw, C, 2F] (the first half to output channels [0, F),
    the second to [F, 2F)); a bias ``b`` becomes ``concat([b, 0])``, so
    the pair sum adds it once; the BatchNorm's parameters and statistics
    move as they are. ``ValueError`` when the kernel does not have 2C
    input channels."""
    def rewrite(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for k, v in tree.items():
            if k == "encoder" and isinstance(v, dict) and "ConvBN_0" in v:
                enc = dict(v)
                stem = enc.pop("ConvBN_0")
                fs = {}
                if "Conv_0" in stem:
                    conv = dict(stem["Conv_0"])
                    kern = np.asarray(conv["kernel"])
                    c = channels_per_frame
                    if kern.shape[2] != 2 * c:
                        raise ValueError(
                            f"stem kernel has {kern.shape[2]} input "
                            f"channels, expected 2*{c}")
                    conv["kernel"] = np.concatenate(
                        [kern[:, :, :c], kern[:, :, c:]], axis=-1)
                    if "bias" in conv:
                        b = np.asarray(conv["bias"])
                        conv["bias"] = np.concatenate([b, np.zeros_like(b)])
                    fs["Conv_0"] = conv
                if "BatchNorm_0" in stem:
                    fs["BatchNorm_0"] = stem["BatchNorm_0"]
                enc["FactorizedStem_0"] = fs
                out[k] = {kk: rewrite(vv) for kk, vv in enc.items()}
            else:
                out[k] = rewrite(v)
        return out

    return rewrite(dict(variables))
