"""DeepLIO and its factory (counterpart of ``deeplio_tpu/models/zoo.py``:
``DeepLIO``, the classic-stem path of ``_lidar_features`` and
``build_model``).

Forward contract, as in the JAX package::

    model(batch) -> (x_pred [B, P, 3], q_pred [B, P, 4])

with ``batch`` holding ``images`` [B, P, H, W, 2C] (NHWC pair stacks),
``imu`` [B, P, T, 6] and ``imu_mask`` [B, P, T].

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
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from deeplio_tpu_torch.config.schema import Config, ModelConfig
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.models.feat_nets import (
    FusionLayer,
    ImuFeatRnn,
    LidarPointSegFeat,
    OdomFeatRNN,
    PoseHeads,
)
from deeplio_tpu_torch.ops.rnn import LstmCellScan

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


class DeepLIO(nn.Module):
    """lidar-feat (+) imu-feat -> fusion -> odom-feat -> pose heads."""

    def __init__(self, cfg: ModelConfig, image_channels: int):
        super().__init__()
        lc, ic, oc = cfg.lidar, cfg.imu, cfg.odom
        self.compute_dtype = DTYPES[cfg.compute_dtype]
        self.lidar_feat = LidarPointSegFeat(
            2 * image_channels, lc.feature_size, lc.h_stride, lc.w_stride,
            lc.se, lc.el_squeeze, lc.dropout)
        self.imu_feat = ImuFeatRnn(ic.input_size, ic.hidden_size,
                                   ic.num_layers)
        self.fusion = FusionLayer(lc.feature_size, ic.hidden_size,
                                  cfg.fusion.kind)
        self.odom_feat = OdomFeatRNN(lc.feature_size + ic.hidden_size,
                                     oc.hidden_size, oc.num_layers)
        self.heads = PoseHeads(oc.hidden_size, cfg.dropout)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        imgs = batch["images"]
        b, p = imgs.shape[0], imgs.shape[1]
        x = imgs.flatten(0, 1).permute(0, 3, 1, 2)     # NCHW view of NHWC
        imu = batch["imu"].flatten(0, 1)
        mask = batch["imu_mask"].flatten(0, 1)
        low = self.compute_dtype != torch.float32
        with torch.autocast(x.device.type, dtype=self.compute_dtype,
                            enabled=low):
            lidar = self.lidar_feat(x, generator)
            imu_f = self.imu_feat(imu, mask)
            fused = self.fusion(lidar, imu_f).reshape(b, p, -1)
            feat = self.odom_feat(fused)
            x_out, q_out = self.heads(feat.flatten(0, 1), generator)
        return x_out.reshape(b, p, 3), q_out.reshape(b, p, 4)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded from-scratch init in flax's families: lecun-normal kernels
    (truncated at two sigma), zero biases, unit BatchNorm, LSTM uniform
    +-1/sqrt(H), and the ``q_out`` bias at the identity quaternion."""
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
            elif isinstance(mod, LstmCellScan):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for prm in (mod.w_ih, mod.w_hh, mod.b):
                    nn.init.uniform_(prm, -k, k, generator=generator)
            if name.endswith("heads.q_out"):
                mod.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))


def build_model(cfg: Config, device: DeviceLike = None,
                seed: Optional[int] = 0) -> DeepLIO:
    """Config -> DeepLIO in eval mode on ``device`` (CUDA by default).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (the same values on every device); ``seed=None`` leaves them
    uninitialised for a caller that loads a checkpoint."""
    dev = resolve_device(device)
    model = DeepLIO(cfg.model, cfg.datasets.num_image_channels)
    if seed is not None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
