"""6-DoF pose regression losses (counterpart of
``deeplio_tpu/losses/pose.py``).

Two weighting schemes:
  * HWS, fixed weighting:  L = Lx + beta * Lq
  * LWS, learned Kendall-style uncertainty weighting:
        L = Lx * exp(-sx) + sx + Lq * exp(-sq) + sq
    with trainable scalars (sx, sq) optimised jointly with the model, in
    the same optimizer and the same gradient norm.

Translation norm: l1 | l2 (mean over valid pairs). Rotation norm: l1 | l2
on the sign-disambiguated quaternion residual, or "geodesic", the mean
geodesic angle in radians. All math is float32 whatever the model's
compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from deeplio_tpu_torch.config.schema import LossConfig
from deeplio_tpu_torch.utils.spatial import (
    quat_geodesic_angle,
    quat_normalize,
)


def init_loss_params(cfg: LossConfig, device=None
                     ) -> Dict[str, torch.nn.Parameter]:
    """Trainable loss parameters ({} for HWS; sx/sq for LWS)."""
    if cfg.active == "lws":
        return {k: torch.nn.Parameter(torch.tensor(v, dtype=torch.float32,
                                                   device=device))
                for k, v in (("sx", cfg.sx), ("sq", cfg.sq))}
    return {}


def _norm(residual: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-pair norm over the last axis. kind: l1|l2 (l2 is squared)."""
    if kind == "l1":
        return residual.abs().sum(-1)
    if kind == "l2":
        return (residual * residual).sum(-1)
    raise ValueError(f"unknown norm '{kind}'")


def _masked_mean(x: torch.Tensor, valid: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if valid is None:
        return x.mean()
    v = valid.to(x.dtype)
    return (x * v).sum() / torch.clamp_min(v.sum(), 1.0)


def pose_loss(cfg: LossConfig, loss_params: Dict[str, torch.Tensor],
              x_pred: torch.Tensor, q_pred: torch.Tensor,
              x_gt: torch.Tensor, q_gt: torch.Tensor,
              valid: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar loss + metrics. Shapes: x [.., 3], q [.., 4], valid [..]."""
    x_pred = x_pred.float()
    q_pred = quat_normalize(q_pred.float())
    q_gt = quat_normalize(q_gt.float())

    lx = _masked_mean(_norm(x_pred - x_gt, cfg.x_norm), valid)
    if cfg.q_norm == "geodesic":
        lq = _masked_mean(quat_geodesic_angle(q_pred, q_gt), valid)
    else:
        # compare against the hemisphere-matched target
        dot = (q_pred * q_gt).sum(-1, keepdim=True)
        q_tgt = torch.where(dot < 0, -q_gt, q_gt)
        lq = _masked_mean(_norm(q_pred - q_tgt, cfg.q_norm), valid)

    if cfg.active == "hws":
        total = lx + cfg.beta * lq
        metrics = {"loss": total, "loss_x": lx, "loss_q": lq}
    elif cfg.active == "lws":
        sx, sq = loss_params["sx"], loss_params["sq"]
        total = lx * torch.exp(-sx) + sx + lq * torch.exp(-sq) + sq
        metrics = {"loss": total, "loss_x": lx, "loss_q": lq, "sx": sx,
                   "sq": sq}
    else:
        raise ValueError(f"unknown loss '{cfg.active}' (want hws|lws)")
    return total, metrics
