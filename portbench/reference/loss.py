"""Plain PyTorch pose loss and optimizer: the benchmark's reference for
the training step.

The loss is the configurations' LWS loss with squared-L2 norms, in
float32: ``Lx exp(-sx) + sx + Lq exp(-sq) + sq`` with ``Lx`` the mean
over valid pairs of ``|x - x_gt|^2`` and ``Lq`` that of ``|q - q_t|^2``,
``q_t`` the unit target on the prediction's hemisphere. The update is the
gradient clipped by its global norm (scaled by ``c / |g|`` when ``|g| >=
c``, no epsilon), then Adam (betas 0.9, 0.999, eps 1e-8) at the
configuration's learning rate, over the model's parameters and ``sx``,
``sq``. Nothing here imports the system under test.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _unit(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        eps)


def pose_loss(x, q, x_gt, q_gt, sx, sq, valid=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, q = x.float(), _unit(q.float())
    q_gt = _unit(q_gt.float())
    v = (torch.ones(x.shape[:-1], device=x.device) if valid is None
         else valid.float())
    lx = (((x - x_gt) ** 2).sum(-1) * v).sum() / v.sum().clamp_min(1.0)
    q_t = torch.where((q * q_gt).sum(-1, keepdim=True) < 0, -q_gt, q_gt)
    lq = (((q - q_t) ** 2).sum(-1) * v).sum() / v.sum().clamp_min(1.0)
    total = lx * torch.exp(-sx) + sx + lq * torch.exp(-sq) + sq
    return total, {"loss": total, "loss_x": lx, "loss_q": lq}


def clip_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip by the global norm in place; returns the norm before."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    if max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm),
                            max_norm / norm)
        for g in grads:
            g.mul_(scale)
    return norm


class Adam:
    """Adam over ``params``, one step at a time."""

    def __init__(self, params: List[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
