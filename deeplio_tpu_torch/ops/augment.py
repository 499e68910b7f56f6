"""Device-side training augmentation (counterpart of
``deeplio_tpu/ops/augment.py::yaw_augment``).

Global yaw rotation: every frame of a window is rotated by one random yaw
phi. Rotating the body points by Rz(phi) re-mounts the sensor, so the
relative pose between frames conjugates (dx' = Rz dx, dq' = qz dq qz^-1)
and the body-frame IMU vectors rotate too (a' = Rz a, w' = Rz w): the
supervision stays exactly consistent.

The JAX function draws phi and rotates in one; here the deterministic
rotation (``yaw_rotate``) and the draw (``draw_yaw``, from an explicit
``torch.Generator``) are apart, so a test can hand both packages the same
angles.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from deeplio_tpu_torch.utils.spatial import quat_multiply

Batch = Dict[str, torch.Tensor]


def draw_yaw(generator: torch.Generator, b: int,
             device: torch.device) -> torch.Tensor:
    """One yaw angle per window, uniform in [-pi, pi), float32 [b]."""
    u = torch.rand(b, generator=generator, device=device)
    return u * (2 * math.pi) - math.pi


def _rot_xy(v: torch.Tensor, c: torch.Tensor, s: torch.Tensor
            ) -> torch.Tensor:
    """Rotate the first two components of [..., 3] vectors about z."""
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1], v[..., 2]], -1)


def yaw_rotate(raw: Batch, phi: torch.Tensor) -> Batch:
    """Rotate one window's points, ground truth and IMU by its yaw phi [B].

    ``raw`` is the training step's batch: points as planes
    ``points_x/points_y`` [B*S, N] (when present: DeepIO's batches have
    none; z and remission pass through), ``x_gt``
    [B, P, 3], ``q_gt`` [B, P, 4] and ``imu`` [B, P, T, 6] (when present).
    Returns a new dict; the inputs are not modified.
    """
    out = dict(raw)
    b = raw["x_gt"].shape[0]
    c, s = torch.cos(phi), torch.sin(phi)

    if "points_x" in raw:
        x, y = raw["points_x"], raw["points_y"]
        rep = x.shape[0] // b              # frames per window
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        cp = c.repeat_interleave(rep).reshape(shape)
        sp = s.repeat_interleave(rep).reshape(shape)
        out["points_x"] = cp * x - sp * y
        out["points_y"] = sp * x + cp * y

    out["x_gt"] = _rot_xy(raw["x_gt"], c[:, None], s[:, None])

    half = phi / 2.0
    zero = torch.zeros_like(half)
    qz = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], -1)
    qz = qz[:, None, :]                    # broadcast over pairs
    qz_inv = qz * qz.new_tensor([1.0, -1.0, -1.0, -1.0])
    out["q_gt"] = quat_multiply(quat_multiply(qz, raw["q_gt"]), qz_inv)

    if "imu" in raw:
        imu = raw["imu"]                   # body frame (ax,ay,az,wx,wy,wz)
        ci, si = c[:, None, None], s[:, None, None]
        out["imu"] = torch.cat([_rot_xy(imu[..., :3], ci, si),
                                _rot_xy(imu[..., 3:], ci, si)], -1)
    return out


def yaw_augment(raw: Batch, generator: torch.Generator) -> Batch:
    """Draw one yaw per window from ``generator`` and apply it."""
    phi = draw_yaw(generator, raw["x_gt"].shape[0], raw["x_gt"].device)
    return yaw_rotate(raw, phi)
