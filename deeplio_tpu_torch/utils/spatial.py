"""Quaternion and SE(3) math in float32 (counterpart of
``deeplio_tpu/utils/spatial.py``'s quaternion, Euler-angle and SE(3)
functions; the host's numpy pose math is ``data/np_spatial.py``).

Conventions as in the JAX package: quaternions are [w, x, y, z], rotation
matrices are world-from-body, everything broadcasts over leading dims.

Pose composition is written as an elementwise product and sum instead of
``torch.matmul``: a float32 matmul may run in TF32 on the card when a
caller enabled it, and trajectories must compose in full float32 (the JAX
package pins HIGHEST precision for the same reason).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch._guards import detect_fake_mode

_CONSTANTS: Dict[tuple, torch.Tensor] = {}


def device_constant(values: Tuple[float, ...],
                    like: torch.Tensor) -> torch.Tensor:
    """``values`` as a 1-D tensor of ``like``'s dtype on its device, made
    there once (zeros, then a fill of each nonzero entry), so that a call
    copies nothing from the host, nor inside a CUDA graph's capture: the
    streaming tick's eager warm-up makes it before the capture. Under a
    fake mode (``torch.export``'s trace) it is the trace's own constant,
    built from the host list, and is not kept: a kept fake tensor would
    reach every later eager call."""
    if detect_fake_mode() is not None:
        return like.new_tensor(values)
    key = (values, like.device, like.dtype)
    c = _CONSTANTS.get(key)
    if c is None:
        c = like.new_zeros(len(values))
        for i, v in enumerate(values):
            if v:
                c[i] = v
        _CONSTANTS[key] = c
    return c


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Return q / ||q||, guarding the zero quaternion."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, eps)


def quat_canonical(q: torch.Tensor) -> torch.Tensor:
    """The double cover's sign fixed: w >= 0."""
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a quaternion, unit or not."""
    sq = (q * q).sum(-1, keepdim=True)
    return quat_conjugate(q) / torch.clamp_min(sq, 1e-12)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectors ``v`` rotated by the unit quaternion ``q`` (no matmul):
    ``v + w t + qv x t`` with ``t = 2 qv x v``."""
    qw, qv = q[..., :1], q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_from_axis_angle(axis: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """The rotation by ``angle`` (radians) about ``axis`` (any length)."""
    axis = axis / torch.clamp_min(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), 1e-12)
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), axis * torch.sin(half)], -1)


def quat_geodesic_angle(qa: torch.Tensor, qb: torch.Tensor,
                        eps: float = 1e-7) -> torch.Tensor:
    """Geodesic angle (radians) between two unit quaternions, sign-invariant:
    ``2 acos(|<qa, qb>|)``, clamped below 1 - eps so the gradient of acos
    stays finite at zero error."""
    dot = (quat_normalize(qa) * quat_normalize(qb)).sum(-1).abs()
    return 2.0 * torch.acos(dot.clamp(0.0, 1.0 - eps))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotmat_to_euler(R: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(roll, pitch, yaw) of ``R = Rz(yaw) Ry(pitch) Rx(roll)`` (KITTI
    OXTS), the pitch's sine clamped to [-1, 1]."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def mercator_scale(lat0: torch.Tensor) -> torch.Tensor:
    """The KITTI devkit's mercator scale ``cos(lat0)``, ``lat0`` in
    degrees."""
    return torch.cos(lat0 * math.pi / 180.0)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R [..., 3, 3], t [..., 3]) into a 4x4 homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), R).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """The inverse of a rigid transform: [R^T | -R^T t], in full
    float32."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t = T[..., :3, 3]
    return se3_matrix(Rt, -(Rt * t[..., None, :]).sum(-1))


def se3_compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """Ta @ Tb in full float32 (no TF32 on any device)."""
    return (Ta[..., :, :, None] * Tb[..., None, :, :]).sum(dim=-2)


def apply_relative(T: torch.Tensor, dx: torch.Tensor,
                   dq: torch.Tensor) -> torch.Tensor:
    """Chain one relative motion onto a global pose: T @ [R(dq) | dx]."""
    return se3_compose(T, se3_matrix(quat_to_rotmat(dq), dx))
