"""Trajectories from predicted relative poses (counterpart of
``deeplio_tpu/eval/trajectory.py``): the chain of relative motions into
global poses on the tensor's device (float32) and on the host (float64),
the ground-truth trajectory of a drive, and KITTI pose files.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplio_tpu_torch.data import np_spatial as nsp
from deeplio_tpu_torch.utils import spatial as sp


def chain_relative(dx: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """[M, 3] translations + [M, 4] quaternions -> [M+1, 4, 4] global poses
    in float32, on their device.

    T_0 = I; T_{k+1} = T_k @ [R(dq_k) | dx_k]. A log-depth inclusive scan
    (ceil(log2 M) rounds of ``T[i] = T[i - d] @ T[i]``), as the JAX
    package's associative scan; the products associate in another order
    than a sequential chain, so the two agree to float32 rounding only.
    Composition is the elementwise ``se3_compose``: full float32, no TF32.
    """
    rel = sp.se3_matrix(sp.quat_to_rotmat(dq), dx)          # [M, 4, 4]
    d = 1
    while d < rel.shape[0]:
        rel = torch.cat([rel[:d], sp.se3_compose(rel[:-d], rel[d:])])
        d *= 2
    eye = torch.eye(4, dtype=rel.dtype, device=rel.device)[None]
    return torch.cat([eye, rel])


def chain_relative_np(dx: np.ndarray, dq: np.ndarray) -> np.ndarray:
    """Float64 host twin of :func:`chain_relative` (sequential)."""
    M = dx.shape[0]
    out = np.zeros((M + 1, 4, 4))
    out[0] = np.eye(4)
    for k in range(M):
        q = dq[k] / np.linalg.norm(dq[k])
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        out[k + 1] = out[k] @ nsp.se3(R, dx[k].astype(np.float64))
    return out


def gt_trajectory(drive) -> np.ndarray:
    """Drive's OXTS-derived global poses at frame times, [n,4,4] f64."""
    return np.stack([drive.pose(i) for i in range(len(drive))])


def write_kitti_poses(path: str, Ts: np.ndarray):
    """KITTI odometry pose format: 12 row-major floats of [R|t] per line."""
    with open(path, "w") as f:
        for T in Ts:
            f.write(" ".join(f"{v:.9e}" for v in T[:3, :4].reshape(-1)) + "\n")


def read_kitti_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :4] = rows
    return out
