"""Host-side float64 pose math (numpy copy of the parts of
``deeplio_tpu/data/np_spatial.py`` that ``SyntheticDrive`` and the window
dataset's ground truth use).

OXTS mercator coordinates are O(1e6) m, where float32 quantisation is far
too coarse for relative poses, so ground truth is computed on the host in
float64 and normalised to a drive-local origin.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS = 6378137.0


def rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def euler_to_rotmat(roll, pitch, yaw) -> np.ndarray:
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ],
        np.float64,
    )


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> [w, x, y, z], w >= 0."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s])
    elif m00 > m11 and m00 > m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s])
    elif m11 > m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s])
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_inv(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3].T
    return se3(R, -R @ T[:3, 3])


def relative_pose(Ti: np.ndarray, Tj: np.ndarray):
    """(dx [3], dq [4]) with T_i^{-1} T_j = [R(dq) | dx]."""
    Trel = se3_inv(Ti) @ Tj
    return Trel[:3, 3].copy(), rotmat_to_quat(Trel[:3, :3])


def latlon_to_mercator(lat, lon, scale):
    x = scale * np.deg2rad(lon) * EARTH_RADIUS
    y = EARTH_RADIUS * scale * np.log(np.tan(np.deg2rad(90.0 + lat) / 2.0))
    return x, y


def oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale) -> np.ndarray:
    x, y = latlon_to_mercator(lat, lon, scale)
    return se3(euler_to_rotmat(roll, pitch, yaw), np.array([x, y, alt]))
