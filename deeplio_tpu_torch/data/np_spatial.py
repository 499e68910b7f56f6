"""Host-side float64 pose math (numpy copy of the parts of
``deeplio_tpu/data/np_spatial.py`` that ``SyntheticDrive`` uses).

OXTS mercator coordinates are O(1e6) m, where float32 quantisation is far
too coarse for relative poses, so ground truth is computed on the host in
float64 and normalised to a drive-local origin.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS = 6378137.0


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


def se3(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def se3_inv(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3].T
    return se3(R, -R @ T[:3, 3])


def latlon_to_mercator(lat, lon, scale):
    x = scale * np.deg2rad(lon) * EARTH_RADIUS
    y = EARTH_RADIUS * scale * np.log(np.tan(np.deg2rad(90.0 + lat) / 2.0))
    return x, y


def oxts_to_pose(lat, lon, alt, roll, pitch, yaw, scale) -> np.ndarray:
    x, y = latlon_to_mercator(lat, lon, scale)
    return se3(euler_to_rotmat(roll, pitch, yaw), np.array([x, y, alt]))
