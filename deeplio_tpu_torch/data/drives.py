"""Drive abstractions (counterpart of ``deeplio_tpu/data/drives.py``: the
``Drive`` interface and ``SyntheticDrive``; ``KittiRawDrive`` comes with
the KITTI data slice).

Scans are padded/truncated to a static ``max_points`` with a validity
mask; poses are float64 on the host, normalised to a drive-local origin.
Projection does not happen here: it runs on the device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from deeplio_tpu_torch.data import np_spatial as nsp
from deeplio_tpu_torch.data import synthetic as syn


class Drive:
    """Interface: one continuously-recorded drive."""

    name: str = "drive"

    def __len__(self) -> int:
        raise NotImplementedError

    def points(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Padded scan i: ([max_points, 4] f32, [max_points] bool)."""
        raise NotImplementedError

    def points_planes(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Scan i as channel planes: ([4, max_points] f32 contiguous,
        [max_points] bool), the layout the training step's batch takes."""
        pts, valid = self.points(i)
        return np.ascontiguousarray(pts[:, :4].T), valid

    def frame_time(self, i: int) -> float:
        raise NotImplementedError

    def pose(self, i: int) -> np.ndarray:
        """Drive-local global pose of frame i, float64 [4,4]."""
        raise NotImplementedError

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        """IMU samples [K, 6] = (ax,ay,az,wx,wy,wz) with t0 < t <= t1."""
        raise NotImplementedError


class SyntheticDrive(Drive):
    """Fabricated drive with self-consistent geometry (data/synthetic.py).

    With the same arguments it yields the same scans, IMU and poses as the
    JAX package's ``SyntheticDrive``. ``rings > 0`` (an addition of the
    port) emits each scan in spinning-sensor order, as KITTI's .bin files
    are, so the ring projection sees the ordering it is built for.
    """

    def __init__(self, n_frames: int = 64, max_points: int = 16384,
                 seed: int = 0, world_points: int = 30000,
                 name: str = "synth", rings: int = 0):
        self.max_points = max_points
        self.seed = seed
        self.rings = rings
        self.name = f"{name}_{seed}"
        self._Ts, self._times = syn.synthetic_trajectory(n_frames, seed=seed)
        self._world = syn.synthetic_world(world_points, seed=seed)
        self._oxts = syn.synthetic_oxts(self._Ts, self._times, seed=seed)
        # Loader-equivalent poses: recompute from the OXTS records through
        # the mercator path a real loader takes (drive-local origin).
        scale = np.cos(np.deg2rad(self._oxts.lat[0]))
        Ts = np.stack([
            nsp.oxts_to_pose(self._oxts.lat[k], self._oxts.lon[k],
                             self._oxts.alt[k], self._oxts.roll[k],
                             self._oxts.pitch[k], self._oxts.yaw[k], scale)
            for k in range(len(self._oxts.times))
        ])
        T0_inv = nsp.se3_inv(Ts[0])
        self._poses_oxts = np.einsum("ij,njk->nik", T0_inv, Ts)

    def __len__(self) -> int:
        return len(self._times)

    @lru_cache(maxsize=None)
    def points(self, i: int):
        return syn.synthetic_scan(self._world, self._Ts[i], self.max_points,
                                  seed=self.seed * 1000 + i, rings=self.rings)

    @lru_cache(maxsize=None)
    def points_planes(self, i: int):
        return super().points_planes(i)

    def frame_time(self, i: int) -> float:
        return float(self._times[i])

    def pose(self, i: int) -> np.ndarray:
        t = self._times[i]
        j = int(np.clip(np.round(t * syn.IMU_HZ), 0,
                        len(self._poses_oxts) - 1))
        return self._poses_oxts[j]

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        sel = (self._oxts.times > t0) & (self._oxts.times <= t1)
        if not sel.any():
            return np.zeros((0, 6), np.float32)
        return np.concatenate(
            [self._oxts.acc[sel], self._oxts.gyro[sel]], -1).astype(np.float32)
