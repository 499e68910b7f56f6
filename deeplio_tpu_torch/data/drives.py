"""Drive abstractions (counterpart of ``deeplio_tpu/data/drives.py``: the
``Drive`` interface, ``KittiRawDrive`` for KITTI raw drives on disk and
``SyntheticDrive``).

Scans are padded/truncated to a static ``max_points`` with a validity
mask; poses are float64 on the host, normalised to a drive-local origin.
Projection does not happen here: it runs on the device.
"""

from __future__ import annotations

import datetime as dt
import os
from functools import lru_cache
from typing import Optional, Tuple

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


class KittiRawDrive(Drive):
    """One KITTI raw synced drive, ``<root>/<date>/<date>_drive_%04d_sync``,
    frames ``start`` to ``end`` (inclusive; ``-1``: to the last):

    - ``velodyne_points/data/%010d.bin``: float32 [n, 4] (x, y, z,
      remission) in the sensor's ring order;
    - ``velodyne_points/timestamps.txt`` and ``oxts/timestamps.txt``;
    - ``oxts/data/%010d.txt``: one 30-field GPS/IMU record a file.

    Scans are read from disk on every access. The OXTS records are parsed
    on the first pose or IMU access, once. Same outputs as the JAX
    package's ``KittiRawDrive`` on the same tree, bit for bit.
    """

    # 0-based fields of an OXTS record
    _LAT, _LON, _ALT, _ROLL, _PITCH, _YAW = 0, 1, 2, 3, 4, 5
    _AX, _AY, _AZ = 11, 12, 13     # body-frame acceleration
    _WX, _WY, _WZ = 17, 18, 19     # body-frame angular rates

    def __init__(self, root: str, date: str, drive: int,
                 max_points: int = 131072, start: int = 0, end: int = -1,
                 slot_grid=None):
        if slot_grid is not None:
            raise ValueError(
                "slot-binned KITTI scans are not supported by the PyTorch "
                "port yet; the model-variants slice (ROADMAP.md Queue 1 "
                "item 5) adds them")
        self.root = root
        self.date = date
        self.drive = drive
        self.max_points = max_points
        base = os.path.join(root, date, f"{date}_drive_{drive:04d}_sync")
        self.velo_dir = os.path.join(base, "velodyne_points", "data")
        self.oxts_dir = os.path.join(base, "oxts", "data")
        self.name = f"{date}_drive_{drive:04d}"
        velo_times = self._read_timestamps(
            os.path.join(base, "velodyne_points", "timestamps.txt"))
        oxts_times = self._read_timestamps(
            os.path.join(base, "oxts", "timestamps.txt"))
        n = len(velo_times)
        self.start, self.end = start, n if end < 0 else min(end + 1, n)
        # one clock for frames and records
        t0 = min(velo_times[0], oxts_times[0]) if n else 0.0
        self.velo_times = velo_times - t0
        self.oxts_times = oxts_times - t0
        self._oxts: Optional[np.ndarray] = None
        self._poses: Optional[np.ndarray] = None

    @staticmethod
    def _read_timestamps(path: str) -> np.ndarray:
        """``2011-10-03 12:55:34.349659964`` lines -> float64 seconds."""
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                date_part, time_part = line.split(" ")
                frac = 0.0
                if "." in time_part:
                    time_part, frac_s = time_part.split(".")
                    frac = float("0." + frac_s)
                t = dt.datetime.strptime(f"{date_part} {time_part}",
                                         "%Y-%m-%d %H:%M:%S")
                out.append(t.timestamp() + frac)
        return np.asarray(out, np.float64)

    @property
    def oxts(self) -> np.ndarray:
        """Every OXTS record of the drive, [m, 30] float64."""
        if self._oxts is None:
            recs = []
            for i in range(len(self.oxts_times)):
                with open(os.path.join(self.oxts_dir, f"{i:010d}.txt")) as f:
                    recs.append(np.array(f.read().split(), np.float64))
            self._oxts = np.stack(recs) if recs else np.zeros((0, 30))
        return self._oxts

    @property
    def _poses_oxts(self) -> np.ndarray:
        """Poses at the records' times, mercator, drive-local origin."""
        if self._poses is None:
            ox = self.oxts
            scale = np.cos(np.deg2rad(ox[0, self._LAT])) if len(ox) else 1.0
            Ts = [nsp.oxts_to_pose(r[self._LAT], r[self._LON], r[self._ALT],
                                   r[self._ROLL], r[self._PITCH],
                                   r[self._YAW], scale) for r in ox]
            Ts = np.stack(Ts) if Ts else np.zeros((0, 4, 4))
            if len(Ts):
                Ts = np.einsum("ij,njk->nik", nsp.se3_inv(Ts[0]), Ts)
            self._poses = Ts
        return self._poses

    def __len__(self) -> int:
        return self.end - self.start

    def points(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        raw = np.fromfile(
            os.path.join(self.velo_dir, f"{self.start + i:010d}.bin"),
            dtype=np.float32).reshape(-1, 4)
        n = min(raw.shape[0], self.max_points)
        pts = np.zeros((self.max_points, 4), np.float32)
        pts[:n] = raw[:n]
        valid = np.zeros(self.max_points, bool)
        valid[:n] = True
        return pts, valid

    def labels(self, i: int, labels_path: str) -> Optional[np.ndarray]:
        """SemanticKITTI per-point labels of frame i, aligned with
        :meth:`points` (int32 [max_points], 0 past the file's points), or
        None when ``<labels_path>/<drive name>/<frame>.label`` is absent.

        The file holds one uint32 a point: the low 16 bits are the
        semantic id, the high 16 the instance id, which is dropped.
        """
        path = os.path.join(labels_path, self.name,
                            f"{self.start + i:010d}.label")
        if not os.path.exists(path):
            return None
        raw = np.fromfile(path, dtype=np.uint32) & 0xFFFF
        n = min(raw.shape[0], self.max_points)
        out = np.zeros(self.max_points, np.int32)
        out[:n] = raw[:n].astype(np.int32)
        return out

    def frame_time(self, i: int) -> float:
        return float(self.velo_times[self.start + i])

    def pose(self, i: int) -> np.ndarray:
        """The pose of the OXTS record nearest frame i's time."""
        t = self.velo_times[self.start + i]
        j = int(np.clip(np.searchsorted(self.oxts_times, t), 0,
                        len(self.oxts_times) - 1))
        if j > 0 and (abs(self.oxts_times[j - 1] - t)
                      < abs(self.oxts_times[j] - t)):
            j -= 1
        return self._poses_oxts[j]

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        sel = (self.oxts_times > t0) & (self.oxts_times <= t1)
        r = self.oxts[sel]
        if r.size == 0:
            return np.zeros((0, 6), np.float32)
        return r[:, [self._AX, self._AY, self._AZ, self._WX, self._WY,
                     self._WZ]].astype(np.float32)


class SyntheticDrive(Drive):
    """Fabricated drive with self-consistent geometry (data/synthetic.py).

    With the same arguments it yields the same scans, IMU and poses as the
    JAX package's ``SyntheticDrive``; ``world_mode`` is ``origin`` (a
    world around the start) or ``corridor`` (one along the whole
    trajectory; ``world_points`` unused). ``rings > 0`` (an addition of
    the port) emits each scan in spinning-sensor order, as KITTI's .bin
    files are, so the ring projection sees the ordering it is built for.
    """

    def __init__(self, n_frames: int = 64, max_points: int = 16384,
                 seed: int = 0, world_points: int = 30000,
                 name: str = "synth", rings: int = 0,
                 world_mode: str = "origin"):
        self.max_points = max_points
        self.seed = seed
        self.rings = rings
        self.name = f"{name}_{seed}"
        self._Ts, self._times = syn.synthetic_trajectory(n_frames, seed=seed)
        if world_mode == "origin":
            self._world = syn.synthetic_world(world_points, seed=seed)
        elif world_mode == "corridor":
            # along the trajectory: long drives stay populated
            self._world = syn.synthetic_world_corridor(self._Ts, seed=seed)
        else:
            raise ValueError(f"unknown synthetic world mode {world_mode!r} "
                             f"(expected 'origin' or 'corridor')")
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
