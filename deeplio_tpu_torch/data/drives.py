"""Drive abstractions (counterpart of ``deeplio_tpu/data/drives.py``: the
``Drive`` interface, ``KittiRawDrive`` for KITTI raw drives on disk,
``SyntheticDrive`` and ``PermutedDrive``).

Scans are padded/truncated to a static ``max_points`` with a validity
mask; poses are float64 on the host, normalised to a drive-local origin.
Projection does not happen here: it runs on the device. With a
``slot_grid`` ``(H, W, fov_up_deg, fov_down_deg)`` a drive bins every scan
onto the slot grid the slot-aligned projection routes read
(``data/synthetic.py::slot_bin_scan``), in the ``slots`` or ``halves``
layout; per-point labels are then refused, since they index the raw
order.
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


_LABELS_SLOT_BIN = ("per-point labels are incompatible with slot-bin "
                    "(points are re-ordered onto the slot grid)")


def _check_grid(slot_grid, max_points: int) -> None:
    if slot_grid is not None and max_points % (slot_grid[0] * slot_grid[1]):
        raise ValueError(f"slot_grid {tuple(slot_grid[:2])} needs "
                         f"max_points ({max_points}) to be a multiple of H*W")


class PermutedDrive(Drive):
    """A drive whose every scan is permuted by one fixed ``perm``: the
    dual-half layout of ``kernel-aligned: halves``
    (``ops/projection.py::halves_permutation``) for a drive with no slot
    grid, so every consumer (windows, streaming, the projection cache)
    sees the layout the route reads. Labels are refused."""

    def __init__(self, inner: Drive, perm: np.ndarray):
        self.inner = inner
        self.perm = np.asarray(perm)
        self.name = inner.name

    def __len__(self) -> int:
        return len(self.inner)

    def points(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        p, v = self.inner.points(i)
        return p[self.perm], v[self.perm]

    def points_planes(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        p, v = self.inner.points_planes(i)
        return np.ascontiguousarray(p[:, self.perm]), v[self.perm]

    def labels(self, i: int, labels_path: str):
        raise ValueError("per-point labels are incompatible with the "
                         "halves point layout (points are re-ordered)")

    def frame_time(self, i: int) -> float:
        return self.inner.frame_time(i)

    def pose(self, i: int) -> np.ndarray:
        return self.inner.pose(i)

    def imu_between(self, t0: float, t1: float) -> np.ndarray:
        return self.inner.imu_between(t0, t1)


class KittiRawDrive(Drive):
    """One KITTI raw synced drive, ``<root>/<date>/<date>_drive_%04d_sync``,
    frames ``start`` to ``end`` (inclusive; ``-1``: to the last):

    - ``velodyne_points/data/%010d.bin``: float32 [n, 4] (x, y, z,
      remission) in the sensor's ring order;
    - ``velodyne_points/timestamps.txt`` and ``oxts/timestamps.txt``;
    - ``oxts/data/%010d.txt``: one 30-field GPS/IMU record a file.

    Scans are read from disk on every access (and binned, under a
    ``slot_grid``, every scan whole). The OXTS records are parsed on the
    first pose or IMU access, once. Same outputs as the JAX package's
    ``KittiRawDrive`` on the same tree, bit for bit.
    """

    # 0-based fields of an OXTS record
    _LAT, _LON, _ALT, _ROLL, _PITCH, _YAW = 0, 1, 2, 3, 4, 5
    _AX, _AY, _AZ = 11, 12, 13     # body-frame acceleration
    _WX, _WY, _WZ = 17, 18, 19     # body-frame angular rates

    def __init__(self, root: str, date: str, drive: int,
                 max_points: int = 131072, start: int = 0, end: int = -1,
                 slot_grid=None, slot_layout: str = "slots"):
        _check_grid(slot_grid, max_points)
        self.slot_grid = slot_grid
        self.slot_layout = slot_layout
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
        if self.slot_grid is not None:
            H, W, fu, fd = self.slot_grid
            return syn.slot_bin_scan(raw, np.ones(raw.shape[0], bool), H, W,
                                     self.max_points // (H * W), fu, fd,
                                     layout=self.slot_layout)
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
        Raises under a slot grid.
        """
        if self.slot_grid is not None:
            raise ValueError(_LABELS_SLOT_BIN)
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
    The scans are compacted, not on a slot grid: the asserted aligned
    routes need ``slot_grid``, which bins them.
    """

    def __init__(self, n_frames: int = 64, max_points: int = 16384,
                 seed: int = 0, world_points: int = 30000,
                 name: str = "synth", rings: int = 0,
                 world_mode: str = "origin", slot_grid=None,
                 slot_layout: str = "slots"):
        _check_grid(slot_grid, max_points)
        self.slot_grid = slot_grid
        self.slot_layout = slot_layout
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
        pts, valid = syn.synthetic_scan(self._world, self._Ts[i],
                                        self.max_points,
                                        seed=self.seed * 1000 + i,
                                        rings=self.rings)
        if self.slot_grid is not None:
            H, W, fu, fd = self.slot_grid
            return syn.slot_bin_scan(pts, valid, H, W,
                                     self.max_points // (H * W), fu, fd,
                                     layout=self.slot_layout)
        return pts, valid

    @lru_cache(maxsize=None)
    def points_planes(self, i: int):
        return super().points_planes(i)

    def labels(self, i: int, labels_path: str):
        """None (no label files; geometric labels), or raises under a slot
        grid, as ``KittiRawDrive.labels`` does."""
        if self.slot_grid is not None:
            raise ValueError(_LABELS_SLOT_BIN)
        return None

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
