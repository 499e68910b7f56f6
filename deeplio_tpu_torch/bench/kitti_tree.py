"""A KITTI raw devkit tree written from synthetic drives, so that the
KITTI path (``data/drives.py::KittiRawDrive`` and everything above it)
runs with no recorded drive on disk. A fixture of the tests, not a
feature of the package.

For each drive, ``<root>/<date>/<date>_drive_%04d_sync`` holds:

- ``velodyne_points/data/%010d.bin``: the valid points of
  ``SyntheticDrive(...).points(i)`` as float32 (x, y, z, remission), in
  the drive's order (ring order when ``rings > 0``, as KITTI's are);
- ``oxts/data/%010d.txt``: one 30-field record per 100 Hz sample of the
  drive's ``synthetic_oxts``: lat, lon, alt, roll, pitch, yaw (fields
  0-5), body acceleration (11-13) and angular rates (17-19), the rest 0,
  written with ``%.17g`` so that every value reads back exactly;
- ``velodyne_points/timestamps.txt`` and ``oxts/timestamps.txt`` in
  KITTI's format, to the nanosecond.

Read back with ``KittiRawDrive(root, date, drive, max_points)``, the
scans equal the synthetic drive's bit for bit.

``write_labels`` adds SemanticKITTI label files for a written tree,
``<labels_root>/<date>_drive_%04d/%010d.label``, one uint32 per point of
the ``.bin``: the semantic id in the low 16 bits follows the geometry
(``GROUND_ID`` below ``GROUND_Z``, ``BUILDING_ID`` above), with a few
points unlabeled (0) and a few carrying ids at or above 2048 (3000 and
0xFFFF), and an instance id in the high 16 bits. The tree's own files do
not change.
"""

from __future__ import annotations

import datetime as dt
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List

import numpy as np

from deeplio_tpu_torch.data.drives import SyntheticDrive

DATE = "2011_10_03"
_BASE = dt.datetime(2011, 10, 3, 12, 55, 34)
GROUND_Z = -1.2
GROUND_ID, BUILDING_ID = 40, 50          # SemanticKITTI road, building
HIGH_IDS = (3000, 0xFFFF)                # ids a float16 holds inexactly
UNLABELED_SHARE, HIGH_SHARE = 0.02, 0.002


def write_timestamps(path: str, times: Iterable[float]) -> None:
    """Seconds after a fixed start -> ``YYYY-MM-DD HH:MM:SS.nnnnnnnnn``."""
    with open(path, "w") as f:
        for t in times:
            ns = int(round(float(t) * 1e9))
            stamp = _BASE + dt.timedelta(seconds=ns // 10**9)
            f.write(f"{stamp:%Y-%m-%d %H:%M:%S}.{ns % 10**9:09d}\n")


def drive_dir(root: str, date: str, drive: int) -> str:
    return os.path.join(root, date, f"{date}_drive_{drive:04d}_sync")


def scan_labels(xyz: np.ndarray, seed: int) -> np.ndarray:
    """SemanticKITTI labels (uint32 [n]) of a scan's points [n, 3]."""
    rng = np.random.default_rng(seed)
    n = xyz.shape[0]
    sem = np.where(xyz[:, 2] < GROUND_Z, GROUND_ID, BUILDING_ID)
    u = rng.uniform(size=n)
    sem = np.where(u < UNLABELED_SHARE, 0, sem)
    high = u > 1.0 - HIGH_SHARE
    sem = np.where(high, rng.choice(HIGH_IDS, n), sem).astype(np.uint32)
    inst = rng.integers(0, 1 << 16, n, dtype=np.uint32)
    return sem | (inst << np.uint32(16))


def write_drive(root: str, drive: int, source: SyntheticDrive,
                date: str = DATE, workers: int = 8) -> str:
    """Write ``source`` as drive ``drive`` of ``date`` under ``root``;
    returns the drive's directory."""
    base = drive_dir(root, date, drive)
    velo = os.path.join(base, "velodyne_points")
    oxts = os.path.join(base, "oxts")
    os.makedirs(os.path.join(velo, "data"))
    os.makedirs(os.path.join(oxts, "data"))
    n = len(source)
    write_timestamps(os.path.join(velo, "timestamps.txt"),
                     [source.frame_time(i) for i in range(n)])

    def scan(i: int) -> None:
        pts, valid = source.points(i)
        pts[valid].tofile(os.path.join(velo, "data", f"{i:010d}.bin"))

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(scan, range(n)))
    # the synthetic drive caches its scans: free them once written
    SyntheticDrive.points.cache_clear()

    ox = source._oxts
    write_timestamps(os.path.join(oxts, "timestamps.txt"), ox.times)
    rec = np.zeros((len(ox.times), 30))
    rec[:, :6] = np.stack([ox.lat, ox.lon, ox.alt, ox.roll, ox.pitch,
                           ox.yaw], -1)
    rec[:, 11:14] = ox.acc
    rec[:, 17:20] = ox.gyro
    for k, r in enumerate(rec):
        with open(os.path.join(oxts, "data", f"{k:010d}.txt"), "w") as f:
            f.write(" ".join(f"{v:.17g}" for v in r) + "\n")
    return base


def write_labels(root: str, labels_root: str, drives: Iterable[int],
                 date: str = DATE, workers: int = 8) -> None:
    """Label files for ``drives`` of ``date`` already under ``root``, from
    their ``.bin`` scans (frame i of drive d drawn with seed
    ``d * 100000 + i``)."""
    for drive in drives:
        velo = os.path.join(drive_dir(root, date, drive), "velodyne_points",
                            "data")
        out = os.path.join(labels_root, f"{date}_drive_{drive:04d}")
        os.makedirs(out, exist_ok=True)

        def one(name: str) -> None:
            i = int(name[:-len(".bin")])
            pts = np.fromfile(os.path.join(velo, name), np.float32)
            scan_labels(pts.reshape(-1, 4)[:, :3], drive * 100_000 + i
                        ).tofile(os.path.join(out, f"{i:010d}.label"))

        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(one, sorted(f for f in os.listdir(velo)
                                      if f.endswith(".bin"))))


def make_tree(root: str, drives: Iterable[int], n_frames: int,
              max_points: int = 131072, rings: int = 64,
              world_points: int = 300_000, date: str = DATE
              ) -> List[SyntheticDrive]:
    """Write ``drives`` (drive numbers) under ``root``, each from
    ``SyntheticDrive(n_frames, max_points, seed=<drive number>,
    world_points, rings)``; returns those synthetic drives."""
    out = []
    for d in drives:
        src = SyntheticDrive(n_frames=n_frames, max_points=max_points,
                             seed=d, world_points=world_points, rings=rings)
        write_drive(root, d, src, date)
        out.append(src)
    return out
