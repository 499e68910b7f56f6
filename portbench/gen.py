"""The benchmark's traffic: synthetic KITTI-shaped drives made from a seed.

A drive is a smooth vehicle path at 10 Hz (a gentle arc with a varying
yaw rate, 8 m/s give or take 10%), 100 Hz IMU records consistent with it
(body-frame acceleration with gravity, yaw rate, light noise), and one
LiDAR scan a frame from a spinning 64-ring sensor: 64 rings between
+3 and -25 degrees, 2048 azimuth steps a revolution, so two returns fall
on each pixel of a 64x1024 range image. Each ray is cast on the device
against a world of a ground plane 1.73 m below the sensor and vertical
pillars scattered along the path (the world of the repository's
synthetic drives, as surfaces): it returns between 2 and 80 m, or not at
all, and 2% of returns are lost at random. The returns are emitted in the
sensor's ring order (ring by ring, azimuth falling from +pi), compacted
to the front of a ``max_points`` buffer and padded with invalid points:
the layout of a KITTI raw ``.bin`` scan. Each return's direction lies in
the interior of its pixel, so the order holds under float32 arithmetic.

Everything a run feeds the system is made here, on the device, from the
run's seed: the same seed gives the same inputs. Paths and IMU records
are float64 numpy on the host (a few hundred numbers a frame).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

GRAVITY = 9.80665
LIDAR_HZ = 10.0
IMU_HZ = 100.0
SENSOR_HEIGHT = 1.73
MIN_RANGE, MAX_RANGE = 2.0, 80.0
LOSS = 0.02
# scans cast at once: bounds the [scans, rays, pillars] intermediates
CAST_CHUNK = 4


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A host generator for one stream of a run's seed."""
    return np.random.default_rng([int(seed) & (2**63 - 1), *stream])


def device_generator(seed: int, device, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng_for(seed, *stream).integers(2**62)))
    return g


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def trajectory(rng: np.random.Generator, n: int, speed: float = 8.0
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(poses [n, 4, 4] world-from-body, frame times [n], yaw-rate
    function parameters) of a smooth path."""
    times = np.arange(n) / LIDAR_HZ
    phase = rng.uniform(0, 2 * np.pi)
    bias = 0.02 * rng.standard_normal()
    yaw_rate = 0.08 * np.sin(2 * np.pi * times / 8.0 + phase) + bias
    yaws = np.concatenate([[rng.uniform(-np.pi, np.pi)],
                           np.cumsum(yaw_rate[:-1] / LIDAR_HZ)])
    yaws[1:] += yaws[0]
    vel = speed * (1.0 + 0.1 * np.sin(2 * np.pi * times / 5.0 + phase))
    xy = np.zeros((n, 2))
    for i in range(1, n):
        h = yaws[i - 1]
        xy[i] = xy[i - 1] + vel[i - 1] / LIDAR_HZ * np.array(
            [np.cos(h), np.sin(h)])
    Ts = np.zeros((n, 4, 4))
    Ts[:, :3, :3] = np.stack([_rotz(a) for a in yaws])
    Ts[:, :2, 3] = xy
    Ts[:, 3, 3] = 1.0
    return Ts, times, yaws


def imu_records(rng: np.random.Generator, Ts: np.ndarray, times: np.ndarray,
                yaws: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """100 Hz (times [m], samples [m, 6]: body acceleration with gravity,
    angular rate) consistent with the path."""
    t = np.arange(int(np.floor(times[-1] * IMU_HZ)) + 1) / IMU_HZ
    fx = np.interp(t, times, Ts[:, 0, 3])
    fy = np.interp(t, times, Ts[:, 1, 3])
    yw = np.interp(t, times, yaws)
    dt = 1.0 / IMU_HZ
    ax = np.gradient(np.gradient(fx, dt), dt)
    ay = np.gradient(np.gradient(fy, dt), dt)
    wz = np.gradient(yw, dt)
    c, s = np.cos(yw), np.sin(yw)
    acc = np.stack([c * ax + s * ay, -s * ax + c * ay,
                    np.full_like(ax, GRAVITY)], -1)
    gyro = np.stack([np.zeros_like(wz), np.zeros_like(wz), wz], -1)
    samples = np.concatenate([acc + 0.02 * rng.standard_normal(acc.shape),
                              gyro + 0.002 * rng.standard_normal(
                                  gyro.shape)], -1)
    return t, samples


def imu_window(t: np.ndarray, samples: np.ndarray, t0: float, t1: float,
               T: int) -> Tuple[np.ndarray, np.ndarray]:
    """The records with t0 < t <= t1, padded to T, and their mask."""
    w = samples[(t > t0 + 1e-9) & (t <= t1 + 1e-9)][:T]
    buf = np.zeros((T, 6), np.float32)
    buf[:len(w)] = w
    mask = np.zeros(T, np.float32)
    mask[:len(w)] = 1.0
    return buf, mask


def relative(Ti: np.ndarray, Tj: np.ndarray) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Frame j in frame i: (translation [3], quaternion [w, x, y, z])."""
    R = Ti[:3, :3].T @ Tj[:3, :3]
    t = Ti[:3, :3].T @ (Tj[:3, 3] - Ti[:3, 3])
    w = math.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12)) / 2.0
    q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                  (R[0, 2] - R[2, 0]) / (4 * w),
                  (R[1, 0] - R[0, 1]) / (4 * w)])
    return t.astype(np.float32), (q / np.linalg.norm(q)).astype(np.float32)


def pillars(rng: np.random.Generator, Ts: np.ndarray) -> np.ndarray:
    """[K, 4] (x, y, radius, top) of pillars within 60 m of the path, at
    the density of the repository's synthetic world (60 per disk of 60
    m)."""
    path = Ts[:, :2, 3]
    length = float(np.sum(np.linalg.norm(np.diff(path, axis=0), axis=1)))
    area = 120.0 * max(length, 1.0) + np.pi * 60.0 ** 2
    k = max(16, int(60.0 * area / (np.pi * 60.0 ** 2)))
    anchor = path[rng.integers(0, len(path), k)]
    rr = 60.0 * np.sqrt(rng.uniform(0.05, 1.0, k))
    th = rng.uniform(-np.pi, np.pi, k)
    xy = anchor + np.stack([rr * np.cos(th), rr * np.sin(th)], -1)
    radius = rng.uniform(0.3, 1.5, k)
    top = rng.uniform(0.0, 6.0, k)
    return np.concatenate([xy, radius[:, None], top[:, None]], -1)


def cast_scans(poses: np.ndarray, world: np.ndarray, max_points: int,
               gen: torch.Generator, device, rings: int = 64,
               steps: int = 2048, fov_up: float = 3.0,
               fov_down: float = -25.0) -> Dict[str, torch.Tensor]:
    """Scans from ``poses`` [F, 4, 4]: planes ``x, y, z, rem`` [F,
    max_points] float32 and ``valid`` [F, max_points] bool, ring order,
    the returns first."""
    f = len(poses)
    n_rays = rings * steps
    W = steps // 2
    up, down = math.radians(fov_up), math.radians(fov_down)
    out = {k: torch.zeros((f, max_points), dtype=torch.float32,
                          device=device) for k in ("x", "y", "z", "rem")}
    out["valid"] = torch.zeros((f, max_points), dtype=torch.bool,
                               device=device)
    wt = torch.tensor(world, dtype=torch.float32, device=device)
    ring = torch.arange(rings, device=device, dtype=torch.float32)
    col = torch.arange(steps, device=device) // 2
    for c0 in range(0, f, CAST_CHUNK):
        c1 = min(c0 + CAST_CHUNK, f)
        b = c1 - c0
        # each ray in the interior of its pixel: 0.2 to 0.8 of a cell
        fv = 0.2 + 0.6 * torch.rand((b, rings, 1), generator=gen,
                                    device=device)
        fu = 0.2 + 0.6 * torch.rand((b, rings, steps), generator=gen,
                                    device=device)
        pitch = up - (ring[None, :, None] + fv) * (up - down) / rings
        yaw = math.pi * (1.0 - 2.0 * (col[None, None] + fu) / W)
        pitch, yaw = (t.expand(b, rings, steps).reshape(b, n_rays)
                      for t in (pitch, yaw))
        d = torch.stack([torch.cos(pitch) * torch.cos(yaw),
                         torch.cos(pitch) * torch.sin(yaw),
                         torch.sin(pitch)], -1)           # body frame
        P = torch.tensor(poses[c0:c1], dtype=torch.float32, device=device)
        R, o = P[:, :3, :3], P[:, :3, 3]
        dw = torch.einsum("bij,bnj->bni", R, d)           # world frame
        ground = SENSOR_HEIGHT + 0.02 * torch.randn(
            (b, n_rays), generator=gen, device=device)
        t_hit = torch.where(dw[..., 2] < -1e-6,
                            ground / (-dw[..., 2]).clamp_min(1e-6),
                            torch.inf)
        # vertical cylinders, in the horizontal plane
        rel = o[:, None, :2] - wt[None, :, :2]            # [b, K, 2]
        a = (dw[..., :2] ** 2).sum(-1).clamp_min(1e-12)   # [b, n]
        bb = 2.0 * torch.einsum("bnc,bkc->bnk", dw[..., :2], rel)
        cc = (rel ** 2).sum(-1) - wt[None, :, 2] ** 2     # [b, K]
        disc = bb * bb - 4.0 * a[..., None] * cc[:, None]
        tp = (-bb - torch.sqrt(disc.clamp_min(0.0))) / (2.0 * a[..., None])
        zt = tp * dw[..., 2:3]
        hit = (disc > 0) & (tp > 0) & (zt > -SENSOR_HEIGHT) & (
            zt < wt[None, None, :, 3])
        tp = torch.where(hit, tp, torch.inf).amin(-1)
        t_hit = torch.minimum(t_hit, tp)
        t_hit = t_hit + 0.01 * torch.randn((b, n_rays), generator=gen,
                                           device=device)
        keep = (t_hit > MIN_RANGE) & (t_hit < MAX_RANGE) & (
            torch.rand((b, n_rays), generator=gen, device=device) >= LOSS)
        pts = d * torch.where(keep, t_hit, 0.0)[..., None]
        rem = 0.05 + 0.9 * torch.rand((b, n_rays), generator=gen,
                                      device=device)
        # compaction: the returns first, in order
        pos = torch.cumsum(keep.to(torch.int64), 1) - 1
        dest = torch.where(keep & (pos < max_points), pos, max_points)
        for k, v in (("x", pts[..., 0]), ("y", pts[..., 1]),
                     ("z", pts[..., 2]), ("rem", rem)):
            buf = torch.zeros((b, max_points + 1), dtype=torch.float32,
                              device=device)
            buf.scatter_(1, dest, v)
            out[k][c0:c1] = buf[:, :max_points]
        vbuf = torch.zeros((b, max_points + 1), dtype=torch.bool,
                           device=device)
        vbuf.scatter_(1, dest, keep)
        out["valid"][c0:c1] = vbuf[:, :max_points]
    return out


class Drive:
    """One drive of ``n`` frames from (seed, stream): path, IMU records,
    world."""

    def __init__(self, seed: int, stream: int, n: int):
        rng = rng_for(seed, 1, stream)
        self.Ts, self.times, yaws = trajectory(rng, n)
        self.imu_t, self.imu = imu_records(rng, self.Ts, self.times, yaws)
        self.world = pillars(rng, self.Ts)
        self.seed, self.stream = seed, stream

    def scans(self, frames: Sequence[int], max_points: int, device,
              rings: int = 64, steps: int = 2048
              ) -> Dict[str, torch.Tensor]:
        gen = device_generator(self.seed, device, 2, self.stream)
        return cast_scans(self.Ts[list(frames)], self.world, max_points,
                          gen, device, rings, steps)

    def pair(self, i: int, j: int, T: int):
        """(imu [T, 6], mask [T], x_gt [3], q_gt [4]) of frames i -> j."""
        imu, mask = imu_window(self.imu_t, self.imu, self.times[i],
                               self.times[j], T)
        x, q = relative(self.Ts[i], self.Ts[j])
        return imu, mask, x, q


def window_batch(seed: int, stream: int, windows: int, frames: int,
                 stride: int, combos, max_points: int, T: int, device,
                 rings: int = 64, steps: int = 2048
                 ) -> Dict[str, torch.Tensor]:
    """A training or eval batch: ``windows`` windows of ``frames`` frames,
    ``stride`` apart on one drive, in the raw batch contract (planes
    [B*S, N], imu [B, P, T, 6], imu_mask [B, P, T], x_gt [B, P, 3], q_gt
    [B, P, 4], valid [B, P])."""
    n = (windows - 1) * stride + frames
    drive = Drive(seed, stream, n)
    scans = drive.scans(range(n), max_points, device, rings, steps)
    rows = torch.tensor([w * stride + s for w in range(windows)
                         for s in range(frames)], device=device)
    out = {f"points_{k}": scans[k].index_select(0, rows).contiguous()
           for k in ("x", "y", "z", "rem")}
    out["points_valid"] = scans["valid"].index_select(0, rows).contiguous()
    per = [[drive.pair(w * stride + i, w * stride + j, T) for i, j in combos]
           for w in range(windows)]
    for k, name in enumerate(("imu", "imu_mask", "x_gt", "q_gt")):
        out[name] = torch.tensor(np.array([[p[k] for p in w] for w in per]),
                                 dtype=torch.float32, device=device)
    out["valid"] = torch.ones(out["x_gt"].shape[:2], dtype=torch.bool,
                              device=device)
    return out
