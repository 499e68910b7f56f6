"""Synthetic KITTI-shaped fixtures (numpy copy of the parts of
``deeplio_tpu/data/synthetic.py`` that the port needs:
``synthetic_world``, ``synthetic_world_corridor``,
``synthetic_trajectory``, ``synthetic_oxts``,
``synthetic_scan``, ``ring_order``, ``synthetic_ring_batch``, and the
host slot binning of the slot-aligned projection routes,
``slot_bin_scan`` and its numpy oracle ``slot_bin_scan_np``).

A static world point cloud observed from a smooth trajectory, 100 Hz
OXTS-style records consistent with it, and 10 Hz scans. Host-side numpy in
float64, exported as float32 arrays; the same seeds give the same arrays as
the JAX package's fixtures, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

GRAVITY = 9.80665
LIDAR_HZ = 10.0
IMU_HZ = 100.0


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def synthetic_world(num_points: int = 40000, seed: int = 0) -> np.ndarray:
    """Random world geometry: ground plane points + scattered pillars/walls."""
    rng = np.random.default_rng(seed)
    n_ground = num_points // 2
    n_struct = num_points - n_ground

    # Ground: annulus around origin, z ~= -1.7 (sensor height), small noise.
    rr = rng.uniform(3.0, 60.0, n_ground)
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack(
        [rr * np.cos(th), rr * np.sin(th), -1.7 + 0.05 * rng.normal(size=n_ground)], -1
    )

    # Structures: vertical pillars at random XY with height 0..3m.
    n_pillars = 60
    centers = rng.uniform(-50, 50, (n_pillars, 2))
    pts = []
    per = n_struct // n_pillars
    for c in centers:
        z = rng.uniform(-1.7, 2.5, per)
        xy = c + 0.3 * rng.normal(size=(per, 2))
        pts.append(np.concatenate([xy, z[:, None]], -1))
    struct = np.concatenate(pts, 0)[:n_struct]
    world = np.concatenate([ground, struct], 0)
    return world.astype(np.float64)


def synthetic_world_corridor(
    Ts: np.ndarray,
    seed: int = 0,
    half_width: float = 60.0,
    ground_density: float = 1.33,
    max_points: int = 500_000,
) -> np.ndarray:
    """World geometry along a trajectory's corridor.

    :func:`synthetic_world` fills a blob of ~60 m radius around the start,
    so a drive longer than ~128 frames (~100 m) leaves it and its scans
    go empty. Here ground and pillar points are scattered around anchors
    taken every ~1 m of the whole path, at the origin world's density
    (1.33 ground points per m^2) and mix (half ground, half pillars, the
    same heights and jitters), so scans stay populated however long the
    drive. The same draws as the JAX package's, in the same order.

    Deterministic in (trajectory, seed). Returns [N, 3] float64.
    """
    rng = np.random.default_rng(seed)
    path = Ts[:, :2, 3]
    seg_len = np.linalg.norm(np.diff(path, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    length = float(cum[-1])
    s = np.linspace(0.0, length, max(int(length), 2))
    anchors = np.stack(
        [np.interp(s, cum, path[:, 0]), np.interp(s, cum, path[:, 1])], -1
    )

    area = 2.0 * half_width * max(length, 1.0) + np.pi * half_width**2
    n_ground = min(int(ground_density * area), max_points // 2)
    n_struct = n_ground

    def _disk(n: int, radius: float) -> np.ndarray:
        # uniform points in a disk around random path anchors
        idx = rng.integers(0, len(anchors), n)
        rr = radius * np.sqrt(rng.uniform(0.0, 1.0, n))
        th = rng.uniform(-np.pi, np.pi, n)
        return anchors[idx] + np.stack([rr * np.cos(th), rr * np.sin(th)], -1)

    gxy = _disk(n_ground, half_width)
    ground = np.concatenate(
        [gxy, -1.7 + 0.05 * rng.normal(size=(n_ground, 1))], -1
    )

    # Pillars: same per-area count as the origin world (60 per pi*60^2).
    n_pillars = max(8, int(60.0 * area / (np.pi * half_width**2)))
    centers = _disk(n_pillars, 0.85 * half_width)
    per = max(n_struct // n_pillars, 1)
    pts = []
    for c in centers:
        z = rng.uniform(-1.7, 2.5, per)
        xy = c + 0.3 * rng.normal(size=(per, 2))
        pts.append(np.concatenate([xy, z[:, None]], -1))
    struct = np.concatenate(pts, 0)[:n_struct]
    return np.concatenate([ground, struct], 0).astype(np.float64)


def synthetic_trajectory(
    n_frames: int, seed: int = 0, speed: float = 8.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Smooth vehicle trajectory.

    Returns (T_world_body [n,4,4] float64, times [n] float64 at 10 Hz).
    Gentle arc with varying yaw rate — enough excitation for the IMU branch.
    """
    rng = np.random.default_rng(seed + 1)
    dt = 1.0 / LIDAR_HZ
    times = np.arange(n_frames) * dt
    yaw_rate = 0.08 * np.sin(2 * np.pi * times / 8.0) + 0.02 * rng.standard_normal()
    yaws = np.cumsum(yaw_rate * dt)
    vel = speed * (1.0 + 0.1 * np.sin(2 * np.pi * times / 5.0))
    xy = np.zeros((n_frames, 2))
    for i in range(1, n_frames):
        h = yaws[i - 1]
        xy[i] = xy[i - 1] + vel[i - 1] * dt * np.array([np.cos(h), np.sin(h)])
    Ts = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        Ts[i, :3, :3] = _rotz(yaws[i])
        Ts[i, :3, 3] = [xy[i, 0], xy[i, 1], 0.0]
        Ts[i, 3, 3] = 1.0
    return Ts, times


@dataclass
class SyntheticOxts:
    """OXTS-like records: times [m], and per-record (lat/lon/alt/rpy + imu)."""
    times: np.ndarray          # [m]
    # packed 30-field-ish record; we keep the fields the loader consumes:
    lat: np.ndarray            # [m] degrees
    lon: np.ndarray
    alt: np.ndarray
    roll: np.ndarray           # [m] radians
    pitch: np.ndarray
    yaw: np.ndarray
    acc: np.ndarray            # [m, 3] body-frame m/s^2 (incl. gravity)
    gyro: np.ndarray           # [m, 3] body-frame rad/s


def synthetic_oxts(Ts: np.ndarray, frame_times: np.ndarray, seed: int = 0,
                   lat0: float = 49.0, lon0: float = 8.43, alt0: float = 112.0
                   ) -> SyntheticOxts:
    """Fabricate 100 Hz OXTS records consistent with the 10 Hz trajectory.

    Positions are converted to lat/lon by inverting the mercator projection
    the loader applies (KITTI devkit convention), so loader-computed poses
    round-trip to the trajectory. IMU accel/gyro are finite-difference body
    rates plus gravity, with light noise.
    """
    rng = np.random.default_rng(seed + 2)
    er = 6378137.0
    scale = np.cos(np.deg2rad(lat0))
    # world position of frame 0 maps to (lat0, lon0).
    x0 = scale * np.deg2rad(lon0) * er
    y0 = er * scale * np.log(np.tan(np.deg2rad(90.0 + lat0) / 2.0))

    t_end = frame_times[-1]
    m = int(np.floor(t_end * IMU_HZ)) + 1
    times = np.arange(m) / IMU_HZ

    # Interpolate trajectory to 100 Hz (linear pos, linear yaw — fine for fixture).
    fx = np.interp(times, frame_times, Ts[:, 0, 3])
    fy = np.interp(times, frame_times, Ts[:, 1, 3])
    fz = np.interp(times, frame_times, Ts[:, 2, 3])
    yaw_f = np.unwrap(np.arctan2(Ts[:, 1, 0], Ts[:, 0, 0]))
    yw = np.interp(times, frame_times, yaw_f)

    lon = np.rad2deg((fx + x0) / (scale * er))
    lat = np.rad2deg(2.0 * np.arctan(np.exp((fy + y0) / (er * scale))) - np.pi / 2.0)
    alt = fz + alt0

    dt = 1.0 / IMU_HZ
    vx = np.gradient(fx, dt)
    vy = np.gradient(fy, dt)
    vz = np.gradient(fz, dt)
    ax_w = np.gradient(vx, dt)
    ay_w = np.gradient(vy, dt)
    az_w = np.gradient(vz, dt) + GRAVITY
    wz = np.gradient(yw, dt)

    acc = np.zeros((m, 3))
    gyro = np.zeros((m, 3))
    for i in range(m):
        Rwb = _rotz(yw[i])
        acc[i] = Rwb.T @ np.array([ax_w[i], ay_w[i], az_w[i]])
        gyro[i] = [0.0, 0.0, wz[i]]
    acc += 0.02 * rng.standard_normal(acc.shape)
    gyro += 0.002 * rng.standard_normal(gyro.shape)

    zeros = np.zeros(m)
    return SyntheticOxts(
        times=times, lat=lat, lon=lon, alt=alt,
        roll=zeros, pitch=zeros, yaw=yw, acc=acc, gyro=gyro,
    )


def synthetic_scan(
    world: np.ndarray,
    T_world_body: np.ndarray,
    max_points: int,
    seed: int = 0,
    max_range: float = 80.0,
    fov_up_deg: float = 3.0,
    fov_down_deg: float = -25.0,
    rings: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Observe the world from one pose: body-frame (x,y,z,remission) + valid.

    Returns (points [max_points, 4] float32, valid [max_points] bool) —
    exactly the padded-scan contract of the projection.

    ``rings > 0`` emits points in spinning-sensor order — sorted by
    (elevation ring, azimuth), the KITTI Velodyne .bin layout — the order
    the ring projection (``ops/projection_ring.py``) is built for when the
    range image has ``height == rings``.
    """
    rng = np.random.default_rng(seed + 3)
    Rwb, t = T_world_body[:3, :3], T_world_body[:3, 3]
    body = (world - t) @ Rwb  # R^T (p - t)
    r = np.linalg.norm(body, axis=-1)
    pitch = np.arcsin(np.clip(body[:, 2] / np.maximum(r, 1e-9), -1, 1))
    keep = (
        (r > 2.0)
        & (r < max_range)
        & (pitch < np.deg2rad(fov_up_deg))
        & (pitch > np.deg2rad(fov_down_deg))
    )
    body = body[keep]
    if body.shape[0] > max_points:
        sel = rng.choice(body.shape[0], max_points, replace=False)
        body = body[sel]
    if rings:
        body = body[ring_order(body.astype(np.float32), rings,
                                fov_up_deg, fov_down_deg)]
    n = body.shape[0]
    remission = rng.uniform(0.05, 0.95, (n, 1))
    pts = np.zeros((max_points, 4), np.float32)
    pts[:n, :3] = body
    pts[:n, 3:] = remission
    valid = np.zeros(max_points, bool)
    valid[:n] = True
    return pts, valid


def ring_order(xyz: np.ndarray, rings: int, fov_up_deg: float = 3.0,
               fov_down_deg: float = -25.0) -> np.ndarray:
    """Permutation putting [N, 3+] points in spinning-sensor order:
    elevation ring (top row first), then azimuth in image-column order.

    The ring binning uses the SAME float32 formula as the device projection
    (ops/projection.py::spherical_uv_planes) so a scan reordered for
    ``rings == H`` satisfies the ring projection's monotone-pixel contract
    except for float-boundary points, which that projection degrades
    gracefully on.
    """
    x = xyz[:, 0].astype(np.float32)
    y = xyz[:, 1].astype(np.float32)
    z = xyz[:, 2].astype(np.float32)
    r = np.sqrt(x * x + y * y + z * z)
    pitch = np.arcsin(np.clip(z / np.maximum(r, np.float32(1e-9)), -1.0, 1.0))
    yaw = np.arctan2(y, x)
    fov_down = np.float32(np.deg2rad(fov_down_deg))
    fov = np.float32(np.deg2rad(fov_up_deg - fov_down_deg))
    v = np.clip(np.floor((1.0 - (pitch - fov_down) / fov) * rings),
                0, rings - 1)
    u_frac = 0.5 * (1.0 - yaw / np.float32(np.pi))
    return np.lexsort((u_frac, v))


def synthetic_ring_batch(rng: np.ndarray, batch: int, n_points: int,
                         rings: int = 64, fov_up_deg: float = 3.0,
                         fov_down_deg: float = -25.0) -> np.ndarray:
    """Vectorized spinning-LiDAR batch: [batch, n_points, 4] float32 in
    ring-major order (ring pitches at image-row centers, one azimuth sweep
    per ring, jittered within azimuth steps), shaped and ORDERED like real
    sensor data.
    """
    per = n_points // rings
    if per * rings != n_points:
        raise ValueError(f"n_points ({n_points}) must be a multiple of "
                         f"rings ({rings})")
    fu, fd = np.deg2rad(fov_up_deg), np.deg2rad(fov_down_deg)
    fov = fu - fd
    pitch = fd + fov * (1.0 - (np.arange(rings) + 0.5) / rings)     # [R]
    jit = rng.uniform(0.05, 0.95, (batch, rings, per))
    yaw = np.pi - 2 * np.pi * (np.arange(per) + jit) / per          # [b,R,P]
    rr = rng.uniform(2.0, 70.0, (batch, rings, per))
    cp = np.cos(pitch)[None, :, None]
    pts = np.stack([rr * cp * np.cos(yaw), rr * cp * np.sin(yaw),
                    rr * np.sin(pitch)[None, :, None],
                    rng.uniform(0, 1, (batch, rings, per))], -1)
    return pts.reshape(batch, n_points, 4).astype(np.float32)


def _slot_key_layout(H: int, W: int, spp: int):
    """(n_pix, capacity, rq_scale, rq ceiling) of a slot grid: the device
    key layout of ``ops/projection.py::idx_key_layout``, whose ``rq_max``
    marks an invalid point, so a valid one stops at ``rq_max - 1``."""
    from deeplio_tpu_torch.ops.projection import idx_key_layout

    n_pix = H * W
    cap = n_pix * spp
    _, rq_bits, rq_scale = idx_key_layout(cap, n_pix)
    return n_pix, cap, rq_scale, (1 << rq_bits) - 2


def slot_bin_scan(pts: np.ndarray, valid: np.ndarray, H: int, W: int,
                  spp: int, fov_up_deg: float = 3.0,
                  fov_down_deg: float = -25.0, layout: str = "slots",
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Bin a raw scan [n, 4] onto the fixed grid of H rings x W * spp
    azimuth slots that the slot-aligned projection routes read: (points
    [H * W * spp, 4] float32, valid [H * W * spp] bool).

    Runs the native op (``deeplio_tpu_torch/native``, the GIL released for
    the call); where it cannot be built, :func:`slot_bin_scan_np`, which
    gives the same bins. The native pass's yaw and pitch may differ from
    numpy's by a few ulp, which moves a point only when it lies on a
    pixel boundary; every operation that feeds an integer decision is
    exact on both.

    ``layout``: ``slots`` (position ``pixel * spp + rank``) or ``halves``
    (position ``rank * H * W + pixel``, the layout ``kernel-aligned:
    halves`` reads, so no separate permutation is paid).
    """
    if layout not in ("slots", "halves"):
        raise ValueError(f"layout must be slots|halves, got {layout!r}")
    from deeplio_tpu_torch import native

    lib = native.lib()
    if lib is None:
        return slot_bin_scan_np(pts, valid, H, W, spp, fov_up_deg,
                                fov_down_deg, layout)
    import ctypes

    _, cap, rq_scale, rq_hi = _slot_key_layout(H, W, spp)
    pts4 = np.ascontiguousarray(pts[:, :4], np.float32)
    vld = np.ascontiguousarray(np.asarray(valid, bool).view(np.uint8))
    out = np.empty((cap, 4), np.float32)
    out_valid = np.empty(cap, np.uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.dlt_slot_bin_scan(
        pts4.ctypes.data_as(f32p), vld.ctypes.data_as(u8p), pts4.shape[0],
        H, W, spp, float(fov_up_deg), float(fov_down_deg), float(rq_scale),
        rq_hi, 1 if layout == "halves" else 0, out.ctypes.data_as(f32p),
        out_valid.ctypes.data_as(u8p))
    return out, out_valid.view(bool)


def slot_bin_scan_np(pts: np.ndarray, valid: np.ndarray, H: int, W: int,
                     spp: int, fov_up_deg: float = 3.0,
                     fov_down_deg: float = -25.0, layout: str = "slots",
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy slot binning: the oracle of the native op, and its stand-in
    where no C++ compiler is found.

    Each pixel keeps its ``spp`` best points by (quantized range, index),
    the winner rule of every projection route, placed best first in its
    slots, so the aligned route's per-pixel minimum finds the same winner;
    points past ``spp`` a pixel could never win and are dropped, and empty
    slots come back invalid. Ranges past the key ceiling tie there, as the
    device's clipped keys do. Pixels come from float32 host trig with the
    projection's formulas, which can differ from the device's by an ulp on
    a pixel boundary: binned real scans run with ``kernel-aligned: trust``
    or ``halves``. Returns ([H*W*spp, 4] f32, [H*W*spp] bool) in
    ``layout`` order (:func:`slot_bin_scan`).
    """
    if layout not in ("slots", "halves"):
        raise ValueError(f"layout must be slots|halves, got {layout!r}")
    n_pix, cap, rq_scale, rq_hi = _slot_key_layout(H, W, spp)
    x = pts[:, 0].astype(np.float32)
    y = pts[:, 1].astype(np.float32)
    z = pts[:, 2].astype(np.float32)
    r = np.sqrt(x * x + y * y + z * z)
    ok = np.asarray(valid, bool) & (r > 1e-6)
    yaw = np.arctan2(y, x)
    pitch = np.arcsin(np.clip(z / np.maximum(r, np.float32(1e-9)), -1, 1))
    fov_down = np.float32(np.deg2rad(fov_down_deg))
    fov = np.float32(np.deg2rad(fov_up_deg - fov_down_deg))
    u = np.clip(np.floor(0.5 * (1.0 - yaw / np.float32(np.pi)) * W),
                0, W - 1).astype(np.int64)
    v = np.clip(np.floor((1.0 - (pitch - fov_down) / fov) * H),
                0, H - 1).astype(np.int64)
    pix = v * W + u
    rq = np.clip((r * np.float32(rq_scale)).astype(np.int64), 0, rq_hi)

    sel = np.flatnonzero(ok)
    # within a pixel: quantized range, then index (lexsort's last key is
    # the primary one; sel ascends, so the stable sort breaks ties by it)
    order = sel[np.lexsort((rq[sel], pix[sel]))]
    p_sorted = pix[order]
    first = np.concatenate([[True], p_sorted[1:] != p_sorted[:-1]])
    starts = np.flatnonzero(first)
    rank = np.arange(len(order)) - np.repeat(starts, np.diff(
        np.concatenate([starts, [len(order)]])))
    keep = rank < spp
    if layout == "halves":
        slot = rank[keep] * n_pix + p_sorted[keep]
    else:
        slot = p_sorted[keep] * spp + rank[keep]
    out = np.zeros((cap, 4), np.float32)
    out_valid = np.zeros(cap, bool)
    out[slot] = pts[order[keep], :4]
    out_valid[slot] = True
    return out, out_valid
