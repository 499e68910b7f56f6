"""Trajectory error metrics (counterpart of
``deeplio_tpu/eval/metrics.py``): ATE, RPE and the KITTI odometry relative
errors, in float64 numpy. The port keeps its own copy, operation for
operation, so its scores equal the JAX package's bit for bit on the same
trajectories.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _positions(Ts: np.ndarray) -> np.ndarray:
    return Ts[:, :3, 3]


def umeyama_alignment(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid alignment (R, t) minimising ||y - (R x + t)||."""
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    C = yc.T @ xc / x.shape[0]
    U, _, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    t = my - R @ mx
    return R, t


def ate(pred: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error: RMSE of positions (optionally SE(3)
    aligned first, the standard TUM protocol)."""
    p, g = _positions(pred), _positions(gt)
    n = min(len(p), len(g))
    p, g = p[:n], g[:n]
    if align and n >= 3:
        R, t = umeyama_alignment(p, g)
        p = p @ R.T + t
    return float(np.sqrt(np.mean(np.sum((p - g) ** 2, axis=-1))))


def rpe(pred: np.ndarray, gt: np.ndarray, delta: int = 1
        ) -> Tuple[float, float]:
    """Relative pose error over a fixed frame delta.

    Returns (trans RMSE [m], rot RMSE [rad]).
    """
    n = min(len(pred), len(gt))
    et, er = [], []
    for i in range(n - delta):
        dp = np.linalg.inv(pred[i]) @ pred[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ dp
        et.append(np.linalg.norm(e[:3, 3]))
        ang = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
        er.append(ang)
    return float(np.sqrt(np.mean(np.square(et)))), float(
        np.sqrt(np.mean(np.square(er))))


def _trajectory_distances(gt: np.ndarray) -> np.ndarray:
    p = _positions(gt)
    d = np.zeros(len(p))
    d[1:] = np.cumsum(np.linalg.norm(np.diff(p, axis=0), axis=-1))
    return d


KITTI_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)


def kitti_odometry_errors(pred: np.ndarray, gt: np.ndarray,
                          lengths: Sequence[int] = KITTI_LENGTHS,
                          step: int = 10) -> Dict[str, float]:
    """KITTI devkit-style averaged relative errors.

    For every start frame (stride ``step``) and every segment length in
    ``lengths`` (meters of GT path), compare the relative motion over the
    segment: translation error as % of length, rotation error in deg/m.
    Returns {"t_rel_pct", "r_rel_deg_per_100m", "n_segments"}.
    """
    n = min(len(pred), len(gt))
    dist = _trajectory_distances(gt[:n])
    t_errs, r_errs = [], []
    for first in range(0, n, step):
        for L in lengths:
            # last frame where GT path length exceeds first+L
            target = dist[first] + L
            last = int(np.searchsorted(dist, target))
            if last >= n:
                continue
            dg = np.linalg.inv(gt[first]) @ gt[last]
            dp = np.linalg.inv(pred[first]) @ pred[last]
            e = np.linalg.inv(dg) @ dp
            t_errs.append(np.linalg.norm(e[:3, 3]) / L)
            ang = np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1))
            r_errs.append(ang / L)
    if not t_errs:
        return {"t_rel_pct": float("nan"), "r_rel_deg_per_100m": float("nan"),
                "n_segments": 0}
    return {
        "t_rel_pct": float(np.mean(t_errs) * 100.0),
        "r_rel_deg_per_100m": float(np.rad2deg(np.mean(r_errs)) * 100.0),
        "n_segments": len(t_errs),
    }
