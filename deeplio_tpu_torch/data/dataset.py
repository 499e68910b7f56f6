"""Window dataset and batch assembly (counterpart of
``deeplio_tpu/data/dataset.py``: ``WindowDataset`` on the raw-points path,
single process, assembling each batch in place).

Each item is a window of ``sequence-size`` frames from one drive; the
configured ``combinations`` define its P frame pairs. Per pair it carries
the IMU samples between the two frames, padded to ``max-imu-per-pair``
with a mask, and the float64-derived relative pose ground truth (dx, dq).
Projection does not happen here: the raw scans go to the device as
channel planes, flattened to [B*S, N], and the training step projects
them. The same drives give the same batches as the JAX package, bit for
bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from deeplio_tpu_torch.config.schema import DatasetConfig
from deeplio_tpu_torch.data import np_spatial as nsp
from deeplio_tpu_torch.data.drives import Drive

# channel planes of the raw scans, flat [B*S, N]: the step projects per
# frame
PLANE_KEYS = ("points_x", "points_y", "points_z", "points_rem")


class WindowDataset:
    """Windows of ``sequence-size`` frames, every ``window-stride`` frames
    of each drive."""

    def __init__(self, ds_cfg: DatasetConfig, drives: Sequence[Drive]):
        self.cfg = ds_cfg
        self.drives = list(drives)
        S = ds_cfg.sequence_size
        stride = max(ds_cfg.window_stride, 1)
        self.index: List[Tuple[int, int]] = []
        for di, d in enumerate(self.drives):
            n_windows = max(len(d) - S + 1, 0)
            self.index.extend((di, s) for s in range(0, n_windows, stride))

    def __len__(self) -> int:
        return len(self.index)

    def _pair_meta(self, d: Drive, s: int):
        """(imu, imu_mask, x_gt, q_gt, valid) for one window."""
        combos = self.cfg.effective_combinations
        P = len(combos)
        T = self.cfg.max_imu_per_pair
        imu = np.zeros((P, T, 6), np.float32)
        imu_mask = np.zeros((P, T), np.float32)
        x_gt = np.zeros((P, 3), np.float32)
        q_gt = np.zeros((P, 4), np.float32)
        valid = np.ones((P,), np.float32)
        for pi, (i, j) in enumerate(combos):
            w = d.imu_between(d.frame_time(s + i), d.frame_time(s + j))
            k = min(len(w), T)
            if k > 0:
                imu[pi, :k] = w[:k]
                imu_mask[pi, :k] = 1.0
            else:
                valid[pi] = 0.0     # no IMU between the frames
            dx, dq = nsp.relative_pose(d.pose(s + i), d.pose(s + j))
            x_gt[pi] = dx.astype(np.float32)
            q_gt[pi] = dq.astype(np.float32)
        return imu, imu_mask, x_gt, q_gt, valid

    def get_into(self, idx: int, row: int, out: Dict[str, np.ndarray]):
        """Assemble window ``idx`` directly into row ``row`` of a batch
        from :meth:`alloc_batch`."""
        di, s = self.index[idx]
        d = self.drives[di]
        S = self.cfg.sequence_size
        for k in range(S):
            planes, vld = d.points_planes(s + k)
            r = row * S + k
            for c, key in enumerate(PLANE_KEYS):
                out[key][r] = planes[c]
            out["points_valid"][r] = vld
        (out["imu"][row], out["imu_mask"][row], out["x_gt"][row],
         out["q_gt"][row], out["valid"][row]) = self._pair_meta(d, s)
        out["meta"][row] = (di, s)

    def alloc_batch(self, rows: int) -> Dict[str, np.ndarray]:
        S = self.cfg.sequence_size
        P = self.cfg.num_pairs
        T = self.cfg.max_imu_per_pair
        N = self.cfg.projection.max_points
        batch = {key: np.empty((rows * S, N), np.float32)
                 for key in PLANE_KEYS}
        batch.update(
            points_valid=np.empty((rows * S, N), bool),
            imu=np.empty((rows, P, T, 6), np.float32),
            imu_mask=np.empty((rows, P, T), np.float32),
            x_gt=np.empty((rows, P, 3), np.float32),
            q_gt=np.empty((rows, P, 4), np.float32),
            valid=np.empty((rows, P), np.float32),
            meta=np.empty((rows, 2), np.int32))
        return batch

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches in one process, in the JAX package's order: the
        same seed shuffles the windows the same way."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n = len(order)
        end = (n // batch_size) * batch_size if drop_last else n
        for b0 in range(0, end, batch_size):
            sel = order[b0:b0 + batch_size]
            out = self.alloc_batch(len(sel))
            for row, i in enumerate(sel):
                self.get_into(int(i), row, out)
            yield out

