"""Window dataset and batch assembly (counterpart of
``deeplio_tpu/data/dataset.py``: ``WindowDataset`` on raw points or on
cached projections, single process, assembling each batch in place with a
thread pool, and ``build_drives``/``build_dataset`` for KITTI raw drives
and synthetic drives).

Each item is a window of ``sequence-size`` frames from one drive; the
configured ``combinations`` define its P frame pairs. Per pair it carries
the IMU samples between the two frames, padded to ``max-imu-per-pair``
with a mask, and the float64-derived relative pose ground truth (dx, dq).
Projection does not happen here: the raw scans go to the device as
channel planes, flattened to [B*S, N], and the training step projects
them; with a projection cache (``data/proj_cache.py``) the items carry the
cached f16 images [B, S, H, W, C] instead. The same drives give the same
batches as the JAX package, bit for bit.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplio_tpu_torch.config.schema import Config, DatasetConfig
from deeplio_tpu_torch.data import np_spatial as nsp
from deeplio_tpu_torch.data.drives import (Drive, KittiRawDrive,
                                           PermutedDrive, SyntheticDrive)

# channel planes of the raw scans, flat [B*S, N]: the step projects per
# frame
PLANE_KEYS = ("points_x", "points_y", "points_z", "points_rem")
FLAT_KEYS = PLANE_KEYS + ("points_valid",)

# {key: (shape, numpy dtype)} of one batch, and a function that returns
# arrays of that layout to assemble a batch into
BatchSpec = Dict[str, Tuple[Tuple[int, ...], type]]
Alloc = Callable[[BatchSpec], Dict[str, np.ndarray]]


def empty_batch(spec: BatchSpec) -> Dict[str, np.ndarray]:
    return {k: np.empty(shape, dtype) for k, (shape, dtype) in spec.items()}


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack items (:meth:`WindowDataset.get`) into a batch, the plane
    keys flattened to [B*S, N]."""
    out = {}
    for k in items[0]:
        v = np.stack([it[k] for it in items])
        if k in FLAT_KEYS:
            v = v.reshape((-1,) + v.shape[2:])
        out[k] = v
    return out


class WindowDataset:
    """Windows of ``sequence-size`` frames, every ``window-stride`` frames
    of each drive.

    ``image_cache`` (a ``ProjectionCache``): the items carry the cached f16
    ``images`` [S, H, W, C] instead of the raw points, and the training
    step skips its projection. ``with_points=False``: neither (DeepIO's
    items: the IMU windows and the ground truth only).
    """

    def __init__(self, ds_cfg: DatasetConfig, drives: Sequence[Drive],
                 with_points: bool = True, image_cache=None):
        self.cfg = ds_cfg
        self.drives = list(drives)
        self.with_points = with_points and image_cache is None
        self.image_cache = image_cache
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
        laid out as :meth:`batch_spec` says."""
        di, s = self.index[idx]
        d = self.drives[di]
        S = self.cfg.sequence_size
        if self.with_points:
            for k in range(S):
                planes, vld = d.points_planes(s + k)
                r = row * S + k
                for c, key in enumerate(PLANE_KEYS):
                    out[key][r] = planes[c]
                out["points_valid"][r] = vld
        elif self.image_cache is not None:
            out["images"][row] = self.image_cache.images(d, s, s + S)
        (out["imu"][row], out["imu_mask"][row], out["x_gt"][row],
         out["q_gt"][row], out["valid"][row]) = self._pair_meta(d, s)
        out["meta"][row] = (di, s)

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        """Window ``idx`` as one item: planes [S, N], ``images`` [S, H, W,
        C], the pair meta [P, ...] and ``meta`` (drive, start)."""
        out = empty_batch(self.batch_spec(1))
        self.get_into(idx, 0, out)
        return {k: v if k in FLAT_KEYS else v[0] for k, v in out.items()}

    def batch_spec(self, rows: int) -> BatchSpec:
        """The layout of a batch of ``rows`` windows."""
        S = self.cfg.sequence_size
        P = self.cfg.num_pairs
        T = self.cfg.max_imu_per_pair
        spec: BatchSpec = {}
        if self.with_points:
            N = self.cfg.projection.max_points
            spec.update({key: ((rows * S, N), np.float32)
                         for key in PLANE_KEYS})
            spec["points_valid"] = ((rows * S, N), np.bool_)
        elif self.image_cache is not None:
            p = self.cfg.projection
            spec["images"] = ((rows, S, p.height, p.width,
                               self.cfg.num_image_channels), np.float16)
        spec.update(imu=((rows, P, T, 6), np.float32),
                    imu_mask=((rows, P, T), np.float32),
                    x_gt=((rows, P, 3), np.float32),
                    q_gt=((rows, P, 4), np.float32),
                    valid=((rows, P), np.float32),
                    meta=((rows, 2), np.int32))
        return spec

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True,
                     workers: int = 8, alloc: Optional[Alloc] = None,
                     process_index: int = 0, process_count: int = 1,
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Host batches in the JAX package's order: the same seed shuffles
        the windows the same way.

        ``workers`` threads assemble the windows of a batch (numpy copies
        that release the GIL), as the JAX package's pool does. ``alloc``
        returns the arrays each batch is assembled into (fresh ones by
        default; ``data/pipeline.py`` passes page-locked staging buffers).

        Multi-process: ``batch_size`` is global. Every process derives the
        same order and assembles only its contiguous row block of each
        global batch: process p of n yields rows [p * B / n, (p + 1) * B
        / n) (``parallel/multihost.py::process_slice``).
        """
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        if process_count > 1 and not drop_last:
            raise ValueError("multi-process iteration requires drop_last "
                             "(a ragged tail batch cannot shard evenly)")
        local = batch_size // process_count
        lo = process_index * local
        alloc = alloc or empty_batch
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        n = len(order)
        end = (n // batch_size) * batch_size if drop_last else n
        pool = ThreadPoolExecutor(workers) if workers > 1 else None
        try:
            for b0 in range(0, end, batch_size):
                sel = order[b0:min(b0 + batch_size, end)][lo:lo + local]
                out = alloc(self.batch_spec(len(sel)))
                jobs = [(int(i), row, out) for row, i in enumerate(sel)]
                if pool is None:
                    for job in jobs:
                        self.get_into(*job)
                else:
                    list(pool.map(lambda job: self.get_into(*job), jobs))
                yield out
        finally:
            if pool is not None:
                pool.shutdown()

    def steps_per_epoch(self, batch_size: int) -> int:
        return len(self) // batch_size


def build_drives(cfg: Config, split: str) -> List[Drive]:
    """The drives of a split (``train``, ``validation`` or ``test``): the
    KITTI raw drives the split lists under ``root-path``, each a number or
    ``{drive, start, end}``; with ``datasets.synthetic``, deterministic
    synthetic drives with the JAX package's seeds and lengths (train seeds
    0.., validation 100.., test 200..).

    The slot grid, as in the JAX package: KITTI drives are binned under
    ``slot-bin``; synthetic drives under ``slot-bin`` or ``kernel-aligned:
    trust | halves`` (their scans are compacted, not on the grid). Under
    ``halves`` binned drives bin straight into the dual-half layout, and
    the others are wrapped in a ``PermutedDrive``."""
    ds = cfg.datasets
    proj = ds.projection
    n_pts = proj.max_points
    halves = proj.kernel_aligned == "halves"
    grid = (proj.height, proj.width, proj.fov_up_deg, proj.fov_down_deg)
    binned = dict(slot_layout="halves" if halves else "slots")
    if ds.synthetic:
        seeds = {"train": range(ds.synthetic_train_drives),
                 "validation": range(100, 100 + ds.synthetic_eval_drives),
                 "test": range(200, 200 + ds.synthetic_eval_drives)}[split]
        n_frames = ds.synthetic_frames
        if split != "train" and ds.synthetic_eval_frames:
            n_frames = ds.synthetic_eval_frames
        on_grid = ds.slot_bin or proj.kernel_aligned in ("trust", "halves")
        drives: List[Drive] = [
            SyntheticDrive(n_frames=n_frames, max_points=n_pts, seed=sd,
                           world_mode=ds.synthetic_world,
                           slot_grid=grid if on_grid else None, **binned)
            for sd in seeds]
        return _layout(drives, halves, proj)
    binned["slot_grid"] = grid if ds.slot_bin else None
    split_map = {"train": ds.train, "validation": ds.validation,
                 "test": ds.test}
    drives = []
    for date, ids in split_map[split].items():
        for drive in ids:
            if isinstance(drive, dict):
                drives.append(KittiRawDrive(
                    ds.root_path, date, int(drive["drive"]),
                    max_points=n_pts, start=int(drive.get("start", 0)),
                    end=int(drive.get("end", -1)), **binned))
            else:
                drives.append(KittiRawDrive(ds.root_path, date, int(drive),
                                            max_points=n_pts, **binned))
    return _layout(drives, halves, proj)


def _layout(drives: List[Drive], halves: bool, proj) -> List[Drive]:
    """Under ``halves``, a ``PermutedDrive`` around each drive with no
    slot grid (a binned one is in the layout already)."""
    if not halves:
        return drives
    from deeplio_tpu_torch.ops.projection import halves_permutation

    perm = halves_permutation(proj.max_points, proj.height, proj.width)
    return [d if getattr(d, "slot_grid", None) is not None
            else PermutedDrive(d, perm) for d in drives]


def build_dataset(cfg: Config, split: str,
                  image_cache=None) -> WindowDataset:
    """A split's windows; with raw points for the LiDAR archs only (DeepIO
    reads none)."""
    return WindowDataset(cfg.datasets, build_drives(cfg, split),
                         with_points=cfg.model.uses_lidar,
                         image_cache=image_cache)
