"""Drive evaluator (counterpart of ``deeplio_tpu/eval/runner.py``): run a
trained model over a drive in stride-1 windows, keep one relative pose
prediction per consecutive frame pair, chain the global trajectory and
score it against the drive's ground truth.

Under data parallelism (a ``mesh`` with a process group) every process
derives the same padded global batches, assembles only its contiguous
row block of each and gets back the gathered predictions from the
data-parallel ``eval_step``, as in the JAX package. Batches are assembled by a thread pool straight into the trainer's pinned
staging ring (``data/pipeline.py::PinnedRing``) and copied to the device
by ``DevicePrefetcher`` while the previous batch runs, as
``Trainer.validate`` does; the tail batch is padded with its last window,
so every batch has the same shape (one projection of ``batch * S`` scans
each).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.data.dataset import WindowDataset, empty_batch
from deeplio_tpu_torch.data.drives import Drive
from deeplio_tpu_torch.data.pipeline import DevicePrefetcher, PinnedRing
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.eval import metrics as em
from deeplio_tpu_torch.eval.trajectory import (
    chain_relative_np,
    gt_trajectory,
    write_kitti_poses,
)
from deeplio_tpu_torch.parallel.mesh import Mesh


def _eval_batches(ds: WindowDataset, bs: int, alloc: Callable,
                  lo: int = 0, local: Optional[int] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Every window of ``ds`` in order, ``bs`` a batch, the tail batch
    padded with its last window, of which rows [lo, lo + local); 8
    threads assemble a batch's windows, as ``WindowDataset.iter_batches``
    does."""
    local = bs if local is None else local
    idxs = list(range(len(ds)))
    with ThreadPoolExecutor(8) as pool:
        for b0 in range(0, len(idxs), bs):
            sel = idxs[b0:b0 + bs]
            sel.extend(sel[-1:] * (bs - len(sel)))
            sel = sel[lo:lo + local]
            out = alloc(ds.batch_spec(local))
            list(pool.map(lambda job: ds.get_into(job[1], job[0], out),
                          enumerate(sel)))
            yield out


def predict_drive(cfg: Config, eval_step, state, drive: Drive,
                  batch_size: Optional[int] = None, device: DeviceLike = None,
                  ring: Optional[PinnedRing] = None,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Predict (dx, dq) for every consecutive frame pair of a drive.

    Windows slide with stride 1 whatever the training ``window-stride``;
    each pair (k, k+1) takes the prediction of the first window covering
    it. The config's combinations must include consecutive pairs.
    ``eval_step`` is ``train/step.py::build_train_step``'s; ``device`` is
    CUDA unless ``"cpu"``; ``ring`` the staging buffers to assemble into
    (the trainer's; by default the prefetcher makes its own on the card).
    With a ``mesh`` of several ranks the global batch is rounded to a
    multiple of them, each rank assembles its rows onto its device and
    ``eval_step`` (built with the mesh) gathers the predictions.

    Returns (dx [n-1, 3], dq [n-1, 4]) float32.
    """
    dev = resolve_device(device) if mesh is None else mesh.device
    bs = batch_size or cfg.train.batch_size
    n_data = 1 if mesh is None else mesh.data
    bs = max((bs // n_data) * n_data, n_data)
    local = bs // n_data
    lo = 0 if mesh is None else mesh.rank * local
    # Evaluation must cover every consecutive pair: always slide windows
    # with stride 1 (a stride-8 training config would otherwise skip tail
    # pairs of each drive).
    ds = WindowDataset(dataclasses.replace(cfg.datasets, window_stride=1),
                       [drive], with_points=cfg.model.uses_lidar)
    combos = cfg.datasets.effective_combinations
    n_pairs = len(drive) - 1
    dx_out = np.full((n_pairs, 3), np.nan, np.float32)
    dq_out = np.full((n_pairs, 4), np.nan, np.float32)

    alloc = ring.take if ring is not None else empty_batch
    starts_done = 0
    it = DevicePrefetcher(_eval_batches(ds, bs, alloc, lo, local), dev,
                          depth=2, ring=ring)
    try:
        for batch in it:
            x, q, _ = eval_step(state, batch)
            x, q = x.float().cpu().numpy(), q.float().cpu().numpy()
            for bi in range(x.shape[0]):
                s = starts_done + bi
                if s >= len(ds):
                    break
                for pi, (i, j) in enumerate(combos):
                    if j - i != 1:
                        continue
                    g = s + i
                    if 0 <= g < n_pairs and np.isnan(dx_out[g, 0]):
                        dx_out[g] = x[bi, pi]
                        dq_out[g] = q[bi, pi]
            starts_done += x.shape[0]
    finally:
        it.close()

    if np.isnan(dx_out).any():
        missing = np.flatnonzero(np.isnan(dx_out[:, 0]))
        raise RuntimeError(
            f"trajectory coverage incomplete: pairs {missing[:10]}... "
            "(config combinations must include consecutive pairs)")
    return dx_out, dq_out


def evaluate_drive(cfg: Config, eval_step, state, drive: Drive,
                   out_dir: Optional[str] = None, device: DeviceLike = None,
                   ring: Optional[PinnedRing] = None,
                   mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """Full per-drive evaluation: trajectory + ATE/RPE/KITTI errors, and
    with ``out_dir`` the KITTI pose files ``<drive>_pred.txt`` and
    ``<drive>_gt.txt`` (and ``<drive>_traj.png`` where matplotlib
    imports)."""
    dx, dq = predict_drive(cfg, eval_step, state, drive, device=device,
                           ring=ring, mesh=mesh)
    pred = chain_relative_np(dx, dq)
    gt = gt_trajectory(drive)
    # GT is drive-local already; express both from the first evaluated frame.
    gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)

    scores: Dict[str, float] = {}
    scores["ate_m"] = em.ate(pred, gt)
    t_rpe, r_rpe = em.rpe(pred, gt, delta=1)
    scores["rpe_trans_m"] = t_rpe
    scores["rpe_rot_rad"] = r_rpe
    scores.update(em.kitti_odometry_errors(pred, gt))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_kitti_poses(os.path.join(out_dir, f"{drive.name}_pred.txt"), pred)
        write_kitti_poses(os.path.join(out_dir, f"{drive.name}_gt.txt"), gt)
        try:
            from deeplio_tpu_torch.eval.plot import plot_trajectories
            plot_trajectories(
                {"prediction": pred, "ground truth": gt},
                os.path.join(out_dir, f"{drive.name}_traj.png"),
                title=drive.name)
        except ImportError:
            pass
    return scores
