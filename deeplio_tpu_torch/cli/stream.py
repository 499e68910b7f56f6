"""Streaming odometry CLI (counterpart of ``deeplio_tpu/cli/stream.py``):
stream every drive of a split through ``StreamingOdometry`` (one scan a
tick, the selection kernel at B = 1), report per drive the frame rate,
the real-time factor against a 10 Hz LiDAR and the trajectory scores, and
write the KITTI-format trajectory ``<drive>_stream.txt``.

Usage:
    python -m deeplio_tpu_torch.cli.stream -c config.yaml --workdir runs/x \\
        [--split test] [--chunk 16] [--out runs/x/stream] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from deeplio_tpu_torch.cli._common import restore_trainer
from deeplio_tpu_torch.config import load_config
from deeplio_tpu_torch.data.dataset import build_drives
from deeplio_tpu_torch.eval.metrics import ate, kitti_odometry_errors, rpe
from deeplio_tpu_torch.eval.streaming import StreamingOdometry
from deeplio_tpu_torch.eval.trajectory import gt_trajectory, write_kitti_poses
from deeplio_tpu_torch.utils import get_app_logger

LIDAR_HZ = 10.0


def main(argv=None):
    p = argparse.ArgumentParser(description="Streaming odometry inference")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--split", default="test",
                   choices=["train", "validation", "test"])
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    log = get_app_logger()
    out = args.out or os.path.join(args.workdir, "stream")
    os.makedirs(out, exist_ok=True)

    trainer = restore_trainer(cfg, args.workdir, args.device)
    try:
        so = StreamingOdometry(cfg, trainer.state.model, chunk=args.chunk,
                               device=trainer.device)
        scores = {}
        for drive in build_drives(cfg, args.split):
            t0 = time.time()
            poses, dx, dq = so.run(drive)      # ends in a copy to the host
            dt = time.time() - t0
            gt = gt_trajectory(drive)
            gt = np.einsum("ij,njk->nik", np.linalg.inv(gt[0]), gt)
            pred = poses.astype(np.float64)
            s = {
                "frames": len(drive),
                "frames_per_sec": len(drive) / dt,
                "real_time_factor": len(drive) / dt / LIDAR_HZ,
                "ate_m": ate(pred, gt),
                "rpe_trans_m": rpe(pred, gt)[0],
            }
            s.update(kitti_odometry_errors(pred, gt))
            scores[drive.name] = s
            write_kitti_poses(os.path.join(out, f"{drive.name}_stream.txt"),
                              pred)
            log.info("%s: %.1f fps (%.1fx RT)  ATE %.3fm  RPE %.3fm",
                     drive.name, s["frames_per_sec"], s["real_time_factor"],
                     s["ate_m"], s["rpe_trans_m"])
        with open(os.path.join(out, "scores.json"), "w") as f:
            json.dump(scores, f, indent=2)
        log.info("wrote %s", os.path.join(out, "scores.json"))
    finally:
        trainer.close()
    return scores


if __name__ == "__main__":
    main()
