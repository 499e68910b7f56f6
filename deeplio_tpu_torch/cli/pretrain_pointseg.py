"""PointSeg backbone pretraining CLI (counterpart of
``deeplio_tpu/cli/pretrain_pointseg.py``), with the JAX package's flags
and the port's ``--device``.

Usage:
    python -m deeplio_tpu_torch.cli.pretrain_pointseg \\
        -c configs/deeplio_kitti_tpu.yaml --out runs/pointseg_pre \\
        [--steps 200] [--batch-size 4] [--lr 1e-3] [--seed 0] \\
        [--device cuda|cpu]

Then point the odometry config at the snapshot:
    lidar-feat-pointseg: {pretrained: true, model-path: runs/pointseg_pre}
"""

from __future__ import annotations

import argparse

from deeplio_tpu_torch.config import load_config
from deeplio_tpu_torch.train.pretrain import pretrain_pointseg
from deeplio_tpu_torch.utils import get_app_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Pretrain the PointSeg backbone")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--out", required=True, help="directory for encoder params")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    """Pretrain and save; returns ``pretrain_pointseg``'s result."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    out = pretrain_pointseg(cfg, args.out, steps=args.steps,
                            batch_size=args.batch_size, lr=args.lr,
                            seed=args.seed, device=args.device)
    get_app_logger().info("pretraining done: loss %.4f acc %.3f -> %s",
                          out["loss"], out["acc"], args.out)
    return out


if __name__ == "__main__":
    main()
