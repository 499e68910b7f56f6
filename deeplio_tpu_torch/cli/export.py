"""Serving-export CLI (counterpart of ``deeplio_tpu/cli/export.py``):
trained work directory -> self-contained streaming artifact
(``eval/export.py``): the streaming chunk step, projection through its
kernel operator, model and pose composition, weights inside, exported with
``torch.export`` for the device it will serve on.

Usage:
    python -m deeplio_tpu_torch.cli.export -c configs/deeplio_kitti_tpu.yaml \\
        --workdir runs/x [--out runs/x/artifact] [--chunk 16] [--use-best] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

from deeplio_tpu_torch.cli._common import restore_trainer
from deeplio_tpu_torch.config import load_config
from deeplio_tpu_torch.eval.export import export_streaming
from deeplio_tpu_torch.utils import get_app_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export a serving artifact")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--workdir", default="runs/default",
                   help="run dir containing checkpoints/")
    p.add_argument("--out", default=None,
                   help="artifact dir (default <workdir>/artifact)")
    p.add_argument("--chunk", type=int, default=16,
                   help="frames per exported step call")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact serves on")
    p.add_argument("--use-best", action="store_true",
                   help="export the best-validation snapshot")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config)
    log = get_app_logger()
    out = args.out or os.path.join(args.workdir, "artifact")

    trainer = restore_trainer(cfg, args.workdir, args.device, args.use_best,
                              log)
    try:
        art = export_streaming(cfg, trainer.state.model, out,
                               chunk=args.chunk, device=trainer.device)
    finally:
        trainer.close()
    log.info("wrote serving artifact to %s", art)
    return art


if __name__ == "__main__":
    main()
