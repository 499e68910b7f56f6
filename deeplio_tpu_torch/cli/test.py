"""Evaluation CLI (counterpart of ``deeplio_tpu/cli/test.py``; reference:
``python test.py -c config.yaml``): restore a checkpoint, slide stride-1
windows over each drive of a split, chain and write the trajectories
(KITTI pose format), and score them: ATE, RPE and the KITTI relative
errors, per drive, in ``<out>/scores.json``.

Usage:
    python -m deeplio_tpu_torch.cli.test -c configs/deeplio_kitti_tpu.yaml \\
        --workdir runs/x [--split test] [--out runs/x/eval] [--use-best] \\
        [--device cuda|cpu]

``--batch-size`` is parsed and ignored, as in the JAX package: eval
batches hold ``train.batch-size`` windows.
"""

from __future__ import annotations

import argparse
import json
import os

from deeplio_tpu_torch.cli._common import restore_trainer
from deeplio_tpu_torch.config import load_config
from deeplio_tpu_torch.data.dataset import build_drives
from deeplio_tpu_torch.eval.runner import evaluate_drive
from deeplio_tpu_torch.utils import get_app_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a trained model")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--workdir", default="runs/default",
                   help="run dir containing checkpoints/")
    p.add_argument("--split", default="test",
                   choices=["train", "validation", "test"])
    p.add_argument("--out", default=None, help="output dir (default <workdir>/eval)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--use-best", action="store_true",
                   help="evaluate the best-validation snapshot (<workdir>/best) "
                        "instead of the latest checkpoint")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config)
    log = get_app_logger()
    out = args.out or os.path.join(args.workdir, "eval")

    trainer = restore_trainer(cfg, args.workdir, args.device, args.use_best,
                              log)
    try:
        all_scores = {}
        for d in build_drives(cfg, args.split):
            scores = evaluate_drive(cfg, trainer.eval_step, trainer.state, d,
                                    out_dir=out, device=trainer.device,
                                    ring=trainer.ring)
            all_scores[d.name] = scores
            log.info("%s: ATE %.3fm  RPE %.3fm/%.4frad  t_rel %.2f%%  "
                     "r_rel %.3fdeg/100m", d.name, scores["ate_m"],
                     scores["rpe_trans_m"], scores["rpe_rot_rad"],
                     scores["t_rel_pct"], scores["r_rel_deg_per_100m"])
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "scores.json"), "w") as f:
            json.dump(all_scores, f, indent=2)
        log.info("wrote %s", os.path.join(out, "scores.json"))
    finally:
        trainer.close()
    return all_scores


if __name__ == "__main__":
    main()
