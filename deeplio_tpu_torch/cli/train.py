"""Training CLI (counterpart of ``deeplio_tpu/cli/train.py``; reference:
``python train.py -c config.yaml [--resume]``), with the JAX package's
flags and override semantics.

Usage:
    python -m deeplio_tpu_torch.cli.train -c configs/deeplio_kitti_tpu.yaml \\
        [--workdir runs/x] [--epochs N] [--batch-size B] [--lr F] \\
        [--seed S] [--resume] [--profile-steps N] [--debug-nans] \\
        [--data-parallel N] [--coordinator host:port --num-processes N \\
        --process-id I] [--device cuda|cpu]

``--profile-steps N`` (N > 0) writes a ``torch.profiler`` Chrome trace of
the first epoch to ``<workdir>/profile/trace.json``, then trains the other
epochs. ``--debug-nans`` turns on autograd's anomaly detection.

Data parallelism runs one process per GPU, each started with the same
command and its own ``--process-id`` (or ``DEEPLIO_COORDINATOR``,
``DEEPLIO_NUM_PROCESSES``, ``DEEPLIO_PROCESS_ID``), or under ``torchrun
--nproc-per-node N -m deeplio_tpu_torch.cli.train ...``; the processes
join (NCCL on the card, gloo with ``--device cpu``) before the Trainer
touches the device, and ``--data-parallel`` (``train.data-parallel``,
default all of them) must equal their number.
"""

from __future__ import annotations

import argparse
import os

import torch
import yaml

from deeplio_tpu_torch.config import load_config_dict
from deeplio_tpu_torch.parallel.multihost import maybe_initialize
from deeplio_tpu_torch.train import Trainer
from deeplio_tpu_torch.utils import get_app_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train DeepLIO")
    p.add_argument("-c", "--config", required=True, help="YAML config path")
    p.add_argument("--workdir", default="runs/default")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override train.seed (init/shuffle/dropout streams)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="-1 = all processes (default from config)")
    p.add_argument("--resume", action="store_true",
                   help="resume from latest checkpoint in workdir")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True)")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="N > 0: write a torch.profiler trace of the first "
                        "epoch to <workdir>/profile")
    p.add_argument("--coordinator", default=None,
                   help="multi-process: coordinator host:port (or set "
                        "DEEPLIO_COORDINATOR, or run under torchrun)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def load_with_overrides(args):
    """The config file with the command line's overrides applied to its
    keys before parsing, so an override is checked as the file would
    be."""
    with open(args.config) as f:
        d = yaml.safe_load(f) or {}
    train = d.setdefault("train", {})
    for key, value in (("epochs", args.epochs),
                       ("batch-size", args.batch_size),
                       ("data-parallel", args.data_parallel),
                       ("seed", args.seed)):
        if value is not None:
            train.pop(key.replace("-", "_"), None)
            train[key] = value
    if args.lr is not None:
        d.setdefault("optimizer", {})["lr"] = args.lr
    return load_config_dict(d)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_with_overrides(args)
    # join the other processes before anything touches the device
    maybe_initialize(args.coordinator, args.num_processes, args.process_id,
                     backend="gloo" if args.device == "cpu" else None)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    log = get_app_logger()
    log.info("arch=%s workdir=%s device=%s", cfg.model.arch, args.workdir,
             args.device)
    trainer = Trainer(cfg, workdir=args.workdir, resume=args.resume,
                      device=args.device)
    try:
        if args.profile_steps > 0:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if trainer.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                trainer.fit(epochs=1)
            path = os.path.join(args.workdir, "profile", "trace.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            prof.export_chrome_trace(path)
            log.info("profile trace written to %s", path)
            trainer.fit(epochs=max(cfg.train.epochs - 1, 0))
        else:
            trainer.fit()
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
