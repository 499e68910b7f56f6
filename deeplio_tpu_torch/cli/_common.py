"""What the evaluation, streaming and export CLIs share: restore a trained
run's model from its work directory."""

from __future__ import annotations

import os

from deeplio_tpu_torch.train import Trainer
from deeplio_tpu_torch.train.checkpoint import load_params


def restore_trainer(cfg, workdir: str, device: str, use_best: bool = False,
                    log=None) -> Trainer:
    """A ``Trainer`` (eval only) with the latest checkpoint of ``workdir``
    restored, and with ``use_best`` the parameters of the best-validation
    snapshot ``<workdir>/best`` loaded over it. ``SystemExit`` when the
    work directory holds no checkpoint."""
    trainer = Trainer(cfg, workdir=workdir, resume=True, eval_only=True,
                      device=device)
    if trainer.ckpt.latest_step() is None:
        trainer.close()
        raise SystemExit(f"no checkpoint found under {workdir}")
    if use_best:
        best = os.path.join(workdir, "best")
        load_params(best, trainer.state.model)
        if log is not None:
            log.info("using the best-validation snapshot from %s", best)
    return trainer
