"""Train state (counterpart of ``deeplio_tpu/train/state.py``).

One object holds everything a training step mutates: the model (its
parameters and BatchNorm statistics), the loss's trainable parameters
(LWS ``sx``, ``sq``), the optimizer over both, the step counter and the
``torch.Generator`` that draws the augmentation angles and dropout masks
on the model's device. PyTorch updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.losses.pose import init_loss_params
from deeplio_tpu_torch.train.optim import Optimizer


@dataclass
class TrainState:
    model: torch.nn.Module
    loss_params: Dict[str, torch.nn.Parameter]
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def create_train_state(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int = 1000,
                       seed: Optional[int] = None) -> TrainState:
    """Loss parameters, optimizer and generator for ``model``, on its
    device. ``seed`` (default ``train.seed + 1``, as the JAX trainer's
    PRNG key) seeds the generator."""
    dev = next(model.parameters()).device
    loss_params = init_loss_params(cfg.loss, device=dev)
    opt = Optimizer(cfg.optim,
                    list(model.parameters()) + list(loss_params.values()),
                    steps_per_epoch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.train.seed + 1 if seed is None else seed)
    return TrainState(model=model, loss_params=loss_params, optimizer=opt,
                      generator=gen)
