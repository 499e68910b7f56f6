"""Train state (counterpart of ``deeplio_tpu/train/state.py``).

One object holds everything a training step mutates: the model (its
parameters and BatchNorm statistics), the loss's trainable parameters
(LWS ``sx``, ``sq``), the optimizer over both, the step counter and the
``torch.Generator`` that draws the augmentation angles and dropout masks
on the model's device. PyTorch updates them in place.

``state_dict()`` / ``load_state_dict()`` cover all of it, so a checkpoint
(``train/checkpoint.py``) restores a run bit for bit: the model's
parameters and BatchNorm buffers, ``sx``/``sq``, the optimizer's state
(Adam's moments and step, or SGD's momentum buffers, and the plateau
learning rate), ``step`` and the generator's state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

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

    def state_dict(self) -> Dict[str, Any]:
        """Tensors as they are (on the model's device, except the
        generator's state, a CPU byte tensor)."""
        return {"step": self.step,
                "model": self.model.state_dict(),
                "loss_params": {k: v.detach()
                                for k, v in self.loss_params.items()},
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        """Copy ``d`` into this state, in place (tensors may be on any
        device)."""
        self.model.load_state_dict(d["model"])
        if d["loss_params"].keys() != self.loss_params.keys():
            raise KeyError(f"loss parameters {sorted(d['loss_params'])} do "
                           f"not match {sorted(self.loss_params)}")
        with torch.no_grad():
            for k, v in d["loss_params"].items():
                self.loss_params[k].copy_(v)
        self.optimizer.load_state_dict(d["optimizer"])
        self.generator.set_state(d["generator"].cpu())
        self.step = int(d["step"])


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
