"""Train state (counterpart of ``deeplio_tpu/train/state.py``).

One object holds everything a training step mutates: the model (its
parameters and BatchNorm statistics), the loss's trainable parameters
(LWS ``sx``, ``sq``), the optimizer over both, the step counter and the
``torch.Generator`` that draws the augmentation angles and dropout masks
on the model's device. PyTorch updates them in place.

The model and the loss's parameters are also held as one module whose
forward is the training loss, :class:`Trainables` (JAX's ``trainables =
{model, loss}``), which the train step calls. Under data parallelism (a
mesh with a process group, ``parallel/``) it is wrapped in
``DistributedDataParallel``, which averages the gradients of ``sx`` and
``sq`` with the model's. Every rank starts from rank 0's
parameters and BatchNorm statistics, and the model's BatchNorms take
their statistics over the whole data axis (``models/zoo.py::
sync_batchnorm``). Each rank's generator is seeded with its rank folded
in, as JAX folds ``axis_index`` into the dropout and yaw keys: rank 0
keeps the one-process seed, the others draw their own masks and angles.

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
from torch import nn

from deeplio_tpu_torch.config.schema import Config, LossConfig
from deeplio_tpu_torch.losses.pose import init_loss_params, pose_loss
from deeplio_tpu_torch.models.zoo import sync_batchnorm
from deeplio_tpu_torch.parallel.mesh import Mesh, replicate
from deeplio_tpu_torch.train.optim import Optimizer


class Trainables(nn.Module):
    """The model and the loss's parameters as one module, whose forward is
    the training loss: ``(total, metrics)`` of a model batch ``mb`` against
    ``raw``'s ground truth. It holds the same ``Parameter`` objects as the
    model and ``TrainState.loss_params``."""

    def __init__(self, model: nn.Module,
                 loss_params: Dict[str, nn.Parameter], loss_cfg: LossConfig):
        super().__init__()
        self.model = model
        self.loss = nn.ParameterDict(loss_params)
        self.loss_cfg = loss_cfg

    def forward(self, mb, raw, generator):
        x_pred, q_pred = self.model(mb, generator)
        return pose_loss(self.loss_cfg, dict(self.loss), x_pred, q_pred,
                         raw["x_gt"], raw["q_gt"], raw.get("valid"))


@dataclass
class TrainState:
    model: torch.nn.Module
    loss_params: Dict[str, torch.nn.Parameter]
    optimizer: Optimizer
    generator: torch.Generator
    # Trainables(model, loss_params), in DistributedDataParallel under
    # data parallelism
    trainables: Optional[nn.Module] = None
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


def fold_in(seed: int, rank: int) -> int:
    """Rank ``rank``'s generator seed: ``seed`` itself on rank 0, a
    distinct stream on every other rank."""
    return seed + (rank << 32)


def create_train_state(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int = 1000,
                       seed: Optional[int] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """Loss parameters, optimizer and generator for ``model``, on its
    device. ``seed`` (default ``train.seed + 1``, as the JAX trainer's
    PRNG key) seeds the generator.

    With a ``mesh`` that has a process group, the model's BatchNorms are
    synchronised over it, rank 0's parameters and statistics are broadcast
    to every rank and ``trainables`` is wrapped in
    ``DistributedDataParallel``; the generator's seed has the rank folded
    in. With no group the state is the one-device state."""
    dev = next(model.parameters()).device
    loss_params = init_loss_params(cfg.loss, device=dev)
    opt = Optimizer(cfg.optim,
                    list(model.parameters()) + list(loss_params.values()),
                    steps_per_epoch)
    seed = cfg.train.seed + 1 if seed is None else seed
    trainables = Trainables(model, loss_params, cfg.loss)
    if mesh is not None and mesh.group is not None:
        from torch.nn.parallel import DistributedDataParallel

        sync_batchnorm(model, mesh.group)
        replicate(mesh, trainables)
        # the buffers (BatchNorm statistics) are updated from the global
        # statistics on every rank, so DDP need not broadcast them; every
        # parameter of the zoo's configurations gets a gradient
        trainables = DistributedDataParallel(
            trainables, device_ids=[dev.index] if dev.type == "cuda" else
            None, process_group=mesh.group, broadcast_buffers=False,
            init_sync=False)
        seed = fold_in(seed, mesh.rank)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return TrainState(model=model, loss_params=loss_params, optimizer=opt,
                      generator=gen, trainables=trainables)
