"""Optimizer, learning-rate schedule and plateau controller from config
(counterpart of ``deeplio_tpu/train/optim.py``).

The JAX package chains ``optax.clip_by_global_norm`` in front of
``optax.adam`` (``optax.adamw`` with ``weight-decay``) or ``optax.sgd``
with momentum (behind ``optax.add_decayed_weights`` with
``weight-decay``), driven by a step-indexed schedule. Here
``torch.optim.Adam`` and ``torch.optim.SGD`` compute the same updates;
:class:`Optimizer` sets their learning rate from the step count before
each update and clips the gradients the way optax does: by ``c / |g|``
when the global norm ``|g| >= c``, with no epsilon (``clip_grad_norm_``
adds 1e-6 to the norm, so it is not used).

AdamW is optax's: ``p + (-lr) * (adam + wd * p)``, the decay scaled by
the learning rate. ``torch.optim.AdamW`` is the same update, its decay
taken first as ``p * (1 - lr * wd)``; here the decay is taken first as
``p + (-lr * wd) * p`` (the old ``p``, as optax reads it) and Adam's
step after it, which rounds apart from optax by a few ulps of ``p``
(``tests/test_torch_optim.py`` measures it). SGD is optax's trace ``t =
g + m * t`` from zeros (so the first ``t = g``), which is
``torch.optim.SGD`` with ``dampening=0`` and ``nesterov=False``, its
``weight_decay`` adding ``wd * p`` to the clipped gradient before the
trace, as optax's chain orders them. The schedules follow optax's
``exponential_decay(staircase=True)``, ``cosine_decay_schedule`` and the
``linear_schedule`` warm-up joined in front of them, in float32. With
``scheduler: plateau`` the learning rate is a float32 constant that only
:class:`PlateauController` rewrites, after a validation (optax's
``inject_hyperparams`` in the JAX package).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import numpy as np
import torch

from deeplio_tpu_torch.config.schema import OptimConfig


def make_schedule(cfg: OptimConfig, steps_per_epoch: int = 1000
                  ) -> Callable[[int], float]:
    """Learning rate as a function of the optimizer step (0 = first)."""
    base = np.float32(cfg.lr)
    decay_steps = cfg.step_size * steps_per_epoch

    def main(count: int) -> np.float32:
        if cfg.scheduler == "none":
            return base
        if cfg.scheduler == "step":
            if decay_steps <= 0:
                return base
            return base * np.float32(cfg.gamma) ** np.float32(
                count // decay_steps)
        if cfg.scheduler == "cosine":
            total = max(decay_steps, 1)
            frac = np.float32(min(count, total)) / np.float32(total)
            return base * np.float32(0.5) * (
                np.float32(1.0) + np.cos(np.float32(math.pi) * frac))
        raise ValueError(f"unknown scheduler '{cfg.scheduler}'")

    def schedule(count: int) -> float:
        w = cfg.warmup_steps
        if w <= 0:
            return float(main(count))
        if count < w:
            return float(base * (np.float32(count) / np.float32(w)))
        return float(main(count - w))

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax's ``clip_by_global_norm`` in place: unchanged when ``norm <
    max_norm``, else scaled by ``max_norm / norm``."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class Optimizer:
    """Adam, AdamW or SGD with momentum, with optax's gradient clip and a
    step-indexed (or plateau) learning rate, over one list of parameters
    (the model's and the loss's alike: one update, one norm, one decay)."""

    def __init__(self, cfg: OptimConfig, params: Iterable[torch.Tensor],
                 steps_per_epoch: int = 1000):
        self.params = list(params)
        self.name = cfg.name
        # plateau: the constant learning rate the controller rewrites
        self.lr = float(np.float32(cfg.lr))
        self.schedule = (None if cfg.scheduler == "plateau"
                         else make_schedule(cfg, steps_per_epoch))
        self.grad_clip = cfg.grad_clip
        self.flat_update = cfg.flat_update
        lr = self.learning_rate(0)
        if cfg.name == "sgd":
            self.decay = 0.0          # inside torch's SGD
            self.inner = torch.optim.SGD(
                self.params, lr=lr, momentum=cfg.momentum, dampening=0.0,
                nesterov=False, weight_decay=cfg.weight_decay)
        else:
            self.decay = cfg.weight_decay
            self.inner = torch.optim.Adam(self.params, lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def learning_rate(self, count: int) -> float:
        return self.lr if self.schedule is None else self.schedule(count)

    def state_dict(self) -> dict:
        """The inner optimizer's state (Adam's moments and step, or SGD's
        momentum buffers) under ``inner``, its ``name`` and the plateau
        learning rate."""
        return {"name": self.name, "inner": self.inner.state_dict(),
                "lr": self.lr}

    def load_state_dict(self, d: dict) -> None:
        """Also a checkpoint from before SGD was ported, whose Adam state
        is under ``adam``."""
        name = d.get("name", "adam")
        if name != self.name:
            raise ValueError(f"the checkpoint's optimizer is {name}, the "
                             f"run's {self.name}")
        self.inner.load_state_dict(d["inner"] if "inner" in d else d["adam"])
        self.lr = float(d["lr"])

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        """Clip, set the learning rate of step ``count`` and update.
        Returns the global gradient norm before clipping. A parameter
        without a gradient is updated with a zero one, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.nn.utils.get_total_norm(grads)   # no host sync
        if self.grad_clip > 0:
            clip_norm = norm
            if self.flat_update:
                # one vector, as the JAX package's raveled update sees it
                clip_norm = torch.linalg.vector_norm(
                    torch.cat([g.flatten() for g in grads]))
            clip_by_global_norm_(grads, self.grad_clip, clip_norm)
        lr = self.learning_rate(count)
        if self.decay > 0:
            # AdamW: the decay on the parameters before Adam's step
            with torch.no_grad():
                torch._foreach_add_(self.params, self.params,
                                    alpha=-lr * self.decay)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        return norm


class PlateauController:
    """Host-side ReduceLROnPlateau over the optimizer's constant learning
    rate (torch's scheduler contract, as the JAX package's controller).

    The trainer calls :meth:`observe` after every validation: when the
    validation loss has not improved by more than ``threshold`` for
    ``patience`` observations, the learning rate is scaled by ``gamma``,
    floored at ``min_lr``.
    """

    def __init__(self, cfg: OptimConfig):
        self.enabled = cfg.scheduler == "plateau"
        self.gamma = cfg.gamma
        self.patience = cfg.patience
        self.min_lr = cfg.min_lr
        self.threshold = cfg.threshold
        self.best = float("inf")
        self.bad = 0
        self.lr = cfg.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "bad": self.bad}

    def restore_state(self, d) -> None:
        if not d:
            return
        self.lr = float(d.get("lr", self.lr))
        self.best = float(d.get("best", self.best))
        self.bad = int(d.get("bad", self.bad))

    def observe(self, val_loss: float, optimizer: Optimizer) -> None:
        """Count one validation; on a plateau, lower ``optimizer``'s
        learning rate (stored in float32, as the JAX package's injected
        hyperparameter is)."""
        if not self.enabled:
            return
        if val_loss < self.best - self.threshold:
            self.best = val_loss
            self.bad = 0
            return
        self.bad += 1
        if self.bad < self.patience:
            return
        self.bad = 0
        new_lr = max(self.lr * self.gamma, self.min_lr)
        if new_lr == self.lr:
            return
        self.lr = new_lr
        optimizer.lr = float(np.float32(new_lr))
