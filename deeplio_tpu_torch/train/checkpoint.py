"""Checkpoints in torch's own format (counterpart of
``deeplio_tpu/train/checkpoint.py``, which uses orbax; reference:
``torch.save``/``torch.load`` of ``{epoch, state_dict, optimizer, best}``,
``--resume`` and the pretrained PointSeg hook).

``CheckpointManager`` keeps one directory per step label under its
directory, ``<step>/state.pt`` (``TrainState.state_dict()``: everything a
step mutates, the generator included) and ``<step>/metrics.json``. Each
file is written to a temporary name and moved into place with
``os.replace``, so a label whose ``state.pt`` exists is complete. Saves
are synchronous: ``torch.save`` copies the card's tensors to the host as
it writes.

Multi-process: every process calls ``maybe_save`` (with the same
arguments, as every rank of a data-parallel run holds the same state);
only the primary writes, and every process waits at a barrier until it
has. Every process can restore from the shared directory.

``save_params``/``load_params`` keep one parameter snapshot (the best
model, a warm start); ``load_pointseg_backbone`` grafts a snapshot's
PointSeg encoder into a model and leaves every other tensor as it was.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional

import torch
from torch import nn

from deeplio_tpu_torch.parallel import multihost
from deeplio_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
PARAMS_FILE = "params.pt"


def _atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Step-labelled checkpoints, the newest ``keep`` kept; periodic saves
    every ``save_every_steps`` steps (0 = only forced saves)."""

    def __init__(self, directory: str, keep: int = 3,
                 save_every_steps: int = 500):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.save_every_steps = save_every_steps

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> List[int]:
        """The complete labels, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, STATE_FILE)))

    def maybe_save(self, state: TrainState, metrics: Optional[dict] = None,
                   force: bool = False, step: Optional[int] = None) -> bool:
        """Save ``state`` under ``step`` (default ``state.step``) when
        forced or on the periodic cadence; True if it wrote. The JAX
        package's rules: a label that exists is not written again, except
        by a forced save carrying metrics over a save without them, and
        never when that label is the only checkpoint."""
        step = state.step if step is None else step
        if not force and (self.save_every_steps <= 0
                          or step % self.save_every_steps != 0):
            return False
        steps = self.all_steps()
        write = step not in steps or (
            bool(force and metrics and not self.metrics(step))
            and len(steps) > 1)
        if write and multihost.is_primary():
            self._write(state, metrics, step)
        multihost.barrier()
        return write

    def _write(self, state: TrainState, metrics: Optional[dict],
               step: int) -> None:
        d = self._dir(step)
        os.makedirs(d, exist_ok=True)
        _atomic_save(state.state_dict(), os.path.join(d, STATE_FILE))
        tmp = os.path.join(d, f"{METRICS_FILE}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        os.replace(tmp, os.path.join(d, METRICS_FILE))
        for old in self.all_steps()[:-self.keep] if self.keep > 0 else ():
            shutil.rmtree(self._dir(old))

    def metrics(self, step: int) -> Dict[str, float]:
        """The metrics saved with ``step`` ({} for a periodic save)."""
        try:
            with open(os.path.join(self._dir(step), METRICS_FILE)) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> TrainState:
        """Load the checkpoint of ``step`` (default the latest) into
        ``state``, in place, and return it."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(os.path.join(self._dir(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        state.load_state_dict(saved)
        return state

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        """Nothing is held open."""


def save_params(directory: str, module: nn.Module,
                overwrite: bool = False) -> None:
    """One parameter snapshot of ``module`` (parameters only, no BatchNorm
    statistics, as the JAX package's ``params`` tree)."""
    path = os.path.join(os.path.abspath(directory), PARAMS_FILE)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"{path} exists (pass overwrite=True)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _atomic_save({k: p.detach() for k, p in module.named_parameters()}, path)


def _read_params(directory: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(os.path.abspath(directory), PARAMS_FILE),
                      map_location="cpu", weights_only=True)


def _copy_params(module: nn.Module, saved: Dict[str, torch.Tensor],
                 where: str) -> None:
    own = dict(module.named_parameters())
    if saved.keys() != own.keys():
        missing, extra = own.keys() - saved.keys(), saved.keys() - own.keys()
        raise KeyError(f"{where}: parameters do not match (missing "
                       f"{sorted(missing)[:5]}, unexpected "
                       f"{sorted(extra)[:5]})")
    for k, v in saved.items():
        if v.shape != own[k].shape:
            raise ValueError(f"{where}: {k} has shape {tuple(v.shape)}, "
                             f"the model {tuple(own[k].shape)}")
    with torch.no_grad():
        for k, v in saved.items():
            own[k].copy_(v)


def load_params(directory: str, module: nn.Module) -> nn.Module:
    """Copy a :func:`save_params` snapshot into ``module``'s parameters
    (every name and shape must match); returns ``module``."""
    _copy_params(module, _read_params(directory), directory)
    return module


def load_pointseg_backbone(model: nn.Module, pretrained_dir: str
                           ) -> nn.Module:
    """Replace only the PointSeg encoder's parameters of ``model`` with
    those of a snapshot of a ``PointSegNet`` (names ``encoder.*``, as the
    JAX package's ``{"encoder": ...}`` tree); everything else keeps its
    initialisation. Returns ``model``."""
    prefix = "encoder."
    saved = {k[len(prefix):]: v for k, v in _read_params(
        pretrained_dir).items() if k.startswith(prefix)}
    if not saved:
        raise KeyError(f"{pretrained_dir}: no PointSeg encoder parameters")
    _copy_params(model.lidar_feat.pointseg.encoder, saved, pretrained_dir)
    return model
