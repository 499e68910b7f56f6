"""Training loop (counterpart of ``deeplio_tpu/train/loop.py``; reference:
the Trainer/Worker classes around ``train.py``): dataset -> prefetcher ->
train step, with metrics, validation, checkpoints, the best model and
resume, on one device or on each rank of a data-parallel run. The
batches come from the host (scans read or
synthesised per batch, or cached projections with ``cache-projections``)
or, with ``device-dataset``, are gathered from a bank of every scan staged
on the device once.

Observability: ``metrics.jsonl`` in the work directory is the source of
truth, one record per log step and per validation with the reference's
scalar names (loss, loss_x, loss_q, ...); a TensorBoard mirror is written
when ``torch.utils.tensorboard`` imports. The step's metrics stay on the
device until a log step reads them, so the loop does not wait for the card
between log steps.

Data parallelism (``data-parallel``, one process per device, joined by
``parallel/multihost.py::maybe_initialize`` before the Trainer is built):
every rank feeds its own contiguous rows of each global batch to the
data-parallel step, and the ranks hold the same state throughout. Side
effects are the primary's: ``metrics.jsonl``, the checkpoints, ``best/``
and ``trainer_meta.json`` (the other ranks log nothing and wait at the
checkpoints' barriers). The validation metrics are the ranks' means, so
every rank takes the same best-model and plateau decisions.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.data import device_bank as dbank
from deeplio_tpu_torch.data.dataset import build_dataset, build_drives
from deeplio_tpu_torch.data.pipeline import DevicePrefetcher, PinnedRing
from deeplio_tpu_torch.data.proj_cache import ProjectionCache
from deeplio_tpu_torch.device import DeviceLike
from deeplio_tpu_torch.models.zoo import build_model
from deeplio_tpu_torch.parallel.mesh import Mesh, make_mesh
from deeplio_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
    load_pointseg_backbone,
    save_params,
)
from deeplio_tpu_torch.train.optim import PlateauController
from deeplio_tpu_torch.train.state import TrainState, create_train_state
from deeplio_tpu_torch.train.step import build_train_step
from deeplio_tpu_torch.utils import AverageMeter, get_app_logger


class MetricsWriter:
    """JSONL metrics (the source of truth) and an optional TensorBoard
    mirror under ``<dir>/tb`` with the same scalar names."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=os.path.join(
                os.path.dirname(os.path.abspath(path)), "tb"))
        except ImportError:
            self._tb = None

    def write(self, step: int, split: str, metrics: Dict[str, float]):
        rec = {"step": step, "split": split, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class _NullMetrics:
    """The metrics sink of the non-primary ranks."""

    def write(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars -> floats, in one copy (one wait for the card)."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, vals))


class Trainer:
    """Train a config's model on its KITTI or synthetic drives.

    ``device`` is CUDA unless ``"cpu"`` is passed (no fallback: without a
    GPU the default raises); under data parallelism it is the rank's
    (``cuda:<local rank>`` by default). ``mesh`` defaults to
    ``make_mesh(train.data-parallel)``: the whole world of processes, one
    in a plain run. ``resume`` restores the latest checkpoint and
    ``trainer_meta.json`` (best validation loss, epochs done, plateau
    state) from ``workdir``; ``eval_only`` builds no training split. A
    validation split whose drives are missing on disk leaves ``val_ds``
    None. ``cache-projections`` projects the train and validation drives
    into ``<workdir>/proj_cache`` before the first epoch (not for DeepIO,
    which reads no scans); ``device-dataset`` stages both splits' scans on
    the device (a LiDAR arch only).
    """

    def __init__(self, cfg: Config, workdir: str = "runs/default",
                 resume: bool = False, eval_only: bool = False,
                 device: DeviceLike = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.workdir = workdir
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.train.data_parallel, device)
        self.device = self.mesh.device
        self.log = get_app_logger()
        self.primary = self.mesh.rank == 0
        bs = cfg.train.batch_size
        if bs % self.mesh.data:
            raise ValueError(f"batch-size {bs} not divisible by "
                             f"data-parallel size {self.mesh.data}")

        self.image_cache = None
        # as in JAX, DeepIO projects nothing, so it caches nothing
        if (cfg.train.cache_projections and not eval_only
                and cfg.model.uses_lidar):
            self.image_cache = ProjectionCache(
                os.path.join(workdir, "proj_cache"), cfg.datasets,
                self.device)
            drives = build_drives(cfg, "train")
            try:
                drives += build_drives(cfg, "validation")
            except (KeyError, FileNotFoundError):
                pass
            self.image_cache.ensure(drives)
        self.train_ds = None if eval_only else build_dataset(
            cfg, "train", image_cache=self.image_cache)
        try:
            self.val_ds = build_dataset(cfg, "validation",
                                        image_cache=self.image_cache)
        except (KeyError, FileNotFoundError):
            self.val_ds = None
        if not eval_only and len(self.train_ds) == 0:
            raise ValueError("empty training dataset")
        steps_per_epoch = max(self.train_ds.steps_per_epoch(bs), 1) \
            if self.train_ds is not None else 1000

        model = build_model(cfg, device=self.device, seed=cfg.train.seed)
        lidar = cfg.model.lidar
        if lidar is not None and lidar.pretrained and lidar.model_path:
            if lidar.name != "lidar-feat-pointseg":
                raise ValueError(f"a pretrained backbone is a PointSeg "
                                 f"encoder; {lidar.name} has none")
            load_pointseg_backbone(model, lidar.model_path)
            self.log.info("loaded pretrained PointSeg backbone from %s",
                          lidar.model_path)
        if cfg.model.pretrained and cfg.model.model_path:
            load_params(cfg.model.model_path, model)
            self.log.info("loaded pretrained model from %s",
                          cfg.model.model_path)
        self.state: TrainState = create_train_state(cfg, model,
                                                    steps_per_epoch,
                                                    mesh=self.mesh)

        self.spc = max(int(cfg.train.steps_per_call), 1)
        if self.train_ds is not None and self.spc > steps_per_epoch:
            # epoch tails shorter than a group are dropped: a group larger
            # than the epoch would train no step at all
            raise ValueError(
                f"steps-per-call {self.spc} exceeds the {steps_per_epoch} "
                f"steps per epoch (batch-size {bs}, {len(self.train_ds)} "
                f"windows): every epoch would drop all its batches")
        self.train_step, self.eval_step = build_train_step(cfg, self.mesh)
        self._train_bank = self._val_bank = None
        if cfg.train.device_dataset and not eval_only:
            self._stage_banks()
        # one set of page-locked staging buffers for every epoch, every
        # validation and the evaluator's batches (depth + 1 batches)
        self.ring = PinnedRing(cfg.train.prefetch + 1) \
            if self.device.type == "cuda" else None

        self.ckpt = CheckpointManager(
            os.path.join(workdir, cfg.train.checkpoint_dir),
            keep=cfg.train.keep_checkpoints,
            save_every_steps=cfg.train.checkpoint_every_steps)
        self._meta_path = os.path.join(workdir, "trainer_meta.json")
        self.plateau = PlateauController(cfg.optim)
        self.best_val = float("inf")
        self._epochs_done = 0
        if resume and self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state)
            self.log.info("resumed from step %d", self.state.step)
            # the host-side state too: without it the first validation
            # after a resume overwrites the best model, shuffle seeds
            # replay from epoch 0 and a lowered plateau lr comes back
            try:
                with open(self._meta_path) as f:
                    meta = json.load(f)
                self.best_val = float(meta.get("best_val", self.best_val))
                self._epochs_done = int(meta.get("epochs_done", 0))
                self.plateau.restore_state(meta.get("plateau"))
            except FileNotFoundError:
                pass
        self._save_boundary = self.state.step   # periodic-save watermark
        self.metrics = (MetricsWriter(os.path.join(workdir, "metrics.jsonl"))
                        if self.primary else _NullMetrics())

    @property
    def step(self) -> int:
        return self.state.step

    def _stage_banks(self) -> None:
        """Build the host banks of both splits and copy them to the device
        once."""
        if self.mesh.data > 1:
            raise ValueError("device-dataset is single-process only")
        if not self.train_ds.with_points:
            raise ValueError("device-dataset needs a dataset of raw points "
                             "(arch deeplo or deeplio, no cache-projections)")
        splits = [self.train_ds] + ([self.val_ds] if self.val_ds is not None
                                    and len(self.val_ds) else [])
        nbytes = sum(dbank.bank_nbytes(ds) for ds in splits)
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
            if nbytes > free:
                raise ValueError(
                    f"device-dataset: the banks take {nbytes / 1e6:.0f} MB, "
                    f"more than the device's {free / 1e6:.0f} MB free")
        self.log.info("staging the device-resident dataset (%.0f MB)",
                      nbytes / 1e6)
        banks = [dbank.put_bank(dbank.build_host_bank(ds), self.device)
                 for ds in splits]
        self._train_bank = banks[0]
        self._val_bank = banks[1] if len(banks) > 1 else None

    def _bank_epoch(self, ds, bank, shuffle: bool, seed: int = 0):
        """One epoch's batches gathered from ``bank`` on the device, in
        ``iter_batches``'s order."""
        for w in dbank.epoch_indices(len(ds), self.cfg.train.batch_size,
                                     shuffle, seed):
            yield dbank.gather_batch(bank, torch.from_numpy(w).to(
                self.device))

    def _prefetch(self, ds, **kw) -> DevicePrefetcher:
        bs = self.cfg.train.batch_size
        alloc = self.ring.take if self.ring is not None else None
        return DevicePrefetcher(ds.iter_batches(
            bs, alloc=alloc, process_index=self.mesh.rank,
            process_count=self.mesh.data, **kw),
                                self.device, depth=self.cfg.train.prefetch,
                                ring=self.ring)

    def _periodic_save(self) -> None:
        # Called only where the state holds every step so far (never
        # inside a k-step group): a label names the state it contains. A
        # save boundary that falls inside a group saves at the group's
        # end, under the group-end step.
        every = self.ckpt.save_every_steps
        step = self.state.step
        if every > 0 and step // every > self._save_boundary // every:
            self._save_boundary = step
            self.ckpt.maybe_save(self.state, force=True, step=step)

    def fit(self, epochs: Optional[int] = None) -> TrainState:
        if self.train_ds is None:
            raise RuntimeError("Trainer was built with eval_only=True")
        cfg = self.cfg
        epochs = cfg.train.epochs if epochs is None else epochs
        bs = cfg.train.batch_size
        pair_meter = AverageMeter("pairs/s")

        def after(m, step, epoch):
            nonlocal t_last
            if step % cfg.train.log_every:
                return
            m_host = _host(m)
            now = time.time()
            pairs = bs * cfg.datasets.num_pairs * cfg.train.log_every
            pair_meter.update(pairs / max(now - t_last, 1e-9))
            t_last = now
            m_host["pairs_per_sec"] = pair_meter.val
            self.metrics.write(step, "train", m_host)
            self.log.info(
                "epoch %d step %d loss %.4f (x %.4f q %.5f) %.0f pairs/s",
                epoch, step, m_host["loss"], m_host["loss_x"],
                m_host["loss_q"], pair_meter.val)

        # epoch numbers continue across fit() calls, so each shuffle seed
        # is used once
        first_epoch = self._epochs_done
        for epoch in range(first_epoch, first_epoch + epochs):
            seed = cfg.train.seed + epoch
            if self._train_bank is not None:
                it = self._bank_epoch(self.train_ds, self._train_bank, True,
                                      seed)
            else:
                it = self._prefetch(self.train_ds, shuffle=True, seed=seed)
            t_last = time.time()
            try:
                group: List[Dict[str, torch.Tensor]] = []
                for batch in it:
                    group.append(batch)
                    if len(group) < self.spc:
                        continue
                    # k sequential steps, then the group's metrics and one
                    # periodic-save check; a short epoch tail is dropped
                    ms = []
                    for raw in group:
                        self.state, m = self.train_step(self.state, raw)
                        ms.append(m)
                    group.clear()
                    first = self.state.step - len(ms)
                    for i, m in enumerate(ms):
                        after(m, first + i + 1, epoch)
                    self._periodic_save()
            finally:
                it.close()
            if (self.val_ds is not None and len(self.val_ds)
                    and (epoch + 1) % cfg.train.eval_every_epochs == 0):
                self._after_validation(epoch, self.validate())
            self._epochs_done = epoch + 1
            self._write_meta()
        self.ckpt.maybe_save(self.state, force=True, step=self.state.step)
        self.ckpt.wait()
        return self.state

    def _after_validation(self, epoch: int, val: Dict[str, float]) -> None:
        if not val:
            self.log.warning("validation split too small for batch size "
                             "%d; skipped", self.cfg.train.batch_size)
            return
        step = self.state.step
        self.metrics.write(step, "val", val)
        self.log.info("epoch %d val loss %.4f", epoch, val["loss"])
        if self.plateau.enabled:
            old_lr = self.plateau.lr
            self.plateau.observe(val["loss"], self.state.optimizer)
            if self.plateau.lr != old_lr:
                self.log.info("plateau: lr %.2e -> %.2e", old_lr,
                              self.plateau.lr)
        # val is the ranks' mean: every rank decides the same way
        if val["loss"] < self.best_val:
            self.best_val = val["loss"]
            # a snapshot of its own: the step-labelled checkpoints keep
            # only the newest few, which would drop an older best
            if self.primary:
                save_params(os.path.join(self.workdir, "best"),
                            self.state.model, overwrite=True)
            self.ckpt.maybe_save(self.state, metrics=val, force=True,
                                 step=step)
        self._write_meta()

    def _write_meta(self) -> None:
        if not self.primary:
            return
        tmp = f"{self._meta_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"best_val": self.best_val,
                       "epochs_done": self._epochs_done,
                       "plateau": self.plateau.state_dict()}, f)
        os.replace(tmp, self._meta_path)

    def validate(self) -> Dict[str, float]:
        """The eval metrics averaged over the validation split's batches
        ({} when it holds less than one batch)."""
        sums: Dict[str, float] = {}
        n = 0
        if self._val_bank is not None:
            it = self._bank_epoch(self.val_ds, self._val_bank, False)
        else:
            it = self._prefetch(self.val_ds, shuffle=False)
        try:
            for batch in it:
                _, _, m = self.eval_step(self.state, batch)
                for k, v in _host(m).items():
                    sums[k] = sums.get(k, 0.0) + v
                n += 1
        finally:
            it.close()
        return {k: v / n for k, v in sums.items()} if n else {}

    def close(self) -> None:
        self.ckpt.wait()
        self.ckpt.close()
        self.metrics.close()
