"""PointSeg segmentation pretraining (counterpart of
``deeplio_tpu/train/pretrain.py``).

Trains the standalone ``PointSegNet`` (encoder, decoder and classifier
head) on per-pixel labels with a masked cross-entropy, then saves only the
encoder's parameters, under ``encoder.*``: the snapshot
``train/checkpoint.py::load_pointseg_backbone`` grafts into a DeepLIO
model (``lidar-feat-pointseg: {pretrained: true, model-path: ...}``).

Labels, as in the JAX package:

1. SemanticKITTI label files when ``datasets.labels-path`` is set
   (``KittiRawDrive.labels``), remapped on the host through
   ``datasets.label-map`` when one is given;
2. else geometric pseudo-labels from the projection: ground below
   ``GROUND_Z``, structure above it, 0 where no point landed.

Each step projects its B scans twice:

- through the config's projector (the ring kernel for ``backend:
  pallas-ring``), for the model input: the image pair-stacked with
  itself, ``concat([img, img])``, the width of the odometry encoder's
  input, so its kernels graft unchanged (for the ``factorized`` stem the
  frames [B, 1, ...], each scan its own pair ``(0, 0)``; ``s2d-pre``
  pretrains as ``s2d``, with the same parameters);
- through the scatter kernel, once (``ops/projection_scatter.py::
  project_batch``, JAX's): for geometric labels ``project_batch(packed=
  packed)`` as in JAX, whose mask and z give the pseudo-labels, the exact
  float32 z through index payloads without ``packed``; with label files
  the packed route, each point's label riding the remission payload word.
  The winner of a pixel depends only on xyz and validity, so the pixel's
  label is that of the point whose channels fill it. The JAX package runs
  a second, exact ``project_batch(packed=False)`` for the labels; a
  payload half is float16, which holds an integer exactly only up to
  2048, so the port applies JAX's post-projection rules to each point
  before projecting (with a label map ``clip(label, 0, num_classes -
  1)``, without one ids outside ``[0, num_classes)`` become 0): per
  value, so the label image is the same bit for bit.

Then the forward pass in training mode (flax BatchNorm semantics), the
loss, backward and ``torch.optim.Adam(lr)`` with optax's epsilon, no clip
and no schedule (``optax.adam(lr)``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deeplio_tpu_torch.config.schema import Config, ConfigError
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.models.pointseg import PointSegNet
from deeplio_tpu_torch.models.zoo import init_parameters
from deeplio_tpu_torch.ops.projection import make_projector
from deeplio_tpu_torch.ops.projection_scatter import (
    project_batch_scatter_planes,
    project_batch_sorted_planes,
)
from deeplio_tpu_torch.train.checkpoint import save_params
from deeplio_tpu_torch.train.step import batch_to_device
from deeplio_tpu_torch.utils import get_app_logger

NUM_CLASSES = 3   # 0 = empty, 1 = ground, 2 = structure
GROUND_Z = -1.2
EMPTY_WEIGHT = 0.05   # the loss weight of label 0 (empty or unlabeled)
ADAM_EPS = 1e-8       # optax.adam's
# the largest integer a float16 payload half holds exactly, and so the
# most classes the label image can carry
MAX_CLASSES = 2048
LOG_EVERY = 20

PLANES = ("points_x", "points_y", "points_z", "points_rem")


def geometric_labels(img5: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pseudo-labels [B, H, W] int64 from the raw 5-channel projection
    (x, y, z, remission, range) and its mask: 1 (ground) where z <
    ``GROUND_Z``, 2 (structure) elsewhere a point landed, 0 where none
    did."""
    ground = (img5[..., 2] < GROUND_Z).long()
    return torch.where(mask > 0.5, 2 - ground, 0)


def masked_xent(logits: torch.Tensor, labels: torch.Tensor,
                num_classes: int = NUM_CLASSES) -> torch.Tensor:
    """Per-pixel softmax cross-entropy, in float32, with label 0 weighted
    ``EMPTY_WEIGHT``: logits [B, K, H, W], labels [B, H, W]."""
    if logits.shape[1] != num_classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, want "
                         f"{num_classes}")
    ce = F.cross_entropy(logits.float(), labels, reduction="none")
    w = torch.where(labels == 0, EMPTY_WEIGHT, 1.0)
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1.0)


def label_lut(label_map: Dict[int, int]) -> Optional[np.ndarray]:
    """Raw id -> train id for every 16-bit id (unlisted ids -> 0), or None
    without a map."""
    if not label_map:
        return None
    lut = np.zeros(1 << 16, np.int32)
    for k, v in label_map.items():
        lut[k] = v
    return lut


def premap_labels(labels: np.ndarray, num_classes: int,
                  mapped: bool) -> np.ndarray:
    """The JAX package's post-projection label rules, applied to each
    point: with a label map the ids are clipped to ``[0, num_classes -
    1]``; without one, ids outside ``[0, num_classes)`` become 0
    (unlabeled, never the top class)."""
    if mapped:
        return np.clip(labels, 0, num_classes - 1).astype(np.int32)
    return np.where((labels >= 0) & (labels < num_classes), labels,
                    0).astype(np.int32)


def sample_batch(drives: Sequence, rng: np.random.Generator,
                 batch_size: int, labels_path: str = "",
                 lut: Optional[np.ndarray] = None,
                 num_classes: int = NUM_CLASSES) -> Dict[str, np.ndarray]:
    """B random scans, drawn as the JAX package draws them (per scan a
    drive ``rng.integers(len(drives))``, then a frame
    ``rng.integers(len(drive))``), in the training step's raw layout
    (``train/step.py``): the planes ``points_x``, ``points_y``,
    ``points_z``, ``points_rem`` [B, N] float32 and ``points_valid`` [B,
    N] bool, and with ``labels_path`` the premapped per-point ``labels``
    [B, N] int32. A drive with no label file for a drawn frame raises
    ``FileNotFoundError``."""
    planes, valid, labs = [], [], []
    for _ in range(batch_size):
        d = drives[rng.integers(len(drives))]
        fi = int(rng.integers(len(d)))
        p, v = d.points_planes(fi)
        if labels_path:
            lab = d.labels(fi, labels_path) if hasattr(d, "labels") else None
            if lab is None:
                raise FileNotFoundError(
                    f"labels-path set but no label file for {d.name} frame "
                    f"{fi} under {labels_path}")
            if lut is not None:
                lab = lut[np.clip(lab, 0, (1 << 16) - 1)]
            labs.append(premap_labels(lab, num_classes, lut is not None))
        planes.append(p)
        valid.append(v)
    planes = np.stack(planes)
    batch = {k: np.ascontiguousarray(planes[:, c]) for c, k in
             enumerate(PLANES)}
    batch["points_valid"] = np.stack(valid)
    if labels_path:
        batch["labels"] = np.stack(labs)
    return batch


def label_image(planes: Sequence[torch.Tensor], valid: torch.Tensor,
                labels: Optional[torch.Tensor], H: int, W: int,
                fov_up_deg: float, fov_down_deg: float,
                select: Optional[Callable] = None,
                packed: bool = True) -> torch.Tensor:
    """One scatter projection -> the per-pixel labels [B, H, W] int64.

    With per-point ``labels`` (premapped, so exact in float16) they ride
    the remission word and the pixel's label is its winner's; without,
    the geometric labels of ``project_batch(packed=packed)``: packed-f16
    z, or without ``packed`` the winner's exact float32 z (index
    payloads, then a gather). ``select`` defaults to the scatter operator
    (the kernel on the card, the plain version on the CPU)."""
    x, y, z, rem = planes
    if labels is None:
        img5, mask5 = project_batch_sorted_planes(
            x, y, z, rem, valid, H, W, fov_up_deg, fov_down_deg,
            payload="carry-f16" if packed else "carry", select=select)
        return geometric_labels(img5, mask5)
    img5, _ = project_batch_scatter_planes(
        x, y, z, labels.to(torch.float32), valid, H, W, fov_up_deg,
        fov_down_deg, select=select)
    # the epilogue zeroes empty pixels: their label is 0 as in JAX's
    return torch.round(img5[..., 3]).long()


# the stem each odometry stem pretrains with: the same parameters, a
# model input the pretraining batch has (the JAX package's rule)
PRETRAIN_STEMS = {"pair-split": "classic", "s2d-pre": "s2d"}
# the factorized stem's one "pair", a standing-still pair of each scan
STILL = ((0, 0),)


def build_pointseg(cfg: Config, num_classes: int) -> PointSegNet:
    """The segmentation net with the odometry encoder's tower settings, so
    its encoder grafts: ``part=encoder+decoder``, ``num_classes`` logits,
    the pair-stacked input width, the config's Fire and pool,
    ``stride-fold`` as ``stride`` (its parameters are the same, and the
    folded stem has no skip the decoder can read), as the JAX package
    pretrains it. The input is the pair concat also for a ``pair-split``
    stem, whose parameters are the classic stem's; ``s2d-pre`` pretrains
    as ``s2d`` (the same parameters, the layout made inside the model);
    ``factorized`` on the frames, each scan its own pair ``(0, 0)``."""
    lc = cfg.model.lidar
    return PointSegNet(2 * cfg.datasets.num_image_channels,
                       part="encoder+decoder", num_classes=num_classes,
                       h_stride=lc.h_stride, w_stride=lc.w_stride,
                       with_se=lc.se, el_squeeze=lc.el_squeeze,
                       pool={"stride-fold": "stride"}.get(lc.pool, lc.pool),
                       stem=PRETRAIN_STEMS.get(lc.stem, lc.stem),
                       fire=lc.fire)


def compute_dtype(cfg: Config) -> torch.dtype:
    """bfloat16 for ``compute-dtype: bfloat16``, else float32 (the JAX
    package's pretraining rule)."""
    return (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
            else torch.float32)


def build_inputs(cfg: Config) -> Callable:
    """``inputs(batch) -> (x, target)`` on a device batch
    (:func:`sample_batch`'s through ``train/step.py::batch_to_device``),
    with no gradient: ``x`` the pair-stacked model input [B, 2C, H, W] in
    the compute dtype (an NCHW view of NHWC memory, channels-last) from
    the config's projector, or for the factorized stem the frames [B, 1,
    C, H, W] (each scan its own pair, :data:`STILL`); ``target`` the
    label image [B, H, W] int64 (:func:`label_image`)."""
    ds = cfg.datasets
    proj = ds.projection
    projector = make_projector(proj, ds.channels, ds.mean, ds.std,
                               out_dtype=compute_dtype(cfg), layout="planes")
    factorized = cfg.model.lidar.stem == "factorized"

    @torch.no_grad()
    def inputs(batch):
        planes = [batch[k] for k in PLANES]
        img, _ = projector(planes, batch["points_valid"])
        if factorized:
            x = img[:, None].permute(0, 1, 4, 2, 3)
        else:
            x = torch.cat([img, img], -1).permute(0, 3, 1, 2)
        return x, label_image(planes, batch["points_valid"],
                              batch.get("labels"), proj.height, proj.width,
                              proj.fov_up_deg, proj.fov_down_deg,
                              packed=proj.packed)

    return inputs


def build_pretrain_step(cfg: Config, model: nn.Module,
                        optimizer: torch.optim.Optimizer, num_classes: int
                        ) -> Callable:
    """``step(batch) -> (loss, acc)``: one pretraining step on a device
    batch (as :func:`build_inputs` takes it), updating ``model`` and
    ``optimizer`` in place. ``loss`` and ``acc`` (the share of pixels whose
    argmax is their label) are detached scalars on the device."""
    dtype = compute_dtype(cfg)
    inputs = build_inputs(cfg)
    combos = STILL if cfg.model.lidar.stem == "factorized" else ()

    def step(batch):
        model.train()
        x, target = inputs(batch)
        with torch.autocast(x.device.type, dtype=dtype,
                            enabled=dtype != torch.float32):
            logits = model(x, combos)
        loss = masked_xent(logits, target, num_classes)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        acc = (logits.detach().argmax(1) == target).float().mean()
        return loss.detach(), acc

    return step


def _checks(cfg: Config) -> int:
    """The run's class count; ``ConfigError`` for a class count a float16
    payload cannot carry."""
    ds = cfg.datasets
    if not ds.labels_path:
        return NUM_CLASSES
    if not 1 <= ds.labels_num_classes <= MAX_CLASSES:
        raise ConfigError(f"labels-num-classes must be in [1, "
                          f"{MAX_CLASSES}] (the label rides a float16 "
                          f"payload), got {ds.labels_num_classes}")
    return ds.labels_num_classes


def pretrain_pointseg(cfg: Config, out_dir: str, steps: int = 200,
                      batch_size: int = 4, lr: float = 1e-3, seed: int = 0,
                      device: DeviceLike = None) -> Dict[str, object]:
    """Pretrain ``PointSegNet`` on the config's train drives for ``steps``
    steps of ``batch_size`` scans on ``device`` (CUDA unless ``"cpu"``),
    then save its encoder under ``out_dir``. Weights from
    ``torch.Generator().manual_seed(seed)``, scans from
    ``numpy.random.default_rng(seed)``. Returns the last step's ``loss``
    and ``acc`` and every step's loss (``losses``)."""
    from deeplio_tpu_torch.data.dataset import build_drives

    dev = resolve_device(device)
    log = get_app_logger()
    ds = cfg.datasets
    num_classes = _checks(cfg)
    lut = label_lut(ds.label_map) if ds.labels_path else None
    drives = build_drives(cfg, "train")
    rng = np.random.default_rng(seed)

    def draw():
        return sample_batch(drives, rng, batch_size, ds.labels_path, lut,
                            num_classes)

    # the JAX package draws one batch to initialise its net before the
    # first step; drawing it here too keeps every later batch the same
    draw()
    model = build_pointseg(cfg, num_classes)
    init_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, eps=ADAM_EPS)
    step = build_pretrain_step(cfg, model, optimizer, num_classes)

    losses, loss, acc = [], None, None
    for k in range(steps):
        loss, acc = step(batch_to_device(draw(), dev))
        losses.append(loss)
        if k % LOG_EVERY == 0:
            log.info("pointseg pretrain step %d loss %.4f acc %.3f", k,
                     float(loss), float(acc))
    os.makedirs(out_dir, exist_ok=True)
    save_params(out_dir, nn.ModuleDict({"encoder": model.encoder}))
    return {"loss": float(loss), "acc": float(acc),
            "losses": torch.stack(losses).cpu().tolist()}
