"""The training and eval steps (counterpart of
``deeplio_tpu/train/step.py``: ``make_model_batch`` on the classic
pair-concat and the pair-split paths, and ``build_train_step`` on one
device or, under data parallelism, on each rank of a mesh).

Raw batch contract (``data/dataset.py`` output, on the device):

    points_x/points_y/points_z/points_rem: [B*S, N] float32 planes
    points_valid: [B*S, N] bool
    imu [B, P, T, 6], imu_mask [B, P, T]
    x_gt [B, P, 3], q_gt [B, P, 4], valid [B, P]

or, from a projection cache (``data/proj_cache.py``), ``images`` [B, S,
H, W, C] float16 in place of the planes: the step then projects nothing.

One training step, in order: yaw augmentation (when configured), one
projection of all B*S frames (a single kernel launch; none for DeepIO,
whose batches carry no points), the P pair images
per window (or the frames, or their space-to-depth pairs, as the stem
takes them), the forward pass in training mode (BatchNorm batch
statistics and their running update, dropout), the pose loss, backward,
optax's global-norm clip and the optimizer's update (Adam, AdamW or SGD
with momentum). The phases run under the layer spans
(``utils/timing.py::span``) ``train.augment``, ``train.project``,
``train.forward``, ``train.backward`` and ``train.update``; an eval call
under ``eval.project`` (the model batch) and ``eval.model`` (the
forward, the loss and its metrics). The forward and the loss are the
state's ``trainables`` (``train/state.py::Trainables``). On one CUDA
device, outside autograd's anomaly mode, the forward, the loss and the
backward run as one CUDA graph from the second step of each input layout
on (``train/graph.py``); the spans are the same, ``train.backward`` empty
on a replay. So do an eval call's forward, loss and metrics on one CUDA
device, under the same span ``eval.model``.

Data parallelism (``build_train_step(cfg, mesh)`` with a mesh whose
process group is set, JAX's shard_map step): each rank runs the step
above on its own rows, with its own generator (``train/state.py``). The
state's ``trainables`` are in ``DistributedDataParallel``, which
averages the gradients (JAX's ``pmean``) before the optimizer
clips and applies them; the BatchNorm statistics are the data axis's
(``models/blocks.py::FlaxBatchNorm2d``). The loss metrics are averaged
over the ranks in one ``all_reduce``. The eval step averages its metrics
and gathers the predictions, so every rank holds the global batch's.
With no mesh, or a mesh of one process with no group, both steps are the
one-device steps.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.losses.pose import pose_loss
from deeplio_tpu_torch.models.blocks import space_to_depth_pairs
from deeplio_tpu_torch.models.zoo import DTYPES
from deeplio_tpu_torch.ops.augment import yaw_augment
from deeplio_tpu_torch.ops.projection import make_projector
from deeplio_tpu_torch.parallel.mesh import Mesh
from deeplio_tpu_torch.train.graph import EvalGraphs, StepGraphs
from deeplio_tpu_torch.train.state import TrainState
from deeplio_tpu_torch.utils.timing import span

Batch = Dict[str, torch.Tensor]


def batch_to_device(host: Dict[str, np.ndarray],
                    device: DeviceLike = None) -> Batch:
    """A host batch of numpy arrays -> tensors on ``device`` (CUDA by
    default), through pinned memory on the card. ``meta`` stays behind."""
    dev = resolve_device(device)
    out = {}
    for k, v in host.items():
        if k == "meta":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def make_model_batch(cfg: Config, projector: Callable, raw: Batch) -> Batch:
    """Raw planes (or cached images) and IMU -> the model's batch: for the
    LiDAR archs ``images`` [B, P, H, W, 2C], the channel concat of frames
    i and j of each configured pair; under ``stem: pair-split`` the
    frame-i and frame-j stacks ``images`` and ``images2`` [B, P, H, W, C]
    (slices of the frames for consecutive pairs, else gathers); under
    ``s2d-pre`` the pairs in space-to-depth layout, ``images`` [B, P, H /
    h, W / w, h * w * 2C] (``space_to_depth_pairs``: no full-resolution
    pair stack); under ``factorized`` the frames themselves, ``frames``
    [B, S, H, W, C], which the stem pairs after its conv. For the IMU
    archs the IMU windows. DeepIO projects nothing."""
    mb: Batch = {}
    if cfg.model.uses_lidar:
        if "images" in raw:
            # cached f16 images go straight to the compute dtype
            imgs = raw["images"].to(DTYPES[cfg.model.compute_dtype])
        else:
            imgs, _ = projector((raw["points_x"], raw["points_y"],
                                 raw["points_z"], raw["points_rem"]),
                                raw["points_valid"])
            b = raw["x_gt"].shape[0]
            imgs = imgs.reshape((b, -1) + tuple(imgs.shape[1:]))
        combos = cfg.datasets.effective_combinations
        lc = cfg.model.lidar
        p = len(combos)
        if lc.stem == "factorized":
            mb["frames"] = imgs
        elif lc.stem == "s2d-pre":
            mb["images"] = space_to_depth_pairs(imgs, combos, lc.h_stride,
                                                lc.w_stride)
        else:
            if all(c == (k, k + 1) for k, c in enumerate(combos)):
                first, second = imgs[:, :p], imgs[:, 1:p + 1]
            else:
                first = imgs[:, [i for i, _ in combos]]
                second = imgs[:, [j for _, j in combos]]
            if lc.stem == "pair-split":
                mb["images"], mb["images2"] = first, second
            else:
                mb["images"] = torch.cat([first, second], -1)
    if cfg.model.uses_imu:
        mb["imu"], mb["imu_mask"] = raw["imu"], raw["imu_mask"]
    return mb


def _mean_over(mesh: Mesh, metrics: Batch) -> Batch:
    """Scalar metrics averaged over the mesh's ranks (one all_reduce)."""
    import torch.distributed as dist

    keys = list(metrics)
    v = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(v, group=mesh.group)
    v = v / mesh.data
    return {k: v[i] for i, k in enumerate(keys)}


def _gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts)


def build_train_step(cfg: Config, mesh: Optional[Mesh] = None
                     ) -> Tuple[Callable, Callable]:
    """Returns ``(train_step, eval_step)``:

    ``train_step(state, raw) -> (state, metrics)`` updates ``state`` in
    place; ``eval_step(state, raw) -> (x_pred, q_pred, metrics)`` runs the
    model in eval mode. The metrics are detached scalar tensors on the
    device (``loss``, ``loss_x``, ``loss_q``, ``sx``/``sq`` for LWS as they
    were before the update, and ``grad_norm``, the norm before clipping).

    With a ``mesh`` that has a process group, ``raw`` is this rank's rows
    and ``state`` was made by ``create_train_state(..., mesh=mesh)``; the
    metrics are the ranks' means and ``grad_norm`` is the averaged
    gradient's, and ``eval_step``'s predictions are the global batch's.

    ``train_step.graph_counts()`` tallies its steps by path
    (``captures``, ``replays``, ``eager``: ``train/graph.py``);
    ``train_step.eager`` is the same step with the forward and backward
    always eager, the reference the card's tests hold the graph against.
    ``eval_step.graph_counts()`` and ``eval_step.eager`` are the same for
    the eval call's forward and loss.
    """
    ds = cfg.datasets
    projector = make_projector(ds.projection, ds.channels, ds.mean, ds.std,
                               out_dtype=DTYPES[cfg.model.compute_dtype],
                               layout="planes")
    dp = mesh is not None and mesh.group is not None

    def forward_backward(state: TrainState, mb: Batch, raw: Batch):
        with span("train.forward"):
            if dp and not isinstance(state.trainables,
                                     DistributedDataParallel):
                raise ValueError("a data-parallel step needs the state of "
                                 "create_train_state(..., mesh=mesh)")
            total, metrics = state.trainables.train()(mb, raw,
                                                      state.generator)
            metrics = {k: v.detach().clone() for k, v in metrics.items()}
        with span("train.backward"):
            state.optimizer.zero_grad()
            total.backward()
        return metrics

    graphs = StepGraphs(forward_backward)
    # the data-parallel step stays eager: DDP's hooks reduce the
    # gradients across ranks as the backward runs
    model_step = graphs.eager if dp else graphs

    def step(state: TrainState, raw: Batch, run: Callable):
        if ds.augment_yaw:
            with span("train.augment"):
                raw = yaw_augment(raw, state.generator)
        with span("train.project"), torch.no_grad():
            mb = make_model_batch(cfg, projector, raw)
        metrics = run(state, mb, raw)
        with span("train.update"):
            grad_norm = state.optimizer.step(state.step)
        if dp:
            metrics = _mean_over(mesh, metrics)
        metrics["grad_norm"] = grad_norm
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, raw: Batch):
        return step(state, raw, model_step)

    def eager_train_step(state: TrainState, raw: Batch):
        return step(state, raw, forward_backward)

    train_step.eager = eager_train_step
    train_step.graph_counts = graphs.graph_counts

    def model_loss(state: TrainState, mb: Batch, raw: Batch):
        x_pred, q_pred = state.model(mb)
        _, metrics = pose_loss(cfg.loss, state.loss_params, x_pred, q_pred,
                               raw["x_gt"], raw["q_gt"], raw.get("valid"))
        return x_pred, q_pred, {k: v.detach().clone()
                                for k, v in metrics.items()}

    eval_graphs = EvalGraphs(model_loss)
    # the data-parallel call stays eager, as the data-parallel training
    # step does: no cell runs either
    model_eval = eval_graphs.eager if dp else eval_graphs

    def evaluate(state: TrainState, raw: Batch, run: Callable):
        with span("eval.project"):
            mb = make_model_batch(cfg, projector, raw)
        with span("eval.model"):
            state.model.eval()
            x_pred, q_pred, metrics = run(state, mb, raw)
        if dp:
            metrics = _mean_over(mesh, metrics)
            x_pred, q_pred = _gather(mesh, x_pred), _gather(mesh, q_pred)
        return x_pred, q_pred, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, raw: Batch):
        return evaluate(state, raw, model_eval)

    @torch.no_grad()
    def eager_eval_step(state: TrainState, raw: Batch):
        return evaluate(state, raw, model_loss)

    eval_step.eager = eager_eval_step
    eval_step.graph_counts = eval_graphs.graph_counts

    return train_step, eval_step
