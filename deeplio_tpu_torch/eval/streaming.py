"""Streaming odometry (counterpart of ``deeplio_tpu/eval/streaming.py``).

Each tick projects the incoming raw scan on the device, pairs it with the
carried previous range image, runs the model (DeepLIO, or DeepLO with no
IMU input) on that one-pair window and composes the predicted relative
pose onto the carried global pose in float32. The pair goes to the model
as its stem takes it (``StreamingStep.pair``): the channel concat, the
two frames apart (``pair-split``), their space-to-depth pair
(``s2d-pre``), or the two frames with the pair ``(0, 1)``
(``factorized``, whose parameters do not depend on the pairs). DeepIO has no scan to
stream and raises, as in the JAX package. No LSTM state carries across
ticks: every tick is a fresh one-pair window, as in the JAX package.

The tick is a function of its carry ``(prev_img, pose, started)``, as the
JAX package's ``tick``/``chunk_fn``/``init_carry``: :class:`StreamingStep`
runs a chunk of ticks, and ``started`` is a tensor, so the first frame's
identity motion is a ``torch.where`` and not a Python branch.
``StreamingOdometry.run`` calls that step chunk by chunk, and
``eval/export.py`` exports the same module, so the served artifact and
``run`` cannot drift apart. ``chunk`` only groups the host-to-device
copies (one pinned, asynchronous copy per chunk) and the frames of one
step call; results do not depend on it.

On one CUDA device, with grad mode off and outside ``torch.export``'s
trace, a call of the step runs the whole chunk as one CUDA graph
(``train/graph.py::StreamGraphs``): the first call of each layout of the
carry and the inputs runs eagerly as the capture's warm-up, the second
captures it, every later one replays it. ``StreamingStep.eager`` is the
always-eager chunk, which ``torch.export`` traces and the graph is held
against; ``StreamingStep.graph_counts()`` tallies the calls by path.

Each eager tick runs under three layer spans (``utils/timing.py::span``):
``stream.project`` (the projection, the pair and the IMU window),
``stream.model`` and ``stream.compose`` (the first frame's select and the
composition); a replay holds its input copies, the graph launch and the
outputs' clones under ``stream.model`` and enters the other two empty.
``StreamingOdometry.to_device``'s copies run under ``stream.to_device``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.data.drives import Drive
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.models.blocks import space_to_depth_pairs
from deeplio_tpu_torch.ops.projection import make_projector
from deeplio_tpu_torch.train.graph import StreamGraphs
from deeplio_tpu_torch.utils import spatial as sp
from deeplio_tpu_torch.utils.timing import span

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# the inputs of one chunk, in the order StreamingStep takes them
CHUNK_KEYS = ("points", "valid", "imu", "imu_mask")
# a tick's window: the carried frame and the new one, one pair
PAIR = ((0, 1),)


def chunk_keys(arch: str) -> Tuple[str, ...]:
    """The inputs of a chunk for ``arch``: DeepLO takes no IMU."""
    return CHUNK_KEYS if arch == "deeplio" else CHUNK_KEYS[:2]


def _tick(step: "StreamingStep", mb: Dict[str, torch.Tensor], raw):
    """The eager chunk on the carry and inputs ``mb`` by name."""
    return step.eager(**mb)


class StreamingStep(nn.Module):
    """``(prev_img, pose, started, points [c, N, 4], valid [c, N], imu [c,
    T, 6], imu_mask [c, T]) -> (prev_img, pose, started, poses [c, 4, 4],
    dx [c, 3], dq [c, 4])``: ``c`` ticks from the carry, the new carry
    first. ``started`` is a float32 scalar, 0 before the first frame.
    DeepLO's step takes no ``imu`` and ``imu_mask``. A call runs eagerly
    or through the chunk's CUDA graph (module docstring); :meth:`eager`
    always runs eagerly."""

    def __init__(self, model: nn.Module, projector: Callable):
        super().__init__()
        self.model = model
        self.projector = projector
        self.graphs = StreamGraphs(_tick)

    def graph_counts(self) -> Dict[str, int]:
        """The calls by path: ``captures``, ``replays``, ``eager``."""
        return self.graphs.graph_counts()

    def pair(self, prev_img: torch.Tensor,
             img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The tick's one-pair window as the model's stem takes it."""
        stem = self.model.stem
        if stem == "pair-split":          # the two frames apart
            return {"images": prev_img[None, None],
                    "images2": img[None, None]}
        if stem == "factorized":          # the frames, paired by PAIR
            return {"frames": torch.stack([prev_img, img])[None]}
        if stem == "s2d-pre":
            hs, ws = self.model.lidar_feat.pointseg.encoder.strides
            return {"images": space_to_depth_pairs(
                torch.stack([prev_img, img])[None], PAIR, hs, ws)}
        return {"images": torch.cat([prev_img, img], -1)[None, None]}

    def forward(self, prev_img, pose, started, points, valid, imu=None,
                imu_mask=None):
        mb = {"prev_img": prev_img, "pose": pose, "started": started,
              "points": points, "valid": valid}
        if imu is not None:
            mb.update(imu=imu, imu_mask=imu_mask)
        return self.graphs(self, mb, {})

    def eager(self, prev_img, pose, started, points, valid, imu=None,
              imu_mask=None):
        poses, dxs, dqs = [], [], []
        for j in range(points.shape[0]):
            with span("stream.project"):
                img, _ = self.projector(points[j:j + 1], valid[j:j + 1])
                img = img[0]
                batch = self.pair(prev_img, img)
                if imu is not None:
                    batch["imu"] = imu[j][None, None]
                    batch["imu_mask"] = imu_mask[j][None, None]
            with span("stream.model"):
                x, q = self.model(batch, combos=PAIR)
            with span("stream.compose"):
                go = started > 0              # first frame: identity motion
                dx = torch.where(go, x[0, 0], torch.zeros_like(x[0, 0]))
                dq = torch.where(go, q[0, 0], sp.device_constant(
                    (1.0, 0.0, 0.0, 0.0), q))
                pose = sp.apply_relative(pose, dx, dq)
            poses.append(pose)
            dxs.append(dx)
            dqs.append(dq)
            prev_img, started = img, torch.ones_like(started)
        return (prev_img, pose, started, torch.stack(poses),
                torch.stack(dxs), torch.stack(dqs))


class StreamingOdometry:
    """Streaming odometry over one drive with a DeepLIO or DeepLO model."""

    def __init__(self, cfg: Config, model: torch.nn.Module, chunk: int = 16,
                 device: DeviceLike = None):
        if not cfg.model.uses_lidar:
            raise ValueError("streaming odometry needs a lidar arch")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.chunk = chunk
        self.model = model.to(self.device).eval()
        ds = cfg.datasets
        self.projector = make_projector(ds.projection, ds.channels,
                                        ds.mean, ds.std)
        self._img_shape = (ds.projection.height, ds.projection.width,
                           ds.num_image_channels)
        self.step = StreamingStep(self.model, self.projector)
        self.keys = chunk_keys(cfg.model.arch)

    def init_carry(self) -> Carry:
        """The carry before the first frame: a zero image, the identity
        pose, ``started`` 0."""
        dev = self.device
        return (torch.zeros(self._img_shape, dtype=torch.float32, device=dev),
                torch.eye(4, dtype=torch.float32, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))

    def host_chunks(self, drive: Drive, pad: bool = False
                    ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
        """(real frames, chunk) for each chunk of the drive, the inputs as
        numpy arrays keyed by ``self.keys``. ``pad``: the last chunk is
        filled up to ``chunk`` frames by repeating its last frame (the
        fixed shape of an exported step), as the JAX package pads it."""
        T = self.cfg.datasets.max_imu_per_pair
        n = len(drive)
        for c0 in range(0, n, self.chunk):
            ks = list(range(c0, min(c0 + self.chunk, n)))
            pts, vld, imu, msk = [], [], [], []
            for k in ks + ks[-1:] * ((self.chunk - len(ks)) if pad else 0):
                p, v = drive.points(k)
                pts.append(p)
                vld.append(v)
                w = (drive.imu_between(drive.frame_time(k - 1),
                                       drive.frame_time(k))
                     if k > 0 else np.zeros((0, 6), np.float32))
                m = min(len(w), T)
                buf = np.zeros((T, 6), np.float32)
                buf[:m] = w[:m]
                mk = np.zeros((T,), np.float32)
                mk[:m] = 1.0
                imu.append(buf)
                msk.append(mk)
            out = {"points": np.stack(pts), "valid": np.stack(vld),
                   "imu": np.stack(imu), "imu_mask": np.stack(msk)}
            yield len(ks), {k: out[k] for k in self.keys}

    def to_device(self, chunk: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        out = {}
        with span("stream.to_device"):
            for k, v in chunk.items():
                t = torch.from_numpy(v)
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    @torch.no_grad()
    def run(self, drive: Drive) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stream a whole drive. Returns (poses [n,4,4], dx [n,3], dq [n,4]).

        poses[k] is the integrated pose AFTER consuming frame k; the first
        tick emits identity motion, so poses[0] is the identity.
        """
        carry = self.init_carry()
        poses, dxs, dqs = [], [], []
        for _, host in self.host_chunks(drive):
            chunk = self.to_device(host)
            *carry, p, x, q = self.step(*carry,
                                        *(chunk[k] for k in self.keys))
            poses.append(p)
            dxs.append(x)
            dqs.append(q)
        return (torch.cat(poses).cpu().numpy(), torch.cat(dxs).cpu().numpy(),
                torch.cat(dqs).cpu().numpy())
