"""Streaming odometry (counterpart of ``deeplio_tpu/eval/streaming.py``).

Each tick projects the incoming raw scan on the device, pairs it with the
carried previous range image, runs DeepLIO on that one-pair window and
composes the predicted relative pose onto the carried global pose in
float32. The tick is a Python loop over frames; ``chunk`` only groups the
host-to-device copies (one pinned, asynchronous copy per chunk), so results
do not depend on it. No LSTM state carries across ticks: every tick is a
fresh one-pair window, as in the JAX package.

Each tick is annotated with three profiler spans, ``stream.project``,
``stream.model`` and ``stream.compose`` (a few microseconds each when no
profiler is running); ``chip_smoke.py`` reads them to split the tick.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.data.drives import Drive
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.ops.projection import make_projector
from deeplio_tpu_torch.utils import spatial as sp


class StreamingOdometry:
    """Streaming odometry over one drive with a DeepLIO model."""

    def __init__(self, cfg: Config, model: torch.nn.Module, chunk: int = 16,
                 device: DeviceLike = None):
        if cfg.model.arch != "deeplio":
            raise ValueError("the port's streaming odometry runs DeepLIO")
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

    def _host_chunks(self, drive: Drive) -> Iterator[Dict[str, np.ndarray]]:
        T = self.cfg.datasets.max_imu_per_pair
        n = len(drive)
        for c0 in range(0, n, self.chunk):
            pts, vld, imu, msk = [], [], [], []
            for k in range(c0, min(c0 + self.chunk, n)):
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
            yield {"points": np.stack(pts), "valid": np.stack(vld),
                   "imu": np.stack(imu), "imu_mask": np.stack(msk)}

    def _to_device(self, chunk: Dict[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
        out = {}
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
        dev = self.device
        prev_img = torch.zeros(self._img_shape, dtype=torch.float32,
                               device=dev)
        pose = torch.eye(4, dtype=torch.float32, device=dev)
        identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        zero_x = torch.zeros(3, device=dev)
        started = False
        poses, dxs, dqs = [], [], []
        for host in self._host_chunks(drive):
            chunk = self._to_device(host)
            for j in range(chunk["points"].shape[0]):
                with record_function("stream.project"):
                    img, _ = self.projector(chunk["points"][j:j + 1],
                                            chunk["valid"][j:j + 1])
                img = img[0]
                batch = {
                    "images": torch.cat([prev_img, img], -1)[None, None],
                    "imu": chunk["imu"][j][None, None],
                    "imu_mask": chunk["imu_mask"][j][None, None],
                }
                with record_function("stream.model"):
                    x, q = self.model(batch)
                dx = x[0, 0] if started else zero_x
                dq = q[0, 0] if started else identity_q
                with record_function("stream.compose"):
                    pose = sp.apply_relative(pose, dx, dq)
                poses.append(pose)
                dxs.append(dx)
                dqs.append(dq)
                prev_img, started = img, True
        return (torch.stack(poses).cpu().numpy(),
                torch.stack(dxs).cpu().numpy(),
                torch.stack(dqs).cpu().numpy())
