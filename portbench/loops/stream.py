"""The ``stream`` loop: real-time odometry, one scan a tick, closed loop.

Set-up makes a drive of ``frames`` scans with their IMU windows and holds
them in pinned host memory as the numpy arrays a sensor driver would hand
over, builds ``StreamingOdometry(cfg, model, chunk=1)`` from the
benchmark's weights and runs ``warm`` ticks (the first emits the identity
motion). A unit is one tick: the scan's arrays through ``to_device`` and
the step, the pose copied back to the host before the next scan is
handed over; its latency is that whole tick on the host clock. The
frames cycle.

The check runs the reference once over the drive's ``frames`` pairs
(each frame with the one before it, eval mode) and compares every tick of
the window: the translations' root-mean-square gap against the
reference head's scale, the widest quaternion gap, the composed poses against the
float64 composition of the system's own motions from its pose at the
window's start (the composition checked alone), the first tick's
identity motion, and the carried image of the last frame element by
element.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np
import torch

from portbench import gen
from portbench.counts import model_flops, projection_bytes
from portbench.harness import Window
from portbench.loops.common import Base, exact_float32, graph_s, mismatch
from portbench.reference import projection as rproj
from portbench.reference.model import round_fp8


def _rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


class Loop(Base):
    SPANS = {"model": ("stream.model",)}

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.n_frames = int(cell.traffic.get("frames", 64))
        self.items_per_unit = 1
        self.tick = 0

    def setup(self) -> None:
        from deeplio_tpu_torch.config import load_config_dict
        from deeplio_tpu_torch.eval.streaming import StreamingOdometry

        drive = gen.Drive(self.seed, 0, self.n_frames + 1)
        planes = drive.scans(range(1, self.n_frames + 1), self.N,
                             self.device, self.rings, self.steps)
        self.planes = planes
        pts = torch.stack([planes[k] for k in ("x", "y", "z", "rem")], -1)
        host = {"points": pts, "valid": planes["valid"]}
        imu = [drive.pair(k, k + 1, self.T) for k in range(self.n_frames)]
        host["imu"] = torch.tensor(np.stack([p[0] for p in imu]))
        host["imu_mask"] = torch.tensor(np.stack([p[1] for p in imu]))
        self.imu = {k: host[k].to(self.device) for k in ("imu", "imu_mask")}
        # the sensor's buffers: pinned host memory, handed over as numpy
        self._pinned = {k: (v.cpu().pin_memory() if self.device.type ==
                            "cuda" else v.cpu().clone())
                        for k, v in host.items()}
        self.host = {k: v.numpy() for k, v in self._pinned.items()}
        self.weights = self.make_weights()
        self.pcfg = load_config_dict(self.cell.cfg)
        model = self.port_model(self.pcfg, self.weights)
        self.so = StreamingOdometry(self.pcfg, model, chunk=1,
                                    device=self.device)
        self.keys = self.so.keys
        self.carry = self.so.init_carry()
        self.first = None
        self.poses: List = []
        for _ in range(int(self.cell.traffic.get("warm", 3))):
            f, p, _, _ = self.unit(self.tick)
            pose = p.cpu()
            if self.first is None:
                self.first = pose[0].double().numpy()
        self.start_pose = pose[0].double().numpy()
        self.flops_per_unit = model_flops(self.spec, 1, 1, self.H, self.W,
                                          self.T, train=False)

    @torch.no_grad()
    def unit(self, i: int):
        f = self.tick % self.n_frames
        self.tick += 1
        host = {k: self.host[k][f:f + 1] for k in self.keys}
        chunk = self.so.to_device(host)
        *carry, p, x, q = self.so.step(*self.carry,
                                       *(chunk[k] for k in self.keys))
        self.carry = carry
        return f, p, x, q

    def window(self, seconds: float, started: Callable[[], None]) -> Window:
        self.sync()
        started()
        t0 = time.perf_counter()
        lat = []
        while True:
            t = time.perf_counter()
            f, p, x, q = self.unit(self.tick)
            pose = p.cpu()
            lat.append(time.perf_counter() - t)
            self.poses.append((f, pose[0], x, q))
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        self.last = (self.carry[0].clone(), self.poses[-1][0])
        return Window(len(lat), len(lat), time.perf_counter() - t0, lat)

    def projection_time(self):
        if self.device.type != "cuda":
            return None             # device time only
        step = self.so.step
        pts = torch.stack([self.planes[k] for k in ("x", "y", "z", "rem")],
                          -1)
        valid = self.planes["valid"]
        prev = self.carry[0]

        def call(f):
            img = step.projector(pts[f:f + 1], valid[f:f + 1])[0][0]
            return step.pair(prev, img)

        calls = [lambda f=f: call(f) for f in range(4)]
        seconds = graph_s(calls)
        mb = call(0)
        elems = sum(v.numel() for v in mb.values())
        nbytes = projection_bytes(1, self.N, elems,
                                  mb["images"].element_size())
        return seconds, nbytes

    def release(self) -> None:
        del self.so, self.carry

    # -- the check --------------------------------------------------------
    def reference_record(self, precision: str = "float32") -> Dict:
        with exact_float32(), torch.no_grad():
            ref = self.reference(self.weights, precision).eval()
            frames = rproj.images({f"points_{k}": self.planes[k] for k in
                                   ("x", "y", "z", "rem")}
                                  | {"points_valid": self.planes["valid"]},
                                  self.cell.cfg)
            prev = torch.roll(frames, 1, 0)
            imgs = torch.cat([prev, frames], -1)[:, None]
            if precision == "fp8":
                imgs = round_fp8(imgs)
                frames = round_fp8(frames)
            x, q = ref(imgs, self.imu["imu"][:, None],
                       self.imu["imu_mask"][:, None])
        return {"x": x[:, 0], "q": q[:, 0], "frames": frames,
                "scale": ref.heads.x_scale}

    def compare_ticks(self, ticks, ref: Dict) -> Dict[str, float]:
        """The translations' root-mean-square gap over ``ticks`` [(frame,
        pose, x, q)] against that of the reference head's scale
        (``reference/model.py::Heads``), and the widest quaternion gap,
        against the reference's motion of each tick's frame pair."""
        f = torch.tensor([t[0] for t in ticks], device=self.device)
        x = torch.cat([t[2] for t in ticks]).float()
        q = torch.cat([t[3] for t in ticks]).float()
        ex, eq = ref["x"][f], ref["q"][f]
        qs = torch.where((q * eq).sum(-1, keepdim=True) < 0, -q, q)
        scale = ref["scale"][f]
        return {"x_gap": float(torch.linalg.vector_norm(x - ex)
                               / torch.linalg.vector_norm(scale).clamp_min(
                                   1e-30)),
                "q_gap": float(torch.linalg.vector_norm(qs - eq,
                                                        dim=-1).max())}

    @staticmethod
    def compose_gap(start: np.ndarray, poses, xs, qs) -> float:
        """The widest gap between ``poses`` and the float64 composition
        of the motions (``xs``, ``qs``) from ``start``, against the
        larger of 1 and the pose's largest entry."""
        T = start.copy()
        worst = 0.0
        for pose, dx, dq in zip(poses, xs, qs):
            step = np.eye(4)
            step[:3, :3], step[:3, 3] = _rotmat(dq), dx
            T = T @ step
            worst = max(worst, float(np.abs(pose - T).max())
                        / max(1.0, float(np.abs(T).max())))
        return worst

    def check(self) -> Dict[str, float]:
        ref = self.reference_record()
        out = self.compare_ticks(self.poses, ref)
        xs = torch.cat([t[2] for t in self.poses]).double().cpu().numpy()
        qs = torch.cat([t[3] for t in self.poses]).double().cpu().numpy()
        out["pose_gap"] = self.compose_gap(
            self.start_pose, [t[1].double().numpy() for t in self.poses],
            xs, qs)
        out["start_gap"] = float(np.abs(self.first - np.eye(4)).max())
        img, f = self.last
        out["image_mismatch"] = mismatch(img, ref["frames"][f])
        return out

    def control(self) -> Dict[str, float]:
        """The reference in float8 in the system's place; its poses
        composed one precision below float32 (bfloat16), over ten passes
        of the drive."""
        ref = self.reference_record()
        ctl = self.reference_record("fp8")
        ctl["scale"] = ref["scale"]
        ticks = [(f, None, ctl["x"][f:f + 1], ctl["q"][f:f + 1])
                 for f in range(self.n_frames)]
        out = self.compare_ticks(ticks, ref)
        seq = list(range(self.n_frames)) * 10
        xs = ctl["x"][seq].double().cpu().numpy()
        qs = ctl["q"][seq].double().cpu().numpy()
        T = torch.eye(4, dtype=torch.bfloat16)
        poses = []
        for dx, dq in zip(xs, qs):
            step = np.eye(4)
            step[:3, :3], step[:3, 3] = _rotmat(dq), dx
            S = torch.tensor(step, dtype=torch.bfloat16)
            T = (T[:, :, None] * S[None, :, :]).sum(1)
            poses.append(T.double().numpy())
        out["pose_gap"] = self.compose_gap(np.eye(4), poses, xs, qs)
        out["image_mismatch"] = mismatch(ctl["frames"], ref["frames"])
        return out

    def answers(self):
        return len(self.poses)

