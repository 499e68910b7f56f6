"""Projection cache (counterpart of ``deeplio_tpu/data/proj_cache.py``).

A frame's projection is the same in every epoch. With ``train:
cache-projections: true`` the trainer projects every frame of its drives
once, on its device, into an f16 memmap per drive; the epochs then read
the cached images and the training step skips its projection.

Layout: ``<dir>/<drive-name>@<start>-<len>-<fingerprint>.npy``, [frames,
H, W, C] float16. The fingerprint hashes every setting that changes the
projected values (geometry, backend, channels, normalisation) as the JAX
package does, so the same config gives the same file names.

Multi-process: only the primary process builds (the work directory is
shared, as checkpoints need); the others poll for its finished files. The
primary's heartbeat file, touched every 15 s by a daemon thread, lets a
waiter tell a slow build from a dead primary: it raises after ``stall_s``
with neither a fresh heartbeat nor the file, and at ``timeout_s`` in any
case. Temporary names carry the process id, so even a work directory that
is not shared cannot mix two builds.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, Sequence

import numpy as np
import torch

from deeplio_tpu_torch.config.schema import DatasetConfig
from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.parallel import multihost
from deeplio_tpu_torch.utils import get_app_logger

POLL_S = 2.0          # a waiter's look at the cache directory
BEAT_S = 15.0         # the primary's heartbeat period


def fingerprint(ds_cfg: DatasetConfig) -> str:
    p = ds_cfg.projection
    blob = json.dumps({
        "h": p.height, "w": p.width, "fu": p.fov_up_deg, "fd": p.fov_down_deg,
        "n": p.max_points, "backend": p.backend, "packed": p.packed,
        "channels": list(ds_cfg.channels),
        "mean": list(ds_cfg.mean), "std": list(ds_cfg.std),
    }, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


class ProjectionCache:
    """Builds and serves per-drive projected-image memmaps. ``device``
    projects the prefill (CUDA unless ``"cpu"`` is passed)."""

    def __init__(self, directory: str, ds_cfg: DatasetConfig,
                 device: DeviceLike = None):
        self.dir = os.path.abspath(directory)
        self.ds_cfg = ds_cfg
        self.device = resolve_device(device)
        self.tag = fingerprint(ds_cfg)
        os.makedirs(self.dir, exist_ok=True)
        self._maps: Dict[str, np.ndarray] = {}
        self.fill_ms = 0.0       # host time of the prefills so far

    def _path(self, drive) -> str:
        # start and length tell apart sub-ranges of one raw drive
        span = f"{getattr(drive, 'start', 0)}-{len(drive)}"
        return os.path.join(self.dir, f"{drive.name}@{span}-{self.tag}.npy")

    def _heartbeat(self) -> str:
        # one per (cache directory, fingerprint)
        return os.path.join(self.dir, f"building-{self.tag}.hb")

    def ensure(self, drives: Sequence, batch: int = 16,
               timeout_s: float = 3600.0, stall_s: float = 120.0) -> None:
        """Project every frame of each drive whose file is missing, in
        chunks of ``batch`` frames (the last padded to ``batch`` with
        copies of its last frame), through ``make_projector(...,
        layout="aos")``. Each file is written as ``<path>.tmp.<pid>`` and
        renamed when complete; a drive listed twice is built once.

        Only the primary process builds; the others wait for its files
        (:meth:`_wait`)."""
        todo = [d for d in drives if not os.path.exists(self._path(d))]
        if not todo:
            return
        if not multihost.is_primary():
            self._wait(todo, timeout_s, stall_s)
            return
        # beat from a thread, not per chunk: the first projection can
        # take long (a kernel build), and the thread dies with the
        # process, which is what the waiters need to see
        stop = threading.Event()

        def touch():
            with open(self._heartbeat(), "w") as f:
                f.write(str(os.getpid()))

        def beat():
            while not stop.wait(BEAT_S):
                touch()

        touch()
        beater = threading.Thread(target=beat, daemon=True)
        beater.start()
        try:
            self._build(todo, batch)
        finally:
            stop.set()
            beater.join()
            try:
                os.remove(self._heartbeat())
            except OSError:
                pass

    def _wait(self, todo: Sequence, timeout_s: float,
              stall_s: float) -> None:
        """Poll for the primary's files. Raises RuntimeError when neither a
        file nor a fresh heartbeat has appeared for ``stall_s`` (the
        primary died mid-build) and TimeoutError at ``timeout_s``."""
        deadline = time.time() + timeout_s
        last_alive = time.time()      # grace before the heartbeat appears
        for d in todo:
            while not os.path.exists(self._path(d)):
                try:
                    last_alive = max(last_alive,
                                     os.path.getmtime(self._heartbeat()))
                except OSError:
                    pass
                now = time.time()
                if now - last_alive > stall_s:
                    raise RuntimeError(
                        f"projection cache {self._path(d)}: the primary "
                        f"process's build heartbeat went stale "
                        f"({now - last_alive:.0f}s > {stall_s:.0f}s): the "
                        f"primary likely died mid-build")
                if now > deadline:
                    raise TimeoutError(
                        f"projection cache {self._path(d)} not built by "
                        f"the primary process within the timeout")
                time.sleep(POLL_S)

    def _build(self, drives: Sequence, batch: int) -> None:
        from deeplio_tpu_torch.ops.projection import make_projector

        ds = self.ds_cfg
        p = ds.projection
        projector = None
        t0 = time.perf_counter()
        for d in drives:
            path = self._path(d)
            if os.path.exists(path):
                continue
            if projector is None:
                projector = make_projector(p, ds.channels, ds.mean, ds.std)
            n = len(d)
            tmp = f"{path}.tmp.{os.getpid()}"
            out = np.lib.format.open_memmap(
                tmp, mode="w+", dtype=np.float16,
                shape=(n, p.height, p.width, ds.num_image_channels))
            for b0 in range(0, n, batch):
                k = min(batch, n - b0)
                pts, vld = zip(*[d.points(i) for i in range(b0, b0 + k)])
                pad = batch - k
                pts = torch.from_numpy(np.stack(pts + pts[-1:] * pad))
                vld = torch.from_numpy(np.stack(vld + vld[-1:] * pad))
                img, _ = projector(pts.to(self.device), vld.to(self.device))
                out[b0:b0 + k] = img[:k].to(torch.float16).cpu().numpy()
            out.flush()
            del out
            os.replace(tmp, path)
            get_app_logger().info("projection cache: %s (%d frames) -> %s",
                                  d.name, n, path)
        self.fill_ms += (time.perf_counter() - t0) * 1e3

    def images(self, drive, lo: int, hi: int) -> np.ndarray:
        """[hi - lo, H, W, C] float16 view of frames [lo, hi)."""
        path = self._path(drive)
        mm = self._maps.get(path)
        if mm is None:
            mm = np.load(path, mmap_mode="r")
            self._maps[path] = mm
        return mm[lo:hi]
