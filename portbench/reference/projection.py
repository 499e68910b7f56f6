"""Plain PyTorch spherical projection: the benchmark's reference for the
model batch.

SqueezeSeg's convention, in float32::

    r = ||p||,  yaw = atan2(y, x),  pitch = asin(z / r)
    u = floor(0.5 * (1 - yaw / pi) * W)               clamped to [0, W-1]
    v = floor((1 - (pitch - fov_down) / fov) * H)     clamped to [0, H-1]

A valid point (range above 1 um) competes for its pixel; the smallest
quantized range wins, ties to the smaller index. Two payloads, as the
configurations choose them:

- ``packed`` (``packed: true``, the ring routes): the winner's x, y, z and
  remission rounded through float16, depth the quantized range times the
  float32 reciprocal of the quantization step; the keys are ``rq <<
  idx_bits | idx`` (``idx_bits`` the scan capacity's bits, ``rq_bits = min
  (14, 30 - idx_bits)``);
- ``exact`` (``packed: false``, the ``sort`` route): the winner's float32
  values, depth ``sqrt(x*x + y*y + z*z)``; the keys are ``pix << rq_bits |
  rq`` with ``rq_bits`` the largest width that keeps the key in int31.

A step of ``rq_scale`` per metre: 100 at 14 bits, else ``2**rq_bits /
164``. The image is the configured channels of (x, y, z, remission,
depth), ``(v - mean) / std`` times the mask, cast to the model's dtype.
Nothing here imports the system under test.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

CHANNELS = {"x": 0, "y": 1, "z": 2, "remission": 3, "depth": 4}


def sqrt(v: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on any device (through
    float64, whose rounding to float32 is exact)."""
    return torch.sqrt(v.double()).float()


def key_layout(n: int, n_pix: int, packed: bool) -> Tuple[int, int, float]:
    """(idx_bits, rq_bits, rq_scale) of the route's keys."""
    if packed:
        idx_bits = max(int(math.ceil(math.log2(max(n, 2)))), 1)
        rq_bits = min(14, 30 - idx_bits)
    else:
        idx_bits, rq_bits = 0, 14
        while rq_bits > 8 and (n_pix + 1) << rq_bits >= 2**31:
            rq_bits -= 1
    scale = 100.0 if rq_bits >= 14 else (1 << rq_bits) / 164.0
    return idx_bits, rq_bits, scale


def project(x, y, z, rem, valid, H: int, W: int, fov_up: float,
            fov_down: float, packed: bool) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Planes [B, N] -> (img [B, H, W, 5] float32, mask [B, H, W])."""
    b, n = x.shape
    n_pix = H * W
    _, rq_bits, rq_scale = key_layout(n, n_pix, packed)
    rq_max = (1 << rq_bits) - 1
    r = sqrt(x * x + y * y + z * z)
    yaw = torch.atan2(y, x)
    pitch = torch.asin(torch.clamp(z / torch.clamp_min(r, 1e-9), -1.0, 1.0))
    fd = float(np.float32(np.deg2rad(fov_down)))
    fov = float(np.float32(np.deg2rad(fov_up - fov_down)))
    pi32 = float(np.float32(np.pi))
    u = torch.floor(0.5 * (1.0 - yaw / pi32) * W).to(torch.int64)
    v = torch.floor((1.0 - (pitch - fd) / fov) * H).to(torch.int64)
    pix = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
    ok = valid & (r > 1e-6)
    rq = torch.clamp(r * rq_scale, max=rq_max - 1).to(torch.int64)
    rq = rq.clamp_min(0)
    idx = torch.arange(n, device=x.device).expand(b, n)
    # one int64 order: pixel, then quantized range, then index
    comp = (rq << 32) | idx
    slot = torch.where(ok, pix, n_pix)                    # dump column
    best = torch.full((b, n_pix + 1), 2**62, dtype=torch.int64,
                      device=x.device)
    best.scatter_reduce_(1, slot, comp, reduce="amin", include_self=True)
    best = best[:, :n_pix]
    landed = best != 2**62
    win = torch.where(landed, best & 0xFFFFFFFF, 0)
    vals = [torch.gather(p, 1, win) for p in (x, y, z, rem)]
    if packed:
        vals = [t.to(torch.float16).to(torch.float32) for t in vals]
        depth = (best >> 32).to(torch.float32) * float(
            np.float32(1.0 / rq_scale))
    else:
        depth = sqrt(vals[0] * vals[0] + vals[1] * vals[1]
                     + vals[2] * vals[2])
    maskf = landed.to(torch.float32)
    img = torch.where(landed[..., None], torch.stack(vals + [depth], -1),
                      0.0)
    return img.reshape(b, H, W, 5), maskf.reshape(b, H, W)


def model_image(img5: torch.Tensor, mask: torch.Tensor,
                channels: Sequence[str], mean: Sequence[float],
                std: Sequence[float]) -> torch.Tensor:
    """The configured channels, normalised and masked, float32."""
    img = torch.stack([img5[..., CHANNELS[c]] for c in channels], -1)
    m = torch.tensor(np.asarray(mean, np.float32), device=img.device)
    s = torch.tensor(np.asarray(std, np.float32), device=img.device)
    return (img - m) / s * mask[..., None]


def images(planes: Dict[str, torch.Tensor], cfg: Dict) -> torch.Tensor:
    """A raw batch's scans [B*S, N] -> float32 images [B*S, H, W, C] as a
    configuration file's dictionary describes them."""
    ds = cfg["datasets"]
    H, W = int(ds.get("image-height", 64)), int(ds.get("image-width", 1024))
    img5, mask = project(planes["points_x"], planes["points_y"],
                         planes["points_z"], planes["points_rem"],
                         planes["points_valid"], H, W,
                         float(ds.get("fov-up", 3.0)),
                         float(ds.get("fov-down", -25.0)),
                         bool(ds.get("packed", False)))
    return model_image(img5, mask, ds["channels"], ds["mean"], ds["std"])


def pair_images(frames: torch.Tensor, combos) -> torch.Tensor:
    """Frames [B, S, H, W, C] -> pair stacks [B, P, H, W, 2C]."""
    return torch.stack([torch.cat([frames[:, i], frames[:, j]], -1)
                        for i, j in combos], 1)
