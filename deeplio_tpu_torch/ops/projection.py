"""Device-side spherical ("range-image") projection of LiDAR scans
(counterpart of ``deeplio_tpu/ops/projection.py``, restricted to what the
``pallas-ring`` backend with ``kernel-aligned: off`` runs).

Projection convention (SqueezeSeg), as in the JAX package:

    r     = ||p||_2
    yaw   = atan2(y, x)
    pitch = asin(z / r)
    u     = floor(0.5 * (1 - yaw/pi) * W)            clamped to [0, W-1]
    v     = floor((1 - (pitch - fov_down)/fov) * H)  clamped to [0, H-1]

The closest point wins a pixel. All arithmetic is float32 and follows the
JAX expressions operation by operation, so the port and the reference agree
bit for bit except where ``atan2``/``asin`` differ by an ulp between
libraries and move a boundary point by one pixel.

Layout: images are NHWC (..., H, W, C) at this module's public functions,
as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from deeplio_tpu_torch.config.schema import ProjectionConfig

DEFAULT_RQ_BITS = 14
CHANNEL_INDEX = {"x": 0, "y": 1, "z": 2, "remission": 3, "depth": 4}


def spherical_uv_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
    H: int, W: int, fov_up_deg: float, fov_down_deg: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point int32 (u, v) and float32 range from x/y/z planes."""
    r = torch.sqrt(x * x + y * y + z * z)
    r_safe = torch.clamp_min(r, 1e-9)
    yaw = torch.atan2(y, x)
    pitch = torch.asin(torch.clamp(z / r_safe, -1.0, 1.0))
    fov_down = float(np.float32(np.deg2rad(fov_down_deg)))
    fov = float(np.float32(np.deg2rad(fov_up_deg - fov_down_deg)))
    pi32 = float(np.float32(np.pi))
    u = torch.floor(0.5 * (1.0 - yaw / pi32) * W).to(torch.int32)
    v = torch.floor((1.0 - (pitch - fov_down) / fov) * H).to(torch.int32)
    return u.clamp(0, W - 1), v.clamp(0, H - 1), r


def pack_f16x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> one int32 tensor of f16(a) | f16(b) << 16.

    The two halves are laid side by side as float16 and reinterpreted as
    int32 (little-endian: ``a`` in the low 16 bits), the bit layout of the
    JAX package's ``_pack_f16x2``.
    """
    pair = torch.stack([a.to(torch.float16), b.to(torch.float16)], dim=-1)
    return pair.view(torch.int32).squeeze(-1)


def unpack_f16x2(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_f16x2`: int32 -> (low half, high half) f32."""
    pair = p.unsqueeze(-1).view(torch.float16)
    return pair[..., 0].to(torch.float32), pair[..., 1].to(torch.float32)


def rq_to_depth(rq: torch.Tensor, rq_scale: float) -> torch.Tensor:
    """Quantized range key -> metres, by MULTIPLYING with the float32
    reciprocal (never dividing), as ``deeplio_tpu`` does to stay bit-exact
    across compilation regimes. The reciprocal is a float32 tensor, so no
    double-precision scalar enters the computation."""
    inv = torch.tensor(np.float32(1.0 / rq_scale))
    return rq.to(torch.float32) * inv


def idx_key_layout(n: int, n_pix: int) -> Tuple[int, int, float]:
    """(idx_bits, rq_bits, rq_scale) for keys ``rq << idx_bits | idx``.

    The minimum key of a pixel is its closest point, ties going to the
    smallest index.
    """
    idx_bits = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    rq_bits = min(DEFAULT_RQ_BITS, 30 - idx_bits)
    if rq_bits < 8:
        raise ValueError(
            f"scan capacity {n} too large for int32 (range, idx) keys")
    rq_scale = 100.0 if rq_bits >= DEFAULT_RQ_BITS else (1 << rq_bits) / 164.0
    return idx_bits, rq_bits, rq_scale


def assemble_channels(img5: torch.Tensor,
                      channels: Sequence[str]) -> torch.Tensor:
    """Select the configured channel stack from the 5-channel projection."""
    return torch.stack([img5[..., CHANNEL_INDEX[c]] for c in channels], -1)


def normalize_channels(img: torch.Tensor, mask: torch.Tensor,
                       mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Per-channel (x - mean) / std, zeroing empty pixels."""
    return (img - mean) / std * mask[..., None]


def make_projector(cfg_proj: ProjectionConfig, channels: Sequence[str],
                   mean: Sequence[float] = (), std: Sequence[float] = ()):
    """Build the batched scan -> image function for a config.

    Returns ``fn(points [..., N, 4], valid [..., N]) -> (img [..., H, W, C],
    mask [..., H, W])`` on the points' device. The ring selection runs the
    CUDA kernel on the card (``projection_ring.ring_select``) and its plain
    PyTorch version on the CPU.
    """
    from deeplio_tpu_torch.ops import projection_ring

    if cfg_proj.backend != "pallas-ring" or cfg_proj.kernel_aligned != "off":
        raise ValueError("the port projects with backend=pallas-ring and "
                         "kernel-aligned=off only")
    if bool(mean) != bool(std):
        raise ValueError(
            "normalization requires both mean and std (or neither)")
    H, W = cfg_proj.height, cfg_proj.width
    fu, fd = cfg_proj.fov_up_deg, cfg_proj.fov_down_deg
    c = len(channels)
    norm = ((np.asarray(mean, np.float32), np.asarray(std, np.float32))
            if mean else None)
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def project(points: torch.Tensor, valid: torch.Tensor):
        lead = tuple(points.shape[:-2])
        n = points.shape[-2]
        pts = points.reshape(-1, n, 4)
        vld = valid.reshape(-1, n)
        img5, mask = projection_ring.project_batch_ring_planes(
            pts[..., 0], pts[..., 1], pts[..., 2], pts[..., 3], vld,
            H, W, fu, fd)
        img = assemble_channels(img5, channels)
        if norm is None:
            img = img * mask[..., None]
        else:
            dev = img.device
            if dev not in consts:
                consts[dev] = (torch.from_numpy(norm[0]).to(dev),
                               torch.from_numpy(norm[1]).to(dev))
            img = normalize_channels(img, mask, *consts[dev])
        return img.reshape(lead + (H, W, c)), mask.reshape(lead + (H, W))

    return project
