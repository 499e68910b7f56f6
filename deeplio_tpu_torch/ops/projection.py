"""Device-side spherical ("range-image") projection of LiDAR scans
(counterpart of ``deeplio_tpu/ops/projection.py``, restricted to what the
``pallas-ring``, ``pallas`` and ``sort`` backends with ``kernel-aligned:
off`` run).

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

from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

if TYPE_CHECKING:   # the serving artifact's loader imports no config
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


def rq_bits_for(n_pix: int) -> int:
    """Largest range-quantization width so ``(n_pix << bits) | mask`` fits
    in int31: the bits of the pixel-major keys ``pix << rq_bits | rq``."""
    bits = DEFAULT_RQ_BITS
    while bits > 8 and (n_pix + 1) << bits >= 2**31:
        bits -= 1
    if (n_pix + 1) << bits >= 2**31:
        raise ValueError(
            f"image with {n_pix} pixels too large for int32 sort key")
    return bits


def rq_scale_for(rq_bits: int) -> float:
    """Quantization steps per metre: 1 cm unless the key budget forces
    coarser."""
    return 100.0 if rq_bits >= DEFAULT_RQ_BITS else (1 << rq_bits) / 164.0


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
    return idx_bits, rq_bits, rq_scale_for(rq_bits)


def assemble_channels(img5: torch.Tensor,
                      channels: Sequence[str]) -> torch.Tensor:
    """Select the configured channel stack from the 5-channel projection."""
    return torch.stack([img5[..., CHANNEL_INDEX[c]] for c in channels], -1)


def normalize_channels(img: torch.Tensor, mask: torch.Tensor,
                       mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Per-channel (x - mean) / std, zeroing empty pixels."""
    return (img - mean) / std * mask[..., None]


def make_projector(cfg_proj: ProjectionConfig, channels: Sequence[str],
                   mean: Sequence[float] = (), std: Sequence[float] = (),
                   out_dtype: Optional[torch.dtype] = None,
                   layout: str = "aos"):
    """Build the batched scan -> image function for a config.

    Returns ``fn(points, valid [..., N]) -> (img [..., H, W, C], mask
    [..., H, W])`` on the points' device. ``layout="aos"`` takes points
    [..., N, 4]; ``layout="planes"`` takes the 4-tuple of planes (x, y, z,
    rem), each [..., N], the training step's contract. All leading dims go
    through the kernel as one batch. ``out_dtype`` casts the image (the
    training step emits its compute dtype); the mask stays float32.

    ``backend: pallas-ring`` selects with ``projection_ring.ring_select``
    (ring-ordered scans), ``backend: pallas`` and ``sort`` with
    ``projection_scatter.scatter_select`` (scans in any order); ``sort``
    carries exact float32 channels unless ``packed`` (JAX's ``carry`` and
    ``carry-f16``). Each runs its CUDA kernel on the card and its plain
    PyTorch version on the CPU, the whole batch in one launch (JAX's
    ``projection-chunk`` only schedules its work).
    """
    import functools

    from deeplio_tpu_torch.ops import projection_ring, projection_scatter

    planes_fn = {
        "pallas-ring": projection_ring.project_batch_ring_planes,
        "pallas": projection_scatter.project_batch_scatter_planes,
        "sort": functools.partial(
            projection_scatter.project_batch_sorted_planes,
            payload="carry-f16" if cfg_proj.packed else "carry"),
    }.get(cfg_proj.backend)
    if planes_fn is None or cfg_proj.kernel_aligned != "off":
        raise ValueError("the port projects with backend=pallas-ring, "
                         "pallas or sort and kernel-aligned=off only")
    if layout not in ("aos", "planes"):
        raise ValueError(f"layout must be aos|planes, got {layout!r}")
    if bool(mean) != bool(std):
        raise ValueError(
            "normalization requires both mean and std (or neither)")
    H, W = cfg_proj.height, cfg_proj.width
    fu, fd = cfg_proj.fov_up_deg, cfg_proj.fov_down_deg
    c = len(channels)
    norm = ((np.asarray(mean, np.float32), np.asarray(std, np.float32))
            if mean else None)
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def project(points, valid: torch.Tensor):
        if layout == "planes":
            lead = tuple(points[0].shape[:-1])
            n = points[0].shape[-1]
            planes = [p.reshape(-1, n) for p in points]
        else:
            lead = tuple(points.shape[:-2])
            n = points.shape[-2]
            pts = points.reshape(-1, n, 4)
            planes = [pts[..., k] for k in range(4)]
        img5, mask = planes_fn(*planes, valid.reshape(-1, n), H, W, fu, fd)
        img = assemble_channels(img5, channels)
        if norm is None:
            img = img * mask[..., None]
        else:
            dev = img.device
            if dev not in consts:
                consts[dev] = (torch.from_numpy(norm[0]).to(dev),
                               torch.from_numpy(norm[1]).to(dev))
            img = normalize_channels(img, mask, *consts[dev])
        if out_dtype is not None:
            img = img.to(out_dtype)
        return img.reshape(lead + (H, W, c)), mask.reshape(lead + (H, W))

    return project
