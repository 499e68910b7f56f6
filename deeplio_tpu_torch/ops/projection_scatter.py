"""Point-scatter projection of raw scans in any order (counterpart of
``deeplio_tpu/ops/projection_pallas.py::project_batch_pallas``, the
``pallas`` backend).

The work splits in three, as in the JAX package:

1. a PyTorch prologue (``scatter_prologue``): per point the pixel-major key
   ``pix << rq_bits | rq`` (INT32_MAX for an invalid point) and two
   packed-f16 payload words;
2. the selection (``scatter_select``): for each scan, per pixel the point
   with the smallest key, ties to the smaller index, and its payload
   words. On a CUDA tensor this launches the hand-written kernel
   ``csrc/proj_scatter.cu`` once, laid out by ``scatter_plan`` (per-pixel
   minima in the shared memory of a cluster of CTAs, no global scratch);
   on a CPU tensor it runs the plain PyTorch version
   ``scatter_select_reference``;
3. a PyTorch epilogue (``scatter_epilogue``): unpack the payloads, depth
   from the quantized range, mask.

Prologue and epilogue are shared by both selections, so on the card the
kernel is held bit-exact against its plain version. The result equals the
JAX package's ``project_batch(packed=True)``: the closest point wins a
pixel whatever the order of the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops.projection import (
    pack_f16x2,
    rq_bits_for,
    rq_scale_for,
    rq_to_depth,
    spherical_uv_planes,
    unpack_f16x2,
)

SENTINEL = 2**31 - 1     # key of an invalid point and of an empty pixel
_EMPTY = 2**63 - 1       # the plain version's empty (index, range) slot
CTA_SLOT_BYTES = 64 * 1024   # slots per CTA: 64x1024 pixels in four CTAs
MAX_CLUSTER = 8              # the portable limit of CTAs in a cluster


def scatter_prologue(x, y, z, rem, valid, H: int, W: int,
                     fov_up_deg: float, fov_down_deg: float):
    """Planes [B, N] -> (key, xy, zr), each int32 [B, N] contiguous.

    ``key = (v * W + u) << rq_bits | rq`` for a valid point with range
    above 1 um, SENTINEL otherwise; ``rq`` is the range in quantization
    steps, clamped to ``rq_max - 1``.
    """
    rq_bits = rq_bits_for(H * W)
    rq_max = (1 << rq_bits) - 1
    u, v, r = spherical_uv_planes(x, y, z, H, W, fov_up_deg, fov_down_deg)
    ok = valid & (r > 1e-6)
    # clamp in float first: a huge range saturates to the key ceiling
    # instead of wrapping in the int32 conversion.
    rq = torch.clamp(r * rq_scale_for(rq_bits), max=rq_max - 1)
    rq = rq.to(torch.int32).clamp_min(0)
    key = torch.where(ok, ((v * W + u) << rq_bits) | rq, SENTINEL)
    return (key.to(torch.int32).contiguous(), pack_f16x2(x, y).contiguous(),
            pack_f16x2(z, rem).contiguous())


def scatter_epilogue(kmin, xyo, zro, H: int, W: int):
    """Selected [B, H*W] words -> (img [B, H, W, 5] f32, mask [B, H, W]),
    word for word the epilogue of ``project_batch_pallas``."""
    b = kmin.shape[0]
    rq_bits = rq_bits_for(H * W)
    rq_max = (1 << rq_bits) - 1
    maskf = (kmin != SENTINEL).to(torch.float32)
    x, y = unpack_f16x2(xyo)
    z, rem = unpack_f16x2(zro)
    depth = rq_to_depth(kmin & rq_max, rq_scale_for(rq_bits))
    img = torch.stack([x, y, z, rem, depth], -1) * maskf[..., None]
    return img.reshape(b, H, W, 5), maskf.reshape(b, H, W)


def scatter_select_reference(key, xy, zr, n_pix: int, rq_bits: int):
    """Plain PyTorch selection: the function the CUDA kernel computes.

    For every pixel ``p < n_pix`` the point i* with ``key >> rq_bits == p``
    and the smallest ``(key & rq_mask, i)``; ``kmin[p] = key[i*]`` and the
    payload words of i* (SENTINEL and 0 if no point landed). A key of
    SENTINEL, a negative key or one whose pixel is out of range lands
    nowhere.
    """
    b, n = key.shape
    pix = key >> rq_bits
    live = (key >= 0) & (key != SENTINEL) & (pix < n_pix)
    slot = torch.where(live, pix, n_pix).long()        # n_pix: dump column
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    comp = ((key & ((1 << rq_bits) - 1)).long() << 32) | idx
    best = torch.full((b, n_pix + 1), _EMPTY, dtype=torch.int64,
                      device=key.device)
    best.scatter_reduce_(1, slot, comp, reduce="amin", include_self=True)
    best = best[:, :n_pix]
    empty = best == _EMPTY
    win = torch.where(empty, 0, best & 0xFFFFFFFF)
    pixels = torch.arange(n_pix, dtype=torch.int64, device=key.device)
    kmin = torch.where(empty, SENTINEL, (pixels << rq_bits) | (best >> 32))
    xyo = torch.where(empty, 0, torch.gather(xy, 1, win))
    zro = torch.where(empty, 0, torch.gather(zr, 1, win))
    return (kmin.to(torch.int32).contiguous(), xyo.contiguous(),
            zro.contiguous())


def _check_inputs(key, xy, zr, n_pix: int, rq_bits: int) -> None:
    for name, t in (("key", key), ("xy", xy), ("zr", zr)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != key.shape:
            raise ValueError(f"{name} must be [B, N] like key "
                             f"{tuple(key.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != key.device:
            raise ValueError(f"{name} is on {t.device}, key on {key.device}")
    if n_pix < 1:
        raise ValueError(f"n_pix must be positive, got {n_pix}")
    if not 1 <= rq_bits <= 30 or (n_pix + 1) << rq_bits >= 2**31:
        raise ValueError(f"rq_bits {rq_bits} does not fit {n_pix} pixels "
                         f"in int32 keys")


class ScatterPlan(NamedTuple):
    """How ``csrc/proj_scatter.cu`` lays one launch out."""
    slot_bytes: int   # 4: composite rq << idx_bits | index in u32; 8: u64
    idx_bits: int     # the index's bits in the composite (32 for u64)
    cluster: int      # CTAs in a cluster, each owning cta_slots pixels
    cta_slots: int    # pixel slots in one CTA's shared memory
    tiles: int        # pixel tiles, one cluster each per scan


def scatter_plan(n: int, n_pix: int, rq_bits: int) -> ScatterPlan:
    """The launch plan of the scatter kernel for scans of ``n`` points
    into ``n_pix`` pixels.

    u32 slots where ``rq_bits + idx_bits <= 31`` (so no composite is all
    ones, the empty slot), else u64. C is the fewest CTAs of at most
    ``CTA_SLOT_BYTES`` of slots each that hold the whole image, at most
    ``MAX_CLUSTER``; a larger image is cut into tiles of ``MAX_CLUSTER``
    CTAs. The grid is ``(cluster * tiles, B)``.
    """
    idx_bits = max((max(n, 2) - 1).bit_length(), 1)
    if rq_bits + idx_bits <= 31:
        slot_bytes = 4
    else:
        slot_bytes, idx_bits = 8, 32
    cap = CTA_SLOT_BYTES // slot_bytes
    need = -(-n_pix // cap)
    cluster = min(need, MAX_CLUSTER)
    tiles = -(-n_pix // (cluster * cap))
    tile_pix = -(-n_pix // tiles)
    return ScatterPlan(slot_bytes, idx_bits, cluster, -(-tile_pix // cluster),
                       tiles)


def scatter_select(key, xy, zr, n_pix: int, rq_bits: int):
    """Scatter selection: [B, N] int32 x3 -> kmin, xyo, zro [B, n_pix]
    int32.

    On a CPU tensor this is :func:`scatter_select_reference`. On a CUDA
    tensor it launches ``csrc/proj_scatter.cu`` once on the current stream
    as :func:`scatter_plan` lays it out, adds one to
    ``scatter_select.launches``, and raises if the build or the launch
    fails (also when no cluster of the plan fits on the device); it never
    falls back to the plain version there.
    """
    _check_inputs(key, xy, zr, n_pix, rq_bits)
    if key.device.type == "cpu":
        return scatter_select_reference(key, xy, zr, n_pix, rq_bits)
    if key.device.type != "cuda":
        raise ValueError(
            f"scatter_select runs on cuda or cpu, got {key.device}")
    b, n = key.shape
    if b > 65535:
        raise ValueError(f"scatter_select takes at most 65535 scans per "
                         f"launch, got {b}")
    lib = _library()
    plan = scatter_plan(n, n_pix, rq_bits)
    kmin = torch.empty((b, n_pix), dtype=torch.int32, device=key.device)
    xyo = torch.empty_like(kmin)
    zro = torch.empty_like(kmin)
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlt_proj_scatter(
            key.data_ptr(), xy.data_ptr(), zr.data_ptr(), kmin.data_ptr(),
            xyo.data_ptr(), zro.data_ptr(), b, n, n_pix, rq_bits, *plan,
            stream)
    if err:
        raise RuntimeError(f"proj_scatter launch failed: "
                           f"{_kernels.error_string(lib, err)}")
    scatter_select.launches += 1
    return kmin, xyo, zro


scatter_select.launches = 0


def project_batch_scatter_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rem: torch.Tensor,
    valid: torch.Tensor, H: int, W: int,
    fov_up_deg: float, fov_down_deg: float,
    select: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planes x/y/z/rem [B, N] float32, valid [B, N] bool ->
    (img [B, H, W, 5] float32, mask [B, H, W] float32).

    Same contract as the JAX package's ``project_batch_pallas``, for any
    N and any H*W (the CUDA kernel needs no padding). ``select`` defaults
    to :func:`scatter_select`.
    """
    key, xy, zr = scatter_prologue(x, y, z, rem, valid, H, W,
                                   fov_up_deg, fov_down_deg)
    kmin, xyo, zro = (select or scatter_select)(key, xy, zr, H * W,
                                                rq_bits_for(H * W))
    return scatter_epilogue(kmin, xyo, zro, H, W)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _kernels.library("proj_scatter")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlt_proj_scatter.argtypes = [p] * 6 + [i] * 9 + [p]
    lib.dlt_proj_scatter.restype = i
    return lib
