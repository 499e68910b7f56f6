"""Ring projection of raw, ring-ordered scans (counterpart of
``deeplio_tpu/ops/projection_pallas_ring.py::project_batch_ring_pallas``).

The work splits in three, as in the JAX package:

1. a PyTorch prologue (``ring_prologue``): per-point pixel, the winner key
   ``rq << idx_bits | idx`` and two packed-f16 payload words;
2. the selection (``ring_select``): for each scan, a running max of the
   pixel along the points, then per pixel the minimum key and the payload
   of the point that holds it. On a CUDA tensor this launches the
   hand-written kernel ``csrc/ring_project.cu``; on a CPU tensor it runs
   the plain PyTorch version ``ring_select_reference``;
3. a PyTorch epilogue (``ring_epilogue``): unpack the payloads, depth from
   the quantized range, mask.

Prologue and epilogue are shared by both selections, so on the card the
kernel is held bit-exact against its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops.projection import (
    idx_key_layout,
    pack_f16x2,
    rq_to_depth,
    spherical_uv_planes,
    unpack_f16x2,
)

SENTINEL = 2**31 - 1     # key of an empty pixel; every real key is smaller


def ring_prologue(x, y, z, rem, valid, H: int, W: int,
                  fov_up_deg: float, fov_down_deg: float):
    """Planes [B, N] -> (pix, key, p1, p2), each int32 [B, N] contiguous.

    ``pix`` is the raw pixel: ``v * W + u`` for a valid point, -1 for an
    invalid one (the selection's running max carries the previous pixel
    over it). A PURE-TAIL invalid suffix (a real scan padded to capacity:
    every valid point before every invalid one) is re-keyed to ``n_pix``
    instead, so it forms its own out-of-range run and never stretches the
    last real pixel's run. Invalid points carry ``rq_max`` in their key, so
    they lose to every valid point of their run.
    """
    n = x.shape[1]
    n_pix = H * W
    idx_bits, rq_bits, rq_scale = idx_key_layout(n, n_pix)
    rq_max = (1 << rq_bits) - 1

    u, v, r = spherical_uv_planes(x, y, z, H, W, fov_up_deg, fov_down_deg)
    ok = valid & (r > 1e-6)
    pix = torch.where(ok, v * W + u, -1)
    # pure tail <=> no valid point follows an invalid one
    pure = ~(ok[:, 1:] & ~ok[:, :-1]).any(dim=1, keepdim=True)
    pix = torch.where(pure & ~ok, n_pix, pix)
    # clamp in float first: a huge range saturates to the key ceiling
    # instead of wrapping in the int32 conversion.
    rq = torch.clamp(r * rq_scale, max=rq_max - 1).to(torch.int32)
    rqv = torch.where(ok, rq.clamp_min(0), rq_max)
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    key = (rqv << idx_bits) | idx
    return (pix.to(torch.int32).contiguous(), key.contiguous(),
            pack_f16x2(x, y).contiguous(), pack_f16x2(z, rem).contiguous())


def ring_epilogue(okey, op1, op2, n: int, H: int, W: int):
    """Selected [B, H*W] words -> (img [B, H, W, 5] f32, mask [B, H, W]).

    A pixel is set when some point's run landed on it and the winner is a
    valid point (an all-invalid run keeps ``rq_max`` and is masked)."""
    b = okey.shape[0]
    idx_bits, rq_bits, rq_scale = idx_key_layout(n, H * W)
    rq_max = (1 << rq_bits) - 1
    rq_out = okey >> idx_bits
    maskf = ((okey != SENTINEL) & (rq_out < rq_max)).to(torch.float32)
    x, y = unpack_f16x2(op1)
    z, rem = unpack_f16x2(op2)
    depth = rq_to_depth(rq_out, rq_scale)
    img = torch.stack([x, y, z, rem, depth], -1) * maskf[..., None]
    return img.reshape(b, H, W, 5), maskf.reshape(b, H, W)


def ring_select_reference(pix, key, p1, p2, n_pix: int):
    """Plain PyTorch selection: the function the CUDA kernel computes.

    ``cpix = max(cummax(pix), 0)`` along each scan; for every pixel
    ``p < n_pix`` the minimum key over ``{i : cpix[i] == p}`` (SENTINEL if
    none) and the payload words of the point holding it (0 if none).
    Keys must be unique within a scan (their index bits make them so).
    """
    b = pix.shape[0]
    cpix = torch.cummax(pix, dim=1).values.clamp_min(0)
    # out-of-range runs (the re-keyed invalid tail) go to a dump column.
    slot = torch.where(cpix < n_pix, cpix, n_pix).long()
    okey = torch.full((b, n_pix + 1), SENTINEL, dtype=torch.int32,
                      device=pix.device)
    okey.scatter_reduce_(1, slot, key, reduce="amin", include_self=True)
    win = (slot < n_pix) & (torch.gather(okey, 1, slot) == key)
    wslot = torch.where(win, slot, n_pix)
    op1 = torch.zeros_like(okey).scatter_(1, wslot, p1)
    op2 = torch.zeros_like(okey).scatter_(1, wslot, p2)
    return (okey[:, :n_pix].contiguous(), op1[:, :n_pix].contiguous(),
            op2[:, :n_pix].contiguous())


def _check_inputs(pix, key, p1, p2, n_pix: int) -> None:
    for name, t in (("pix", pix), ("key", key), ("p1", p1), ("p2", p2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != pix.shape:
            raise ValueError(f"{name} must be [B, N] like pix "
                             f"{tuple(pix.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pix.device:
            raise ValueError(f"{name} is on {t.device}, pix on {pix.device}")
    if n_pix < 1:
        raise ValueError(f"n_pix must be positive, got {n_pix}")


def ring_select(pix, key, p1, p2, n_pix: int):
    """Ring selection: [B, N] int32 x4 -> okey, op1, op2 [B, n_pix] int32.

    On a CPU tensor this is :func:`ring_select_reference`. On a CUDA tensor
    it launches ``csrc/ring_project.cu`` on the current stream, adds one to
    ``ring_select.launches``, and raises if the launch fails; it never falls
    back to the plain version there.
    """
    _check_inputs(pix, key, p1, p2, n_pix)
    if pix.device.type == "cpu":
        return ring_select_reference(pix, key, p1, p2, n_pix)
    if pix.device.type != "cuda":
        raise ValueError(f"ring_select runs on cuda or cpu, got {pix.device}")
    b, n = pix.shape
    lib = _library()
    # the kernel writes every word of the outputs: no fill, no scratch
    okey = torch.empty((b, n_pix), dtype=torch.int32, device=pix.device)
    op1 = torch.empty_like(okey)
    op2 = torch.empty_like(okey)
    with torch.cuda.device(pix.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlt_ring_project(
            pix.data_ptr(), key.data_ptr(), p1.data_ptr(), p2.data_ptr(),
            okey.data_ptr(), op1.data_ptr(), op2.data_ptr(), b, n, n_pix,
            stream)
    if err:
        raise RuntimeError(f"ring_project launch failed: "
                           f"{_kernels.error_string(lib, err)}")
    ring_select.launches += 1
    return okey, op1, op2


ring_select.launches = 0


def project_batch_ring_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rem: torch.Tensor,
    valid: torch.Tensor, H: int, W: int,
    fov_up_deg: float, fov_down_deg: float,
    select: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planes x/y/z/rem [B, N] float32, valid [B, N] bool ->
    (img [B, H, W, 5] float32, mask [B, H, W] float32).

    Same contract as the JAX package's ``project_batch_ring_pallas``.
    ``select`` defaults to :func:`ring_select`.
    """
    n = x.shape[1]
    n_pix = H * W
    pix, key, p1, p2 = ring_prologue(x, y, z, rem, valid, H, W,
                                     fov_up_deg, fov_down_deg)
    okey, op1, op2 = (select or ring_select)(pix, key, p1, p2, n_pix)
    return ring_epilogue(okey, op1, op2, n, H, W)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of ``csrc/ring_project.cu`` on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dlt_ring_project.argtypes = [p] * 7 + [i, i, i, p]
    lib.dlt_ring_project.restype = i
    lib.dlt_error_string.argtypes = [i]
    lib.dlt_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _bind(_kernels.library("ring_project"))
