"""The projection's prologue and epilogue around the two selections, on
the packed-f16 routes (``pallas-ring``, ``pallas``, and ``ring`` /
``sort`` / ``sort-sentinel`` under ``packed``).

The JAX package leaves this work to XLA, which fuses it into a few loops
around each ``pallas_call`` (``projection_pallas.py:104-114`` and
``:149-158``, ``projection_pallas_ring.py:489-513`` and ``:591-601``).
Here it is two PyTorch operators, each a hand-written CUDA kernel on the
card (``csrc/proj_io.cu``) and the composition of the plain PyTorch
functions on the CPU:

- ``deeplio::proj_prologue`` (:func:`proj_prologue`): planes and
  ``valid`` [B, N] -> the selection's inputs ``(pix, key, p1, p2)``, each
  int32 [B, N]; ``pix`` is [B, 0] on the scatter route, which has none.
  Its plain version is :func:`proj_prologue_reference`
  (``projection_ring.ring_prologue`` or
  ``projection_scatter.scatter_prologue``). On the ring route the kernel
  is two launches: a pre-pass for the pure-tail flag, a reduction over
  each scan, and the main pass.
- ``deeplio::proj_epilogue`` (:func:`proj_epilogue`): the selected words
  [B, H*W] -> (img [B, H, W, C] in ``out_dtype``, mask [B, H, W] float32)
  with the configured channels (indices into x, y, z, remission, depth),
  normalised as ``(v - mean) / std * mask`` when ``mean`` is given, else
  ``v * mask``: ``make_projector``'s image. Its plain version is
  :func:`proj_epilogue_reference` (``ring_epilogue`` or
  ``scatter_epilogue``, then ``assemble_channels``,
  ``normalize_channels`` and the cast). Channels ``0..4``, no mean and
  float32 give the 5-channel ``img5`` of ``project_batch_*_planes``: the
  second mask product leaves every bit of ``img5 * mask`` as it is.

A CPU tensor takes the plain version and counts no launch. A CUDA tensor
launches the kernel on the current stream, adds one to the operator's
``launches`` (one a call, the ring's two passes included) and raises if
the launch fails; there is no fallback. The outputs come from
``torch.empty``, so the operators capture in a CUDA graph. Each has a
fake implementation, so ``torch.export`` (the serving artifact) and
``torch.cond`` (the ``auto`` route) trace them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops.projection import (
    CHANNEL_INDEX,
    finish_image,
    idx_key_layout,
    rq_bits_for,
    rq_scale_for,
)

ROUTES = ("ring", "scatter")
IMG5 = (0, 1, 2, 3, 4)           # the channels of the 5-channel image
CHANNEL_NAMES = {i: c for c, i in CHANNEL_INDEX.items()}
MAX_CHANNELS = 16
_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_route(route: str) -> None:
    if route not in ROUTES:
        raise ValueError(f"route must be {'|'.join(ROUTES)}, got {route!r}")


def _check_prologue_inputs(x, y, z, rem, valid, route) -> None:
    _check_route(route)
    for name, t in (("x", x), ("y", y), ("z", z), ("rem", rem)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    for name, t in (("x", x), ("y", y), ("z", z), ("rem", rem),
                    ("valid", valid)):
        if t.dim() != 2 or t.shape != x.shape:
            raise ValueError(f"{name} must be [B, N] like x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def proj_prologue_reference(x, y, z, rem, valid, H: int, W: int,
                            fov_up_deg: float, fov_down_deg: float,
                            route: str):
    """The plain prologue: ``projection_ring.ring_prologue`` (ring) or
    ``projection_scatter.scatter_prologue`` (scatter, with an empty
    ``pix``) -> (pix, key, p1, p2)."""
    from deeplio_tpu_torch.ops import projection_ring, projection_scatter
    _check_route(route)
    if route == "ring":
        return projection_ring.ring_prologue(x, y, z, rem, valid, H, W,
                                             fov_up_deg, fov_down_deg)
    key, p1, p2 = projection_scatter.scatter_prologue(
        x, y, z, rem, valid, H, W, fov_up_deg, fov_down_deg)
    return key.new_empty((key.shape[0], 0)), key, p1, p2


_PROLOGUE_SCHEMA = (
    "(Tensor x, Tensor y, Tensor z, Tensor rem, Tensor valid, int H, "
    "int W, float fov_up_deg, float fov_down_deg, str route) -> "
    "(Tensor, Tensor, Tensor, Tensor)")


@torch.library.custom_op("deeplio::proj_prologue", mutates_args=(),
                         device_types="cpu", schema=_PROLOGUE_SCHEMA)
def proj_prologue(x, y, z, rem, valid, H, W, fov_up_deg, fov_down_deg,
                  route):
    """Planes x, y, z, rem float32 and valid bool, each [B, N] (any
    strides) -> (pix, key, p1, p2) int32 [B, N] contiguous, ``pix`` [B, 0]
    on the scatter route. The CPU implementation is
    :func:`proj_prologue_reference`; the CUDA one launches
    ``csrc/proj_io.cu``."""
    _check_prologue_inputs(x, y, z, rem, valid, route)
    return tuple(t.contiguous() for t in proj_prologue_reference(
        x, y, z, rem, valid, H, W, fov_up_deg, fov_down_deg, route))


def _key_layout(n: int, H: int, W: int, route: str):
    """(bits, rq_max, rq_scale) of the route's keys: ``bits`` is the
    ring's ``idx_bits`` or the scatter route's ``rq_bits``."""
    if route == "ring":
        bits, rq_bits, rq_scale = idx_key_layout(n, H * W)
    else:
        bits = rq_bits = rq_bits_for(H * W)
        rq_scale = rq_scale_for(rq_bits)
    return bits, (1 << rq_bits) - 1, rq_scale


@proj_prologue.register_kernel("cuda")
def _proj_prologue_cuda(x, y, z, rem, valid, H, W, fov_up_deg,
                        fov_down_deg, route):
    _check_prologue_inputs(x, y, z, rem, valid, route)
    b, n = x.shape
    ring = route == "ring"
    bits, rq_max, rq_scale = _key_layout(n, H, W, route)
    if b > 65535:
        raise ValueError(f"proj_prologue takes at most 65535 scans per "
                         f"launch, got {b}")
    dev = x.device
    key = torch.empty((b, n), dtype=torch.int32, device=dev)
    p1, p2 = torch.empty_like(key), torch.empty_like(key)
    pix = torch.empty((b, n if ring else 0), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return pix, key, p1, p2
    lib = _library()
    chunk = lib.dlt_proj_chunk()
    flags = torch.empty((b, -(-n // chunk) if ring else 0),
                        dtype=torch.int32, device=dev)
    strides = (ctypes.c_longlong * 10)(*(s for t in (x, y, z, rem, valid)
                                         for s in t.stride()))
    fov_down = np.float32(np.deg2rad(fov_down_deg))
    fov = np.float32(np.deg2rad(fov_up_deg - fov_down_deg))
    # PyTorch divides by a Python scalar as a multiply by its float32
    # reciprocal on the card
    one = np.float32(1.0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlt_proj_prologue(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), rem.data_ptr(),
            valid.data_ptr(), strides, pix.data_ptr(), key.data_ptr(),
            p1.data_ptr(), p2.data_ptr(), flags.data_ptr(), b, n, int(ring),
            H, W, float(fov_down), float(one / fov),
            float(one / np.float32(np.pi)), float(np.float32(rq_scale)), bits,
            rq_max, stream)
    if err:
        raise RuntimeError(f"proj_prologue launch failed: "
                           f"{_kernels.error_string(lib, err)}")
    _PROLOGUE.launches += 1
    return pix, key, p1, p2


@proj_prologue.register_fake
def _proj_prologue_fake(x, y, z, rem, valid, H, W, fov_up_deg,
                        fov_down_deg, route):
    _check_prologue_inputs(x, y, z, rem, valid, route)
    b, n = x.shape
    key = x.new_empty((b, n), dtype=torch.int32)
    pix = x.new_empty((b, n if route == "ring" else 0), dtype=torch.int32)
    return pix, key, torch.empty_like(key), torch.empty_like(key)


def _check_epilogue_inputs(key, p1, p2, n, H, W, route, channels, mean, std,
                           out_dtype) -> None:
    _check_route(route)
    for name, t in (("key", key), ("p1", p1), ("p2", p2)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != key.shape or t.shape[1] != H * W:
            raise ValueError(f"{name} must be [B, H*W={H * W}] like key "
                             f"{tuple(key.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != key.device:
            raise ValueError(f"{name} is on {t.device}, key on {key.device}")
    if not 1 <= len(channels) <= MAX_CHANNELS or any(
            c not in CHANNEL_NAMES for c in channels):
        raise ValueError(f"channels must be 1 to {MAX_CHANNELS} indices "
                         f"into x, y, z, remission, depth (0..4), got "
                         f"{list(channels)}")
    if (len(mean), len(std)) not in ((0, 0), (len(channels),) * 2):
        raise ValueError(f"mean and std need an entry per channel "
                         f"({len(channels)}) or none, got {len(mean)} and "
                         f"{len(std)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32, bfloat16 or float16, "
                        f"got {out_dtype}")
    if route == "ring":
        idx_key_layout(n, H * W)       # raises on a capacity too large


def proj_epilogue_reference(key, p1, p2, n: int, H: int, W: int,
                            route: str, channels: Sequence[int] = IMG5,
                            mean: Sequence[float] = (),
                            std: Sequence[float] = (),
                            out_dtype: torch.dtype = torch.float32
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain epilogue: ``ring_epilogue`` / ``scatter_epilogue``, then
    ``projection.finish_image`` (``assemble_channels``,
    ``normalize_channels`` or the mask product, the cast), as
    ``make_projector`` composes them."""
    from deeplio_tpu_torch.ops import projection_ring, projection_scatter
    _check_route(route)
    if route == "ring":
        img5, mask = projection_ring.ring_epilogue(key, p1, p2, n, H, W)
    else:
        img5, mask = projection_scatter.scatter_epilogue(key, p1, p2, H, W)
    return finish_image(img5, mask, [CHANNEL_NAMES[c] for c in channels],
                        mean, std, out_dtype)


_EPILOGUE_SCHEMA = (
    "(Tensor key, Tensor p1, Tensor p2, int n, int H, int W, str route, "
    "int[] channels, float[] mean, float[] std, ScalarType out_dtype) -> "
    "(Tensor, Tensor)")


@torch.library.custom_op("deeplio::proj_epilogue", mutates_args=(),
                         device_types="cpu", schema=_EPILOGUE_SCHEMA)
def proj_epilogue(key, p1, p2, n, H, W, route, channels, mean, std,
                  out_dtype):
    """The selected words key, p1, p2 int32 [B, H*W] of scans of ``n``
    points -> (img [B, H, W, len(channels)] ``out_dtype``, mask [B, H, W]
    float32). ``mean`` and ``std`` hold float32 values (a float each, or
    both empty). The CPU implementation is :func:`proj_epilogue_reference`;
    the CUDA one launches ``csrc/proj_io.cu``."""
    _check_epilogue_inputs(key, p1, p2, n, H, W, route, channels, mean, std,
                           out_dtype)
    img, mask = proj_epilogue_reference(key, p1, p2, n, H, W, route,
                                        channels, mean, std, out_dtype)
    return img.contiguous(), mask.contiguous()


@proj_epilogue.register_kernel("cuda")
def _proj_epilogue_cuda(key, p1, p2, n, H, W, route, channels, mean, std,
                        out_dtype):
    _check_epilogue_inputs(key, p1, p2, n, H, W, route, channels, mean, std,
                           out_dtype)
    b = key.shape[0]
    if b > 65535:
        raise ValueError(f"proj_epilogue takes at most 65535 scans per "
                         f"launch, got {b}")
    c = len(channels)
    img = torch.empty((b, H, W, c), dtype=out_dtype, device=key.device)
    mask = torch.empty((b, H, W), dtype=torch.float32, device=key.device)
    if b == 0:
        return img, mask
    bits, rq_max, rq_scale = _key_layout(n, H, W, route)
    lib = _library()
    chans = (ctypes.c_int * c)(*channels)
    norm = ([(ctypes.c_float * c)(*v) for v in (mean, std)] if mean
            else [None, None])
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dlt_proj_epilogue(
            key.data_ptr(), p1.data_ptr(), p2.data_ptr(), img.data_ptr(),
            mask.data_ptr(), b, H * W, int(route == "ring"), bits, rq_max,
            float(np.float32(1.0 / rq_scale)), c, chans,
            *norm, _OUT_DTYPES[out_dtype], stream)
    if err:
        raise RuntimeError(f"proj_epilogue launch failed: "
                           f"{_kernels.error_string(lib, err)}")
    _EPILOGUE.launches += 1
    return img, mask


@proj_epilogue.register_fake
def _proj_epilogue_fake(key, p1, p2, n, H, W, route, channels, mean, std,
                        out_dtype):
    _check_epilogue_inputs(key, p1, p2, n, H, W, route, channels, mean, std,
                           out_dtype)
    b = key.shape[0]
    return (key.new_empty((b, H, W, len(channels)), dtype=out_dtype),
            key.new_empty((b, H, W), dtype=torch.float32))


# the counters live on the operator objects, as the selections' do
_PROLOGUE = proj_prologue
_PROLOGUE.launches = 0
_EPILOGUE = proj_epilogue
_EPILOGUE.launches = 0


def epilogue_form(channels: Sequence[str], mean: Sequence[float] = (),
                  std: Sequence[float] = (), out_dtype=None) -> dict:
    """The epilogue's arguments for a channel list with no ``normals``:
    channel indices, mean and std as float32 values (as ``make_projector``
    rounds them), the output dtype (float32 for ``None``)."""
    f32 = [float(v) for v in np.asarray(mean, np.float32)]
    return {"channels": [CHANNEL_INDEX[c] for c in channels],
            "mean": f32,
            "std": [float(v) for v in np.asarray(std, np.float32)],
            "out_dtype": out_dtype or torch.float32}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _kernels.library("proj_io")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dlt_proj_chunk.argtypes = []
    lib.dlt_proj_chunk.restype = i
    lib.dlt_proj_prologue.argtypes = ([p] * 5 + [ctypes.POINTER(
        ctypes.c_longlong)] + [p] * 5 + [i] * 5 + [f] * 4 + [i, i, p])
    lib.dlt_proj_prologue.restype = i
    lib.dlt_proj_epilogue.argtypes = ([p] * 5 + [i] * 5 + [f, i] + [
        ctypes.POINTER(ctypes.c_int)] + [ctypes.POINTER(ctypes.c_float)] * 2
        + [i, p])
    lib.dlt_proj_epilogue.restype = i
    return lib
