"""Device-side spherical ("range-image") projection of LiDAR scans
(counterpart of ``deeplio_tpu/ops/projection.py``: every backend,
``pallas-ring``, ``pallas``, ``ring``, ``sort`` and ``sort-sentinel``,
the slot-aligned routes of ``kernel-aligned: auto | on | trust |
halves``, the channel stack with its surface normals, and the numpy
oracle ``project_scan_np``).

Projection convention (SqueezeSeg), as in the JAX package:

    r     = ||p||_2
    yaw   = atan2(y, x)
    pitch = asin(z / r)
    u     = floor(0.5 * (1 - yaw/pi) * W)            clamped to [0, W-1]
    v     = floor((1 - (pitch - fov_down)/fov) * H)  clamped to [0, H-1]

The closest point wins a pixel. All arithmetic is float32 and follows the
JAX expressions operation by operation, so the port and the reference agree
bit for bit except where ``atan2``/``asin`` differ by an ulp between
libraries and move a boundary point by one pixel. Square roots go through
:func:`sqrt_rn`: PyTorch's CPU float32 ``sqrt`` is not correctly rounded,
XLA's is.

Layout: images are NHWC (..., H, W, C) at this module's public functions,
as in the JAX package.

The slot-aligned routes (``pallas-ring`` with ``kernel-aligned`` other than
``off``) are plain PyTorch, as they are plain XLA in the JAX package. They
read scans laid out on a fixed grid of ``n = H * W * spp`` slots, ring-major,
``spp`` slots a pixel, every valid point on its slot's pixel
(``data/synthetic.py::synthetic_ring_batch``, or ``slot_bin_scan``):

- :func:`project_batch_ring_aligned_planes` (``auto``, ``on``, ``trust``):
  each pixel's winner is the minimum ``rq << idx_bits | idx`` key of its
  ``spp`` slots, with packed-f16 payloads and depth from the quantized
  range, the ring kernel's output. ``auto`` and ``on`` check on the device
  that every valid point sits on its slot's pixel and run the ring kernel
  (``ops/projection_ring.py``) when one does not: the check is read on the
  host, one synchronisation a projection (``torch.cond`` under
  ``torch.export``). ``trust`` skips the check.
- :func:`project_batch_ring_halves_planes` (``halves``): the same grid
  permuted by :func:`halves_permutation` so each residue's candidates form
  one contiguous block; exact float32 payloads, depth the winner's true
  range. No check: the configuration allows it only for data on the grid
  by construction.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch._guards import detect_fake_mode

if TYPE_CHECKING:   # the serving artifact's loader imports no config
    from deeplio_tpu_torch.config.schema import ProjectionConfig

DEFAULT_RQ_BITS = 14
CHANNEL_INDEX = {"x": 0, "y": 1, "z": 2, "remission": 3, "depth": 4}


def spherical_uv(
    xyz: torch.Tensor, H: int, W: int, fov_up_deg: float, fov_down_deg: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point (u, v, range): xyz [..., 3] -> int32 u, v and float32 r."""
    return spherical_uv_planes(xyz[..., 0], xyz[..., 1], xyz[..., 2],
                               H, W, fov_up_deg, fov_down_deg)


def spherical_uv_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
    H: int, W: int, fov_up_deg: float, fov_down_deg: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point int32 (u, v) and float32 range from x/y/z planes."""
    r = sqrt_rn(x * x + y * y + z * z)
    r_safe = torch.clamp_min(r, 1e-9)
    yaw = torch.atan2(y, x)
    pitch = torch.asin(torch.clamp(z / r_safe, -1.0, 1.0))
    fov_down = float(np.float32(np.deg2rad(fov_down_deg)))
    fov = float(np.float32(np.deg2rad(fov_up_deg - fov_down_deg)))
    pi32 = float(np.float32(np.pi))
    u = torch.floor(0.5 * (1.0 - yaw / pi32) * W).to(torch.int32)
    v = torch.floor((1.0 - (pitch - fov_down) / fov) * H).to(torch.int32)
    return u.clamp(0, W - 1), v.clamp(0, H - 1), r


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded. PyTorch's CPU float32 sqrt
    is not (torch 2.13: about 1% of results 1 ulp off); its float64 sqrt
    is, and rounding that to float32 is exact. On the card ``torch.sqrt``
    is IEEE's."""
    if v.device.type == "cpu":
        return torch.sqrt(v.double()).float()
    return torch.sqrt(v)


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
    across compilation regimes. The reciprocal is a float32 value, so the
    float32 product is the same as with a float32 tensor; a Python scalar
    keeps tensor constants out of ``torch.cond``'s branches, which
    ``torch.export`` cannot save."""
    return rq.to(torch.float32) * float(np.float32(1.0 / rq_scale))


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


def num_channels(channels: Sequence[str]) -> int:
    """Image channels of a channel list: ``normals`` counts 3."""
    return sum(3 if c == "normals" else 1 for c in channels)


def compute_normals(img_xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Surface normals from the projected vertex map: img_xyz [..., H, W,
    3], mask [..., H, W] -> [..., H, W, 3].

    ``n(v, u) = normalize((V[v, u+1] - V[v, u]) x (V[v+1, u] - V[v,
    u]))``, wrapping in azimuth (a full revolution) and repeating the last
    elevation row, whose ``m_down`` is 0; a pixel whose three-point
    stencil is not all landed gets a zero normal. The norm is
    ``sqrt(n0*n0 + n1*n1 + n2*n2)`` clamped at 1e-9, once per pixel; the
    arithmetic is JAX's ``jnp.cross`` and ``jnp.linalg.norm`` operation
    by operation."""
    V = img_xyz
    m = mask > 0.5
    V_right = torch.roll(V, -1, dims=-2)
    m_right = torch.roll(m, -1, dims=-1)
    V_down = torch.cat([V[..., 1:, :, :], V[..., -1:, :, :]], dim=-3)
    m_down = torch.cat([m[..., 1:, :], torch.zeros_like(m[..., -1:, :])],
                       dim=-2)
    a, b = V_right - V, V_down - V
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    n = torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                     a0 * b1 - a1 * b0], -1)
    n0, n1, n2 = n.unbind(-1)
    norm = sqrt_rn(n0 * n0 + n1 * n1 + n2 * n2)[..., None]
    n = n / torch.clamp_min(norm, 1e-9)
    ok = (m & m_right & m_down)[..., None]
    return torch.where(ok, n, 0.0)


def assemble_channels(img5: torch.Tensor, mask: torch.Tensor,
                      channels: Sequence[str]) -> torch.Tensor:
    """The configured channel stack from the 5-channel projection and its
    mask; ``normals`` adds :func:`compute_normals`' three channels,
    computed once however often it is listed."""
    outs, normals = [], None
    for c in channels:
        if c == "normals":
            if normals is None:
                normals = compute_normals(img5[..., :3], mask)
            outs.append(normals)
        else:
            k = CHANNEL_INDEX[c]
            outs.append(img5[..., k:k + 1])
    return torch.cat(outs, -1)


def normalize_channels(img: torch.Tensor, mask: torch.Tensor,
                       mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Per-channel (x - mean) / std, zeroing empty pixels."""
    return (img - mean) / std * mask[..., None]


_NORM_CONSTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _norm_consts(mean: Tuple[float, ...], std: Tuple[float, ...],
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean and std as float32 tensors on ``device``, made once, so that a
    call copies nothing to the card (nor inside a CUDA graph's
    capture). Under a fake mode (``torch.export``'s trace) they are made
    for the trace and not kept: a kept fake tensor would reach every
    later eager call."""
    fake = detect_fake_mode() is not None
    key = (mean, std, device)
    if fake or key not in _NORM_CONSTS:
        consts = tuple(torch.tensor(v, dtype=torch.float32, device=device)
                       for v in (mean, std))
        if fake:
            return consts
        _NORM_CONSTS[key] = consts
    return _NORM_CONSTS[key]


def finish_image(img5: torch.Tensor, mask: torch.Tensor,
                 channels: Sequence[str], mean: Sequence[float] = (),
                 std: Sequence[float] = (),
                 out_dtype: Optional[torch.dtype] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's image from the 5-channel one, in PyTorch: the
    ``channels`` (``normals`` included, :func:`assemble_channels`),
    normalised with ``mean`` and ``std`` as float32 values
    (:func:`normalize_channels`) or else times the mask, then cast to
    ``out_dtype`` (kept for ``None``). The plain composition of
    ``make_projector`` and of the epilogue operator's plain version."""
    img = assemble_channels(img5, mask, channels)
    if len(mean):
        f32 = (tuple(np.asarray(v, np.float32).tolist())
               for v in (mean, std))
        img = normalize_channels(img, mask, *_norm_consts(*f32, img.device))
    else:
        img = img * mask[..., None]
    if out_dtype is not None:
        img = img.to(out_dtype)
    return img, mask


def check_ring_order(points: np.ndarray, valid: np.ndarray, H: int, W: int,
                     fov_up_deg: float, fov_down_deg: float) -> bool:
    """Host check of the ring route's contract on one [N, 4] scan: the
    pixel index never decreases over the valid points (those with a range
    above 1e-6), in numpy as the JAX package computes it."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    yaw = np.arctan2(y, x)
    pitch = np.arcsin(np.clip(z / np.maximum(r, 1e-9), -1.0, 1.0))
    fov_down = np.float32(np.deg2rad(fov_down_deg))
    fov = np.float32(np.deg2rad(fov_up_deg - fov_down_deg))
    uu = np.clip(np.floor(0.5 * (1.0 - yaw / np.float32(np.pi)) * W), 0,
                 W - 1)
    vv = np.clip(np.floor((1.0 - (pitch - fov_down) / fov) * H), 0, H - 1)
    pix = (vv * W + uu)[np.asarray(valid, bool) & (r > 1e-6)]
    return bool(np.all(np.diff(pix) >= 0))


def aligned_route_feasible(n: int, H: int, W: int) -> bool:
    """Whether a scan capacity ``n`` is a whole number of slots a pixel."""
    n_pix = H * W
    return n_pix > 0 and n % n_pix == 0 and n // n_pix >= 1


def slot_pixel(n: int, H: int, W: int, device=None) -> torch.Tensor:
    """int32 [n]: the pixel each slot of the aligned grid belongs to. Slot
    ``s`` of ``H`` rings of ``W * spp`` azimuth slots covers pixel
    ``(s // (W * spp)) * W + (s % (W * spp)) // spp``."""
    spp = n // (H * W)
    slot = torch.arange(n, dtype=torch.int32, device=device)
    return (slot // (W * spp)) * W + (slot % (W * spp)) // spp


def project_batch_ring_aligned_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rem: torch.Tensor,
    valid: torch.Tensor, H: int, W: int,
    fov_up_deg: float, fov_down_deg: float,
    check: str = "cond", fallback: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slot-aligned route: planes [B, n] on the slot grid (``n = H * W
    * spp``) -> (img [B, H, W, 5], mask [B, H, W]) float32, the ring
    kernel's output on such scans.

    Each pixel's winner is the minimum key ``rq << idx_bits | idx`` of its
    ``spp`` consecutive slots (keys are unique, so any exact minimum picks
    JAX's winner); invalid slots carry ``rq_max`` and lose. Payloads round
    trip through f16 and depth comes from the quantized range; a pixel
    whose winner is invalid is masked, its payload zeroed first.

    ``check="cond"``: when some valid point is off its slot's pixel, the
    result is ``fallback(x, y, z, rem, valid)`` (the ring kernel's route)
    instead; the predicate is read on the host (``torch.cond`` while
    exporting). ``check="assert-off"`` trusts the grid: an off-grid valid
    point then lands on its slot's pixel.
    """
    b, n = x.shape
    n_pix = H * W
    if not aligned_route_feasible(n, H, W):
        raise ValueError(f"aligned ring route needs n % (H*W) == 0, got "
                         f"n={n}, H*W={n_pix}")
    if check not in ("cond", "assert-off"):
        raise ValueError(f"check must be cond|assert-off, got {check!r}")
    if check == "cond" and fallback is None:
        raise ValueError("check='cond' requires a fallback projector")
    spp = n // n_pix
    idx_bits, rq_bits, rq_scale = idx_key_layout(n, n_pix)
    rq_max = (1 << rq_bits) - 1
    u, v, r = spherical_uv_planes(x, y, z, H, W, fov_up_deg, fov_down_deg)
    ok = valid & (r > 1e-6)

    def direct(x, y, z, rem, ok, r):
        # clamp in float first: a huge range saturates to the key ceiling
        rq = torch.clamp(r * rq_scale, max=rq_max - 1).to(torch.int32)
        rqv = torch.where(ok, rq.clamp_min(0), rq_max)
        idx = torch.arange(n, dtype=torch.int32, device=x.device)
        wk = ((rqv << idx_bits) | idx).view(b, n_pix, spp).amin(-1)
        win = (wk & ((1 << idx_bits) - 1)).long()
        rq_out = wk >> idx_bits
        live = rq_out < rq_max
        maskf = live.to(torch.float32)
        # losing payloads are zeroed: the mask multiply would keep a NaN
        ch = [torch.where(live, a.gather(1, win).to(torch.float16)
                          .to(torch.float32), 0.0) for a in (x, y, z, rem)]
        img = torch.stack(ch + [rq_to_depth(rq_out, rq_scale)], -1)
        img = img * maskf[..., None]
        return img.reshape(b, H, W, 5), maskf.reshape(b, H, W)

    if check == "assert-off":
        return direct(x, y, z, rem, ok, r)
    on_slot = (v * W + u) == slot_pixel(n, H, W, x.device)
    aligned = torch.where(ok, on_slot, True).all()

    def other(x, y, z, rem, ok, r):
        return fallback(x, y, z, rem, valid)

    if torch.compiler.is_exporting():
        # torch.cond refuses operands that alias one another, as planes
        # cut from one [B, N, 4] tensor do
        ops = tuple(t.clone() for t in (x, y, z, rem, ok, r))
        return torch.cond(aligned, direct, other, ops)
    if bool(aligned):            # one host read of the device's predicate
        return direct(x, y, z, rem, ok, r)
    return fallback(x, y, z, rem, valid)


def halves_permutation(n: int, H: int, W: int) -> np.ndarray:
    """Host permutation of a slot-grid scan into the dual-half layout
    :func:`project_batch_ring_halves_planes` reads: slot ``s`` (pixel ``s
    // spp``, residue ``s % spp``) moves to ``(s % spp) * H * W + s //
    spp``. Returns ``idx`` with ``new_plane = plane[idx]``."""
    spp = n // (H * W)
    s = np.arange(n, dtype=np.int64)
    out = np.empty(n, np.int64)
    out[(s % spp) * (H * W) + s // spp] = s
    return out


def project_batch_ring_halves_planes(
    x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, rem: torch.Tensor,
    valid: torch.Tensor, H: int, W: int,
    fov_up_deg: float, fov_down_deg: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual-half route: planes [B, n] in the :func:`halves_permutation`
    layout (position ``k * H * W + p`` holds pixel ``p``'s residue-``k``
    candidate) -> (img [B, H, W, 5], mask [B, H, W]) float32.

    A fold over the ``spp`` contiguous blocks: a candidate takes the pixel
    when its quantized range is strictly smaller (the earlier residue, the
    smaller original index, wins ties). Payloads are exact float32 and
    depth is the winner's range, JAX's ``carry`` output even under
    ``packed``. A masked pixel keeps its last candidate's coordinates times
    0, so a negative one gives -0.0, as in JAX. No check: the fov arguments
    are unused, the grid holds by construction.
    """
    b, n = x.shape
    n_pix = H * W
    if not aligned_route_feasible(n, H, W):
        raise ValueError(f"halves ring route needs n % (H*W) == 0, got "
                         f"n={n}, H*W={n_pix}")
    spp = n // n_pix
    _, rq_bits, rq_scale = idx_key_layout(n, n_pix)
    rq_max = (1 << rq_bits) - 1
    r = sqrt_rn(x * x + y * y + z * z)
    ok = valid & (r > 1e-6)
    rq = torch.clamp(r * rq_scale, max=rq_max - 1).to(torch.int32)
    rqv = torch.where(ok, rq.clamp_min(0), rq_max)
    blocks = [a.view(b, spp, n_pix) for a in (rqv, x, y, z, rem, r, ok)]
    wk, *win = (a[:, 0] for a in blocks)
    for i in range(1, spp):
        ki = blocks[0][:, i]
        take = ki < wk
        wk = torch.where(take, ki, wk)
        win = [torch.where(take, a[:, i], w) for a, w in zip(blocks[1:], win)]
    maskf = win[-1].to(torch.float32)
    img = torch.stack(win[:-1], -1) * maskf[..., None]
    return img.reshape(b, H, W, 5), maskf.reshape(b, H, W)


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

    ``backend: pallas-ring`` and ``ring`` select with
    ``projection_ring.ring_select`` (ring-ordered scans), ``backend:
    pallas``, ``sort`` and ``sort-sentinel`` with
    ``projection_scatter.scatter_select`` (scans in any order); ``ring``,
    ``sort`` and ``sort-sentinel`` carry exact float32 channels unless
    ``packed`` (JAX's ``carry`` and ``carry-f16``), ``pallas-ring`` and
    ``pallas`` packed-f16 words always. Each runs its CUDA kernel on the
    card and its plain PyTorch version on the CPU, the whole batch in one
    launch (JAX's ``projection-chunk`` only schedules its work).
    ``channels`` may list ``normals`` (:func:`compute_normals`, three
    channels); ``mean`` and ``std`` then have an entry for each of the
    three.

    On the packed routes that launch a selection (``pallas-ring`` on the
    ring kernel, ``pallas``, and ``ring``, ``sort`` and ``sort-sentinel``
    under ``packed``) with no ``normals``, the epilogue operator
    (``projection_io.proj_epilogue``) writes the final image: channels,
    normalisation and ``out_dtype`` in one pass, so a projection is three
    launches on the card (four on the ring route). Every other route
    assembles the image from the 5-channel one in PyTorch.

    Under ``pallas-ring``, ``kernel-aligned`` picks the route, as JAX's
    ``_aligned_check_mode`` does: ``auto`` takes the checked slot-aligned
    route when the scan capacity is a multiple of H*W and the ring kernel
    otherwise; ``on`` and ``trust`` (unchecked) and ``halves`` raise
    ``ValueError`` at the call on a capacity that is not.
    """
    from deeplio_tpu_torch.ops import (
        projection_io,
        projection_ring,
        projection_scatter,
    )

    H, W = cfg_proj.height, cfg_proj.width
    fu, fd = cfg_proj.fov_up_deg, cfg_proj.fov_down_deg
    aligned = cfg_proj.kernel_aligned
    if aligned not in ("auto", "on", "off", "trust", "halves"):
        raise ValueError(f"kernel-aligned must be auto|on|off|trust|halves, "
                         f"got {aligned!r}")
    if layout not in ("aos", "planes"):
        raise ValueError(f"layout must be aos|planes, got {layout!r}")
    if bool(mean) != bool(std):
        raise ValueError(
            "normalization requires both mean and std (or neither)")
    c = num_channels(channels)
    for name, vals in (("mean", mean), ("std", std)):
        if vals and len(vals) != c:
            raise ValueError(f"normalization {name} has {len(vals)} "
                             f"entries for {c} channels {tuple(channels)}")
    def finish(img5, mask):
        return finish_image(img5, mask, channels, mean, std, out_dtype)

    def assembled(fn):
        return lambda *a: finish(*fn(*a))

    def packed(mod, name):
        """A packed route's planes function ``mod.name`` (looked up at the
        call), its epilogue writing the final image unless ``normals``
        needs the 5-channel one."""
        if "normals" in channels:
            return assembled(lambda *a: getattr(mod, name)(*a))
        form = projection_io.epilogue_form(channels, mean, std, out_dtype)
        return lambda *a: getattr(mod, name)(*a, **form)

    ring_kernel = packed(projection_ring, "project_batch_ring_planes")

    def ring_planes(x, y, z, rem, vld, *geom):
        n = x.shape[-1]
        if aligned == "off":
            mode = None
        elif aligned_route_feasible(n, H, W):
            mode = {"halves": "halves", "trust": "assert-off"}.get(aligned,
                                                                  "cond")
        elif aligned in ("on", "trust", "halves"):
            raise ValueError(f"kernel-aligned={aligned} infeasible: scan "
                             f"capacity {n} is not a multiple of H*W={H * W}")
        else:
            mode = None            # auto: no shape can meet the contract
        if mode is None:
            return ring_kernel(x, y, z, rem, vld, *geom)
        if mode == "halves":
            return finish(*project_batch_ring_halves_planes(
                x, y, z, rem, vld, *geom))
        return finish(*project_batch_ring_aligned_planes(
            x, y, z, rem, vld, *geom, check=mode,
            fallback=functools.partial(
                projection_ring.project_batch_ring_planes, H=H, W=W,
                fov_up_deg=fu, fov_down_deg=fd)))

    if cfg_proj.packed:
        ring_fn = ring_kernel
        # sort and sort-sentinel select sort's winners; packed, they are
        # the scatter route
        sorted_fn = packed(projection_scatter,
                           "project_batch_scatter_planes")
    else:
        ring_fn = assembled(functools.partial(
            projection_ring.project_batch_ring_planes, payload="carry"))
        # sort-sentinel (JAX's project_batch) keeps sort's winners: the
        # same key, the stable sort's ties; its exact depth is the
        # winner's range
        sorted_fn = assembled(functools.partial(
            projection_scatter.project_batch_sorted_planes, payload="carry"))
    planes_fn = {
        "pallas-ring": ring_planes,
        "pallas": packed(projection_scatter, "project_batch_scatter_planes"),
        "ring": ring_fn,
        "sort": sorted_fn,
        "sort-sentinel": sorted_fn,
    }.get(cfg_proj.backend)
    if planes_fn is None:
        raise ValueError(f"unknown projection backend "
                         f"{cfg_proj.backend!r}")

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
        img, mask = planes_fn(*planes, valid.reshape(-1, n), H, W, fu, fd)
        return img.reshape(lead + (H, W, c)), mask.reshape(lead + (H, W))

    return project


def project_scan_np(points: np.ndarray, valid: np.ndarray, H: int, W: int,
                    fov_up_deg: float, fov_down_deg: float,
                    quantize: bool = True, key_layout: str = "pixel"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Sequential-fill numpy oracle with :func:`project_batch`'s semantics
    (the JAX package's ``project_scan_np``; tests only): points [N, 4],
    valid [N] -> (img [H, W, 5], mask [H, W]).

    Points in order, the closest range per pixel, ties to the first
    point. ``quantize`` compares the quantized range of the keys, so the
    winners are the kernels'; ``key_layout`` picks whose quantization:
    ``"pixel"`` the scatter routes' ``pix << rq_bits | rq``, ``"index"``
    the ring routes' ``rq << idx_bits | idx`` (coarser when the index
    takes bits). ``quantize=False`` compares exact ranges.
    """
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    r = np.sqrt(x * x + y * y + z * z)
    yaw = np.arctan2(y, x)
    pitch = np.arcsin(np.clip(z / np.maximum(r, 1e-9), -1.0, 1.0))
    fov_down = np.float32(np.deg2rad(fov_down_deg))
    fov = np.float32(np.deg2rad(fov_up_deg - fov_down_deg))
    u = np.floor(0.5 * (1.0 - yaw / np.float32(np.pi)) * W).astype(np.int64)
    v = np.floor((1.0 - (pitch - fov_down) / fov) * H).astype(np.int64)
    u = np.clip(u, 0, W - 1)
    v = np.clip(v, 0, H - 1)
    if quantize:
        if key_layout == "index":
            _, rq_bits, rq_scale = idx_key_layout(points.shape[0], H * W)
        else:
            rq_bits = rq_bits_for(H * W)
            rq_scale = rq_scale_for(rq_bits)
        rq_max = (1 << rq_bits) - 1
        cmp = np.clip((r * rq_scale).astype(np.int64), 0, rq_max - 1)
    else:
        cmp = r
    img = np.zeros((H, W, 5), np.float32)
    mask = np.zeros((H, W), np.float32)
    best = np.full((H, W), np.inf, np.float64)
    ok = np.asarray(valid, bool) & (r > 1e-6)
    for i in range(points.shape[0]):
        if not ok[i]:
            continue
        vi, ui = v[i], u[i]
        if cmp[i] < best[vi, ui]:
            best[vi, ui] = cmp[i]
            img[vi, ui, :4] = points[i, :4]
            img[vi, ui, 4] = r[i]
            mask[vi, ui] = 1.0
    return img, mask
