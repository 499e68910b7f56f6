#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths at the full width of
``configs/deeplio_kitti_tpu.yaml`` and holds each CUDA kernel against its
plain PyTorch version:

1. device: the GPU's name and power limit; build the kernels from
   ``deeplio_tpu_torch/csrc`` (into ``build/kernels/``, one ``nvcc`` per
   source, all at once) and time the build;

Slice 1, streaming odometry on raw ring-ordered scans (ring kernel):

2. the ring-projection kernel against its plain version at full width
   (B = 1 and 9, N = 131072, 64x1024) on ring scans and edge cases (one
   over an allocator poisoned with 0x5A5A5A5A, an invalid prefix before
   points on pixel 0): the selected words and the whole projector must be
   bit-identical;
3. a full-width SyntheticDrive streamed through ``StreamingOdometry`` in
   bfloat16 with seeded weights; the kernel must launch once per frame;
   poses finite, first tick the identity; bfloat16 within a stated
   tolerance of the port's own float32 run; the float32 model on the card
   against the same model on the CPU on one frame;
4. a torch.profiler trace of a short stream (device busy and idle share;
   exactly one ring kernel per frame);
5. timings with CUDA events (median of 30 runs after warm-up), per Python
   call and as device time from CUDA-graph replays, and at B = 1 with
   every point invalid.

Slice 2, the training step on unordered scans (point-scatter kernel), the
slice configuration being the file above with ``backend: pallas`` and
``augment-yaw: true``:

6. the scatter kernel against its plain version at full width, B = 1 and
   144, on unordered, ring and yaw-rotated ring scans and edge cases, and
   on the u64-slot route (N = 2^18 + 3) and a multi-tile image (256x4096):
   the selected words and the whole projector must be bit-identical;
7. ``train_step`` in bfloat16 from seeded weights on 16 windows of 9
   unordered synthetic frames: 3 warm-up and 10 timed steps, exactly one
   scatter launch per step, finite losses; 20 steps on one batch without
   augmentation or dropout must lower the loss; one float32 step on the
   card against the same step on the CPU at 16x128;
8. a torch.profiler trace of training steps;
9. the scatter kernel's timings, as in 5, and at B = 144 on the same
   scans with every key invalid (no atomics, no gathers).

Exits non-zero, with no result line, when there is no CUDA device or any
check fails. The last line is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import yaml

from deeplio_tpu_torch.config import load_config, load_config_dict
from deeplio_tpu_torch.data.dataset import WindowDataset
from deeplio_tpu_torch.data.drives import SyntheticDrive
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.eval.streaming import StreamingOdometry
from deeplio_tpu_torch.models.from_flax import to_flax_variables
from deeplio_tpu_torch.models.zoo import build_model
from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops.projection import rq_bits_for
from deeplio_tpu_torch.ops.projection_ring import (
    project_batch_ring_planes,
    ring_prologue,
    ring_select,
    ring_select_reference,
)
from deeplio_tpu_torch.ops.projection_scatter import (
    SENTINEL,
    project_batch_scatter_planes,
    scatter_plan,
    scatter_prologue,
    scatter_select,
    scatter_select_reference,
)
from deeplio_tpu_torch.train.state import create_train_state
from deeplio_tpu_torch.train.step import batch_to_device, build_train_step

CONFIG = pathlib.Path(__file__).resolve().parent / "configs" / \
    "deeplio_kitti_tpu.yaml"
H, W, N = 64, 1024, 131072
FU, FD = 3.0, -25.0
HBM_BYTES_PER_S = 3.35e12       # H100 SXM memory rate (NVIDIA data sheet)
FRAMES = 48                     # streamed frames (the contract asks >= 32)
# bfloat16 serving against the port's float32 run on the card, per frame:
# |dx_bf16 - dx_f32| <= BF16_RTOL * max|dx_f32| and the same for dq. bf16
# keeps 8 mantissa bits (0.4% per rounding) through ~30 layers.
BF16_RTOL = 0.05
# float32 model on the card (TF32 off) against the CPU, same input pair.
F32_RTOL = 1e-3
MAX_FLIP_FRACTION = 1e-3        # CPU vs GPU projector: trig ulps
REPS = 30
POISONED = "ring B=1 over a poisoned allocator"
# the __global__ function of csrc/ring_project.cu, as the profiler names it
RING_KERNELS = ("ring_select_kernel",)
# ... and the one of csrc/proj_scatter.cu
SCATTER_KERNELS = ("scatter_select_kernel",)
RQ_BITS = rq_bits_for(H * W)
# the training slice: windows per batch, frames per window, steps
TRAIN_B, TRAIN_S = 16, 9
TRAIN_PAIRS = TRAIN_B * (TRAIN_S - 1)
WARMUP_STEPS, TIMED_STEPS, FIT_STEPS, PROFILE_STEPS = 3, 10, 20, 2
# one float32 step on the card (TF32 off) against the CPU, 16x128, B = 2,
# S = 3. At this size the last ConvBN normalises over 8 values per channel,
# which magnifies the rounding of different summation orders: the CPU
# tests measure gradients that move by up to 6e-4 of the largest with the
# thread count alone, and Adam's first update keeps only each gradient's
# sign. So: the loss within 1e-4 of its magnitude, grad_norm within 1e-2,
# the BatchNorm statistics within 1e-4 of each leaf's largest value, and
# the parameter update in L2 within 20% (sign flips where |g| is at the
# rounding level).
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_STATS_RTOL, STEP_UPDATE_L2 = (
    1e-4, 1e-2, 1e-4, 0.2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def graph_ms(fn, inner: int = 10, reps: int = REPS) -> float:
    """Device time of one ``fn`` call: ``inner`` calls captured in one CUDA
    graph, replayed between CUDA events (median over ``reps``, / inner).
    Timed one Python call at a time (``cuda_ms``), a call that takes the
    card less time than the host takes to issue it measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return cuda_ms(graph.replay, reps) / inner


def device_kernels(events, span_prefix: str):
    """The profiler's device rows that are kernels or copies. The
    ``record_function`` spans, and the optimizer's own, also show up as
    device-typed annotation rows that hold each span's whole range."""
    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith((span_prefix, "Optimizer."))]


def kernel_cases(rng, dev):
    """(name, points [B, N, 4], valid [B, N]) at full width."""
    ring1 = synthetic_ring_batch(rng, 1, N)
    ring9 = synthetic_ring_batch(rng, 9, N)
    ones = np.ones((1, N), bool)
    cases = [("ring B=1", ring1, ones), ("ring B=9", ring9,
                                        np.ones((9, N), bool)),
             (POISONED, ring1, ones)]
    # the clamp trap: an invalid prefix, then points on pixel 0, one run
    pix = ring_prologue(*planes(torch.from_numpy(ring1).to(dev)),
                        torch.from_numpy(ones).to(dev), H, W, FU, FD)[0]
    on0 = torch.nonzero(pix[0] == 0).flatten().tolist()
    check(len(on0) > 0, "no point of the ring scan lands on pixel 0")
    zero = ring1.copy()
    zero[0, 5000:5003] = ring1[0, on0[0]]
    lead0 = ones.copy()
    lead0[:, :5000] = False
    cases.append(("invalid prefix then pixel 0", zero, lead0))
    cases.append(("30% interleaved invalid", ring1,
                  rng.uniform(size=(1, N)) >= 0.3))
    tail = ones.copy()
    tail[:, 100000:] = False
    cases.append(("pure invalid tail", ring1, tail))
    lead = ones.copy()
    lead[:, :5000] = False
    cases.append(("leading invalid prefix", ring1, lead))
    cases.append(("all invalid", ring1, np.zeros((1, N), bool)))
    short = N - 4096
    cases.append(("N = 131072 - 4096", synthetic_ring_batch(rng, 1, short),
                  np.ones((1, short), bool)))
    broken = ring1.copy()
    broken[0, 20000:20500] = broken[0, 20000:20500][::-1]   # backward run
    i = rng.choice(N - 64, 2000, replace=False)              # local swaps
    j = i + rng.integers(1, 64, 2000)
    broken[0, i], broken[0, j] = ring1[0, j], ring1[0, i]
    cases.append(("ring-order violations", broken, ones))
    return cases


def planes(points: torch.Tensor):
    return [points[..., c].contiguous() for c in range(4)]


def poison_allocator(dev, b: int) -> None:
    """Fill and free blocks of the outputs' size, so that the kernel's
    torch.empty outputs start as 0x5A5A5A5A where it skips a word."""
    bufs = [torch.full((b, H * W), 0x5A5A5A5A, dtype=torch.int32, device=dev)
            for _ in range(16)]
    del bufs


def phase_kernel(dev, rng):
    worst = 0
    for name, pts, vld in kernel_cases(rng, dev):
        p = torch.from_numpy(pts).to(dev)
        v = torch.from_numpy(vld).to(dev)
        x, y, z, rem = planes(p)
        pix, key, p1, p2 = ring_prologue(x, y, z, rem, v, H, W, FU, FD)
        if name == POISONED:
            poison_allocator(dev, pts.shape[0])
        got = ring_select(pix, key, p1, p2, H * W)
        ref = ring_select_reference(pix, key, p1, p2, H * W)
        torch.cuda.synchronize()
        for label, a, b in zip(("okey", "op1", "op2"), got, ref):
            diff = int((a.long() - b.long()).abs().max())
            worst = max(worst, diff)
            check(diff == 0, f"{name}: kernel {label} differs by {diff}")
        ik, mk = project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD,
                                           select=ring_select)
        ir, mr = project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD,
                                           select=ring_select_reference)
        check(torch.equal(mk, mr) and torch.equal(ik, ir),
              f"{name}: projector kernel path differs from plain path")
        print(f"kernel vs plain [{name}]: B={pts.shape[0]} N={pts.shape[1]} "
              f"landed={int(mk.sum())} bit-identical")
    return worst


def phase_timings(dev, rng, gpu):
    out = {}
    for b in (1, 9):
        pts = torch.from_numpy(synthetic_ring_batch(rng, b, N)).to(dev)
        x, y, z, rem = planes(pts)
        v = torch.ones((b, N), dtype=torch.bool, device=dev)
        args = ring_prologue(x, y, z, rem, v, H, W, FU, FD)

        def kernel():
            return ring_select(*args, H * W)

        def plain():
            return ring_select_reference(*args, H * W)

        k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
        k_ms, p_ms = graph_ms(kernel), graph_ms(plain)
        landed = int((kernel()[0] != SENTINEL).sum())
        # each point's pixel and key read once; the two payload words only
        # of each landed pixel's winner; the three output planes written
        nbytes = 8 * b * N + 8 * landed + 12 * b * H * W
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[b] = (k_ms, p_ms, bound_ms)
        print(f"timing ring_project B={b}: device (graph replay) kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per Python call kernel "
              f"{k_call:.4f} ms, plain {p_call:.4f} ms; bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s: 8 B per "
              f"point, 8 B per landed pixel, {landed} landed, 12 B per "
              f"pixel written) [{gpu}]")
    # every point invalid: one run off the image and one gap of every pixel
    pts = torch.from_numpy(synthetic_ring_batch(rng, 1, N)).to(dev)
    none = ring_prologue(*planes(pts), torch.zeros((1, N), dtype=torch.bool,
                                                   device=dev), H, W, FU, FD)
    e_ms = graph_ms(lambda: ring_select(*none, H * W))
    print(f"timing ring_project B=1 all invalid: device (graph replay) "
          f"kernel {e_ms:.4f} ms (every pixel an empty gap) [{gpu}]")
    return out


def phase_slice(dev, gpu):
    cfg = load_config(CONFIG)
    drive = SyntheticDrive(n_frames=FRAMES, max_points=N, seed=0,
                           world_points=300_000, rings=H)
    for k in range(len(drive)):      # build the scans before timing
        drive.points(k)
    valid_pts = int(drive.points(1)[1].sum())
    model = build_model(cfg, device=dev, seed=0)
    so = StreamingOdometry(cfg, model, chunk=16, device=dev)
    so.run(drive)                                  # warm-up
    torch.cuda.synchronize()
    ring_select.launches = 0
    t0 = time.perf_counter()
    poses, dx, dq = so.run(drive)                  # main path (synchronises)
    wall = time.perf_counter() - t0
    launches = ring_select.launches
    check(launches == FRAMES,
          f"ring kernel launched {launches} times for {FRAMES} frames")
    check(all(np.isfinite(a).all() for a in (poses, dx, dq)),
          "non-finite pose output")
    check(np.array_equal(poses[0], np.eye(4, dtype=np.float32))
          and not dx[0].any() and np.array_equal(dq[0], [1, 0, 0, 0]),
          "first tick is not the identity")
    fps = FRAMES / wall
    print(f"slice: streamed {FRAMES} frames of {N} points "
          f"({valid_pts} valid in frame 1) at 64x1024 in bfloat16: "
          f"{wall:.3f} s, {fps:.1f} frames/s, kernel launches {launches} "
          f"[{gpu}]")

    cfg32 = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  compute_dtype="float32"))
    model32 = build_model(cfg32, device=dev, seed=0)
    p32, dx32, dq32 = StreamingOdometry(cfg32, model32, chunk=16,
                                        device=dev).run(drive)
    ex = float(np.abs(dx - dx32).max() / np.abs(dx32).max())
    eq = float(np.abs(dq - dq32).max() / np.abs(dq32).max())
    print(f"slice: bfloat16 vs float32 on the card: max |ddx| / max|dx| = "
          f"{ex:.4g}, max |ddq| / max|dq| = {eq:.4g} (tolerance {BF16_RTOL})")
    check(ex <= BF16_RTOL and eq <= BF16_RTOL, "bfloat16 outside tolerance")

    # float32 on the card against the CPU: projector flips, then the
    # model on the CPU's image pair.
    proj = so.projector
    pts1, v1 = drive.points(1)
    pts0, v0 = drive.points(0)
    cpu_imgs = [proj(torch.from_numpy(p)[None], torch.from_numpy(v)[None])
                for p, v in ((pts0, v0), (pts1, v1))]
    gpu_img, gpu_mask = proj(torch.from_numpy(pts1)[None].to(dev),
                             torch.from_numpy(v1)[None].to(dev))
    flips = int((gpu_img.cpu() != cpu_imgs[1][0]).any(-1).sum()
                + (gpu_mask.cpu() != cpu_imgs[1][1]).sum())
    check(flips <= MAX_FLIP_FRACTION * H * W,
          f"{flips} pixels differ between the CPU and GPU projector")
    imu = torch.from_numpy(np.stack([np.asarray(drive.imu_between(
        drive.frame_time(0), drive.frame_time(1)), np.float32)[:16]]))
    mask = torch.ones(imu.shape[:2])
    batch = {"images": torch.cat([cpu_imgs[0][0][0], cpu_imgs[1][0][0]],
                                 -1)[None, None],
             "imu": imu[None], "imu_mask": mask[None]}
    model_cpu = build_model(cfg32, device="cpu", seed=0)
    with torch.no_grad():
        xc, qc = model_cpu(batch)
        xg, qg = model32({k: t.to(dev) for k, t in batch.items()})
    rx = float((xg.cpu() - xc).abs().max() / xc.abs().max())
    rq = float((qg.cpu() - qc).abs().max() / qc.abs().max())
    print(f"slice: float32 GPU vs CPU on one frame pair: projector flips "
          f"{flips} of {H * W} pixels, rel err dx {rx:.3g}, dq {rq:.3g} "
          f"(tolerance {F32_RTOL})")
    check(rx <= F32_RTOL and rq <= F32_RTOL, "float32 GPU vs CPU")
    return launches, fps, so


def phase_profile(so, gpu, frames: int = 8):
    """torch.profiler over a short stream: device busy time per frame, the
    tick's spans, and the kernels that take the device time."""
    from torch.profiler import ProfilerActivity, profile
    short = SyntheticDrive(n_frames=frames, max_points=N, seed=1,
                           world_points=300_000, rings=H)
    for k in range(frames):
        short.points(k)
    so.run(short)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        so.run(short)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith("stream.")]
    kernels = device_kernels(events, "stream.")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / frames
    if busy_ms <= 0:
        print("profile: the profiler recorded no device time")
        return
    wall_ms = wall * 1e3 / frames
    n_k = sum(e.count for e in kernels) / frames
    print(f"profile: {wall_ms:.3f} ms/frame wall (profiler on), device "
          f"busy {busy_ms:.3f} ms/frame, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {n_k:.0f} device kernels/frame "
          f"[{gpu}]")
    for e in spans:
        if e.device_type.name == "CPU":
            print(f"profile span {e.key}: host "
                  f"{e.cpu_time_total / 1e3 / frames:.3f} ms/frame, its "
                  f"kernels {e.device_time_total / 1e3 / frames:.3f} "
                  f"ms/frame")
    ring = [e for e in kernels if any(p in e.key for p in RING_KERNELS)]
    ring_us = sum(e.self_device_time_total for e in ring) / frames
    n_ring = sum(e.count for e in ring)
    print(f"profile ring_project: {ring_us:.2f} us/frame of device time in "
          f"{n_ring / frames:.0f} kernel per frame [{gpu}]")
    check(n_ring == frames, f"{n_ring} ring kernels in {frames} frames")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile kernel {e.key[:160]}: "
              f"{e.self_device_time_total / frames:.1f} us/frame, "
              f"{e.count / frames:.1f} launches/frame")


# ------------------------------------------------------------- slice 2

def slice2_config(**over):
    """The slice configuration (``backend: pallas``, ``augment-yaw``), with
    ``datasets`` keys and the top-level ``compute-dtype``/``dropout``
    (both dropout rates) overridden from ``over``."""
    with open(CONFIG) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"backend": "pallas", "augment-yaw": True})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    if "dropout" in over:
        d["deeplio"]["dropout"] = over.pop("dropout")
        d["lidar-feat-pointseg"]["dropout"] = 0.0
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    return load_config_dict(d)


def training_batch():
    """One host batch of 16 windows of 9 unordered full-width frames (16
    synthetic drives of 9 frames; every scan built before any timing)."""
    cfg = slice2_config()
    drives = [SyntheticDrive(n_frames=TRAIN_S, max_points=N, seed=s,
                             world_points=300_000) for s in range(TRAIN_B)]
    ds = WindowDataset(cfg.datasets, drives)
    check(len(ds) == TRAIN_B, f"{len(ds)} windows, want {TRAIN_B}")
    return next(ds.iter_batches(TRAIN_B, shuffle=False))


def rotate_yaw(pts: np.ndarray, rng) -> np.ndarray:
    """Each scan of [B, N, 4] rotated about z by its own random yaw."""
    phi = rng.uniform(-np.pi, np.pi, pts.shape[0]).astype(np.float32)
    c, s = np.cos(phi)[:, None], np.sin(phi)[:, None]
    out = pts.copy()
    out[..., 0] = c * pts[..., 0] - s * pts[..., 1]
    out[..., 1] = s * pts[..., 0] + c * pts[..., 1]
    return out


def scatter_cases(rng, batch):
    """(name, points [B, N, 4], valid [B, N], H, W) at full width."""
    un = np.stack([batch[k] for k in ("points_x", "points_y", "points_z",
                                      "points_rem")], -1)     # [144, N, 4]
    un_valid = batch["points_valid"]
    ring = synthetic_ring_batch(rng, TRAIN_B * TRAIN_S, N)
    ones = np.ones((1, N), bool)
    one = un[:1]
    cases = [(f"unordered B={len(un)}", un, un_valid),
             ("unordered B=1", one, un_valid[:1]),
             (f"ring B={len(ring)}", ring, np.ones(ring.shape[:2], bool)),
             (f"yaw-rotated ring B={len(ring)}", rotate_yaw(ring, rng),
              np.ones(ring.shape[:2], bool)),
             ("yaw-rotated ring B=1", rotate_yaw(ring[:1], rng), ones),
             ("30% interleaved invalid", one, rng.uniform(size=(1, N)) >= 0.3),
             ("all invalid", one, np.zeros((1, N), bool))]
    short = 126979
    cases.append((f"N = {short}", one[:, :short].copy(), ones[:, :short]))
    dup = one.copy()
    src = rng.choice(N, N // 5, replace=False)
    dst = rng.choice(N, N // 5, replace=False)
    dup[0, dst] = one[0, src]                     # exact duplicates
    cases.append(("duplicated points", dup, ones))
    cases.append(("one hot pixel", hot_pixel_scan(rng), ones))
    # u64 slots: rq_bits 14 + 19 index bits; two scans and 3 points in one
    big = 2**18 + 3
    cases.append((f"u64 slots, N = {big}",
                  un[:3].reshape(1, -1, 4)[:, :big].copy(),
                  un_valid[:3].reshape(1, -1)[:, :big].copy()))
    cases = [c + (H, W) for c in cases]
    cases.append(("multi-tile 256x4096 B=16", un[:16], un_valid[:16], 256,
                  4096))
    return cases


def hot_pixel_scan(rng) -> np.ndarray:
    """All N points straight ahead at ranges in [2, 70) m: one pixel takes
    every candidate (the atomics' worst case), with 1 cm range ties."""
    pts = np.zeros((1, N, 4), np.float32)
    pts[0, :, 0] = rng.uniform(2.0, 70.0, N)
    pts[0, :, 3] = rng.uniform(0.0, 1.0, N)
    return pts


def phase_scatter_kernel(dev, rng, batch):
    worst, plans = 0, []
    for name, pts, vld, h, w in scatter_cases(rng, batch):
        p = torch.from_numpy(pts).to(dev)
        v = torch.from_numpy(vld).to(dev)
        x, y, z, rem = planes(p)
        rq_bits = rq_bits_for(h * w)
        words = scatter_prologue(x, y, z, rem, v, h, w, FU, FD)
        got = scatter_select(*words, h * w, rq_bits)
        ref = scatter_select_reference(*words, h * w, rq_bits)
        torch.cuda.synchronize()
        for label, a, b in zip(("kmin", "xyo", "zro"), got, ref):
            diff = int((a.long() - b.long()).abs().max())
            worst = max(worst, diff)
            check(diff == 0, f"{name}: scatter kernel {label} differs by "
                  f"{diff}")
        ik, mk = project_batch_scatter_planes(x, y, z, rem, v, h, w, FU, FD,
                                              select=scatter_select)
        ir, mr = project_batch_scatter_planes(
            x, y, z, rem, v, h, w, FU, FD, select=scatter_select_reference)
        check(torch.equal(mk, mr) and torch.equal(ik, ir),
              f"{name}: scatter projector kernel path differs from plain "
              f"path")
        landed = int((got[0] != SENTINEL).sum())
        plans.append(scatter_plan(pts.shape[1], h * w, rq_bits))
        print(f"scatter kernel vs plain [{name}]: B={pts.shape[0]} "
              f"N={pts.shape[1]} {h}x{w} landed={landed} {plans[-1]} "
              f"bit-identical")
        del p, v, x, y, z, rem, words, got, ref, ik, mk, ir, mr
    check(any(p.slot_bytes == 8 for p in plans)
          and any(p.tiles > 1 for p in plans),
          "the scatter cases missed the u64-slot or the multi-tile route")
    return worst


def _metrics(ms):
    return {k: float(v) for k, v in ms.items()}


def phase_train(dev, gpu, host):
    """The training slice at full width in bfloat16: warm-up, then the
    timed main-path run with its launch count."""
    cfg = slice2_config()
    model = build_model(cfg, device=dev, seed=0)
    state = create_train_state(cfg, model)
    train_step, _ = build_train_step(cfg)
    t0 = time.perf_counter()
    raw = batch_to_device(host, dev)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    for _ in range(WARMUP_STEPS):
        state, m = train_step(state, raw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scatter_select.launches = 0
    ring_select.launches = 0
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TIMED_STEPS):
        state, m = train_step(state, raw)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scatter_select.launches
    check(launches == TIMED_STEPS,
          f"scatter kernel launched {launches} times in {TIMED_STEPS} steps")
    check(ring_select.launches == 0, "the training slice ran the ring kernel")
    ms = [_metrics(m) for m in metrics]
    check(all(np.isfinite(list(m.values())).all() for m in ms),
          "non-finite training metrics")
    step_ms = wall * 1e3 / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train: {TIMED_STEPS} steps of {TRAIN_B} windows x {TRAIN_S} "
          f"frames x {N} points at 64x1024 in bfloat16: {step_ms:.2f} "
          f"ms/step, {TRAIN_PAIRS / step_ms * 1e3:.1f} pairs/s, scatter "
          f"launches {launches} (one per step, {TRAIN_B * TRAIN_S} scans "
          f"each), peak memory {peak_gb:.2f} GB; batch host-to-device "
          f"{h2d_ms:.1f} ms, outside the step [{gpu}]")
    print(f"train: first timed step loss {ms[0]['loss']:.5g} grad_norm "
          f"{ms[0]['grad_norm']:.5g}; last loss {ms[-1]['loss']:.5g} "
          f"grad_norm {ms[-1]['grad_norm']:.5g}")
    return launches, step_ms, state, train_step, raw


def phase_overfit(dev, raw):
    """FIT_STEPS steps on one batch, augmentation and dropout off: the loss
    must fall below its first value."""
    cfg = slice2_config(augment_yaw=False, dropout=0.0)
    state = create_train_state(cfg, build_model(cfg, device=dev, seed=0))
    train_step, _ = build_train_step(cfg)
    losses = []
    for _ in range(FIT_STEPS):
        state, m = train_step(state, raw)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    check(np.isfinite(losses).all(), "non-finite overfit loss")
    check(losses[-1] < losses[0], f"overfit loss did not fall: "
          f"{losses[0]:.5g} -> {losses[-1]:.5g}")
    print(f"train: overfit {FIT_STEPS} steps on one batch (no augmentation, "
          f"no dropout): loss {losses[0]:.5g} -> {losses[-1]:.5g}, min "
          f"{min(losses):.5g}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def phase_train_vs_cpu(dev):
    """One float32 step on the card against the same step on the CPU, at
    16x128 with identical weights and batch."""
    cfg = slice2_config(compute_dtype="float32", augment_yaw=False,
                        dropout=0.0, image_height=16, image_width=128,
                        max_points=2048, sequence_size=3, window_stride=2)
    ds = WindowDataset(cfg.datasets, [SyntheticDrive(n_frames=5,
                                                     max_points=2048)])
    host = next(ds.iter_batches(2, shuffle=False))
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    old = _flat(to_flax_variables(cpu_model))
    train_step, _ = build_train_step(cfg)
    _, mc = train_step(create_train_state(cfg, cpu_model),
                       batch_to_device(host, "cpu"))
    _, mg = train_step(create_train_state(cfg, gpu_model),
                       batch_to_device(host, dev))
    mc, mg = _metrics(mc), _metrics(mg)
    new_c = _flat(to_flax_variables(cpu_model))
    new_g = _flat(to_flax_variables(gpu_model))
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc}
    params = sorted(k for k in old if k.startswith("params/"))
    du_c = np.concatenate([(new_c[k] - old[k]).ravel() for k in params])
    du_g = np.concatenate([(new_g[k] - old[k]).ravel() for k in params])
    upd = float(np.linalg.norm(du_g - du_c) / np.linalg.norm(du_c))
    stats = max(float(np.abs(new_g[k] - new_c[k]).max()
                      / max(np.abs(new_c[k]).max(), 1e-3))
                for k in old if k.startswith("batch_stats/"))
    print(f"train: float32 step GPU vs CPU at 16x128: loss rel err "
          f"{rel['loss']:.3g} (tolerance {STEP_LOSS_RTOL}), grad_norm "
          f"{rel['grad_norm']:.3g} ({STEP_NORM_RTOL}), BatchNorm statistics "
          f"{stats:.3g} ({STEP_STATS_RTOL}), update L2 {upd:.3g} "
          f"({STEP_UPDATE_L2})")
    check(rel["loss"] <= STEP_LOSS_RTOL, "float32 step loss GPU vs CPU")
    check(rel["grad_norm"] <= STEP_NORM_RTOL, "float32 grad_norm GPU vs CPU")
    check(stats <= STEP_STATS_RTOL, "float32 BatchNorm statistics GPU vs CPU")
    check(upd <= STEP_UPDATE_L2, "float32 parameter update GPU vs CPU")


def phase_train_profile(state, train_step, raw, gpu, step_ms: float):
    """torch.profiler over PROFILE_STEPS training steps: device busy and
    idle share, host time per train.* span, the scatter kernel's share and
    the top kernels. The profiler slows the host, so the idle share is
    also given against ``step_ms``, the step time measured without it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, _ = train_step(state, raw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith("train.")
             and e.device_type.name == "CPU"]
    kernels = device_kernels(events, "train.")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / PROFILE_STEPS
    if busy_ms <= 0:
        print("train profile: the profiler recorded no device time")
        return
    wall_ms = wall * 1e3 / PROFILE_STEPS
    n_k = sum(e.count for e in kernels) / PROFILE_STEPS
    print(f"train profile: {wall_ms:.3f} ms/step wall (profiler on), device "
          f"busy {busy_ms:.3f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on), "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f} against the "
          f"{step_ms:.2f} ms step without it, {n_k:.0f} device kernels/step "
          f"[{gpu}]")
    # autograd launches the backward's kernels from its own thread, so the
    # profiler puts them under no span: they are the busy time the other
    # spans leave.
    own = {e.key: e.device_time_total / 1e3 / PROFILE_STEPS for e in spans}
    for e in spans:
        dev_ms = own[e.key]
        if e.key == "train.backward":
            dev_ms = busy_ms - sum(v for k, v in own.items() if k != e.key)
        print(f"train profile span {e.key}: host "
              f"{e.cpu_time_total / 1e3 / PROFILE_STEPS:.3f} ms/step, its "
              f"kernels {dev_ms:.3f} ms/step")
    sc = [e for e in kernels if any(p in e.key for p in SCATTER_KERNELS)]
    sc_ms = sum(e.self_device_time_total for e in sc) / 1e3 / PROFILE_STEPS
    print(f"train profile proj_scatter: {sc_ms:.4f} ms/step of device time "
          f"({sc_ms / busy_ms:.4f} of busy) in "
          f"{sum(e.count for e in sc) / PROFILE_STEPS:.0f} kernels [{gpu}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"train profile kernel {e.key[:160]}: "
              f"{e.self_device_time_total / 1e3 / PROFILE_STEPS:.3f} ms/step,"
              f" {e.count / PROFILE_STEPS:.1f} launches/step")


def phase_scatter_timings(dev, rng, batch, gpu):
    out = {}
    un = np.stack([batch[k] for k in ("points_x", "points_y", "points_z",
                                      "points_rem")], -1)
    cases = [(1, un[:1], batch["points_valid"][:1]),
             (len(un), un, batch["points_valid"]),
             ("1 hot pixel", hot_pixel_scan(rng), np.ones((1, N), bool))]
    for b, pts, vld in cases:
        p = torch.from_numpy(pts).to(dev)
        x, y, z, rem = planes(p)
        v = torch.from_numpy(vld).to(dev)
        words = scatter_prologue(x, y, z, rem, v, H, W, FU, FD)

        def kernel():
            return scatter_select(*words, H * W, RQ_BITS)

        def plain():
            return scatter_select_reference(*words, H * W, RQ_BITS)

        k_call, p_call = cuda_ms(kernel), cuda_ms(plain)
        k_ms, p_ms = graph_ms(kernel), graph_ms(plain)
        nb = pts.shape[0]
        landed = int((kernel()[0] != SENTINEL).sum())
        # each point's key read once; the xy/zr words only of each landed
        # pixel's winner; the three output planes written once
        nbytes = 4 * nb * N + 8 * landed + 12 * nb * H * W
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[b] = (k_ms, p_ms, bound_ms)
        print(f"timing proj_scatter B={b}: device (graph replay) kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; per Python call kernel "
              f"{k_call:.4f} ms, plain {p_call:.4f} ms; bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s: 4 B per "
              f"point, 8 B per landed pixel, {landed} landed, 12 B per "
              f"pixel written) [{gpu}]")
        if nb > 1:
            # the same launch with every key invalid: the key stream and
            # the output writes without the atomics and the payload gathers
            none = (torch.full_like(words[0], SENTINEL),) + tuple(words[1:])
            e_ms = graph_ms(lambda: scatter_select(*none, H * W, RQ_BITS))
            print(f"timing proj_scatter B={b} with no point landing: "
                  f"{e_ms:.4f} ms (keys read by every CTA, outputs written); "
                  f"the atomics and gathers of the {landed} landed pixels "
                  f"take the other {k_ms - e_ms:.4f} ms [{gpu}]")
        del p, x, y, z, rem, v, words
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test needs one GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = gpu_line()
    print(f"device: {gpu} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    t0 = time.perf_counter()
    logs = _kernels.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    # slice 1: streaming odometry, ring kernel
    worst = phase_kernel(dev, rng)
    launches, fps, so = phase_slice(dev, gpu)
    phase_profile(so, gpu)
    times = phase_timings(dev, rng, gpu)
    print(f"slice rate: {fps:.1f} frames/s [{gpu}]")
    del so
    torch.cuda.empty_cache()

    # slice 2: the training step, scatter kernel
    t0 = time.perf_counter()
    host = training_batch()
    print(f"train data: {TRAIN_B} windows x {TRAIN_S} unordered frames of "
          f"{N} points ({int(host['points_valid'].sum())} valid) built in "
          f"{time.perf_counter() - t0:.1f} s")
    s_worst = phase_scatter_kernel(dev, rng, host)
    s_launches, step_ms, state, train_step, raw = phase_train(dev, gpu, host)
    phase_train_profile(state, train_step, raw, gpu, step_ms)
    del state
    torch.cuda.empty_cache()
    phase_overfit(dev, raw)
    phase_train_vs_cpu(dev)
    s_times = phase_scatter_timings(dev, rng, host, gpu)
    print(f"train rate: {step_ms:.2f} ms/step, "
          f"{TRAIN_PAIRS / step_ms * 1e3:.1f} pairs/s [{gpu}]")

    print(f"kernels: ring_project (ported, launches={launches}, bit-exact), "
          f"proj_scatter (ported, launches={s_launches}, bit-exact)")
    k_ms, p_ms, bound_ms = times[1]
    sk_ms, sp_ms, s_bound_ms = s_times[TRAIN_B * TRAIN_S]
    print(json.dumps({"kernels": [{
        "name": "ring_project",
        "route": "cuda",
        "source": "deeplio_tpu_torch/csrc/ring_project.cu",
        "replaces": "deeplio_tpu/ops/projection_pallas_ring.py:62",
        "launches": launches,
        "max_abs_err": float(worst),
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "proj_scatter",
        "route": "cuda",
        "source": "deeplio_tpu_torch/csrc/proj_scatter.cu",
        "replaces": "deeplio_tpu/ops/projection_pallas.py:48",
        "launches": s_launches,
        "max_abs_err": float(s_worst),
        "ms": sk_ms,
        "plain_ms": sp_ms,
        "bound_ms": s_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
