#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths at the full width of
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
   scatter launch per step, each timed step a replay of the step's CUDA
   graph (``train_step.graph_counts()``, printed), finite losses; 20 steps
   on one batch without augmentation or dropout must lower the loss; one
   float32 step on the card against the same step on the CPU at 16x128;
8. a torch.profiler trace of training steps;
9. the scatter kernel's timings, as in 5, and at B = 144 on the same
   scans with every key invalid (no atomics, no gathers).

Slice 3, the training loop (``Trainer``: prefetcher, validation,
checkpoints, resume), the slice-2 configuration with ``synthetic: true``:

10. ``Trainer.fit(epochs=2)`` on 16 synthetic drives of 25 frames (48
    windows of 9 frames, 3 steps of 16 windows an epoch) with 16
    validation drives of 9 frames (one batch), ``log-every: 1``,
    ``checkpoint-every-steps: 4``; then ``close()``, a second Trainer with
    ``resume=True`` and ``fit(epochs=1)``. Checks: steps 6 then 9, the
    checkpoint labels of the JAX package's rules, the restored state
    bit-equal to the saved one, finite losses, one validation per epoch,
    one scatter launch per train step and per validation batch, each
    Trainer's steps after its first a replay of the step's CUDA graph
    (the counts printed), and the prefetcher's full-width batches equal
    to ``batch_to_device``'s. Prints
    ms/step inside ``fit``, the host's batch build, the copy and the
    loop's wait for data, checkpoint save and restore ms and size, and the
    peak device memory.

Slice 4, training on KITTI raw drives (``KittiRawDrive``, the projection
cache, the device-resident dataset), the configuration file as shipped
but for its ``root-path`` and splits, so ``backend: pallas-ring``:

11. a KITTI devkit tree in a temporary directory (drives 27 and 42 of
    2011_10_03, 137 ring-ordered frames each, from
    ``SyntheticDrive(world_points=300000, rings=64)``); train split ``{27,
    {drive: 42, start: 0, end: 136}}``, validation ``{27}``: 17 windows a
    drive, 2 steps of 16 an epoch and 1 validation batch, ``log-every:
    1``, ``prefetch: 2``, no periodic checkpoint. Run A ``fit(epochs=2)``
    with every batch read from disk; run B with ``device-dataset: true``;
    run C with ``cache-projections: true``. Checks: one ring launch per
    train step and per validation batch in A and B and none of the
    scatter kernel, the gathered batch equal to the host-fed one, the
    prefill's one ring launch per chunk of 16 frames of each distinct
    drive span, no launch in C's ``fit``, a cached frame equal to the
    projector's output cast to f16. Then the ring kernel on the tree's
    scans at B = 144 and 16, bit-exact and timed beside its bound; one
    profiled train step of run A (the ring kernel's share of its device
    time); 16 frames of drive 27 streamed from disk (one launch a frame).
    Prints ms/step in ``fit`` for A, B and C, the data waits and build
    times, the bank's size and staging time, the prefill's time and size.

Slice 5, the command lines (evaluation, streaming, the serving export) on
the same tree and configuration, with drive 42 as the test split:

12. ``cli.train`` for 1 epoch (3 ring launches); ``cli.test`` (129
    stride-1 windows of drive 42 in 9 batches of 16: 9 ring launches at
    B = 144, finite scores with the JAX package's keys, the first eval
    batch's selection bit-equal to the plain version on the same card
    tensors; eval ms per batch and pairs/s), again with ``--use-best``;
    ``cli.stream`` (one launch per frame, frames/s and the real-time
    factor); ``cli.export`` with chunks of 4, then the artifact fed the
    drive chunk by chunk (the last padded) against the eager step on the
    same weights: bit-equal poses, one launch per tick, the export's
    seconds, the artifact's MB and ms per frame each way.

Slice 6, PointSeg pretraining (``cli.pretrain_pointseg``) on the same
tree and configuration, both kernels at B = 16:

13. SemanticKITTI label files for the tree (``bench/kitti_tree.py``:
    ground and building ids by height, a few unlabeled points and ids >=
    2048); ``cli.pretrain_pointseg --steps 30 --batch-size 16`` with the
    labels and SemanticKITTI's learning map (20 classes), then 4 steps
    with geometric labels: exactly one ring launch (the model input) and
    one scatter launch (the label image) a step, the first step's
    selections and the first batch's label image bit-equal to the plain
    versions, finite losses whose last 5 average below the first 5; one
    float32 step on the card against the CPU at 16x128; the snapshot
    grafted into a ``Trainer`` (``pretrained: true``) that trains a step
    through the ring kernel; a profiled step; both kernels timed on the
    first batch (B = 16) beside their bounds. Prints ms/step and scans/s.

Slice 7, the model zoo as shipped (DeepIO, DeepLO, the simple LiDAR
towers, the classic pool, ``backend: sort``) on the same tree:

14. the sort route (the scatter kernel with index payloads and exact
    float32 channels, or packed-f16 words under ``packed``) against its
    plain version on the same card tensors, both payload modes, at B = 96
    on the tree's scans and at B = 24, N = 16384 on synthetic scans:
    selected words, image and mask bit-equal; then at B = 96 the kernel,
    its bound, the plain version and the one ``scatter_reduce_`` call that
    finds the same winners, timed. ``cli.train --epochs 1`` on
    ``configs/deeplio_kitti.yaml`` (only ``root-path``, the splits, the
    log and checkpoint cadence set in code: train on drives 27 and 42,
    validate and test on 42) and ``cli.test``: one scatter launch per
    step, validation batch and eval batch at B = 96, no ring launch,
    finite losses and scores, ms/step, pairs/s, ms per eval batch. The
    six synthetic files as shipped with their drives cut: ``fit`` for one
    epoch, one scatter launch per step and validation batch (none for
    ``deepio_synth.yaml``); ``deeplo_synth.yaml`` streamed by
    ``cli.stream`` with no IMU (one launch a tick). One float32 DeepIO and
    one DeepLO step on the card against the CPU within ``STEP_*``.

Slice 8, the JAX package's benchmark configuration as shipped
(``__graft_entry__._FLAGSHIP``, through ``bench/flagship.py``'s copy:
pair-split stem, stride-fold pool, ``kernel-aligned: halves``):

15. the training step as ``bench.py`` builds it, 16 windows of 9 grid
    scans (``bench/flagship.py::raw_batch``) in bfloat16: 3 + 10 steps
    with no ring and no scatter launch, profiled; one float32 step on the
    card against the CPU at full width on 2 windows. The same tower with
    ``kernel-aligned: off`` on the same scans in ring order: one ring
    launch a step, the kernel bit-equal to its plain version on the
    step's 144 scans. The routes on those scans at B = 144: ``on`` and
    ``trust`` bit-equal to the ring kernel's route with no launch,
    ``halves`` on the card bit-equal to the CPU, ``auto`` and ``on`` on
    the scans shifted one slot launching the ring kernel once and equal
    to its route; each route timed, and the check's host read. On phase
    11's tree: ``cli.train --epochs 1`` with ``auto`` (the tree's
    compacted scans fall back: 3 ring launches) and with ``slot-bin`` +
    ``halves`` (none; the native binning library must build), the native
    binning against its numpy oracle on one scan, ``cli.stream`` on a
    binned drive, ``cli.export`` and the artifact against the eager step.
    Then the pair-split stem against the classic stem on the same
    weights: the stem alone and the step, in turns.

Slice 9, every projection backend and channel and the rest of the
reference zoo (``backend: ring`` and ``sort-sentinel`` with exact
payloads, the normals channel, GRU and bidirectional RNNs, the FC nets,
the decoder-bearing tower, exact-z pretraining) on the same tree:

16. the new routes on 144 of the tree's scans (``ring`` also at B = 1):
    ``ring`` exact (the winner's index in the key, the payload words
    zero) and packed, ``sort-sentinel`` exact (index payloads) and
    packed, each one launch, the kernel's words and the route's image and
    mask bit-equal to the plain version's; each backend's projector one
    launch, ``ring`` packed equal to ``pallas-ring``; both kernels timed
    with index payloads beside bound, plain version and (scatter)
    ``scatter_reduce_``. The slice's configuration (the file with
    ``backend: ring``, ``packed: false``, ``normals``, a bidirectional GRU
    IMU net, a GRU odometry net, ``part: encoder+decoder``): 3 + 10 bf16
    steps at B = 144 on a tree batch (one ring launch a step), beside
    slice 2's step; ``imu-feat-fc``, ``odom-feat-fc`` and ``bypass: true``
    on ``sort-sentinel``: 3 steps (one scatter launch a step); one float32
    step of each against the CPU on 2 windows. ``cli.train --epochs 1``
    (one ring launch per step and validation batch), ``cli.test`` of its
    checkpoint on ``sort-sentinel`` (one scatter launch per eval batch of
    144 scans), ``cli.stream`` on ``ring`` (one launch a tick);
    ``cli.pretrain_pointseg`` with ``packed: false`` and no labels, 4
    steps of 16 scans: one ring launch (the input) and one scatter launch
    (the exact-z label image, index payloads) a step.

Slice 10, every optimizer, stem and Fire (``bench/slice10.py``: A, the
factorized stem, mixed Fires and SGD through the ring kernel; B, the
s2d-pre stem, fused Fires, AdamW and ``param-dtype: bfloat16`` through
the scatter kernel, ``backend: pallas``) on the same tree:

17. for A and for B, 3 + 10 bf16 steps at B = 144 on a tree batch: the
    first step's selection spied and bit-equal to the plain version on
    the same card tensors, then exactly one launch of the configuration's
    kernel a step and none of the other, the kernel timed on the step's
    own selection inputs, a profile of 2 steps, beside slice 2's step;
    one float32 step of each against the CPU on 2 windows (both fed the
    card's images); for A, 20 SGD steps on one batch lower the loss.
    ``cli.train --epochs 1`` of each (one launch per step and validation
    batch); under A the checkpoint's SGD momentum buffers restored
    bit-equal, ``--resume`` for one more epoch, ``cli.stream`` (one ring
    launch a tick); under B ``cli.test`` (one scatter launch per eval
    batch of 144 scans) and ``cli.export --chunk 4`` (the artifact
    bit-equal to the eager bf16 step on the first 16 frames, one scatter
    launch a tick). ``cli.pretrain_pointseg``, 4 steps of 16 scans under
    each tower (A: one ring and one scatter launch a step; B: two
    scatter launches), each snapshot grafted into a Trainer that takes a
    step.

Slice 11, data parallelism (``parallel/``, DDP, BatchNorm statistics over
the data axis, the multi-process Trainer), slice 2's configuration and
batch and phase 11's tree:

18. NCCL at world 1 through the data-parallel path: 3 + 10 bf16 steps
    of 16 windows x 9 frames, the first step's scatter selection spied
    and bit-equal to the plain version, then one scatter launch a step,
    timed beside the mesh-less step on the same batch, both profiled; the
    kernel timed on the spied step's selection inputs beside its bound;
    a float32 SGD step (no augmentation, no dropout) against the
    mesh-less float32 step on the same weights within ``DP_*``. Then two
    gloo ranks on the one card (spawned; NCCL refuses two ranks on one
    GPU), 8 windows each: the float32 step on each rank's rows (one
    scatter launch a rank, bit-equal), the ranks' states equal to each
    other and within ``DP_*`` of the mesh-less step; 1 + 3 bf16 steps of
    the tree's configuration on each rank's rows of its first batch (one
    ring launch a step, the first bit-equal, the kernel timed on it),
    ms/step a rank; ``Trainer.fit(epochs=1)`` at world 2 on the tree (2
    steps and a validation batch: 3 ring launches a rank), its
    ``metrics.jsonl``, checkpoint, ``best/`` and ``trainer_meta.json``
    written once, by rank 0.

Slice 12, the projection's prologue and epilogue as hand-written kernels
(``csrc/proj_io.cu``, the operators ``deeplio::proj_prologue`` and
``deeplio::proj_epilogue`` of ``ops/projection_io.py``) around both
selections on the packed routes:

19. both kernels held bit for bit (as integers: signed zeros and NaN bits
    count) against their plain versions on the same card tensors, on both
    routes at B = 1, 9, 16 and 144, on the tree's ring scans and slice 2's
    unordered synthetic batch, and on eight full-width edge cases (a pure
    invalid tail, interleaved invalid points, an all-invalid scan, a NaN
    remission on valid points, ranges past the key ceiling, ranges at or
    below 1e-6, a scan in no order, NaN on invalid points), as planes and
    as strided [B, N, 4] views, the epilogue in each form (the 5-channel
    image in float32, the configuration's normalised channels in
    bfloat16, float16 and float32); each kernel, the whole projection
    and the plain composition it replaces timed (graph replay) at B = 1,
    16 and 144 beside their bounds; one ``make_projector`` call profiled
    alone at B = 144 (3 device launches on ``pallas``, 4 on
    ``pallas-ring``); a slice-2 step (scatter) and a ring-route step on a
    tree batch at B = 144 profiled with the kernels and with the plain
    prologue and epilogue in turns: ``train.project``'s device ms and the
    kernels of its call. Every main-path run of phases 1 to 18 (the
    stream's ticks, each step loop, fit, the command lines, the
    artifact, the prefill, pretraining, the data-parallel steps) sets the
    two operators' counts to 0 just before it, as it does the
    selections', and reads them just after: one prologue and one
    epilogue per projection on a packed route, none on the others; the
    ``kernels`` line sums those runs only. Phase 4 also profiles the
    stream with the plain prologue and epilogue (kernels a frame each
    way). A call's device work is counted from a CUDA graph of it
    (``utils/timing.py::graph_work``): on the card's machine the profiler
    drops records (after some seconds with no work on the card it
    records no device event at all), so its readings are printed beside,
    not checked.

After phase 4, the cost of the operator binding: a stream with the ring
kernel behind ``torch.ops.deeplio.ring_select`` and with its CUDA
implementation called directly, in turns (frames/s each way).

Exits non-zero, with no result line, when there is no CUDA device or any
check fails. The last line is the JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import yaml

from deeplio_tpu_torch.bench.flagship import flagship_dict
from deeplio_tpu_torch.bench.flagship import raw_batch as flagship_raw_batch
from deeplio_tpu_torch.bench.kitti_tree import make_tree
from deeplio_tpu_torch.bench.slice10 import slice10_dict
from deeplio_tpu_torch.config import load_config, load_config_dict
from deeplio_tpu_torch.data import device_bank as dbank
from deeplio_tpu_torch.data.dataset import WindowDataset
from deeplio_tpu_torch.data.pipeline import DevicePrefetcher, PinnedRing
from deeplio_tpu_torch.data.drives import KittiRawDrive, SyntheticDrive
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.eval.streaming import StreamingOdometry
from deeplio_tpu_torch.models.from_flax import to_flax_variables
from deeplio_tpu_torch.models.zoo import build_model
from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops import projection_io as pio
from deeplio_tpu_torch.ops.projection import make_projector, rq_bits_for
from deeplio_tpu_torch.ops.projection_io import (
    epilogue_form,
    proj_epilogue,
    proj_epilogue_reference,
    proj_prologue,
    proj_prologue_reference,
)
from deeplio_tpu_torch.ops.projection_ring import SENTINEL as SENTINEL_RING
from deeplio_tpu_torch.ops.projection_ring import (
    project_batch_ring_planes,
    ring_prologue,
    ring_select,
    ring_select_reference,
)
from deeplio_tpu_torch.ops.projection_scatter import (
    SENTINEL,
    project_batch_scatter_planes,
    project_batch_sorted_planes,
    scatter_keys,
    scatter_plan,
    scatter_prologue,
    scatter_select,
    scatter_select_reference,
)
from deeplio_tpu_torch.train import Trainer
from deeplio_tpu_torch.train.state import create_train_state
from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
from deeplio_tpu_torch.utils.timing import graph_work

ROOT = pathlib.Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "deeplio_kitti_tpu.yaml"
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
# the training loop: 16 drives of 25 frames (windows of 9 at stride 8: 3
# a drive, 48 in all, 3 steps of 16 an epoch), 16 validation drives of 9
# frames (16 windows, one batch), a periodic checkpoint every 4 steps
FIT_DRIVES, FIT_FRAMES, FIT_EVAL_FRAMES, FIT_EVERY = 16, 25, 9, 4
FIT_EPOCHS, FIT_RESUME_EPOCHS = 2, 1
# The labels the JAX package's rules give. Run 1 (steps 1-6): the first
# validation (step 3) is the best so far, a forced save with metrics; the
# periodic save at step 4; step 6 (validation and the final save): {3, 4,
# 6}. Run 2, resumed at 6 (steps 7-9): the periodic save at 8 (8 // 4 >
# 6 // 4), step 9; the newest three: {6, 8, 9}.
FIT_LABELS, RESUME_LABELS = [3, 4, 6], [6, 8, 9]
# the KITTI loop: a devkit tree of two drives of 137 frames (17 windows of
# 9 at stride 8 a drive: 2 steps of 16 an epoch, 1 validation batch); the
# prefill projects chunks of 16 frames; 16 frames streamed from disk
KITTI_DATE, KITTI_DRIVES, KITTI_FRAMES = "2011_10_03", (27, 42), 137
KITTI_TRAIN = {KITTI_DATE: [27, {"drive": 42, "start": 0, "end": 136}]}
KITTI_VAL = {KITTI_DATE: [27]}
# phase 12: the CLIs on the same tree, drive 42 (137 frames) as the test
# split: 129 stride-1 windows of 9, 9 eval batches of 16 windows (the last
# padded), each one ring launch at B = 144; the artifact's chunk (a chunk
# unrolls the model that many times in the exported program)
KITTI_TEST = {KITTI_DATE: [42]}
EXPORT_CHUNK = 4
KITTI_EPOCHS, PREFILL_CHUNK, STREAM_FRAMES = 2, 16, 16
# phase 13: pretraining on the same tree, 16 scans a step, 30 steps with
# label files (3 of them warm-up for the rate), 4 with geometric labels
PRETRAIN_B, PRETRAIN_STEPS, PRETRAIN_WARMUP, PRETRAIN_GEO_STEPS = (
    16, 30, 3, 4)
# pretraining's float32 step on the card against the CPU (16x128, B = 2):
# the update in L2 within 1e-3 of the CPU's. Its BatchNorms normalise over
# 2 x 2 x 16 x 32 values per channel, not the odometry step's 8, so its
# gradients sit well above the rounding level (an H100 80GB HBM3 gives
# ~2e-5); the loss and the statistics keep STEP_LOSS_RTOL, STEP_STATS_RTOL
PRETRAIN_UPDATE_L2 = 1e-3
# phase 14: the model zoo as shipped. configs/deeplio_kitti.yaml (backend
# sort, pool classic, 32 windows of 3 frames: B = 96 scans a step) on the
# same tree, train {27, 42} (135 windows a drive: 8 steps of 32), validate
# and test on 42 (4 validation batches, 5 eval batches, the last padded);
# the synthetic files with their drives cut to SYNTH_DRIVES of
# SYNTH_FRAMES frames (2 steps of 8 windows, 1 validation batch); the
# sort route also at B = 24 (8 windows of 3) and N = 16384
VARIANT_CONFIG = ROOT / "configs" / "deeplio_kitti.yaml"
VARIANT_TRAIN = {KITTI_DATE: [27, 42]}
VARIANT_EVAL = {KITTI_DATE: [42]}
SYNTH_FILES = ("deepio_synth.yaml", "deeplo_synth.yaml", "deeplio_synth.yaml",
               "deeplio_synth_gen.yaml", "deeplio_synth_gen2.yaml",
               "deeplio_synth_gen2_packed.yaml")
SYNTH_DRIVES, SYNTH_FRAMES, SYNTH_N, SYNTH_B = 2, 10, 16384, 24
# phase 15: the JAX package's benchmark configuration
# (__graft_entry__._FLAGSHIP, bench/flagship.py): TRAIN_B windows of
# TRAIN_S frames, its batch (bench/flagship.py::raw_batch); the float32
# step against the CPU at full width on FLAG_CPU_B windows (the CPU's
# step over 16 windows would outgrow the phase)
FLAG_CPU_B = 2


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


HOST_CALLS = 200


def host_call_us(fn, calls: int = HOST_CALLS, warmup: int = 5) -> float:
    """Host microseconds a call of ``fn`` takes to issue: ``calls`` calls
    back to back on the host clock, then one synchronize, over ``calls``
    (a device that keeps up adds only the last call's tail)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


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


def phase_dispatch(dev, gpu, frames: int = 24):
    """What binding the ring kernel as a ``torch.library`` operator costs
    the host-bound stream: the same drive streamed with the operator
    (``torch.ops.deeplio.ring_select``, the dispatcher in front of the
    kernel) and with its CUDA implementation called as a plain function
    (the binding before the operator), in turns; and one call's host issue
    time at B = 1 each way (``host_call_us``)."""
    from deeplio_tpu_torch.ops import projection_ring as pring
    cfg = load_config(CONFIG)
    drive = SyntheticDrive(n_frames=frames, max_points=N, seed=2,
                           world_points=300_000, rings=H)
    for k in range(frames):
        drive.points(k)
    so = StreamingOdometry(cfg, build_model(cfg, device=dev, seed=0),
                           chunk=16, device=dev)

    def direct(*args):
        return pring._ring_select_cuda(*args)

    op = pring.ring_select
    so.run(drive)                                    # warm-up
    fps = {"operator": [], "plain function": []}
    for name in ("operator", "plain function", "plain function",
                 "operator"):
        pring.ring_select = op if name == "operator" else direct
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            so.run(drive)
            fps[name].append(frames / (time.perf_counter() - t0))
        finally:
            pring.ring_select = op
    rng = np.random.default_rng(5)
    args = ring_prologue(*planes(torch.from_numpy(synthetic_ring_batch(
        rng, 1, N)).to(dev)), torch.ones(1, N, dtype=torch.bool,
                                         device=dev), H, W, FU, FD)
    host_us = {name: host_call_us(lambda f=f: f(*args, H * W))
               for name, f in (("operator", op), ("plain function", direct))}
    print(f"dispatch: {frames} frames streamed at "
          + "; ".join(f"{k} {' / '.join(f'{v:.1f}' for v in fps[k])} "
                      f"frames/s" for k in fps)
          + " (in turns: operator, function, function, operator); host "
          f"time to issue one B = 1 call ({HOST_CALLS} calls back to back, "
          f"then one synchronize): operator {host_us['operator']:.1f} us, "
          f"plain function {host_us['plain function']:.1f} us [{gpu}]")


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
    _zero_counts()
    t0 = time.perf_counter()
    poses, dx, dq = so.run(drive)                  # main path (synchronises)
    wall = time.perf_counter() - t0
    launches = ring_select.launches
    io_take(launches if packed_route(cfg) else 0)
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
    # the same frames with the projection's plain prologue and epilogue
    with plain_io(), profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
        so.run(short)
    plain = device_kernels(prof.key_averages(), "stream.")
    n_plain = sum(e.count for e in plain) / frames
    busy_plain = sum(e.self_device_time_total for e in plain) / 1e3 / frames
    print(f"profile: {n_k:.0f} device kernels/frame and {busy_ms:.3f} ms "
          f"busy with the prologue and epilogue kernels, {n_plain:.0f} and "
          f"{busy_plain:.3f} ms with their plain versions [{gpu}]")


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
    _zero_counts()
    warm = train_step.graph_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TIMED_STEPS):
        state, m = train_step(state, raw)
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = train_step.graph_counts()
    launches = scatter_select.launches
    io_take(launches if packed_route(cfg) else 0)
    check(launches == TIMED_STEPS,
          f"scatter kernel launched {launches} times in {TIMED_STEPS} steps")
    check(counts["replays"] - warm["replays"] == TIMED_STEPS
          and counts["captures"] == warm["captures"] == 1,
          f"the timed steps did not all replay the step's CUDA graph: "
          f"{warm} after warm-up, {counts} after")
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
          f"{h2d_ms:.1f} ms, outside the step; step graph counts {counts} "
          f"({warm} after the {WARMUP_STEPS} warm-up steps) [{gpu}]")
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


def phase_train_vs_cpu(dev, cfg=None, label: str = "train", host=None):
    """One float32 step on the card against the same step on the CPU, at
    16x128 with identical weights and batch (``cfg``: the slice
    configuration cut so, by default; ``host``: the batch, by default two
    windows of a synthetic drive)."""
    cfg = cfg or slice2_config(
        compute_dtype="float32", augment_yaw=False, dropout=0.0,
        image_height=16, image_width=128, max_points=2048, sequence_size=3,
        window_stride=2)
    if host is None:
        ds = WindowDataset(cfg.datasets, [SyntheticDrive(n_frames=5,
                                                         max_points=2048)],
                           with_points=cfg.model.uses_lidar)
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
    # DeepIO has no BatchNorm
    stats = max([float(np.abs(new_g[k] - new_c[k]).max()
                       / max(np.abs(new_c[k]).max(), 1e-3))
                 for k in old if k.startswith("batch_stats/")] or [0.0])
    print(f"{label}: float32 step GPU vs CPU at {cfg.datasets.projection.height}"
          f"x{cfg.datasets.projection.width}: loss rel err "
          f"{rel['loss']:.3g} (tolerance {STEP_LOSS_RTOL}), grad_norm "
          f"{rel['grad_norm']:.3g} ({STEP_NORM_RTOL}), BatchNorm statistics "
          f"{stats:.3g} ({STEP_STATS_RTOL}), update L2 {upd:.3g} "
          f"({STEP_UPDATE_L2})")
    check(rel["loss"] <= STEP_LOSS_RTOL, f"{label}: float32 step loss GPU "
          f"vs CPU")
    check(rel["grad_norm"] <= STEP_NORM_RTOL, f"{label}: float32 grad_norm "
          f"GPU vs CPU")
    check(stats <= STEP_STATS_RTOL, f"{label}: float32 BatchNorm statistics "
          f"GPU vs CPU")
    check(upd <= STEP_UPDATE_L2, f"{label}: float32 parameter update GPU vs "
          f"CPU")


def phase_train_profile(state, train_step, raw, gpu, step_ms: float,
                        steps: int = PROFILE_STEPS,
                        kernel=("proj_scatter", SCATTER_KERNELS)):
    """torch.profiler over ``steps`` training steps: device busy and idle
    share, host time per train.* span, the share of ``kernel`` (its name
    and the profiler's names for it) and the top kernels. The profiler
    slows the host, so the idle share is also given against ``step_ms``,
    the step time measured without it. Returns the kernel's share of the
    busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = train_step(state, raw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    spans = [e for e in events if e.key.startswith("train.")
             and e.device_type.name == "CPU"]
    kernels = device_kernels(events, "train.")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / steps
    if busy_ms <= 0:
        print("train profile: the profiler recorded no device time")
        return None
    wall_ms = wall * 1e3 / steps
    n_k = sum(e.count for e in kernels) / steps
    print(f"train profile: {wall_ms:.3f} ms/step wall (profiler on), device "
          f"busy {busy_ms:.3f} ms/step, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f} (profiler on), "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f} against the "
          f"{step_ms:.2f} ms step without it, {n_k:.0f} device kernels/step "
          f"[{gpu}]")
    # autograd launches the backward's kernels from its own thread, so the
    # profiler puts them under no span: they are the busy time the other
    # spans leave.
    own = {e.key: e.device_time_total / 1e3 / steps for e in spans}
    for e in spans:
        dev_ms = own[e.key]
        if e.key == "train.backward":
            dev_ms = busy_ms - sum(v for k, v in own.items() if k != e.key)
        print(f"train profile span {e.key}: host "
              f"{e.cpu_time_total / 1e3 / steps:.3f} ms/step, its "
              f"kernels {dev_ms:.3f} ms/step")
    name, names = kernel
    sc = [e for e in kernels if any(p in e.key for p in names)]
    sc_ms = sum(e.self_device_time_total for e in sc) / 1e3 / steps
    print(f"train profile {name}: {sc_ms:.4f} ms/step of device time "
          f"({sc_ms / busy_ms:.4f} of busy) in "
          f"{sum(e.count for e in sc) / steps:.0f} kernels [{gpu}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"train profile kernel {e.key[:160]}: "
              f"{e.self_device_time_total / 1e3 / steps:.3f} ms/step,"
              f" {e.count / steps:.1f} launches/step")
    return sc_ms / busy_ms


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


# ------------------------------------------------------------- slice 3

def fit_config(**over):
    """The slice-2 configuration on synthetic drives, with the loop's
    cadence; ``over`` replaces ``datasets`` keys (the CPU rehearsal)."""
    with open(CONFIG) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({
        "backend": "pallas", "augment-yaw": True, "synthetic": True,
        "synthetic-frames": FIT_FRAMES,
        "synthetic-eval-frames": FIT_EVAL_FRAMES,
        "synthetic-train-drives": FIT_DRIVES,
        "synthetic-eval-drives": FIT_DRIVES})
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    d["train"].update({"log-every": 1, "checkpoint-every-steps": FIT_EVERY})
    return load_config_dict(d)


def _records(workdir):
    with open(pathlib.Path(workdir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _cpu_copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_copy(v) for v in tree)
    return copy.deepcopy(tree)


def _same(a, b) -> bool:
    """``a`` (a host copy) equals ``b`` bit for bit, tensors and all."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b.detach().cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _step_gaps(records, steps, spe: int, every: int = FIT_EVERY):
    """ms between the records of consecutive train steps in ``steps``
    (log-every 1: a record is written once its step's metrics reached the
    host), leaving out the gaps that hold a validation (after an epoch's
    last step) or a periodic checkpoint save (after a multiple of
    ``every``)."""
    t = {r["step"]: r["time"] for r in records if r["split"] == "train"}
    return [(t[s + 1] - t[s]) * 1e3 for s in steps
            if s + 1 in t and s in t and s % spe and s % every]


def _offsets(records, steps, t0: float) -> str:
    """When each train step's record was written, ms after ``t0``."""
    t = {r["step"]: r["time"] for r in records if r["split"] == "train"}
    return ", ".join(f"{s}: {(t[s] - t0) * 1e3:.0f}" for s in steps)


def _prebuild(trainer) -> float:
    """Synthesise every scan of the trainer's drives (the drives cache
    them), so that the loop's batch build is assembly only; seconds."""
    t0 = time.perf_counter()
    for d in trainer.train_ds.drives + trainer.val_ds.drives:
        for k in range(len(d)):
            d.points_planes(k)
    return time.perf_counter() - t0


def _data_line(trainer, steps_per_epoch: int, gpu: str, label: str):
    for e, t in enumerate(trainer.data_timings):
        print(f"fit {label} epoch {e + 1}: {t['batches']} batches; host "
              f"batch build {t['build_ms'] / t['batches']:.1f} ms/batch "
              f"(producer thread), host-to-device copy "
              f"{t['copy_ms'] / t['batches']:.2f} ms/batch (side stream, "
              f"device time), loop waited {t['wait_ms'] / steps_per_epoch:.2f}"
              f" ms/step for data ({t['first_wait_ms']:.1f} ms of it for "
              f"the epoch's first batch) [{gpu}]")


def phase_fit(dev, gpu, workdir: pathlib.Path, cfg=None):
    """The training loop at full width: fit, checkpoints, resume. Returns
    the scatter launches of both fits and ms/step."""
    import shutil
    cfg = cfg or fit_config()
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, workdir=str(workdir), device=dev)
    spe = trainer.train_ds.steps_per_epoch(cfg.train.batch_size)
    n_val = len(trainer.val_ds) // cfg.train.batch_size
    synth_s = _prebuild(trainer)
    print(f"fit: Trainer built in {time.perf_counter() - t0:.1f} s "
          f"({synth_s:.1f} s of it synthesising the scans of run 1): "
          f"{len(trainer.train_ds)} train windows ({spe} steps an epoch), "
          f"{len(trainer.val_ds)} validation windows ({n_val} batches), "
          f"{cfg.datasets.sequence_size} frames of "
          f"{cfg.datasets.projection.max_points} points; "
          f"{int(trainer.train_ds.drives[0].points(1)[1].sum())} valid in "
          f"drive 0 frame 1 [{gpu}]")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0, start = time.perf_counter(), time.time()
    trainer.fit(epochs=FIT_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scatter_select.launches
    io_take(launches if packed_route(cfg) else 0)
    want = FIT_EPOCHS * (spe + n_val)
    check(launches == want, f"fit: {launches} scatter launches, want {want} "
          f"(one per train step and per validation batch)")
    counts = trainer.train_step.graph_counts()
    steps = FIT_EPOCHS * spe
    check(counts == {"captures": 1, "replays": steps - 1, "eager": 1},
          f"fit: step graph counts {counts}, want every step after the "
          f"first replayed ({steps} steps)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(trainer.step == FIT_EPOCHS * spe, f"fit ended at step "
          f"{trainer.step}")
    labels = trainer.ckpt.all_steps()
    check(labels == FIT_LABELS, f"checkpoint labels {labels}, want "
          f"{FIT_LABELS}")
    saved = _cpu_copy(trainer.state.state_dict())
    save_ms = trainer.ckpt.save_ms
    size_mb = trainer.ckpt.nbytes(labels[-1]) / 1e6
    gaps = _step_gaps(_records(workdir), range(1, trainer.step), spe)
    med = float(np.median(gaps))
    _data_line(trainer, spe, gpu, "run 1 (scans built before fit)")
    trainer.close()
    print(f"fit run 1: {trainer.step} steps and {FIT_EPOCHS} validations in "
          f"{wall:.2f} s; {med:.2f} ms/step, median of the step-to-step gaps "
          f"{', '.join(f'{g:.2f}' for g in gaps)} ms (those with no "
          f"validation or checkpoint save), {TRAIN_PAIRS / med * 1e3:.1f} "
          f"pairs/s; scatter launches {launches}; step graph counts "
          f"{counts}; peak device memory "
          f"{peak_gb:.2f} GB; checkpoints {labels}, save "
          f"{', '.join(f'{m:.1f}' for m in save_ms)} ms "
          f"({size_mb:.1f} MB each) [{gpu}]")
    print(f"fit run 1: step records at ms after the start of fit "
          f"{_offsets(_records(workdir), range(1, trainer.step + 1), start)}"
          f" [{gpu}]")

    resumed = Trainer(cfg, workdir=str(workdir), resume=True, device=dev)
    restore_ms = resumed.ckpt.restore_ms[-1]
    check(resumed.step == FIT_EPOCHS * spe, f"resumed at step {resumed.step}")
    check(_same(saved, resumed.state.state_dict()),
          "the restored state differs from the saved one")
    print(f"fit: resumed at step {resumed.step}, state bit-equal to the "
          f"saved one (parameters, BatchNorm buffers, sx/sq, Adam moments "
          f"and step, CUDA generator); restore {restore_ms:.1f} ms [{gpu}]")
    _zero_counts()
    start = time.time()
    resumed.fit(epochs=FIT_RESUME_EPOCHS)
    torch.cuda.synchronize()
    r_launches = scatter_select.launches
    io_take(r_launches if packed_route(cfg) else 0)
    want = FIT_RESUME_EPOCHS * (spe + n_val)
    check(r_launches == want, f"resumed fit: {r_launches} scatter launches, "
          f"want {want}")
    end = (FIT_EPOCHS + FIT_RESUME_EPOCHS) * spe
    check(resumed.step == end, f"resumed fit ended at step {resumed.step}")
    r_counts = resumed.train_step.graph_counts()
    steps = FIT_RESUME_EPOCHS * spe
    check(r_counts == {"captures": 1, "replays": steps - 1, "eager": 1},
          f"resumed fit: step graph counts {r_counts}, want every step "
          f"after the first replayed ({steps} steps)")
    labels = resumed.ckpt.all_steps()
    check(labels == RESUME_LABELS, f"checkpoint labels after the resume "
          f"{labels}, want {RESUME_LABELS}")
    records = _records(workdir)
    train = [r for r in records if r["split"] == "train"]
    val = [r for r in records if r["split"] == "val"]
    check([r["step"] for r in train] == list(range(1, end + 1)),
          "a train step is missing from metrics.jsonl")
    check([r["step"] for r in val] == [spe * (e + 1) for e in range(
        FIT_EPOCHS + FIT_RESUME_EPOCHS)], "not one validation per epoch")
    check(all(np.isfinite(r[k]) for r in records
              for k in ("loss", "loss_x", "loss_q")), "non-finite fit loss")
    r_gaps = _step_gaps(records, range(FIT_EPOCHS * spe + 1, end), spe)
    print(f"fit run 2: step records at ms after the start of fit "
          f"{_offsets(records, range(FIT_EPOCHS * spe + 1, end + 1), start)}"
          f" [{gpu}]")
    _data_line(resumed, spe, gpu, "run 2 (scans synthesised in the loop)")
    print(f"fit run 2 (resumed, scans synthesised by the producer thread "
          f"as the epoch reads them): step-to-step gaps "
          f"{', '.join(f'{g:.2f}' for g in r_gaps)} ms (no validation or "
          f"save in them); scatter launches {r_launches}; step graph "
          f"counts {r_counts}; checkpoints "
          f"{labels}; losses: step 1 {train[0]['loss']:.5g}, step {end} "
          f"{train[-1]['loss']:.5g}; validation "
          f"{', '.join(f'{r["loss"]:.5g}' for r in val)} [{gpu}]")

    # the prefetcher's full-width batches against batch_to_device, through
    # a ring of two staging buffers (reused from the third batch on)
    ring = PinnedRing(2)
    ds = resumed.train_ds
    want_it = ds.iter_batches(cfg.train.batch_size, shuffle=True, seed=99)
    it = DevicePrefetcher(ds.iter_batches(cfg.train.batch_size, shuffle=True,
                                          seed=99, alloc=ring.take),
                          dev, depth=1, ring=ring)
    for k, (got, host) in enumerate(zip(it, want_it)):
        ref = batch_to_device(host, dev)
        check(all(torch.equal(got[key], ref[key]) for key in ref),
              f"prefetched batch {k} differs from batch_to_device")
    check(k + 1 == spe, f"prefetched {k + 1} batches")
    it.close()
    print(f"fit: {spe} prefetched full-width batches through 2 staging "
          f"buffers equal batch_to_device's")
    resumed.close()
    shutil.rmtree(workdir, ignore_errors=True)
    return launches + r_launches, med


# ------------------------------------------------------------- slice 4

def kitti_dict(root, over=None, **train):
    """``configs/deeplio_kitti_tpu.yaml`` as shipped, as a dict, on the
    devkit tree at ``root`` with the phase's splits (and phase 12's test
    split), logging every step, prefetch 2 and a checkpoint interval
    longer than the run; ``train`` adds ``train`` keys, ``over`` replaces
    ``datasets`` keys and ``compute_dtype`` (the CPU rehearsal)."""
    with open(CONFIG) as f:
        d = yaml.safe_load(f)
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    d["datasets"]["kitti"] = {"root-path": str(root), "train": KITTI_TRAIN,
                              "validation": KITTI_VAL, "test": KITTI_TEST}
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    d["train"].update({"log-every": 1, "prefetch": 2,
                       "checkpoint-every-steps": 1000})
    d["train"].update({k.replace("_", "-"): v for k, v in train.items()})
    return d


def kitti_config(root, over=None, **train):
    """:func:`kitti_dict`, parsed."""
    return load_config_dict(kitti_dict(root, over, **train))


def write_kitti_tree(root, gpu, frames: int = KITTI_FRAMES) -> None:
    """Drives 27 and 42 of 2011_10_03 under ``root``, ``frames`` each, from
    ``SyntheticDrive(world_points=300000, rings=64)`` at full width."""
    t0 = time.perf_counter()
    srcs = make_tree(str(root), KITTI_DRIVES, n_frames=frames, max_points=N,
                     rings=H, world_points=300_000)
    secs = time.perf_counter() - t0
    base = pathlib.Path(root) / KITTI_DATE
    files = sorted(base.rglob("*.bin"))
    pts = [f.stat().st_size // 16 for f in files]
    mb = sum(f.stat().st_size for f in base.rglob("*") if f.is_file()) / 1e6
    check(len(files) == len(KITTI_DRIVES) * frames
          and all(len(s) == frames for s in srcs), "KITTI tree incomplete")
    print(f"kitti: devkit tree of drives {KITTI_DRIVES} x {frames} frames "
          f"written in {secs:.1f} s, {mb:.0f} MB; points per scan min "
          f"{min(pts)}, median {int(np.median(pts))}, max {max(pts)} (of "
          f"{N}) [{gpu}]")


def _kitti_fit(trainer, gpu, label: str):
    """``fit(KITTI_EPOCHS)`` with the kernels' counts set to 0 just before
    it; returns (ms/step, ring launches, scatter launches)."""
    bs = trainer.cfg.train.batch_size
    spe = trainer.train_ds.steps_per_epoch(bs)
    _zero_counts()
    t0, start = time.perf_counter(), time.time()
    trainer.fit(epochs=KITTI_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ring, scatter = ring_select.launches, scatter_select.launches
    io_take(ring + scatter if packed_route(trainer.cfg) else 0)
    records = _records(trainer.workdir)
    check(all(np.isfinite(r["loss"]) for r in records),
          f"{label}: non-finite loss")
    check(trainer.step == KITTI_EPOCHS * spe, f"{label}: ended at step "
          f"{trainer.step}")
    gaps = _step_gaps(records, range(1, trainer.step), spe, every=1000)
    med = float(np.median(gaps))
    pairs = bs * trainer.cfg.datasets.num_pairs
    print(f"kitti {label}: {trainer.step} steps of {bs} windows x "
          f"{trainer.cfg.datasets.sequence_size} frames and {KITTI_EPOCHS} "
          f"validations in {wall:.2f} s; {med:.2f} ms/step in fit, median "
          f"of the step-to-step gaps {', '.join(f'{g:.2f}' for g in gaps)} "
          f"ms, {pairs / med * 1e3:.1f} pairs/s; step records at ms after "
          f"the start of fit {_offsets(records, range(1, trainer.step + 1), start)}"
          f"; ring launches {ring}, scatter launches {scatter} [{gpu}]")
    return med, ring, scatter


def phase_kitti_runs(dev, gpu, root, over=None):
    """Runs A (host-fed from disk), B (``device-dataset``) and C
    (``cache-projections``) of ``fit`` on the tree. Returns (the ring
    launches of each run's path, ms/step of each run, a host batch of run
    A, run A's trainer)."""
    launches, ms = {}, {}
    cfg = kitti_config(root, over)

    # run A: every batch read from disk by the producer thread
    trainer = Trainer(cfg, workdir=str(root / "run_a"), device=dev)
    bs = cfg.train.batch_size
    spe = trainer.train_ds.steps_per_epoch(bs)
    n_val = len(trainer.val_ds) // bs
    want = KITTI_EPOCHS * (spe + n_val)
    print(f"kitti: {len(trainer.train_ds)} train windows ({spe} steps an "
          f"epoch), {len(trainer.val_ds)} validation windows ({n_val} "
          f"batch), drives {[d.name for d in trainer.train_ds.drives]}")
    ms["A"], ring, scatter = _kitti_fit(trainer, gpu, "run A (host-fed "
                                        "from disk)")
    check(ring == want, f"run A: {ring} ring launches, want {want} (one per "
          f"train step and per validation batch)")
    check(scatter == 0, "run A launched the scatter kernel")
    launches["A"] = ring
    _data_line(trainer, spe, gpu, "kitti run A")
    host = next(trainer.train_ds.iter_batches(bs, shuffle=False))

    # run B: the scans staged on the card once, each batch gathered there
    t0 = time.perf_counter()
    bank_t = Trainer(kitti_config(root, over, device_dataset=True),
                     workdir=str(root / "run_b"), device=dev)
    build_s = time.perf_counter() - t0
    bm = bank_t.bank_ms
    print(f"kitti run B: device-resident banks {bm['mb']:.0f} MB (train and "
          f"validation), built on the host in {bm['build']:.0f} ms (every "
          f"scan read from disk), staged in {bm['put']:.0f} ms; Trainer "
          f"built in {build_s:.1f} s [{gpu}]")
    ms["B"], ring, scatter = _kitti_fit(bank_t, gpu, "run B (device bank)")
    check(ring == want and scatter == 0, f"run B: {ring} ring and {scatter} "
          f"scatter launches, want {want} and 0")
    launches["B"] = ring
    widx = dbank.epoch_indices(len(bank_t.train_ds), bs, shuffle=True,
                               seed=cfg.train.seed)[0]
    got = dbank.gather_batch(bank_t._train_bank,
                             torch.from_numpy(widx).to(dev))
    fed = next(bank_t.train_ds.iter_batches(bs, shuffle=True,
                                            seed=cfg.train.seed))
    ref = batch_to_device(fed, dev)
    check(all(torch.equal(got[k], ref[k]) for k in ref)
          and np.array_equal(got["meta"].cpu().numpy(), fed["meta"]),
          "run B: the gathered batch differs from the host-fed batch")
    print(f"kitti run B: gather_batch of the first batch's windows "
          f"{widx.tolist()} equals the host-fed batch bit for bit on the "
          f"card ({len(ref)} keys)")
    bank_t.close()
    del bank_t, got, ref
    torch.cuda.empty_cache()

    # run C: every frame projected once into the cache, fit on the images
    _zero_counts()
    t0 = time.perf_counter()
    cache_t = Trainer(kitti_config(root, over, cache_projections=True),
                      workdir=str(root / "run_c"), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cache = cache_t.image_cache
    prefill = ring_select.launches
    io_take(prefill if packed_route(cache_t.cfg) else 0)
    spans = {cache._path(d): d for d in cache_t.train_ds.drives
             + cache_t.val_ds.drives}
    chunks = sum(-(-len(d) // PREFILL_CHUNK) for d in spans.values())
    check(prefill == chunks, f"run C: prefill launched the ring kernel "
          f"{prefill} times, want {chunks} (one per chunk of "
          f"{PREFILL_CHUNK} frames of each distinct drive span)")
    mb = sum(os.path.getsize(p) for p in spans) / 1e6
    print(f"kitti run C: projection cache prefill {cache.fill_ms:.0f} ms, "
          f"{prefill} ring launches (B = {PREFILL_CHUNK} each) for "
          f"{len(spans)} drive spans, {mb:.0f} MB of f16 images; Trainer "
          f"built in {build_s:.1f} s [{gpu}]")
    ms["C"], ring, scatter = _kitti_fit(cache_t, gpu, "run C (cached "
                                        "projections)")
    check(ring == 0 and scatter == 0, f"run C: fit launched {ring} ring and "
          f"{scatter} scatter kernels, want 0")
    _data_line(cache_t, spe, gpu, "kitti run C")
    drive = cache_t.train_ds.drives[-1]
    frame = len(drive) - 1
    ds = cfg.datasets
    proj = make_projector(ds.projection, ds.channels, ds.mean, ds.std)
    pts, vld = drive.points(frame)
    img, _ = proj(torch.from_numpy(pts)[None].to(dev),
                  torch.from_numpy(vld)[None].to(dev))
    want_f16 = img[0].to(torch.float16).cpu().numpy()
    cached = np.asarray(cache.images(drive, frame, frame + 1))[0]
    check(cached.view(np.uint16).tobytes()
          == want_f16.view(np.uint16).tobytes(),
          "run C: the cached frame differs from the projector's output")
    print(f"kitti run C: cached frame {frame} of {drive.name} equals "
          f"make_projector's output on the card cast to f16, bit for bit")
    launches["C prefill"] = prefill
    cache_t.close()
    del cache_t
    torch.cuda.empty_cache()
    return launches, ms, host, trainer


def phase_ring_training(dev, gpu, host):
    """The ring kernel on the tree's scans at training's B = 144 (a batch
    of run A) and the prefill's B = 16: bit-exact against its plain
    version, kernel and projector path, and timed. Returns {B: (kernel
    ms, plain ms, bound ms, worst difference)}."""
    out = {}
    nb = host["points_x"].shape[0]
    for b in (nb, PREFILL_CHUNK):
        x, y, z, rem = (torch.from_numpy(host[k][:b]).to(dev)
                        for k in ("points_x", "points_y", "points_z",
                                  "points_rem"))
        v = torch.from_numpy(host["points_valid"][:b]).to(dev)
        args = ring_prologue(x, y, z, rem, v, H, W, FU, FD)
        got = ring_select(*args, H * W)
        ref = ring_select_reference(*args, H * W)
        torch.cuda.synchronize()
        worst = max(int((a.long() - r.long()).abs().max())
                    for a, r in zip(got, ref))
        check(worst == 0, f"ring kernel B={b} on KITTI scans differs by "
              f"{worst}")
        ik, mk = project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD,
                                           select=ring_select)
        ir, mr = project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD,
                                           select=ring_select_reference)
        check(torch.equal(ik, ir) and torch.equal(mk, mr),
              f"ring projector B={b}: kernel path differs from plain path")

        def kernel():
            return ring_select(*args, H * W)

        def plain():
            return ring_select_reference(*args, H * W)

        k_ms, p_ms = graph_ms(kernel), graph_ms(plain)
        landed = int((got[0] != SENTINEL).sum())
        n_pts = x.shape[1]
        # as for B = 1: 8 B per point, 8 B per landed pixel, 12 B written
        # per pixel
        nbytes = 8 * b * n_pts + 8 * landed + 12 * b * H * W
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[b] = (k_ms, p_ms, bound_ms, worst)
        print(f"timing ring_project B={b} (KITTI scans, "
              f"{int(v.sum())} valid points): device (graph replay) kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms; bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s, {landed} "
              f"pixels landed); bit-identical [{gpu}]")
        del x, y, z, rem, v, args, got, ref, ik, mk, ir, mr
    torch.cuda.empty_cache()
    return out


def phase_kitti_stream(dev, gpu, root, cfg):
    """STREAM_FRAMES frames of drive 27 streamed from disk through
    ``StreamingOdometry.run``: one ring launch per frame."""
    drive = KittiRawDrive(str(root), KITTI_DATE, KITTI_DRIVES[0],
                          max_points=cfg.datasets.projection.max_points,
                          end=STREAM_FRAMES - 1)
    so = StreamingOdometry(cfg, build_model(cfg, device=dev, seed=0),
                           chunk=16, device=dev)
    so.run(drive)                                    # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    poses, dx, dq = so.run(drive)
    wall = time.perf_counter() - t0
    launches = ring_select.launches
    io_take(launches if packed_route(cfg) else 0)
    check(launches == STREAM_FRAMES, f"streamed {STREAM_FRAMES} KITTI "
          f"frames with {launches} ring launches")
    check(all(np.isfinite(a).all() for a in (poses, dx, dq))
          and np.array_equal(poses[0], np.eye(4, dtype=np.float32)),
          "KITTI stream: non-finite poses or a first tick not the identity")
    print(f"kitti stream: {STREAM_FRAMES} frames of {drive.name} read from "
          f"disk through StreamingOdometry.run in {wall:.3f} s "
          f"({STREAM_FRAMES / wall:.1f} frames/s), ring launches {launches}"
          f" [{gpu}]")
    return launches


def phase_kitti(dev, gpu, root, over=None, frames: int = KITTI_FRAMES):
    """Phase 11: a KITTI devkit tree under ``root``, runs A, B and C, the
    ring kernel at B = 144 and 16, a profiled train step of run A and a
    stream from disk. Returns (ring launches of the phase's paths, the B =
    144 and B = 16 timings, ms/step of the runs)."""
    write_kitti_tree(root, gpu, frames)
    launches, ms, host, trainer = phase_kitti_runs(dev, gpu, root, over)
    times = phase_ring_training(dev, gpu, host)
    raw = batch_to_device(host, dev)
    trainer.state, _ = trainer.train_step(trainer.state, raw)  # warm-up
    share = phase_train_profile(trainer.state, trainer.train_step, raw,
                                gpu, ms["A"], steps=1,
                                kernel=("ring_project", RING_KERNELS))
    if share is not None:
        print(f"kitti: the ring kernel is {share:.4f} of a run-A train "
              f"step's device time (the scatter kernel's share in "
              f"slice 2 was 0.0044) [{gpu}]")
    cfg = trainer.cfg
    trainer.close()
    del trainer, raw
    torch.cuda.empty_cache()
    launches["stream"] = phase_kitti_stream(dev, gpu, root, cfg)
    print(f"kitti rate: run A {ms['A']:.2f}, run B {ms['B']:.2f}, run C "
          f"{ms['C']:.2f} ms/step in fit; ring launches "
          f"{', '.join(f'{k} {v}' for k, v in launches.items())} [{gpu}]")
    return sum(launches.values()), times, ms


# ------------------------------------------------------------- slice 5

EVAL_KEYS = ["ate_m", "rpe_trans_m", "rpe_rot_rad", "t_rel_pct",
             "r_rel_deg_per_100m", "n_segments"]


class FirstCall:
    """A selection that passes every call through to ``op`` and keeps the
    first call's arguments and outputs (copies), to hold them against the
    plain version afterwards."""

    def __init__(self, op):
        self.op, self.first = op, None

    def __call__(self, *args):
        out = self.op(*args)
        if self.first is None:
            self.first = ([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], [o.clone() for o in out])
        return out


def _timed(fn, seconds: list):
    """``fn``, appending each call's host seconds to ``seconds``."""
    def wrapped(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return wrapped


def _zero_counts() -> None:
    """Sets every kernel's count to 0: both selections', the projection
    prologue's and its epilogue's."""
    torch.cuda.synchronize()
    ring_select.launches = scatter_select.launches = 0
    proj_prologue.launches = proj_epilogue.launches = 0


# the projection prologue's launches on each slice's main paths, as
# io_take reads them after each run: {slice: launches}
IO_LAUNCHES = {}
IO_SLICE = [None]                   # the slice io_take adds to


def packed_route(cfg) -> bool:
    """Whether ``cfg``'s projector runs the prologue and epilogue
    operators around its selection: ``pallas`` and ``pallas-ring`` always
    (their slot-aligned routes launch no selection either), ``ring``,
    ``sort`` and ``sort-sentinel`` under ``packed``."""
    p = cfg.datasets.projection
    return p.backend in ("pallas", "pallas-ring") or p.packed


def io_take(want: int) -> int:
    """The prologue's and the epilogue's launches in the main-path run
    just ended, their counts set to 0 just before it
    (:func:`_zero_counts`): each must be ``want``, the run's projections
    on the packed routes (one of each a projection). Adds them to the
    slice's count and returns them."""
    torch.cuda.synchronize()
    pro, epi = proj_prologue.launches, proj_epilogue.launches
    check(pro == epi == want, f"{IO_SLICE[0]}: {pro} prologue and {epi} "
          f"epilogue launches in a run, want {want} of each (one a "
          f"projection on a packed route)")
    IO_LAUNCHES[IO_SLICE[0]] = IO_LAUNCHES.get(IO_SLICE[0], 0) + pro
    return pro


def phase_cli_eval(gpu, common, cfg, label: str, extra=(),
                   kernel: str = "ring"):
    """``cli.test.main``: one launch of ``kernel`` (``ring`` or
    ``scatter``) per eval batch on the test drive (phase 12: 9 ring
    launches at B = 144), none of the other, finite scores with the JAX
    package's keys, the first eval batch's selection bit-equal to the
    plain version on the same card tensors.
    The drive's one-time OXTS parse is made as soon as ``cli.test`` has
    built the drive, and timed apart; ``predict_drive`` (the eval
    batches) is timed apart from the rest of ``evaluate_drive`` (ground
    truth, metrics, pose files), with its prefetcher's timings. Returns
    the kernel's launches."""
    from deeplio_tpu_torch.cli import test as test_cli
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval import runner
    from deeplio_tpu_torch.ops import projection_ring as pring
    from deeplio_tpu_torch.ops import projection_scatter as pscat
    mod, attr, reference = {
        "ring": (pring, "ring_select", ring_select_reference),
        "scatter": (pscat, "scatter_select", scatter_select_reference),
    }[kernel]
    ds = cfg.datasets
    n = len(build_drives(cfg, "test")[0])
    windows = n - ds.sequence_size + 1
    bs = cfg.train.batch_size
    batches = -(-windows // bs)
    spy = FirstCall(getattr(mod, attr))
    parse_s, predict_s, evaluate_s, prefetchers = [], [], [], []
    build, evaluate = test_cli.build_drives, test_cli.evaluate_drive
    predict, prefetcher = runner.predict_drive, runner.DevicePrefetcher

    def parsed_drives(*args):
        drives = build(*args)
        t0 = time.perf_counter()
        for d in drives:
            d.pose(0)             # the drive's OXTS records and poses
        parse_s.append(time.perf_counter() - t0)
        return drives

    class Recorded(prefetcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            prefetchers.append(self)

    setattr(mod, attr, spy)
    test_cli.build_drives = parsed_drives
    test_cli.evaluate_drive = _timed(evaluate, evaluate_s)
    runner.predict_drive = _timed(predict, predict_s)
    runner.DevicePrefetcher = Recorded
    try:
        _zero_counts()
        t0 = time.perf_counter()
        scores = test_cli.main(list(common) + list(extra))
        wall = time.perf_counter() - t0
    finally:
        setattr(mod, attr, spy.op)
        test_cli.build_drives, test_cli.evaluate_drive = build, evaluate
        runner.predict_drive, runner.DevicePrefetcher = predict, prefetcher
    counts = {"ring": ring_select.launches,
              "scatter": scatter_select.launches}
    ring, scatter = counts["ring"], counts["scatter"]
    io_take(ring + scatter if packed_route(cfg) else 0)
    launched = counts.pop(kernel)
    (other,) = counts.values()
    check(launched == batches and other == 0, f"eval {label}: {ring} ring "
          f"and {scatter} scatter launches, want {batches} {kernel} "
          f"launches (one per eval batch) and none of the other")
    (name, s), = scores.items()
    check(list(s) == EVAL_KEYS and all(np.isfinite(v) for v in s.values())
          and s["n_segments"] > 0, f"eval {label}: scores {s}")
    args, outs = spy.first
    check(args[0].shape[0] == bs * ds.sequence_size,
          f"eval {label}: first {kernel} launch at B = {args[0].shape[0]}")
    ref = reference(*args)
    worst = max(int((a.long() - r.long()).abs().max())
                for a, r in zip(outs, ref))
    check(worst == 0, f"eval {label}: the first eval batch's selection "
          f"differs from the plain version by {worst}")
    (pf,) = prefetchers
    t = pf.timings()
    check(t["batches"] == batches, f"eval {label}: prefetcher gave "
          f"{t['batches']} batches, want {batches}")
    pred, secs = predict_s[0], evaluate_s[0]
    pairs = bs * ds.num_pairs
    print(f"cli test ({label}): {name}, {n} frames, {windows} stride-1 "
          f"windows in {batches} batches of {bs} ({kernel} launches "
          f"{launched} at B = {args[0].shape[0]}); OXTS parse and poses "
          f"{parse_s[0]:.3f} s (apart); predict_drive {pred:.3f} s: "
          f"{pred / batches * 1e3:.1f} ms per eval batch, "
          f"{batches * pairs / pred:.1f} model pairs/s; prefetcher per "
          f"batch: build {t['build_ms'] / batches:.1f} ms (8 threads), copy "
          f"{t['copy_ms'] / batches:.2f} ms, consumer wait "
          f"{t['wait_ms'] / batches:.1f} ms (first batch "
          f"{t['first_wait_ms']:.1f} ms); evaluate_drive {secs:.3f} s "
          f"(ground truth, metrics and files {secs - pred:.3f} s), "
          f"{(n - 1) / secs:.1f} drive pairs/s scored; cli.test.main "
          f"{wall:.2f} s; first batch's selection bit-equal to the plain "
          f"version; scores {json.dumps(s)} [{gpu}]")
    return launched


def _serve(step, carry, chunks, to_device):
    """The chunks through ``step``; (poses, dx, dq) of the real frames."""
    outs = []
    for n_real, host in chunks:
        carry, res = step(carry, to_device(host))
        outs.append([r[:n_real] for r in res])
    torch.cuda.synchronize()
    return [torch.cat(o).cpu().numpy() for o in zip(*outs)]


def phase_cli_export(dev, gpu, common, cfg, wd, per_tick: int = 1,
                     kernel: str = "ring", max_chunks=None):
    """``cli.export.main``, then the artifact fed the test drive chunk by
    chunk (the last chunk padded; only the first ``max_chunks`` chunks
    when given) against the eager step of ``StreamingOdometry`` on the
    same restored weights and chunks, with ``per_tick`` launches of
    ``kernel`` (``ring`` or ``scatter``) a tick. Returns the artifact
    path's launches of ``kernel``."""
    from deeplio_tpu_torch.cli import export as export_cli
    from deeplio_tpu_torch.cli._common import restore_trainer
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval.export import load_streaming_artifact
    from deeplio_tpu_torch.eval.streaming import CHUNK_KEYS
    t0 = time.perf_counter()
    art = export_cli.main(list(common) + ["--chunk", str(EXPORT_CHUNK)])
    export_s = time.perf_counter() - t0
    mb = sum(p.stat().st_size for p in pathlib.Path(art).iterdir()) / 1e6
    step, init_carry, manifest = load_streaming_artifact(art)
    trainer = restore_trainer(cfg, wd, dev.type)
    so = StreamingOdometry(cfg, trainer.state.model, chunk=EXPORT_CHUNK,
                           device=dev)
    drive = build_drives(cfg, "test")[0]
    chunks = list(so.host_chunks(drive, pad=True))   # disk reads first
    chunks = chunks[:max_chunks]

    def eager(carry, inp):
        with torch.no_grad():
            *carry, p, x, q = so.step(*carry, *(inp[k] for k in CHUNK_KEYS))
        return carry, (p, x, q)

    for fn, c0 in ((step, init_carry), (eager, so.init_carry)):
        _serve(fn, c0(), chunks[:1], so.to_device)             # warm-up
    op = ring_select if kernel == "ring" else scatter_select
    walls = {"artifact": [], "eager": []}
    got = None
    for name in ("artifact", "eager", "eager", "artifact"):
        fn, c0 = ((step, init_carry) if name == "artifact"
                  else (eager, so.init_carry))
        _zero_counts()
        t0 = time.perf_counter()
        out = _serve(fn, c0(), chunks, so.to_device)
        walls[name].append(time.perf_counter() - t0)
        if name == "artifact" and got is None:
            got, art_launches = out, op.launches
            io_take(art_launches if packed_route(cfg) else 0)
        elif name == "eager":
            want = out
    frames = sum(n for n, _ in chunks)
    padded = len(chunks) * EXPORT_CHUNK
    check(art_launches == per_tick * padded, f"artifact: {art_launches} "
          f"{kernel} launches for {padded} ticks ({frames} frames padded "
          f"to chunks of {EXPORT_CHUNK}), want {per_tick} a tick")
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    check(all(np.array_equal(g, w) for g, w in zip(got, want)),
          f"artifact vs eager step: poses, dx, dq differ by up to {diff}")
    check(all(np.isfinite(g).all() for g in got), "artifact: non-finite")
    ms = {k: [w / padded * 1e3 for w in v] for k, v in walls.items()}
    print(f"cli export: chunk {EXPORT_CHUNK} exported in {export_s:.2f} s "
          f"(cli.export.main, Trainer restore included), artifact "
          f"{mb:.2f} MB ({', '.join(sorted(manifest))}); {frames} frames of "
          f"{drive.name} in {len(chunks)} chunks: artifact "
          f"{' / '.join(f'{v:.2f}' for v in ms['artifact'])} ms/frame, "
          f"eager step {' / '.join(f'{v:.2f}' for v in ms['eager'])} "
          f"ms/frame (two runs each, in turns); poses, dx, dq bit-equal to "
          f"the eager step; {kernel} launches {art_launches} [{gpu}]")
    trainer.close()
    return art_launches


def phase_cli(dev, gpu, root, over=None):
    """Phase 12: the command lines on phase 11's tree, with drive 42 as
    the test split: train 1 epoch, evaluate (latest and ``--use-best``),
    stream, export and serve the artifact. Returns the ring launches of
    those paths."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    from deeplio_tpu_torch.cli import train as train_cli
    cfg_path = root / "kitti_cli.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(kitti_dict(root, over), f)
    cfg = load_config(cfg_path)
    wd = str(root / "cli_run")
    common = ["-c", str(cfg_path), "--workdir", wd, "--device", dev.type]
    launches = {}

    _zero_counts()
    t0 = time.perf_counter()
    train_cli.main(common + ["--epochs", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ring, scatter = ring_select.launches, scatter_select.launches
    io_take(ring + scatter if packed_route(cfg) else 0)
    records = _records(wd)
    steps = [r["step"] for r in records if r["split"] == "train"]
    # 2 train steps and 1 validation batch (phase 11's splits)
    check(ring == 3 and scatter == 0 and steps == [1, 2]
          and all(np.isfinite(r["loss"]) for r in records),
          f"cli train: steps {steps}, {ring} ring and {scatter} scatter "
          f"launches, want [1, 2], 3 and 0")
    print(f"cli train: 1 epoch ({steps[-1]} steps, 1 validation) in "
          f"{secs:.2f} s (Trainer build and the OXTS parse included), ring "
          f"launches {ring} [{gpu}]")
    launches["train"] = ring

    launches["eval"] = phase_cli_eval(gpu, common, cfg, "latest checkpoint")
    launches["eval best"] = phase_cli_eval(
        gpu, common, cfg, "--use-best",
        ["--use-best", "--out", str(root / "cli_eval_best")])

    _zero_counts()
    scores = stream_cli.main(common + ["--chunk", "16"])
    ring = ring_select.launches
    io_take(ring if packed_route(cfg) else 0)
    (name, s), = scores.items()
    check(ring == s["frames"] and np.isfinite(s["ate_m"]),
          f"cli stream: {ring} ring launches for {s['frames']} frames")
    print(f"cli stream: {name}, {s['frames']} frames at "
          f"{s['frames_per_sec']:.1f} frames/s, real-time factor "
          f"{s['real_time_factor']:.2f} (10 Hz LiDAR), ATE {s['ate_m']:.4f} "
          f"m, ring launches {ring} [{gpu}]")
    launches["stream"] = ring

    launches["artifact"] = phase_cli_export(dev, gpu, common, cfg, wd)
    print(f"cli: ring launches {', '.join(f'{k} {v}' for k, v in launches.items())} [{gpu}]")
    return sum(launches.values())


# ------------------------------------------------------------- slice 6

# SemanticKITTI's learning map (raw id -> one of 20 train ids), as its
# semantic-kitti.yaml gives it
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5}
PRETRAIN_CLASSES = 20


def pretrain_dict(root, labels: bool = True, over=None):
    """Phase 11's configuration on its tree (:func:`kitti_dict`), with the
    tree's SemanticKITTI labels, SemanticKITTI's learning map and its 20
    classes when ``labels``."""
    d = kitti_dict(root, over)
    if labels:
        d["datasets"].update({"labels-path": str(root / "labels"),
                              "label-map": LEARNING_MAP,
                              "labels-num-classes": PRETRAIN_CLASSES})
    return d


class StepClock:
    """Wraps ``pretrain.build_pretrain_step`` so that the run's steps are
    timed on the host clock: a synchronize and a stamp before step
    ``warmup`` and after the last of ``steps``. Keeps the first step's
    device batch (``first``)."""

    def __init__(self, build, steps: int, warmup: int):
        self.build, self.steps, self.warmup = build, steps, warmup
        self.calls, self.t0, self.t1, self.first = 0, None, None, None

    def __call__(self, *args, **kw):
        step = self.build(*args, **kw)

        def timed(batch):
            if self.calls == 0:
                self.first = batch
            if self.calls == self.warmup:
                torch.cuda.synchronize()
                self.t0 = time.perf_counter()
            out = step(batch)
            self.calls += 1
            if self.calls == self.steps:
                torch.cuda.synchronize()
                self.t1 = time.perf_counter()
            return out
        return timed

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3 / (self.steps - self.warmup)


def _pretrain_run(dev, gpu, cfg_path, out, steps: int, warmup: int,
                  label: str, per_step=(1, 1)):
    """``cli.pretrain_pointseg`` in-process on ``cfg_path`` at B =
    PRETRAIN_B for ``steps`` steps, both selections spied on; checks
    ``per_step`` (ring, scatter) launches a step (by default one of each:
    the model input through the ring kernel, the label image through the
    scatter kernel), the projections on packed routes among them (the
    model input's on a packed route, the label image's with label files
    or under ``packed``) and the first step's selections against the
    plain versions. Returns (result, ms/step over the steps after ``warmup``,
    the ring and scatter launches, the scatter spy, the first step's
    device batch)."""
    from deeplio_tpu_torch.cli import pretrain_pointseg as pre_cli
    from deeplio_tpu_torch.ops import projection_ring as pring
    from deeplio_tpu_torch.ops import projection_scatter as pscat
    from deeplio_tpu_torch.train import pretrain as tpre
    ring, scatter = FirstCall(pring.ring_select), FirstCall(
        pscat.scatter_select)
    clock = StepClock(tpre.build_pretrain_step, steps, warmup)
    build = tpre.build_pretrain_step
    pring.ring_select, pscat.scatter_select = ring, scatter
    tpre.build_pretrain_step = clock
    try:
        _zero_counts()
        t0 = time.perf_counter()
        res = pre_cli.main(["-c", str(cfg_path), "--out", str(out),
                            "--steps", str(steps), "--batch-size",
                            str(PRETRAIN_B), "--device", dev.type])
        wall = time.perf_counter() - t0
    finally:
        pring.ring_select, pscat.scatter_select = ring.op, scatter.op
        tpre.build_pretrain_step = build
    launches = (ring_select.launches, scatter_select.launches)
    cfg = load_config(cfg_path)
    io_take(steps * (int(packed_route(cfg)) + int(
        bool(cfg.datasets.labels_path) or cfg.datasets.projection.packed)))
    want = tuple(k * steps for k in per_step)
    check(launches == want, f"pretrain {label}: {launches[0]} ring and "
          f"{launches[1]} scatter launches in {steps} steps, want {want}")
    worst = 0
    for name, spy, plain in (("ring", ring, ring_select_reference),
                             ("scatter", scatter, scatter_select_reference)):
        if spy.first is None:           # a kernel this path does not run
            continue
        args, outs = spy.first
        check(args[0].shape[0] == PRETRAIN_B, f"pretrain {label}: first "
              f"{name} launch at B = {args[0].shape[0]}")
        worst = max([worst] + [int((a.long() - r.long()).abs().max())
                               for a, r in zip(outs, plain(*args))])
    check(worst == 0, f"pretrain {label}: the first step's selections "
          f"differ from the plain versions by {worst}")
    losses = res["losses"]
    check(len(losses) == steps and np.isfinite(losses).all(),
          f"pretrain {label}: losses {losses}")
    print(f"pretrain {label}: cli.pretrain_pointseg {steps} steps of "
          f"{PRETRAIN_B} scans in {wall:.2f} s; {clock.ms:.2f} ms/step, "
          f"{PRETRAIN_B / clock.ms * 1e3:.1f} scans/s (host clock over "
          f"steps {warmup + 1}-{steps}, scans read from disk "
          f"inside); loss {losses[0]:.4f} -> {losses[-1]:.4f}, last acc "
          f"{res['acc']:.3f}; launches ring {launches[0]}, scatter "
          f"{launches[1]}; first step's selections bit-equal to the plain "
          f"versions [{gpu}]")
    return res, clock.ms, launches, scatter, clock.first


def _label_image_check(batch, scatter_spy, gpu):
    """The first step's label image through the scatter kernel equals the
    plain route's bit for bit; ``batch`` is the step's device batch (its
    keys are the spied launch's)."""
    from deeplio_tpu_torch.train import pretrain as tpre
    planes_ = [batch[k] for k in tpre.PLANES]
    valid, labels = batch["points_valid"], batch["labels"]
    key = scatter_prologue(*planes_, valid, H, W, FU, FD)[0]
    check(torch.equal(key, scatter_spy.first[0][0]),
          "pretrain: the first step's batch is not the spied launch's")
    got = tpre.label_image(planes_, valid, labels, H, W, FU, FD,
                           select=scatter_select)
    ref = tpre.label_image(planes_, valid, labels, H, W, FU, FD,
                           select=scatter_select_reference)
    check(torch.equal(got, ref), "pretrain: the label image differs from "
          "the plain route's")
    counts = torch.bincount(got.flatten(), minlength=PRETRAIN_CLASSES)
    print(f"pretrain: first batch's label image ({PRETRAIN_B}x{H}x{W}) "
          f"bit-equal to the plain route's; pixels per class "
          f"{counts.tolist()} [{gpu}]")


def phase_pretrain_vs_cpu(dev):
    """One float32 pretraining step on the card against the same step on
    the CPU, 16x128, B = 2 ring scans with labels, identical weights."""
    from deeplio_tpu_torch.train import pretrain as tpre
    over = dict(image_height=16, image_width=128, max_points=2048,
                compute_dtype="float32")
    cfg = load_config_dict(pretrain_dict(pathlib.Path("/unused"),
                                         over=over))
    rng = np.random.default_rng(9)
    pts = synthetic_ring_batch(rng, 2, 2048, rings=16)
    labels = rng.integers(0, PRETRAIN_CLASSES, (2, 2048)).astype(np.int32)
    host = {k: np.ascontiguousarray(pts[..., c])
            for c, k in enumerate(tpre.PLANES)}
    host.update(points_valid=np.ones((2, 2048), bool), labels=labels)
    cpu_model = tpre.build_pointseg(cfg, PRETRAIN_CLASSES)
    from deeplio_tpu_torch.models.zoo import init_parameters
    init_parameters(cpu_model, torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    old = _flat(to_flax_variables(cpu_model))
    out = {}
    for name, model, d in (("cpu", cpu_model, torch.device("cpu")),
                           ("gpu", gpu_model, dev)):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               eps=tpre.ADAM_EPS)
        step = tpre.build_pretrain_step(cfg, model, opt, PRETRAIN_CLASSES)
        loss, acc = step(batch_to_device(host, d))
        out[name] = (float(loss), float(acc),
                     _flat(to_flax_variables(model)))
    (lc, ac, new_c), (lg, ag, new_g) = out["cpu"], out["gpu"]
    rel = abs(lg - lc) / abs(lc)
    params = sorted(k for k in old if k.startswith("params/"))
    du_c = np.concatenate([(new_c[k] - old[k]).ravel() for k in params])
    du_g = np.concatenate([(new_g[k] - old[k]).ravel() for k in params])
    upd = float(np.linalg.norm(du_g - du_c) / np.linalg.norm(du_c))
    stats = max(float(np.abs(new_g[k] - new_c[k]).max()
                      / max(np.abs(new_c[k]).max(), 1e-3))
                for k in old if k.startswith("batch_stats/"))
    print(f"pretrain: float32 step GPU vs CPU at 16x128: loss rel err "
          f"{rel:.3g} (tolerance {STEP_LOSS_RTOL}), acc {ag:.4f} vs "
          f"{ac:.4f}, BatchNorm statistics {stats:.3g} ({STEP_STATS_RTOL}), "
          f"update L2 {upd:.3g} ({PRETRAIN_UPDATE_L2})")
    check(rel <= STEP_LOSS_RTOL, "float32 pretraining loss GPU vs CPU")
    check(stats <= STEP_STATS_RTOL, "float32 pretraining BatchNorm "
          "statistics GPU vs CPU")
    check(upd <= PRETRAIN_UPDATE_L2, "float32 pretraining update GPU vs CPU")


def phase_pretrain_graft(dev, gpu, root, out, over=None, d=None,
                         want=(1, 0), label=""):
    """A ``Trainer`` with ``pretrained: true, model-path``: its encoder is
    the snapshot, every other tensor its seeded init; then one train step
    with ``want`` (ring, scatter) launches, through the ring kernel by
    default. ``d``: the configuration, :func:`kitti_dict`'s by default."""
    d = copy.deepcopy(d) if d is not None else kitti_dict(root, over)
    d["lidar-feat-pointseg"].update({"pretrained": True,
                                     "model-path": str(out)})
    cfg = load_config_dict(d)
    saved = torch.load(pathlib.Path(out) / "params.pt", map_location="cpu",
                       weights_only=True)
    trainer = Trainer(cfg, workdir=str(root / f"graft_run{label}"),
                      device=dev)
    try:
        got = {k: v.cpu() for k, v in trainer.state.model.state_dict()
               .items()}
        init = build_model(cfg, device="cpu", seed=cfg.train.seed)
        enc = "lidar_feat.pointseg.encoder."
        check(all(torch.equal(got[enc + k[len("encoder."):]], v)
                  for k, v in saved.items()),
              "graft: the encoder is not the snapshot")
        rest = [k for k in got if not k.startswith(enc)]
        check(all(torch.equal(got[k], init.state_dict()[k]) for k in rest),
              "graft: a tensor outside the encoder moved")
        host = next(trainer.train_ds.iter_batches(cfg.train.batch_size,
                                                  shuffle=False))
        raw = batch_to_device(host, dev)
        _zero_counts()
        trainer.state, m = trainer.train_step(trainer.state, raw)
        torch.cuda.synchronize()
        launches = (ring_select.launches, scatter_select.launches)
        io_take(sum(launches) if packed_route(cfg) else 0)
        loss = float(m["loss"])
    finally:
        trainer.close()
    check(launches == tuple(want) and np.isfinite(loss), f"graft{label}: "
          f"train step with {launches} launches, want {tuple(want)}, loss "
          f"{loss}")
    print(f"pretrain graft{label}: Trainer with pretrained: true loads the "
          f"snapshot's {len(saved)} encoder tensors, its other "
          f"{len(rest)} tensors keep their seed-{cfg.train.seed} init; one "
          f"train step of {cfg.train.batch_size} windows: loss {loss:.4f}, "
          f"ring launches {launches[0]}, scatter {launches[1]} [{gpu}]")
    return launches


def phase_pretrain_profile(dev, cfg, batch, gpu, step_ms: float):
    """torch.profiler over one pretraining step on the first batch, after
    a warm-up step: device busy and idle share (against the run's ms/step
    and the profiled wall), both kernels' shares, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    from deeplio_tpu_torch.models.zoo import init_parameters
    from deeplio_tpu_torch.train import pretrain as tpre
    model = tpre.build_pointseg(cfg, PRETRAIN_CLASSES)
    init_parameters(model, torch.Generator().manual_seed(0))
    model = model.to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=tpre.ADAM_EPS)
    step = tpre.build_pretrain_step(cfg, model, opt, PRETRAIN_CLASSES)
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = device_kernels(events, "pretrain.")
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        print("pretrain profile: the profiler recorded no device time")
        return
    print(f"pretrain profile: one step {wall_ms:.3f} ms wall (profiler on, "
          f"batch on the card), device busy {busy:.3f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f} (profiler on), "
          f"{max(0.0, 1 - busy / step_ms):.3f} against the run's "
          f"{step_ms:.2f} ms/step (scans read inside), "
          f"{sum(e.count for e in kernels)} device kernels [{gpu}]")
    for name, names in (("ring_project", RING_KERNELS),
                        ("proj_scatter", SCATTER_KERNELS)):
        sel = [e for e in kernels if any(p in e.key for p in names)]
        ms = sum(e.self_device_time_total for e in sel) / 1e3
        print(f"pretrain profile {name}: {ms:.4f} ms ({ms / busy:.4f} of "
              f"busy) in {sum(e.count for e in sel)} kernel [{gpu}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"pretrain profile kernel {e.key[:160]}: "
              f"{e.self_device_time_total / 1e3:.3f} ms, {e.count} launches")


def _early_frames(cfg, dev):
    """The first PRETRAIN_B frames of the first train drive, on the card:
    scans still inside the tree's world, fuller than random draws."""
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.train import pretrain as tpre
    drive = build_drives(cfg, "train")[0]
    planes, valid = zip(*(drive.points_planes(i) for i in range(PRETRAIN_B)))
    planes = np.stack(planes)
    host = {k: np.ascontiguousarray(planes[:, c])
            for c, k in enumerate(tpre.PLANES)}
    host["points_valid"] = np.stack(valid)
    return drive.name, batch_to_device(host, dev)


def phase_pretrain_timings(dev, batches, gpu, ring16_ms=None):
    """Both kernels at B = 16 on each of ``batches`` ({what: device
    batch}): graph-replay device time, the plain version's, the byte
    bound, bit-identical outputs; the ring kernel beside ``ring16_ms``,
    its time on the training batch's first 16 scans (phase 11)."""
    from deeplio_tpu_torch.train import pretrain as tpre
    for what, batch in batches.items():
        planes_ = [batch[k] for k in tpre.PLANES]
        valid = batch["points_valid"]
        words = scatter_prologue(*planes_, valid, H, W, FU, FD)
        args = ring_prologue(*planes_, valid, H, W, FU, FD)
        n_pts = planes_[0].shape[1]
        for name, run, plain, per_point in (
                ("proj_scatter",
                 lambda: scatter_select(*words, H * W, RQ_BITS),
                 lambda: scatter_select_reference(*words, H * W, RQ_BITS),
                 4),
                ("ring_project", lambda: ring_select(*args, H * W),
                 lambda: ring_select_reference(*args, H * W), 8)):
            got, ref = run(), plain()
            check(all(torch.equal(a, r) for a, r in zip(got, ref)),
                  f"{name} B={PRETRAIN_B} on {what}: kernel differs from "
                  f"plain")
            k_ms, p_ms = graph_ms(run), graph_ms(plain)
            landed = int((got[0] != SENTINEL).sum())
            # as for B = 144: the per-point words read once (scatter: the
            # key; ring: pixel and key), the two payload words of each
            # landed pixel's winner, three int32 words written per pixel
            nbytes = (per_point * PRETRAIN_B * n_pts + 8 * landed
                      + 12 * PRETRAIN_B * H * W)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"timing {name} B={PRETRAIN_B} ({what}, "
                  f"{int(valid.sum())} valid points): device (graph "
                  f"replay) kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
                  f"bound {bound * 1e3:.3f} us ({nbytes} B at 3.35 TB/s, "
                  f"{landed} pixels landed: {k_ms / bound:.1f}x); "
                  f"bit-identical"
                  + (f"; {ring16_ms:.4f} ms on the training batch's first "
                     f"16 scans (phase 11)" if name == "ring_project"
                     and ring16_ms is not None else "") + f" [{gpu}]")


def phase_pretrain(dev, gpu, root, over=None, ring16_ms=None):
    """Phase 13 on phase 11's tree: SemanticKITTI label files, then
    ``cli.pretrain_pointseg`` for PRETRAIN_STEPS steps of 16 scans with
    the labels and PRETRAIN_GEO_STEPS with geometric labels, each step one
    ring and one scatter launch; the label image; a float32 step against
    the CPU; the graft into a Trainer; a profiled step; both kernels at B
    = 16 on the first step's batch and on a drive's first 16 frames (the
    ring kernel beside ``ring16_ms``, phase 11's B = 16 time). Returns the
    ring and the scatter launches its paths' counters read."""
    from deeplio_tpu_torch.bench.kitti_tree import write_labels
    t0 = time.perf_counter()
    write_labels(str(root), str(root / "labels"), KITTI_DRIVES, KITTI_DATE)
    mb = sum(f.stat().st_size for f in (root / "labels").rglob("*.label"))
    print(f"pretrain: SemanticKITTI label files of drives {KITTI_DRIVES} "
          f"written in {time.perf_counter() - t0:.1f} s, {mb / 1e6:.1f} MB "
          f"[{gpu}]")
    cfg_path = root / "pretrain.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(pretrain_dict(root, over=over), f)
    cfg = load_config(cfg_path)
    out = root / "pretrained"
    res, step_ms, l_launches, scatter_spy, batch = _pretrain_run(
        dev, gpu, cfg_path, out, PRETRAIN_STEPS, PRETRAIN_WARMUP,
        "with labels")
    losses = res["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check(last < first, f"pretrain: loss did not fall: mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f}")
    print(f"pretrain: mean loss of steps 1-5 {first:.4f}, of the last 5 "
          f"{last:.4f}; losses {' '.join(f'{v:.3f}' for v in losses)}")
    _label_image_check(batch, scatter_spy, gpu)

    geo_path = root / "pretrain_geometric.yaml"
    with open(geo_path, "w") as f:
        yaml.safe_dump(pretrain_dict(root, labels=False, over=over), f)
    _, g_ms, g_launches, _, _ = _pretrain_run(
        dev, gpu, geo_path, root / "pretrained_geo", PRETRAIN_GEO_STEPS, 1,
        "geometric labels")
    phase_pretrain_vs_cpu(dev)
    graft_ring, _ = phase_pretrain_graft(dev, gpu, root, out, over)
    phase_pretrain_profile(dev, cfg, batch, gpu, step_ms)
    drive, full = _early_frames(cfg, dev)
    phase_pretrain_timings(
        dev, {"the first pretraining batch": batch,
              f"frames 0-{PRETRAIN_B - 1} of drive {drive}": full},
        gpu, ring16_ms)
    ring = l_launches[0] + g_launches[0]
    scatter = l_launches[1] + g_launches[1]
    print(f"pretrain rate: {step_ms:.2f} ms/step, "
          f"{PRETRAIN_B / step_ms * 1e3:.1f} scans/s with labels; "
          f"{g_ms:.2f} ms/step geometric; launches ring {ring} + "
          f"{graft_ring} (graft), scatter {scatter} [{gpu}]")
    del batch, full
    torch.cuda.empty_cache()
    return ring + graft_ring, scatter


# ------------------------------------------------------------- slice 7

def variant_dict(root, over=None):
    """``configs/deeplio_kitti.yaml`` as shipped, as a dict, on the devkit
    tree at ``root`` with phase 14's splits, logging every step (for
    ms/step) and a checkpoint interval longer than the run; ``over``
    replaces ``datasets`` keys and ``compute_dtype`` (the CPU
    rehearsal)."""
    with open(VARIANT_CONFIG) as f:
        d = yaml.safe_load(f)
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    d["datasets"]["kitti"] = {"root-path": str(root),
                              "train": VARIANT_TRAIN,
                              "validation": VARIANT_EVAL,
                              "test": VARIANT_EVAL}
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    d["train"].update({"log-every": 1, "checkpoint-every-steps": 1000})
    return d


def synth_dict(name, over=None):
    """A synthetic file as shipped, its drives cut to SYNTH_DRIVES train
    drives and one validation and test drive of SYNTH_FRAMES frames;
    logging every step."""
    with open(ROOT / "configs" / name) as f:
        d = yaml.safe_load(f)
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    d["datasets"].update({
        "synthetic-frames": SYNTH_FRAMES,
        "synthetic-eval-frames": SYNTH_FRAMES,
        "synthetic-train-drives": SYNTH_DRIVES,
        "synthetic-eval-drives": 1})
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    d["train"].update({"log-every": 1, "checkpoint-every-steps": 1000})
    return d


def _sort_route_check(label, planes, valid, gpu):
    """The sort route in both payload modes on card tensors
    (:func:`_route_check`). Returns the largest difference (0) and the
    index-payload words."""
    words = None
    for payload in ("carry", "carry-f16"):
        args = _route_check(f"sort route {label} {payload}",
                            _sort_route(payload), planes, valid,
                            scatter_select, scatter_select_reference, gpu)
        if payload == "carry":
            words = args
    return 0, words


def _bits_equal(a, b) -> bool:
    return all(torch.equal(x.contiguous().view(torch.int32),
                           y.contiguous().view(torch.int32))
               for x, y in zip(a, b))


def _ring_route(payload):
    def route(x, y, z, rem, v, select):
        return project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD,
                                         select=select, payload=payload)
    return route


def _sort_route(payload):
    def route(x, y, z, rem, v, select):
        return project_batch_sorted_planes(x, y, z, rem, v, H, W, FU, FD,
                                           payload=payload, select=select)
    return route


def _route_check(label, route, planes, valid, spy_op, reference, gpu):
    """``route(*planes, valid, select=...)`` with the kernel (spied) and
    with its plain version on the same card tensors: the kernel's words
    bit-equal to the plain version's on the same inputs, image and mask
    bit-equal, exactly one launch. Returns the first call's arguments."""
    spy = FirstCall(spy_op)
    _zero_counts()
    got = route(*planes, valid, select=spy)
    torch.cuda.synchronize()
    launches = ring_select.launches + scatter_select.launches
    want = route(*planes, valid, select=reference)
    args, outs = spy.first
    worst = max(int((a.long() - r.long()).abs().max())
                for a, r in zip(outs, reference(*args)))
    same = _bits_equal(got, want)
    landed = int(got[1].sum())
    check(worst == 0 and same and launches == 1,
          f"{label}: words differ by {worst}, image and mask bit-equal "
          f"{same}, {launches} launches (want 1)")
    print(f"{label}: one launch, selected words and the projected image "
          f"and mask bit-equal to the plain version's ({landed} of "
          f"{got[1].numel()} pixels landed) [{gpu}]")
    return args


def phase_sort_route(dev, gpu, root, over=None):
    """The sort route on the card against its plain version at B = 96 on
    the tree's scans (48 frames of each drive) and at B = 24, N = 16384
    on synthetic scans, both payload modes; then at B = 96 with index
    payloads the kernel, its bound, the plain version and the one
    ``scatter_reduce_`` call that finds the same winners, timed. Returns
    (worst difference, (ms, plain ms, bound ms, library ms))."""
    from deeplio_tpu_torch.data.dataset import build_drives
    cfg = load_config_dict(variant_dict(root, over))
    b = cfg.train.batch_size * cfg.datasets.sequence_size
    drives = build_drives(cfg, "train")
    per = b // len(drives)
    planes, valid = zip(*(d.points_planes(k) for d in drives
                          for k in range(per)))
    planes = torch.from_numpy(np.stack(planes)).to(dev)
    valid = torch.from_numpy(np.stack(valid)).to(dev)
    cols = [planes[:, c].contiguous() for c in range(4)]
    worst, words = _sort_route_check(
        f"B={b} (frames 0-{per - 1} of drives {KITTI_DRIVES})", cols, valid,
        gpu)
    n = cfg.datasets.projection.max_points

    synth = [SyntheticDrive(n_frames=SYNTH_B, max_points=SYNTH_N, seed=s)
             for s in (0, 1)]
    sp, sv = zip(*(d.points_planes(k) for d in synth
                   for k in range(SYNTH_B // 2)))
    sp = torch.from_numpy(np.stack(sp)).to(dev)
    w24, _ = _sort_route_check(
        f"B={SYNTH_B}, N={SYNTH_N} (synthetic scans)",
        [sp[:, c].contiguous() for c in range(4)],
        torch.from_numpy(np.stack(sv)).to(dev), gpu)
    worst = max(worst, w24)

    key, idx, zero, n_pix, rq_bits = words

    def kernel():
        return scatter_select(key, idx, zero, n_pix, rq_bits)

    def plain():
        return scatter_select_reference(key, idx, zero, n_pix, rq_bits)

    # the plain version's composite and slots, built once; the library
    # call alone: per pixel the smallest (rq << 32 | i)
    pix = key >> rq_bits
    live = (key != SENTINEL) & (pix < n_pix)
    slot = torch.where(live, pix, n_pix).long()
    comp = ((key & ((1 << rq_bits) - 1)).long() << 32) | torch.arange(
        n, dtype=torch.int64, device=dev)
    best = torch.full((b, n_pix + 1), 2**63 - 1, dtype=torch.int64,
                      device=dev)

    def library():
        return best.scatter_reduce_(1, slot, comp, reduce="amin",
                                    include_self=True)

    k_ms, p_ms, l_ms = graph_ms(kernel), graph_ms(plain), graph_ms(library)
    landed = int((kernel()[0] != SENTINEL).sum())
    nbytes = 4 * b * n + 8 * landed + 12 * b * n_pix
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"timing proj_scatter sort route B={b} (index payloads): device "
          f"(graph replay) kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"scatter_reduce_ amin on the int64 composite {l_ms:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes} B at 3.35 TB/s: 4 B per point, "
          f"8 B per landed pixel, {landed} landed, 12 B per pixel written) "
          f"[{gpu}]")
    del planes, valid, cols, sp, words, key, idx, zero, slot, comp, best
    torch.cuda.empty_cache()
    return worst, (k_ms, p_ms, bound_ms, l_ms)


def phase_variant_cli(dev, gpu, root, over=None):
    """``cli.train --epochs 1`` on ``configs/deeplio_kitti.yaml``, then
    ``cli.test`` on drive 42: one scatter launch per train step,
    validation batch and eval batch, no ring launch; ms/step and pairs/s
    in fit. Returns the scatter launches of those paths."""
    from deeplio_tpu_torch.cli import train as train_cli
    from deeplio_tpu_torch.data.dataset import build_dataset
    cfg_path = root / "deeplio_kitti.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(variant_dict(root, over), f)
    cfg = load_config(cfg_path)
    wd = str(root / "variant_run")
    common = ["-c", str(cfg_path), "--workdir", wd, "--device", dev.type]
    bs, seq = cfg.train.batch_size, cfg.datasets.sequence_size
    _zero_counts()
    t0 = time.perf_counter()
    train_cli.main(common + ["--epochs", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ring, scatter = ring_select.launches, scatter_select.launches
    io_take(ring + scatter if packed_route(cfg) else 0)
    records = _records(wd)
    steps = [r["step"] for r in records if r["split"] == "train"]
    n_val = sum(1 for r in records if r["split"] == "val")
    spe = len(build_dataset(cfg, "train")) // bs
    val_batches = len(build_dataset(cfg, "validation")) // bs
    check(steps == list(range(1, spe + 1)) and n_val == 1
          and scatter == spe + val_batches and ring == 0
          and all(np.isfinite(r["loss"]) for r in records),
          f"variant cli train: steps {steps}, {scatter} scatter and {ring} "
          f"ring launches, want {spe} steps, {spe + val_batches} and 0")
    gaps = _step_gaps(records, range(1, spe), spe, every=1000)
    med = float(np.median(gaps))
    pairs = bs * cfg.datasets.num_pairs
    print(f"variant cli train ({VARIANT_CONFIG.name}): 1 epoch, {spe} steps "
          f"of {bs} windows x {seq} frames (B = {bs * seq} scans a "
          f"projection) and "
          f"{val_batches} validation batches in {secs:.2f} s; {med:.2f} "
          f"ms/step in fit (median of the gaps "
          f"{', '.join(f'{g:.1f}' for g in gaps)}), "
          f"{pairs / med * 1e3:.1f} pairs/s; scatter launches {scatter}, "
          f"ring {ring} [{gpu}]")
    e = phase_cli_eval(gpu, common, cfg, "deeplio_kitti.yaml",
                       kernel="scatter")
    return scatter + e, med


def phase_variant_synth(dev, gpu, root, over=None):
    """Each synthetic file as shipped, its drives cut: ``Trainer.fit`` for
    one epoch, one scatter launch per step and validation batch for the
    LiDAR files and none for DeepIO's; then ``deeplo_synth.yaml``'s test
    drive streamed with ``cli.stream`` (one launch a tick). Returns the
    scatter launches."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    total = 0
    for name in SYNTH_FILES:
        path = root / name
        with open(path, "w") as f:
            yaml.safe_dump(synth_dict(name, over), f)
        cfg = load_config(path)
        wd = root / f"synth_{path.stem}"
        trainer = Trainer(cfg, workdir=str(wd), device=dev)
        try:
            bs = cfg.train.batch_size
            spe = trainer.train_ds.steps_per_epoch(bs)
            n_val = len(trainer.val_ds) // bs
            _zero_counts()
            t0 = time.perf_counter()
            trainer.fit(epochs=1)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            trainer.close()
        ring, scatter = ring_select.launches, scatter_select.launches
        io_take(ring + scatter if packed_route(cfg) else 0)
        want = (spe + n_val) if cfg.model.uses_lidar else 0
        records = _records(wd)
        check(trainer.step == spe and scatter == want and ring == 0
              and all(np.isfinite(r["loss"]) for r in records),
              f"{name}: {trainer.step} steps, {scatter} scatter and {ring} "
              f"ring launches, want {spe}, {want} and 0")
        total += scatter
        proj = cfg.datasets.projection
        print(f"synth {name} ({cfg.model.arch}"
              + (f", {cfg.model.lidar.name}, pool {cfg.model.lidar.pool}"
                 if cfg.model.lidar else "")
              + f", {proj.backend}{' packed' if proj.packed else ''}, "
              f"{cfg.datasets.synthetic_world} world, "
              f"{cfg.model.compute_dtype}): fit 1 epoch, {spe} steps of "
              f"{bs} windows and {n_val} validation batch in {secs:.2f} s, "
              f"scatter launches {scatter} [{gpu}]")
        if name == "deeplo_synth.yaml":
            _zero_counts()
            scores = stream_cli.main(["-c", str(path), "--workdir", str(wd),
                                      "--device", dev.type])
            launches = scatter_select.launches
            io_take(launches if packed_route(cfg) else 0)
            (drive, sc), = scores.items()
            check(launches == sc["frames"] and np.isfinite(sc["ate_m"])
                  and ring_select.launches == 0,
                  f"deeplo stream: {launches} scatter launches for "
                  f"{sc['frames']} frames")
            total += launches
            print(f"synth deeplo_synth.yaml cli stream: {drive}, "
                  f"{sc['frames']} ticks with no IMU input at "
                  f"{sc['frames_per_sec']:.1f} frames/s, scatter launches "
                  f"{launches} [{gpu}]")
    return total


def variant_step_config(name):
    """A zoo file cut for the float32 step against the CPU (16x128, 2048
    points, windows of 3 at stride 2, dropout 0)."""
    with open(ROOT / "configs" / name) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d[d["arch"]]["dropout"] = 0.0
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2})
    return load_config_dict(d)


def phase_variants(dev, gpu, root, over=None):
    """Phase 14 on phase 11's tree: the sort route against its plain
    version and timed, ``deeplio_kitti.yaml`` through ``cli.train`` and
    ``cli.test``, the synthetic files through ``fit`` (and DeepLO through
    ``cli.stream``), float32 DeepIO and DeepLO steps against the CPU.
    Returns (scatter launches of the paths, worst difference, timings at
    B = 96, ms/step)."""
    worst, times = phase_sort_route(dev, gpu, root, over)
    launches, step_ms = phase_variant_cli(dev, gpu, root, over)
    launches += phase_variant_synth(dev, gpu, root, over)
    phase_train_vs_cpu(dev, variant_step_config("deepio_synth.yaml"),
                       "deepio")
    phase_train_vs_cpu(dev, variant_step_config("deeplo_synth.yaml"),
                       "deeplo")
    return launches, worst, times, step_ms



# ------------------------------------------------------------- slice 8

def flagship_config(over=None, stem=None, f32=False, **ds):
    """``__graft_entry__._FLAGSHIP`` (``bench/flagship.py``'s copy) with
    ``datasets`` keys from ``ds`` (hyphens for underscores) and ``over``
    (the CPU rehearsal's cuts, ``compute_dtype`` at the top); ``stem``
    replaces the stem; ``f32``: float32 and no dropout."""
    d = flagship_dict()
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    if f32:
        d["compute-dtype"] = "float32"
        d["deeplio"]["dropout"] = 0.0
    if stem:
        d["lidar-feat-pointseg"]["stem"] = stem
    d["datasets"].update({k.replace("_", "-"): v
                          for k, v in {**over, **ds}.items()})
    return load_config_dict(d)


def _timed_steps(state, train_step, raw, steps: int = TIMED_STEPS,
                 warmup: int = WARMUP_STEPS, *, packed: bool):
    """``steps`` steps after ``warmup``, the counts set to 0 just before
    them and the prologue's and epilogue's read after them (a launch of
    each per selection when ``packed``: the step projects on a packed
    route); (ms/step, ring launches, scatter launches, metrics)."""
    for _ in range(warmup):
        state, m = train_step(state, raw)
    _zero_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(steps):
        state, m = train_step(state, raw)
        metrics.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    ring, scatter = ring_select.launches, scatter_select.launches
    io_take(ring + scatter if packed else 0)
    vals = [_metrics(m) for m in metrics]
    check(all(np.isfinite(list(v.values())).all() for v in vals),
          "non-finite training metrics")
    return ms, ring, scatter, vals


def phase_flagship_steps(dev, gpu, over=None):
    """Items 1 and 2: the flagship's training step as ``bench.py`` builds
    it (``halves``: no kernel) and the same tower through the ring kernel
    (``off``: one launch a step, bit-equal to its plain version on the
    step's scans). Returns (halves ms/step, off ms/step, off launches,
    worst difference, the ``off`` batch's card planes)."""
    b = TRAIN_B
    out = {}
    for aligned in ("halves", "off"):
        cfg = flagship_config(over, kernel_aligned=aligned)
        t0 = time.perf_counter()
        host = flagship_raw_batch(cfg, b, seed=0)
        build_s = time.perf_counter() - t0
        model = build_model(cfg, device=dev, seed=0)
        state = create_train_state(cfg, model)
        train_step, _ = build_train_step(cfg)
        raw = batch_to_device(host, dev)
        ms, ring, scatter, vals = _timed_steps(state, train_step, raw,
                                               packed=packed_route(cfg))
        want = 0 if aligned == "halves" else TIMED_STEPS
        check(ring == want and scatter == 0,
              f"flagship {aligned}: {ring} ring and {scatter} scatter "
              f"launches in {TIMED_STEPS} steps, want {want} and 0")
        pairs = b * cfg.datasets.num_pairs
        print(f"flagship {aligned}: {TIMED_STEPS} steps of {b} windows x "
              f"{cfg.datasets.sequence_size} frames x "
              f"{cfg.datasets.projection.max_points} points at "
              f"{cfg.datasets.projection.height}x"
              f"{cfg.datasets.projection.width} in {cfg.model.compute_dtype}"
              f" (pair-split stem, stride-fold pool): {ms:.2f} ms/step, "
              f"{pairs / ms * 1e3:.1f} pairs/s; ring launches {ring}, "
              f"scatter {scatter}; loss {vals[0]['loss']:.5g} -> "
              f"{vals[-1]['loss']:.5g}; batch built in {build_s:.1f} s "
              f"[{gpu}]")
        if aligned == "halves":
            share = phase_train_profile(state, train_step, raw, gpu, ms,
                                        kernel=("ring_project",
                                                RING_KERNELS))
            check(share in (None, 0.0), "the halves step ran a ring kernel")
        out[aligned] = (ms, ring, raw)
        del state, model, train_step
        torch.cuda.empty_cache()
    # the ring kernel on the off step's 144 scans, bit-equal
    raw = out["off"][2]
    n_pix = H * W
    planes = [raw[k] for k in ("points_x", "points_y", "points_z",
                               "points_rem")]
    words = ring_prologue(*planes, raw["points_valid"], H, W, FU, FD)
    got = ring_select(*words, n_pix)
    ref = ring_select_reference(*words, n_pix)
    torch.cuda.synchronize()
    worst = max(int((a.long() - r.long()).abs().max())
                for a, r in zip(got, ref))
    check(worst == 0, f"flagship off: the ring kernel differs from its "
          f"plain version by {worst} on the step's scans")
    print(f"flagship off: the ring kernel bit-equal to its plain version "
          f"on the step's {planes[0].shape[0]} scans "
          f"({int((got[0] != SENTINEL_RING).sum())} of "
          f"{got[0].numel()} pixels landed) [{gpu}]")
    return out["halves"][0], out["off"][0], out["off"][1], worst, planes, \
        raw["points_valid"]


def phase_flagship_vs_cpu(dev, over=None):
    """Item 1's float32 step on the card against the CPU, at full width
    with FLAG_CPU_B windows of 9 frames of the flagship's batch."""
    cfg = flagship_config(over, f32=True, kernel_aligned="halves")
    phase_train_vs_cpu(dev, cfg, "flagship halves",
                       host=flagship_raw_batch(cfg, FLAG_CPU_B, seed=1))


def phase_flagship_routes(dev, gpu, planes, valid):
    """Item 3: the routes on the flagship's 144 grid scans against the
    ring kernel's route, then on the same scans shifted one slot; each
    timed. Returns the ring launches of the misaligned calls."""
    from deeplio_tpu_torch.ops import projection as tproj
    n = planes[0].shape[1]

    def ring_route(x, y, z, rem, v):
        return project_batch_ring_planes(x, y, z, rem, v, H, W, FU, FD)

    def route(check_mode, ps, v):
        return tproj.project_batch_ring_aligned_planes(
            *ps, v, H, W, FU, FD, check=check_mode, fallback=ring_route)

    want = ring_route(*planes, valid)
    _zero_counts()
    on = route("cond", planes, valid)
    trust = route("assert-off", planes, valid)
    torch.cuda.synchronize()
    check(ring_select.launches == 0, f"on/trust on grid scans launched "
          f"{ring_select.launches} ring kernels")
    check(_bits_equal(on, want) and _bits_equal(trust, want),
          "on/trust differ from the ring kernel route on grid scans")
    perm = torch.from_numpy(tproj.halves_permutation(n, H, W)).to(dev)
    hp = [p.index_select(1, perm) for p in planes]
    hv = valid.index_select(1, perm)
    halves = tproj.project_batch_ring_halves_planes(*hp, hv, H, W, FU, FD)
    cpu = tproj.project_batch_ring_halves_planes(
        *(p.cpu() for p in hp), hv.cpu(), H, W, FU, FD)
    check(_bits_equal([t.cpu() for t in halves], cpu),
          "halves on the card differs from the CPU")
    landed = int(want[1].sum())
    print(f"flagship routes B={planes[0].shape[0]}: on and trust bit-equal "
          f"to the ring kernel route with no ring launch ({landed} of "
          f"{want[1].numel()} pixels landed); halves on the card bit-equal "
          f"to the CPU [{gpu}]")
    shifted = [torch.roll(p, 1, dims=1) for p in planes]
    want_s = ring_route(*shifted, valid)
    launches = 0
    for name in ("auto", "on"):
        _zero_counts()
        got = route("cond", shifted, valid)
        torch.cuda.synchronize()
        launches += ring_select.launches
        check(ring_select.launches == 1 and _bits_equal(got, want_s),
              f"{name} on shifted scans: {ring_select.launches} ring "
              f"launches, bit-equal {_bits_equal(got, want_s)}")
    print(f"flagship routes, scans shifted one slot: auto and on launch the "
          f"ring kernel once each and equal its route bit for bit [{gpu}]")

    aligned = tproj.slot_pixel(n, H, W, dev)

    def predicate():
        u, v, r = tproj.spherical_uv_planes(*planes[:3], H, W, FU, FD)
        ok = valid & (r > 1e-6)
        return torch.where(ok, (v * W + u) == aligned, True).all()

    times = {"ring route": graph_ms(lambda: ring_route(*planes, valid)),
             "trust": graph_ms(lambda: route("assert-off", planes, valid)),
             "halves": graph_ms(lambda: tproj.project_batch_ring_halves_planes(
                 *hp, hv, H, W, FU, FD)),
             "predicate": graph_ms(predicate)}
    walls = {"on": cuda_ms(lambda: route("cond", planes, valid)),
             "trust": cuda_ms(lambda: route("assert-off", planes, valid))}
    read_us = host_call_us(lambda: bool(predicate()), calls=50)
    print(f"flagship routes timing B={planes[0].shape[0]}: device (graph "
          f"replay) {', '.join(f'{k} {v:.4f} ms' for k, v in times.items())}"
          f"; one call between CUDA events: on {walls['on']:.4f} ms, trust "
          f"{walls['trust']:.4f} ms; the predicate computed and read on the "
          f"host {read_us:.1f} us a call [{gpu}]")
    del hp, hv, shifted, want, want_s
    torch.cuda.empty_cache()
    return launches


class _Recorded:
    """``cli.train``'s ``Trainer`` with each instance kept, to read the
    prefetcher's timings after ``main`` returns."""

    made = []

    def __new__(cls, *a, **k):
        t = Trainer(*a, **k)
        cls.made.append(t)
        return t


def flagship_kitti_dict(root, over=None, **ds):
    """The flagship on phase 11's tree (phase 12's splits), logging every
    step, prefetch 2, no periodic checkpoint; ``ds`` sets ``datasets``
    keys."""
    d = flagship_dict()
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    d["datasets"]["synthetic"] = False
    d["datasets"]["kitti"] = {"root-path": str(root), "train": KITTI_TRAIN,
                              "validation": KITTI_VAL, "test": KITTI_TEST}
    d["datasets"].update({k.replace("_", "-"): v
                          for k, v in {**over, **ds}.items()})
    d["train"].update({"log-every": 1, "prefetch": 2,
                       "checkpoint-every-steps": 1000})
    return d


def _flagship_cli_train(dev, gpu, root, label, over, **ds):
    """``cli.train --epochs 1`` on the tree; (cfg, common args, ms/step in
    fit, ring launches, scatter launches)."""
    from deeplio_tpu_torch.cli import train as train_cli
    cfg_path = root / f"flagship_{label}.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(flagship_kitti_dict(root, over, **ds), f)
    cfg = load_config(cfg_path)
    wd = str(root / f"flagship_{label}")
    common = ["-c", str(cfg_path), "--workdir", wd, "--device", dev.type]
    _Recorded.made.clear()
    real, train_cli.Trainer = train_cli.Trainer, _Recorded
    try:
        _zero_counts()
        t0 = time.perf_counter()
        train_cli.main(common + ["--epochs", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ring, scatter = ring_select.launches, scatter_select.launches
        io_take(ring + scatter if packed_route(cfg) else 0)
    finally:
        train_cli.Trainer = real
    (trainer,) = _Recorded.made
    records = _records(wd)
    steps = [r["step"] for r in records if r["split"] == "train"]
    check(steps == [1, 2] and all(np.isfinite(r["loss"]) for r in records),
          f"flagship cli train {label}: steps {steps}")
    gaps = _step_gaps(records, range(1, len(steps)), len(steps), every=1000)
    med = float(np.median(gaps))
    bs = cfg.train.batch_size
    pairs = bs * cfg.datasets.num_pairs
    print(f"flagship cli train {label}: 1 epoch ({len(steps)} steps of {bs} "
          f"windows x {cfg.datasets.sequence_size} frames, 1 validation "
          f"batch) in {secs:.2f} s; {med:.2f} ms/step in fit (step 1 to "
          f"2), {pairs / med * 1e3:.1f} pairs/s; ring launches {ring}, "
          f"scatter {scatter} [{gpu}]")
    _data_line(trainer, len(steps), gpu, f"flagship {label}")
    return cfg, common, wd, med, ring, scatter


def phase_flagship_cli(dev, gpu, root, over=None):
    """Item 4: the command lines on phase 11's tree. ``auto``: the tree's
    compacted ring-ordered scans break the slot contract, so every train
    step and validation batch falls back to the ring kernel at B = 144;
    ``slot-bin`` + ``halves``: the loader's threads bin each scan natively,
    no launch; native binning against the oracle on one scan; ``cli.stream``
    on a binned drive; the binned run's artifact against the eager step.
    Returns the ring launches of the ``auto`` run."""
    from deeplio_tpu_torch import native
    from deeplio_tpu_torch.cli import stream as stream_cli
    from deeplio_tpu_torch.data import synthetic as syn
    _, _, _, _, ring, scatter = _flagship_cli_train(
        dev, gpu, root, "auto", over, kernel_aligned="auto")
    check(ring == 3 and scatter == 0, f"flagship cli train auto: {ring} "
          f"ring and {scatter} scatter launches, want 3 (2 steps and 1 "
          f"validation batch on compacted KITTI scans) and 0")
    auto_ring = ring

    check(native.lib() is not None,
          f"the native slot-binning library did not build: "
          f"{native.build_error()}")
    cfg, common, wd, _, ring, scatter = _flagship_cli_train(
        dev, gpu, root, "slot-bin", over, slot_bin=True,
        kernel_aligned="halves")
    check(ring == 0 and scatter == 0, f"flagship cli train slot-bin: {ring} "
          f"ring and {scatter} scatter launches, want 0")
    # native binning against its numpy oracle on one scan of the tree
    path = sorted((pathlib.Path(root) / KITTI_DATE).rglob("*.bin"))[0]
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    ones = np.ones(len(scan), bool)
    pj = cfg.datasets.projection
    spp = pj.max_points // (pj.height * pj.width)
    args = (scan, ones, pj.height, pj.width, spp, pj.fov_up_deg,
            pj.fov_down_deg, "halves")
    secs = {}
    for name, fn in (("native", syn.slot_bin_scan),
                     ("numpy", syn.slot_bin_scan_np)):
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(5):
            got = fn(*args)
        secs[name] = (time.perf_counter() - t0) / 5
        secs[name + "_out"] = got
    a, b = secs.pop("native_out"), secs.pop("numpy_out")
    check(np.array_equal(a[0].view(np.int32), b[0].view(np.int32))
          and np.array_equal(a[1], b[1]),
          "native slot binning differs from the numpy oracle")
    print(f"slot binning one tree scan ({len(scan)} points, {spp} slots a "
          f"pixel, halves layout): native {secs['native'] * 1e3:.2f} ms, "
          f"numpy oracle {secs['numpy'] * 1e3:.2f} ms, bit-equal [{gpu}]")

    _zero_counts()
    scores = stream_cli.main(common + ["--chunk", "16"])
    io_take(0)
    (name, s), = scores.items()
    check(ring_select.launches == 0 and np.isfinite(s["ate_m"]),
          f"flagship cli stream: {ring_select.launches} ring launches")
    print(f"flagship cli stream (slot-binned {name}, halves, B = 1): "
          f"{s['frames']} frames at {s['frames_per_sec']:.1f} frames/s, "
          f"real-time factor {s['real_time_factor']:.2f}, ATE "
          f"{s['ate_m']:.4f} m, ring launches 0 [{gpu}]")
    phase_cli_export(dev, gpu, common, cfg, wd, per_tick=0)
    return auto_ring


def phase_flagship_stems(dev, gpu, over=None):
    """Item 5: the pair-split stem against the classic stem on the same
    weights, full width, bfloat16: the stem alone and the step, in
    turns."""
    cfg = flagship_config(over, kernel_aligned="halves")
    ccfg = flagship_config(over, stem="classic", kernel_aligned="halves")
    split = build_model(cfg, device=dev, seed=0)
    classic = build_model(ccfg, device=dev, seed=None)
    classic.load_state_dict(split.state_dict())
    raw = batch_to_device(flagship_raw_batch(cfg, TRAIN_B, seed=2), dev)
    from deeplio_tpu_torch.train.step import make_model_batch
    projector = make_projector(cfg.datasets.projection, cfg.datasets.channels,
                               cfg.datasets.mean, cfg.datasets.std,
                               out_dtype=torch.bfloat16, layout="planes")
    with torch.no_grad():
        mb = make_model_batch(cfg, projector, raw)
    enc = split.lidar_feat.pointseg.encoder.eval()
    x = mb["images"].flatten(0, 1).permute(0, 3, 1, 2)
    pads = enc._fold_pads(x)
    stem = enc.ConvBN_0

    def nchw(t):
        return t.flatten(0, 1).permute(0, 3, 1, 2)

    def split_stem():
        return stem((nchw(mb["images"]), nchw(mb["images2"])), pads)

    def classic_stem():
        return stem(nchw(torch.cat([mb["images"], mb["images2"]], -1)),
                    pads)

    stem_ms = {}
    with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16):
        for name, fn in (("pair-split", split_stem),
                         ("classic", classic_stem)) * 2:
            stem_ms.setdefault(name, []).append(cuda_ms(fn))
    step_ms = {}
    for name, model, c in (("pair-split", split, cfg),
                           ("classic", classic, ccfg)) * 2:
        state = create_train_state(c, model)
        train_step, _ = build_train_step(c)
        ms, *_ = _timed_steps(state, train_step, raw,
                              packed=packed_route(c))
        step_ms.setdefault(name, []).append(ms)
    print(f"flagship stems, same weights, B = {TRAIN_B} x 8 pairs at "
          f"{H}x{W}, bfloat16 (in turns): the stem with its input copies "
          f"(CUDA events) pair-split "
          f"{' / '.join(f'{v:.4f}' for v in stem_ms['pair-split'])} ms, "
          f"classic {' / '.join(f'{v:.4f}' for v in stem_ms['classic'])} "
          f"ms; the step pair-split "
          f"{' / '.join(f'{v:.2f}' for v in step_ms['pair-split'])} "
          f"ms/step, classic "
          f"{' / '.join(f'{v:.2f}' for v in step_ms['classic'])} ms/step "
          f"[{gpu}]")
    del split, classic, raw, mb
    torch.cuda.empty_cache()


def phase_flagship(dev, gpu, root, over=None):
    """Phase 15: the JAX package's benchmark configuration as shipped.
    Returns (ring launches on its main paths, worst difference, halves
    ms/step, off ms/step)."""
    halves_ms, off_ms, off_ring, worst, planes, valid = \
        phase_flagship_steps(dev, gpu, over)
    phase_flagship_vs_cpu(dev, over)
    phase_flagship_routes(dev, gpu, planes, valid)
    del planes, valid
    torch.cuda.empty_cache()
    cli_ring = phase_flagship_cli(dev, gpu, root, over)
    phase_flagship_stems(dev, gpu, over)
    print(f"flagship: halves {halves_ms:.2f} ms/step, "
          f"{TRAIN_PAIRS / halves_ms * 1e3:.1f} pairs/s; off (ring kernel) "
          f"{off_ms:.2f} ms/step, {TRAIN_PAIRS / off_ms * 1e3:.1f} pairs/s "
          f"[{gpu}]")
    return off_ring + cli_ring, worst, halves_ms, off_ms


# ------------------------------------------------------------- slice 9

def slice9_dict(root, over=None, fc=False):
    """Phase 11's configuration on its tree (:func:`kitti_dict`) with the
    slice's settings: ``backend: ring`` with ``packed: false``, the
    normals channel (``mean``/``std`` extended by 0/1 for its three
    components), a bidirectional GRU IMU net, a GRU odometry net and the
    decoder-bearing tower (``part: encoder+decoder``). ``fc``: the second
    configuration, ``imu-feat-fc``, ``odom-feat-fc`` and ``bypass: true``
    on ``sort-sentinel`` (still exact payloads and normals)."""
    d = kitti_dict(root, over)
    ds = d["datasets"]
    ds.update({"backend": "ring", "packed": False,
               "channels": list(ds["channels"]) + ["normals"],
               "mean": list(ds["mean"]) + [0.0] * 3,
               "std": list(ds["std"]) + [1.0] * 3})
    d["imu-feat-rnn"].update({"type": "gru", "bidirectional": True})
    d["odom-feat-rnn"]["type"] = "gru"
    d["lidar-feat-pointseg"]["part"] = "encoder+decoder"
    if fc:
        ds["backend"] = "sort-sentinel"
        d["deeplio"]["imu-feat-net"] = {"name": "imu-feat-fc"}
        d["deeplio"]["odom-feat-net"] = {"name": "odom-feat-fc"}
        d["imu-feat-fc"] = {"hidden-size": 128, "num-layers": 2}
        d["odom-feat-fc"] = {"hidden-size": 256, "num-layers": 2}
        lp = d["lidar-feat-pointseg"]
        del lp["part"]
        lp["bypass"] = True
    return d


def phase_slice9_routes(dev, gpu, root, over=None):
    """Item 1: the new routes on 144 of the tree's scans (72 frames of
    each drive, a training batch's count), ``ring`` also at B = 1: the
    kernels against their plain versions, each route through its
    projector with one launch, timed beside bounds and plain versions.
    Returns (worst difference, {route: (ms, plain ms, bound ms, library
    ms)})."""
    from deeplio_tpu_torch.data.dataset import build_drives
    cfg = load_config_dict(slice9_dict(root, over))
    drives = build_drives(cfg, "train")
    b = TRAIN_B * TRAIN_S
    per = b // len(drives)
    planes, valid = zip(*(d.points_planes(k) for d in drives
                          for k in range(per)))
    planes = torch.from_numpy(np.stack(planes)).to(dev)
    valid = torch.from_numpy(np.stack(valid)).to(dev)
    cols = [planes[:, c].contiguous() for c in range(4)]
    n = cols[0].shape[1]
    n_pix = H * W
    words = {}
    for label, route, op, ref in (
            ("ring carry", _ring_route("carry"), ring_select,
             ring_select_reference),
            ("ring carry-f16", _ring_route("carry-f16"), ring_select,
             ring_select_reference),
            ("sort-sentinel carry", _sort_route("carry"), scatter_select,
             scatter_select_reference),
            ("sort-sentinel carry-f16", _sort_route("carry-f16"),
             scatter_select, scatter_select_reference)):
        words[label] = _route_check(f"slice9 route {label} B={b}", route,
                                    cols, valid, op, ref, gpu)
    _route_check("slice9 route ring carry B=1", _ring_route("carry"),
                 [c[:1] for c in cols], valid[:1], ring_select,
                 ring_select_reference, gpu)
    zero = words["ring carry"][2]
    check(not zero.any(), "ring carry: payload words not zero")

    # each backend through make_projector: one launch a projection, and
    # ring packed equal to the pallas-ring projector
    ds = cfg.datasets
    outs = {}
    for backend, packed, kind in (("ring", False, "ring"),
                                  ("ring", True, "ring"),
                                  ("pallas-ring", True, "ring"),
                                  ("sort-sentinel", False, "scatter"),
                                  ("sort-sentinel", True, "scatter")):
        proj = dataclasses.replace(ds.projection, backend=backend,
                                   packed=packed)
        fn = make_projector(proj, ds.channels, ds.mean, ds.std,
                            layout="planes")
        _zero_counts()
        outs[backend, packed] = fn(cols, valid)
        torch.cuda.synchronize()
        counts = {"ring": ring_select.launches,
                  "scatter": scatter_select.launches}
        check(counts.pop(kind) == 1 and list(counts.values()) == [0],
              f"slice9 projector {backend} packed={packed}: launches "
              f"{ring_select.launches} ring, {scatter_select.launches} "
              f"scatter")
    check(_bits_equal(outs["ring", True], outs["pallas-ring", True]),
          "ring packed differs from the pallas-ring projector")
    img = outs["ring", False][0]
    check(img.shape == (b, H, W, ds.num_image_channels)
          and bool(torch.isfinite(img).all()),
          f"slice9 projector: image {tuple(img.shape)}, finite "
          f"{bool(torch.isfinite(img).all())}")
    print(f"slice9 projectors B={b}: one launch each for ring (exact, "
          f"packed), pallas-ring, sort-sentinel (exact, packed); ring packed "
          f"bit-equal to pallas-ring; the {ds.num_image_channels}-channel "
          f"image (normals included) finite [{gpu}]")

    times = {}
    rk, sk = words["ring carry"], words["sort-sentinel carry"]
    landed = int((ring_select(*rk)[0] != SENTINEL_RING).sum())
    nbytes = 8 * b * n + 8 * landed + 12 * b * n_pix
    times["ring carry"] = (graph_ms(lambda: ring_select(*rk)),
                           graph_ms(lambda: ring_select_reference(*rk)),
                           nbytes / HBM_BYTES_PER_S * 1e3, None, nbytes,
                           landed)
    key, *_, rq_bits = sk
    slot_pix = key >> rq_bits
    live = (key != SENTINEL) & (slot_pix < n_pix)
    slot = torch.where(live, slot_pix, n_pix).long()
    comp = ((key & ((1 << rq_bits) - 1)).long() << 32) | torch.arange(
        n, dtype=torch.int64, device=dev)
    best = torch.full((b, n_pix + 1), 2**63 - 1, dtype=torch.int64,
                      device=dev)
    landed = int((scatter_select(*sk)[0] != SENTINEL).sum())
    nbytes = 4 * b * n + 8 * landed + 12 * b * n_pix
    times["sort-sentinel carry"] = (
        graph_ms(lambda: scatter_select(*sk)),
        graph_ms(lambda: scatter_select_reference(*sk)),
        nbytes / HBM_BYTES_PER_S * 1e3,
        graph_ms(lambda: best.scatter_reduce_(1, slot, comp, reduce="amin",
                                              include_self=True)),
        nbytes, landed)
    for label, (k_ms, p_ms, bound, lib, nb, ld) in times.items():
        print(f"timing slice9 {label} B={b} (the tree's scans, index "
              f"payloads): device (graph replay) kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms"
              + (f", scatter_reduce_ amin on the int64 composite "
                 f"{lib:.4f} ms" if lib is not None else "")
              + f"; bound {bound * 1e3:.3f} us ({nb} B at 3.35 TB/s, {ld} "
              f"pixels landed) [{gpu}]")
    del planes, valid, cols, words, rk, sk, slot, comp, best, outs
    torch.cuda.empty_cache()
    return 0, {k: v[:4] for k, v in times.items()}


def phase_slice9_steps(dev, gpu, root, step_ms, over=None):
    """Items 2 and 4: the slice's configuration, 3 + 10 bf16 steps at B =
    144 on the tree's first training batch (one ring launch a step), and
    the second configuration, 3 steps (one scatter launch a step); one
    float32 step of each on the card against the CPU on 2 windows.
    Returns (ms/step, ring launches, scatter launches)."""
    from deeplio_tpu_torch.data.dataset import build_dataset
    out = {}
    for label, fc in (("slice9", False), ("slice9 fc", True)):
        cfg = load_config_dict(slice9_dict(root, over, fc=fc))
        host = next(build_dataset(cfg, "train").iter_batches(
            cfg.train.batch_size, shuffle=False))
        model = build_model(cfg, device=dev, seed=0)
        state = create_train_state(cfg, model)
        train_step, _ = build_train_step(cfg)
        raw = batch_to_device(host, dev)
        steps = 3 if fc else TIMED_STEPS
        ms, ring, scatter, vals = _timed_steps(state, train_step, raw, steps,
                                               packed=packed_route(cfg))
        want = (0, steps) if fc else (steps, 0)
        check((ring, scatter) == want, f"{label}: {ring} ring and {scatter} "
              f"scatter launches in {steps} steps, want {want}")
        pairs = cfg.train.batch_size * cfg.datasets.num_pairs
        print(f"{label} ({cfg.datasets.projection.backend} exact, channels "
              f"{'+'.join(cfg.datasets.channels)}, imu "
              f"{cfg.model.imu.name}/{cfg.model.imu.rnn_type}"
              f"{' bidirectional' if cfg.model.imu.bidirectional else ''}, "
              f"odom {cfg.model.odom.name}/{cfg.model.odom.rnn_type}, "
              f"tower part {cfg.model.lidar.part}): {steps} steps of "
              f"{cfg.train.batch_size} windows x "
              f"{cfg.datasets.sequence_size} tree frames in "
              f"{cfg.model.compute_dtype}: {ms:.2f} ms/step, "
              f"{pairs / ms * 1e3:.1f} pairs/s (slice 2's step, same call: "
              f"{step_ms:.2f} ms/step); ring launches {ring}, scatter "
              f"{scatter}; loss {vals[0]['loss']:.5g} -> "
              f"{vals[-1]['loss']:.5g} [{gpu}]")
        out[label] = (ms, ring, scatter)
        del state, model, train_step, raw
        torch.cuda.empty_cache()
        f32 = slice9_dict(root, over, fc=fc)
        f32["compute-dtype"] = "float32"
        f32["deeplio"]["dropout"] = 0.0
        f32 = load_config_dict(f32)
        seq = cfg.datasets.sequence_size        # scans are [B * S, N]
        small = {k: v[:2 * seq] if k.startswith("points_") else v[:2]
                 for k, v in host.items()}
        phase_train_vs_cpu(dev, f32, f"{label} f32",
                           host=_projected_on_card(dev, gpu, f32, small))
    return out


def _projected_on_card(dev, gpu, cfg, host):
    """``host`` with its scans replaced by their images projected on the
    card (``images`` [B, S, H, W, C] float32, the projection cache's
    contract), so that the card's and the CPU's steps see the same input.
    The CPU's projection differs from the card's where ``atan2``/``asin``
    round a boundary point into the next pixel, and the normals turn each
    such flip into changes of order 1 in its neighbours' normals: both
    are measured and printed here."""
    ds = cfg.datasets
    fn = make_projector(ds.projection, ds.channels, ds.mean, ds.std,
                        layout="planes")
    keys = ("points_x", "points_y", "points_z", "points_rem")
    out = {}
    for d in (dev, torch.device("cpu")):
        img, mask = fn([torch.from_numpy(host[k]).to(d) for k in keys],
                       torch.from_numpy(host["points_valid"]).to(d))
        out[d.type] = (img.cpu(), mask.cpu())
    (gi, gm), (ci, cm) = out[dev.type], out["cpu"]
    flips = int((gm != cm).sum())
    other = int((gi[..., :-3] != ci[..., :-3]).any(-1).sum())
    nrm = float((gi[..., -3:] - ci[..., -3:]).abs().max()) \
        if "normals" in ds.channels else 0.0
    check(flips <= MAX_FLIP_FRACTION * host["points_valid"].size,
          f"projection card vs CPU: {flips} mask pixels differ")
    print(f"projection card vs CPU ({gm.shape[0]} scans, "
          f"{ds.projection.backend}): {flips} mask pixels and {other} "
          f"pixels of the other channels differ (trig ulps move boundary "
          f"points), the normals by up to {nrm:.3g}; the float32 step "
          f"below feeds both sides the card's images [{gpu}]")
    b = host["x_gt"].shape[0]
    images = gi.reshape((b, -1) + tuple(gi.shape[1:])).numpy()
    return {"images": images, **{k: v for k, v in host.items()
                                 if not k.startswith("points_")}}


def phase_slice9_cli(dev, gpu, root, over=None):
    """Item 3: ``cli.train --epochs 1`` with the slice's configuration on
    the tree (one ring launch per step and validation batch), ``cli.test``
    of its checkpoint with ``backend: sort-sentinel`` (one scatter launch
    per eval batch of 144 scans), ``cli.stream`` with ``backend: ring``
    (one ring launch a tick). Returns (ring launches, scatter launches,
    ms/step in fit)."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    from deeplio_tpu_torch.cli import train as train_cli
    d = slice9_dict(root, over)
    cfg_path = root / "slice9.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(d, f)
    wd = str(root / "slice9_run")
    common = ["-c", str(cfg_path), "--workdir", wd, "--device", dev.type]
    _zero_counts()
    t0 = time.perf_counter()
    train_cli.main(common + ["--epochs", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ring, scatter = ring_select.launches, scatter_select.launches
    packed = packed_route(load_config_dict(d))
    io_take(ring + scatter if packed else 0)
    records = _records(wd)
    steps = [r["step"] for r in records if r["split"] == "train"]
    n_val = sum(1 for r in records if r["split"] == "val")
    check(ring == len(steps) + n_val and scatter == 0 and steps == [1, 2]
          and all(np.isfinite(r["loss"]) for r in records),
          f"slice9 cli train: steps {steps}, {n_val} validations, {ring} "
          f"ring and {scatter} scatter launches")
    gaps = _step_gaps(records, range(1, len(steps)), len(steps), every=1000)
    med = float(np.median(gaps))
    print(f"slice9 cli train: 1 epoch ({len(steps)} steps, {n_val} "
          f"validation batch) in {secs:.2f} s; {med:.2f} ms/step in fit "
          f"(step 1 to 2); ring launches {ring} [{gpu}]")

    d["datasets"]["backend"] = "sort-sentinel"
    eval_path = root / "slice9_sentinel.yaml"
    with open(eval_path, "w") as f:
        yaml.safe_dump(d, f)
    scat = phase_cli_eval(
        gpu, ["-c", str(eval_path), "--workdir", wd, "--device", dev.type],
        load_config(eval_path), "slice9 sort-sentinel exact",
        ["--out", str(root / "slice9_eval")], kernel="scatter")

    _zero_counts()
    scores = stream_cli.main(common + ["--chunk", "16"])
    launches = ring_select.launches
    io_take(launches if packed else 0)
    (name, s), = scores.items()
    check(launches == s["frames"] and np.isfinite(s["ate_m"])
          and scatter_select.launches == 0,
          f"slice9 cli stream: {launches} ring launches for {s['frames']} "
          f"frames")
    print(f"slice9 cli stream (ring exact, B = 1): {name}, {s['frames']} "
          f"frames at {s['frames_per_sec']:.1f} frames/s, ATE "
          f"{s['ate_m']:.4f} m, ring launches {launches} [{gpu}]")
    return ring + launches, scat, med


def phase_slice9(dev, gpu, root, step_ms, over=None):
    """Phase 16 on phase 11's tree: every backend and channel and the rest
    of the zoo. Returns (ring launches, scatter launches, worst
    difference, route timings)."""
    worst, times = phase_slice9_routes(dev, gpu, root, over)
    steps = phase_slice9_steps(dev, gpu, root, step_ms, over)
    c_ring, c_scatter, fit_ms = phase_slice9_cli(dev, gpu, root, over)
    cfg_path = root / "slice9_pretrain.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(slice9_dict(root, over), f)
    _, p_ms, p_launches, spy, _ = _pretrain_run(
        dev, gpu, cfg_path, root / "slice9_pretrained", PRETRAIN_GEO_STEPS,
        1, "exact-z geometric labels (ring exact input)")
    key, idx = spy.first[0][:2]
    check(torch.equal(idx[0], torch.arange(key.shape[1], dtype=torch.int32,
                                           device=dev)),
          "exact-z labels: the scatter launch carried no index payloads")
    ring = (steps["slice9"][1] + steps["slice9 fc"][1] + c_ring
            + p_launches[0])
    scatter = (steps["slice9"][2] + steps["slice9 fc"][2] + c_scatter
               + p_launches[1])
    print(f"slice9: bare step {steps['slice9'][0]:.2f} ms/step, fc "
          f"{steps['slice9 fc'][0]:.2f}, fit {fit_ms:.2f}, exact-z "
          f"pretraining {p_ms:.2f} ms/step; launches ring {ring}, scatter "
          f"{scatter} [{gpu}]")
    return ring, scatter, worst, times


# ------------------------------------------------------------- slice 10

# phase 17: bench/slice10.py's two configurations on phase 11's tree; the
# kernel each runs, and its plain version
SLICE10_KERNELS = {"A": ("ring", ring_select_reference),
                   "B": ("scatter", scatter_select_reference)}


def slice10_cfg_dict(root, which, over=None):
    """Phase 11's configuration on its tree (:func:`kitti_dict`) with
    configuration ``which`` of ``bench/slice10.py`` set: ``A`` the
    factorized stem, mixed Fires and SGD through the ring kernel, ``B``
    the s2d-pre stem, fused Fires, AdamW and ``param-dtype: bfloat16``
    through the scatter kernel."""
    return slice10_dict(kitti_dict(root, over), which)


def _spy_step(state, train_step, raw, kernel, plain, label):
    """One training step with ``kernel``'s selection spied on: its launch
    is held against ``plain`` on the same card tensors, bit for bit.
    Returns (state, the spied arguments, the launch's outputs, the step's
    metrics)."""
    from deeplio_tpu_torch.ops import projection_ring as pring
    from deeplio_tpu_torch.ops import projection_scatter as pscat
    mod, attr = {"ring": (pring, "ring_select"),
                 "scatter": (pscat, "scatter_select")}[kernel]
    spy = FirstCall(getattr(mod, attr))
    setattr(mod, attr, spy)
    try:
        state, m = train_step(state, raw)
    finally:
        setattr(mod, attr, spy.op)
    check(spy.first is not None, f"{label}: the step made no {kernel} "
          f"selection")
    args, outs = spy.first
    worst = max(int((a.long() - r.long()).abs().max())
                for a, r in zip(outs, plain(*args)))
    b = raw["points_valid"].shape[0]
    check(worst == 0 and args[0].shape[0] == b,
          f"{label}: the step's {kernel} selection at B = "
          f"{args[0].shape[0]} differs from the plain version by {worst}")
    return state, args, outs, _metrics(m)


def selection_bound(kernel, args, outs):
    """The bytes a step's selection must move and their time at 3.35
    TB/s: its keys (the ring kernel also its pixel ids), two payload words
    per landed pixel, three words per pixel written (phases 11 and 16's
    bound). Returns (bytes, ms, landed pixels)."""
    b, n = args[0].shape
    empty = SENTINEL_RING if kernel == "ring" else SENTINEL
    landed = int((outs[0] != empty).sum())
    nbytes = ((8 if kernel == "ring" else 4) * b * n + 8 * landed
              + 12 * b * H * W)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3, landed


def phase_slice10_steps(dev, gpu, root, step_ms, over=None):
    """A and B: 3 + 10 bf16 steps at B = 144 on the tree's first training
    batch, the first warm-up step's selection spied and held bit for bit
    against its plain version, then exactly one launch of the
    configuration's kernel a step and none of the other; the kernel's
    device time on the step's own selection inputs; a profile of 2 steps;
    one float32 step on the card against the CPU on 2 windows (both fed
    the card's images); for A, 20 SGD steps on one batch must lower the
    loss. Returns {which: (ms/step, ring launches, scatter launches,
    kernel ms, kernel bound ms)}."""
    from deeplio_tpu_torch.data.dataset import build_dataset
    out = {}
    for which, (kernel, plain) in SLICE10_KERNELS.items():
        label = f"slice10 {which}"
        cfg = load_config_dict(slice10_cfg_dict(root, which, over))
        host = next(build_dataset(cfg, "train").iter_batches(
            cfg.train.batch_size, shuffle=False))
        model = build_model(cfg, device=dev, seed=0)
        state = create_train_state(cfg, model)
        train_step, _ = build_train_step(cfg)
        raw = batch_to_device(host, dev)
        state, args, outs, _ = _spy_step(state, train_step, raw, kernel,
                                         plain, label)
        ms, ring, scatter, vals = _timed_steps(state, train_step, raw,
                                               warmup=WARMUP_STEPS - 1,
                                               packed=packed_route(cfg))
        want = (TIMED_STEPS, 0) if kernel == "ring" else (0, TIMED_STEPS)
        check((ring, scatter) == want, f"{label}: {ring} ring and "
              f"{scatter} scatter launches in {TIMED_STEPS} steps, want "
              f"{want}")
        op = ring_select if kernel == "ring" else scatter_select
        k_ms = graph_ms(lambda: op(*args))
        b = args[0].shape[0]
        nbytes, bound_ms, landed = selection_bound(kernel, args, outs)
        names = RING_KERNELS if kernel == "ring" else SCATTER_KERNELS
        phase_train_profile(state, train_step, raw, gpu, ms,
                            kernel=(label, names))
        lc, oc = cfg.model.lidar, cfg.optim
        pairs = cfg.train.batch_size * cfg.datasets.num_pairs
        print(f"{label} ({cfg.datasets.projection.backend}, stem {lc.stem}, "
              f"fire {lc.fire}, optimizer {oc.name} lr {oc.lr:g} momentum "
              f"{oc.momentum:g} weight-decay {oc.weight_decay:g}, "
              f"param-dtype {cfg.model.param_dtype} with float32 "
              f"parameters): {TIMED_STEPS} steps of {cfg.train.batch_size} "
              f"windows x {cfg.datasets.sequence_size} tree frames in "
              f"{cfg.model.compute_dtype}: {ms:.2f} ms/step, "
              f"{pairs / ms * 1e3:.1f} pairs/s (slice 2's step, same call: "
              f"{step_ms:.2f} ms/step, {TRAIN_PAIRS / step_ms * 1e3:.1f} "
              f"pairs/s); ring launches {ring}, scatter {scatter}; the "
              f"{kernel} kernel on the step's selection (B = {b}) "
              f"{k_ms:.4f} ms device time, bound {bound_ms * 1e3:.3f} us "
              f"({nbytes} B at 3.35 TB/s, {landed} pixels landed), "
              f"bit-equal to its plain version; loss {vals[0]['loss']:.5g} "
              f"-> {vals[-1]['loss']:.5g} [{gpu}]")
        out[which] = (ms, ring, scatter, k_ms, bound_ms)
        del state, model, train_step, args, outs
        torch.cuda.empty_cache()
        if which == "A":
            d = slice10_cfg_dict(root, which, over)
            d["deeplio"]["dropout"] = 0.0
            cfg = load_config_dict(d)
            state = create_train_state(cfg, build_model(cfg, device=dev,
                                                        seed=0))
            train_step, _ = build_train_step(cfg)
            losses = []
            for _ in range(FIT_STEPS):
                state, m = train_step(state, raw)
                losses.append(m["loss"])
            losses = [float(v) for v in losses]
            check(np.isfinite(losses).all() and losses[-1] < losses[0],
                  f"{label}: SGD on one batch: loss {losses[0]:.5g} -> "
                  f"{losses[-1]:.5g}")
            print(f"{label}: {FIT_STEPS} SGD steps on one batch (no "
                  f"dropout): loss {losses[0]:.5g} -> {losses[-1]:.5g}, min "
                  f"{min(losses):.5g} [{gpu}]")
            del state, train_step
        del raw
        torch.cuda.empty_cache()
        f32 = slice10_cfg_dict(root, which, over)
        f32["compute-dtype"] = "float32"
        f32["deeplio"]["dropout"] = 0.0
        f32 = load_config_dict(f32)
        seq = cfg.datasets.sequence_size        # scans are [B * S, N]
        small = {k: v[:2 * seq] if k.startswith("points_") else v[:2]
                 for k, v in host.items()}
        phase_train_vs_cpu(dev, f32, f"{label} f32",
                           host=_projected_on_card(dev, gpu, f32, small))
    return out


def _optimizer_state_equal(got, want) -> bool:
    """Two optimizer ``state_dict``s' per-parameter tensors, bit for
    bit."""
    got, want = got["inner"]["state"], want["inner"]["state"]
    return bool(want) and got.keys() == want.keys() and all(
        all(torch.equal(got[i][k].cpu(), v.cpu()) for k, v in st.items()
            if isinstance(v, torch.Tensor))
        for i, st in want.items())


def phase_slice10_cli(dev, gpu, root, over=None):
    """A: ``cli.train --epochs 1`` (one ring launch per step and
    validation batch), the checkpoint restored into a fresh Trainer with
    SGD's momentum buffers bit-equal, ``--resume`` for one more epoch,
    ``cli.stream`` (one ring launch a tick). B: ``cli.train --epochs 1``
    (scatter), ``cli.test`` (one scatter launch per eval batch of 144
    scans), ``cli.export --chunk 4``: the artifact bit-equal to the eager
    bf16 step, one scatter launch a tick. Returns (ring launches, scatter
    launches, {which: ms/step in fit})."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    from deeplio_tpu_torch.cli import train as train_cli
    from deeplio_tpu_torch.cli._common import restore_trainer
    ring_n = scatter_n = 0
    fit_ms = {}
    for which, (kernel, _) in SLICE10_KERNELS.items():
        label = f"slice10 {which}"
        cfg_path = root / f"slice10_{which}.yaml"
        with open(cfg_path, "w") as f:
            yaml.safe_dump(slice10_cfg_dict(root, which, over), f)
        cfg = load_config(cfg_path)
        wd = str(root / f"slice10_{which}_run")
        common = ["-c", str(cfg_path), "--workdir", wd, "--device", dev.type]
        op = ring_select if kernel == "ring" else scatter_select
        _zero_counts()
        t0 = time.perf_counter()
        train_cli.main(common + ["--epochs", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = op.launches
        other = ring_select.launches + scatter_select.launches - launched
        io_take(launched + other if packed_route(cfg) else 0)
        records = _records(wd)
        steps = [r["step"] for r in records if r["split"] == "train"]
        n_val = sum(1 for r in records if r["split"] == "val")
        check(launched == len(steps) + n_val and other == 0
              and steps == [1, 2]
              and all(np.isfinite(r["loss"]) for r in records),
              f"{label} cli train: steps {steps}, {n_val} validations, "
              f"{launched} {kernel} and {other} other launches")
        gaps = _step_gaps(records, range(1, len(steps)), len(steps),
                          every=1000)
        fit_ms[which] = float(np.median(gaps))
        print(f"{label} cli train: 1 epoch ({len(steps)} steps, {n_val} "
              f"validation batch) in {secs:.2f} s; {fit_ms[which]:.2f} "
              f"ms/step in fit (step 1 to 2); {kernel} launches {launched} "
              f"[{gpu}]")
        ring_n += ring_select.launches
        scatter_n += scatter_select.launches
        if which == "A":
            ckpt = torch.load(pathlib.Path(wd) / "checkpoints" /
                              str(steps[-1]) / "state.pt",
                              map_location="cpu", weights_only=True)
            trainer = restore_trainer(cfg, wd, dev.type)
            try:
                restored = trainer.state.optimizer.state_dict()
            finally:
                trainer.close()
            bufs = [st.get("momentum_buffer") for st in
                    ckpt["optimizer"]["inner"]["state"].values()]
            check(ckpt["optimizer"]["name"] == "sgd"
                  and all(b is not None for b in bufs)
                  and _optimizer_state_equal(restored, ckpt["optimizer"]),
                  f"{label}: the restored SGD momentum buffers differ from "
                  f"the checkpoint's")
            _zero_counts()
            train_cli.main(common + ["--epochs", "1", "--resume"])
            torch.cuda.synchronize()
            io_take(ring_select.launches + scatter_select.launches
                    if packed_route(cfg) else 0)
            records = _records(wd)
            steps = [r["step"] for r in records if r["split"] == "train"]
            check(steps == [1, 2, 3, 4] and ring_select.launches == 3,
                  f"{label} cli train --resume: steps {steps}, "
                  f"{ring_select.launches} ring launches")
            print(f"{label} cli train --resume: the checkpoint's {len(bufs)} "
                  f"SGD momentum buffers restored bit-equal; steps 3 to 4, "
                  f"ring launches {ring_select.launches} [{gpu}]")
            ring_n += ring_select.launches
            _zero_counts()
            scores = stream_cli.main(common + ["--chunk", "16"])
            io_take(ring_select.launches + scatter_select.launches
                    if packed_route(cfg) else 0)
            (name, s), = scores.items()
            check(ring_select.launches == s["frames"]
                  and scatter_select.launches == 0
                  and np.isfinite(s["ate_m"]),
                  f"{label} cli stream: {ring_select.launches} ring "
                  f"launches for {s['frames']} frames")
            print(f"{label} cli stream (factorized stem, B = 1): {name}, "
                  f"{s['frames']} frames at {s['frames_per_sec']:.1f} "
                  f"frames/s, ATE {s['ate_m']:.4f} m, ring launches "
                  f"{ring_select.launches} [{gpu}]")
            ring_n += ring_select.launches
        else:
            scatter_n += phase_cli_eval(gpu, common, cfg,
                                        f"{label} s2d-pre", kernel="scatter")
            # the first 4 chunks (16 frames): the export itself is the
            # phase's longest part
            scatter_n += phase_cli_export(dev, gpu, common, cfg, wd,
                                          kernel="scatter", max_chunks=4)
    return ring_n, scatter_n, fit_ms


def phase_slice10(dev, gpu, root, step_ms, over=None):
    """Phase 17 on phase 11's tree: every optimizer, stem and Fire. The
    two configurations' bare steps, command lines and pretraining (4
    steps of 16 scans under each tower, each snapshot grafted into a
    Trainer). Returns (ring launches, scatter launches, step timings)."""
    steps = phase_slice10_steps(dev, gpu, root, step_ms, over)
    c_ring, c_scatter, fit_ms = phase_slice10_cli(dev, gpu, root, over)
    ring = sum(v[1] for v in steps.values()) + c_ring
    scatter = sum(v[2] for v in steps.values()) + c_scatter
    pre_ms = {}
    for which, (kernel, _) in SLICE10_KERNELS.items():
        d = slice10_cfg_dict(root, which, over)
        cfg_path = root / f"slice10_{which}_pretrain.yaml"
        with open(cfg_path, "w") as f:
            yaml.safe_dump(d, f)
        out = root / f"slice10_{which}_pretrained"
        per_step = (1, 1) if kernel == "ring" else (0, 2)
        _, pre_ms[which], launches, _, _ = _pretrain_run(
            dev, gpu, cfg_path, out, PRETRAIN_GEO_STEPS, 1,
            f"slice10 {which} geometric labels", per_step)
        graft = phase_pretrain_graft(
            dev, gpu, root, out, d=d, label=f" slice10 {which}",
            want=(1, 0) if kernel == "ring" else (0, 1))
        ring += launches[0] + graft[0]
        scatter += launches[1] + graft[1]
    print(f"slice10: bare step A {steps['A'][0]:.2f} ms/step, B "
          f"{steps['B'][0]:.2f}, slice 2 {step_ms:.2f} (same call); fit A "
          f"{fit_ms['A']:.2f}, B {fit_ms['B']:.2f} ms/step; pretraining A "
          f"{pre_ms['A']:.2f}, B {pre_ms['B']:.2f} ms/step; the ring kernel "
          f"in A's step {steps['A'][3]:.4f} ms (bound "
          f"{steps['A'][4] * 1e3:.3f} us), the scatter kernel in B's "
          f"{steps['B'][3]:.4f} ms (bound {steps['B'][4] * 1e3:.3f} us); "
          f"launches ring {ring}, scatter {scatter} [{gpu}]")
    return ring, scatter, steps


# phase 18: data parallelism. The slice-2 configuration (DP_STEP's
# float32 twin: no augmentation, no dropout, SGD, so the parameters
# compare element by element after the update) and the KITTI tree's
# configuration (ring kernel), two ranks of DP_RANK_B windows each on the
# one card over gloo (NCCL refuses two ranks on one GPU); DP_RING_STEPS
# timed bf16 steps a rank after the spied one.
DP_WORLD, DP_RING_STEPS, DP_TIMEOUT_S = 2, 3, 300
DP_RANK_B = TRAIN_B // DP_WORLD
DP_SGD = {"name": "sgd", "lr": 0.01, "momentum": 0.9}
# a float32 data-parallel step against the mesh-less step on the same
# weights and batch (16 windows): the ranks take their BatchNorm
# statistics as flax does (float32 mean and mean of squares, averaged) and
# their gradients' mean in another order than the mesh-less step's one
# sum. The loss and sx/sq within DP_LOSS_RTOL of their magnitude, each
# BatchNorm statistic within DP_STATS_RTOL of its leaf's largest value,
# the SGD update within DP_UPDATE_MAX of its largest element, element by
# element, and DP_UPDATE_L2 in L2. Measured on an H100 80GB
# HBM3 (world 1 over NCCL / two gloo ranks): loss 0 / 0, sx/sq 0 / 0,
# statistics 3.4e-7 / 2.3e-7, update 7.8e-6 / 7.3e-6 and 1.4e-4 / 1.0e-4.
DP_LOSS_RTOL, DP_STATS_RTOL, DP_UPDATE_MAX, DP_UPDATE_L2 = (
    1e-5, 1e-5, 2e-4, 2e-3)


def dp_dict(f32: bool = False, over=None):
    """The slice configuration as a dict; ``f32``: float32, no
    augmentation, no dropout, SGD. ``over`` replaces ``datasets`` keys
    and ``compute_dtype`` (the CPU rehearsal)."""
    with open(CONFIG) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"backend": "pallas", "augment-yaw": not f32})
    if f32:
        d["compute-dtype"] = "float32"
        d["deeplio"]["dropout"] = 0.0
        d["lidar-feat-pointseg"]["dropout"] = 0.0
        d["optimizer"] = dict(DP_SGD)
    over = dict(over or {})
    if "compute_dtype" in over:
        d["compute-dtype"] = over.pop("compute_dtype")
    d["datasets"].update({k.replace("_", "-"): v for k, v in over.items()})
    return d


def _dp_kernel_ms(kernel, args, outs):
    """The kernel's device time on a step's own selection inputs (graph
    replay) and its bound: (ms, bound ms, B)."""
    op = ring_select if kernel == "ring" else scatter_select
    return (graph_ms(lambda: op(*args)), selection_bound(kernel, args,
                                                         outs)[1],
            int(args[0].shape[0]))


def _dp_result(state, metrics):
    """What a float32 step is held by: its metrics, sx/sq after it and the
    model's variables (flat, numpy)."""
    return {"metrics": metrics,
            "loss_params": {k: float(v) for k, v in
                            state.loss_params.items()},
            "variables": _flat(to_flax_variables(state.model))}


def _dp_compare(label, got, want, old):
    """``got`` (a data-parallel float32 step's :func:`_dp_result`) against
    ``want`` (the mesh-less step's) from the variables ``old``; prints and
    checks the DP_* tolerances."""
    rel = {k: abs(got["metrics"][k] - w) / max(abs(w), 1e-12)
           for k, w in want["metrics"].items()}
    lp = max([abs(got["loss_params"][k] - w) / max(abs(w), 1e-12)
              for k, w in want["loss_params"].items()] or [0.0])
    g, w = got["variables"], want["variables"]
    stats = max(float(np.abs(g[k] - w[k]).max()
                      / max(np.abs(w[k]).max(), 1e-3))
                for k in w if k.startswith("batch_stats/"))
    params = sorted(k for k in w if k.startswith("params/"))
    du = np.concatenate([(g[k] - old[k]).ravel() for k in params])
    dw = np.concatenate([(w[k] - old[k]).ravel() for k in params])
    umax = float(np.abs(du - dw).max() / np.abs(dw).max())
    ul2 = float(np.linalg.norm(du - dw) / np.linalg.norm(dw))
    print(f"{label}: float32 SGD step against the mesh-less step on the "
          f"same weights and {TRAIN_B} windows: loss rel err "
          f"{rel['loss']:.3g}, "
          f"loss_x {rel['loss_x']:.3g}, loss_q {rel['loss_q']:.3g}, "
          f"grad_norm {rel['grad_norm']:.3g}, sx/sq after the update "
          f"{lp:.3g} (tolerance {DP_LOSS_RTOL}); BatchNorm statistics "
          f"{stats:.3g} ({DP_STATS_RTOL}); update max {umax:.3g} "
          f"({DP_UPDATE_MAX}), L2 {ul2:.3g} ({DP_UPDATE_L2})")
    check(rel["loss"] <= DP_LOSS_RTOL and lp <= DP_LOSS_RTOL,
          f"{label}: loss or sx/sq against the mesh-less step")
    check(stats <= DP_STATS_RTOL, f"{label}: BatchNorm statistics against "
          f"the mesh-less step")
    check(umax <= DP_UPDATE_MAX and ul2 <= DP_UPDATE_L2,
          f"{label}: the update against the mesh-less step")


def _dp_rank(rank, world, port, device, tmp, root, over, out):
    """One of the gloo ranks of phase 18, on ``device``: (a) the float32
    step on its rows of the slice-2 batch (one scatter launch, the
    selection bit-equal to the plain version); (b) 1 + DP_RING_STEPS bf16
    steps of the tree's configuration on its rows of the first batch (one
    ring launch a step, the first step's selection bit-equal), timed; (c)
    ``Trainer.fit(epochs=1)`` on the tree. Puts (rank, ok, result or
    traceback) on ``out``; the float32 step's variables go to
    ``<tmp>/rank<r>.npz``."""
    import traceback

    import torch.distributed as dist

    from deeplio_tpu_torch.data.dataset import build_dataset
    from deeplio_tpu_torch.parallel import (
        make_mesh,
        maybe_initialize,
        shard_batch,
    )

    label = f"dp gloo rank {rank}/{world}"
    if device == "cpu":
        _cpu_rehearsal()
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        t_start = time.perf_counter()
        maybe_initialize(f"localhost:{port}", world, rank, backend="gloo")
        mesh = make_mesh(device=device)
        dev = mesh.device
        res = {"device": str(dev)}
        # (a) float32, scatter kernel
        host = np.load(pathlib.Path(tmp) / "host.npz")
        host = {k: np.ascontiguousarray(v) for k, v in
                shard_batch(mesh, dict(host)).items()}
        cfg = load_config_dict(dp_dict(True, over))
        state = create_train_state(cfg, build_model(cfg, device=dev, seed=0),
                                   mesh=mesh)
        train_step, _ = build_train_step(cfg, mesh)
        raw = batch_to_device(host, dev)
        _zero_counts()
        state, args, outs, m = _spy_step(state, train_step, raw, "scatter",
                                         scatter_select_reference,
                                         f"{label} float32")
        res["f32"] = (scatter_select.launches, ring_select.launches,
                      int(args[0].shape[0]))
        io_take(sum(res["f32"][:2]) if packed_route(cfg) else 0)
        del args, outs
        r = _dp_result(state, m)
        np.savez(pathlib.Path(tmp) / f"rank{rank}.npz", **r["variables"])
        res["f32_metrics"], res["f32_loss_params"] = (r["metrics"],
                                                      r["loss_params"])
        del state, train_step, raw, host
        # (b) bf16, ring kernel, the tree's first batch
        cfg = kitti_config(root, over)
        host = next(build_dataset(cfg, "train").iter_batches(
            cfg.train.batch_size, shuffle=False, process_index=rank,
            process_count=world))
        state = create_train_state(cfg, build_model(cfg, device=dev, seed=0),
                                   mesh=mesh)
        train_step, _ = build_train_step(cfg, mesh)
        raw = batch_to_device(host, dev)
        _zero_counts()
        state, args, outs, _ = _spy_step(state, train_step, raw, "ring",
                                         ring_select_reference,
                                         f"{label} ring")
        spied = (ring_select.launches, scatter_select.launches)
        ms, ring, scatter, vals = _timed_steps(state, train_step, raw,
                                               steps=DP_RING_STEPS, warmup=0,
                                               packed=packed_route(cfg))
        k_ms, bound_ms, b = _dp_kernel_ms("ring", args, outs)
        res["ring"] = (spied, ring, scatter, b, ms, vals[0]["loss"],
                       vals[-1]["loss"], k_ms, bound_ms)
        del args, outs
        del state, train_step, raw, host
        torch.cuda.empty_cache()
        # (c) the Trainer on the tree
        trainer = Trainer(cfg, str(pathlib.Path(root) / "dp_fit"),
                          device=dev)
        _zero_counts()
        t0 = time.perf_counter()
        trainer.fit(epochs=1)
        torch.cuda.synchronize()
        res["fit"] = (ring_select.launches, scatter_select.launches,
                      trainer.step, trainer.mesh.data,
                      (time.perf_counter() - t0) * 1e3)
        io_take(sum(res["fit"][:2]) if packed_route(cfg) else 0)
        trainer.close()
        # the prologue's launches on the rank's main paths (a, the timed
        # steps of b, c), each read by io_take
        res["io"] = sum(IO_LAUNCHES.values())
        res["seconds"] = time.perf_counter() - t_start
        out.put((rank, True, res))
    except BaseException:                      # reported by the parent
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cpu_rehearsal() -> None:
    """The CPU rehearsal (a rank's, or the caller's): nothing to wait for
    on a card and no launch to count, so the checks print instead of
    raising and a kernel is timed as one call of its plain version."""
    def show(cond, msg):
        if not cond:
            print(f"check failed (CPU rehearsal): {msg}")
    globals()["check"] = show
    globals()["graph_ms"] = lambda fn, *a, **k: (fn(), 0.0)[1]
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.empty_cache = lambda *a, **k: None


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_dp_one(dev, gpu, host, over=None):
    """Item 1: NCCL at world 1 through the data-parallel path (DDP, the
    synchronised BatchNorms): the first step's scatter selection spied and
    bit-equal, then WARMUP_STEPS - 1 + TIMED_STEPS bf16 steps, one scatter
    launch each, beside the mesh-less step on the same batch in the same
    call; a float32 step against the mesh-less float32 step. Returns
    (scatter launches, dp ms/step, mesh-less ms/step, the mesh-less
    float32 step's result and its starting variables)."""
    import torch.distributed as dist

    from deeplio_tpu_torch.parallel import make_mesh, maybe_initialize
    label = "dp nccl world 1"
    backend = "nccl" if dev.type == "cuda" else "gloo"
    maybe_initialize(f"localhost:{_free_port()}", 1, 0, backend=backend)
    try:
        mesh = make_mesh(device=dev)
        cfg = load_config_dict(dp_dict(over=over))
        raw = batch_to_device(host, dev)
        times = {}
        for name, m in (("mesh-less", None), ("dp", mesh)):
            state = create_train_state(cfg, build_model(cfg, device=dev,
                                                        seed=0), mesh=m)
            train_step, _ = build_train_step(cfg, m)
            if m is not None:
                state, args, outs, _ = _spy_step(
                    state, train_step, raw, "scatter",
                    scatter_select_reference, label)
                kernel = _dp_kernel_ms("scatter", args, outs)
                del args, outs
            else:
                state, _ = train_step(state, raw)
            ms, ring, scatter, vals = _timed_steps(state, train_step, raw,
                                                   warmup=WARMUP_STEPS - 1,
                                                   packed=packed_route(cfg))
            check((ring, scatter) == (0, TIMED_STEPS), f"{label} {name}: "
                  f"{ring} ring and {scatter} scatter launches in "
                  f"{TIMED_STEPS} steps")
            times[name] = (ms, scatter, vals[-1]["loss"])
            print(f"{label} profile of the {name} step:")
            phase_train_profile(state, train_step, raw, gpu, ms)
            del state, train_step
            torch.cuda.empty_cache()
        launches = times["dp"][1]
        print(f"{label} (DDP, synchronised BatchNorm, backend "
              f"{dist.get_backend()}): {TIMED_STEPS} bf16 steps of "
              f"{TRAIN_B} windows x {TRAIN_S} frames: {times['dp'][0]:.2f} "
              f"ms/step against the mesh-less step's "
              f"{times['mesh-less'][0]:.2f} timed just before it on the same batch; "
              f"scatter launches {launches}, the first step's selection at "
              f"B = {kernel[2]} bit-equal to the plain version, the kernel "
              f"on it {kernel[0]:.4f} ms device time (bound "
              f"{kernel[1] * 1e3:.3f} us); last loss {times['dp'][2]:.5g} "
              f"(mesh-less {times['mesh-less'][2]:.5g}) [{gpu}]")
        cfg = load_config_dict(dp_dict(True, over))
        base = build_model(cfg, device=dev, seed=0)
        old = _flat(to_flax_variables(base))
        results = {}
        for name, m in (("mesh-less", None), ("dp", mesh)):
            state = create_train_state(cfg, copy.deepcopy(base), mesh=m)
            train_step, _ = build_train_step(cfg, m)
            state, metrics = train_step(state, raw)
            results[name] = _dp_result(state, _metrics(metrics))
            del state, train_step
        _dp_compare(label, results["dp"], results["mesh-less"], old)
    finally:
        dist.destroy_process_group()
    return launches, times["dp"][0], times["mesh-less"][0], kernel, \
        results["mesh-less"], old


def phase_dp_two(dev, gpu, host, root, want, old, over=None):
    """Item 2: DP_WORLD gloo ranks on the one card (:func:`_dp_rank`), the
    float32 step held against ``want`` (the mesh-less float32 step from
    the variables ``old``) and the ranks against each other; the launches
    and ms/step of each rank; the fit's files written by rank 0 only.
    Returns (scatter launches, ring launches, [ring ms/step a rank])."""
    import shutil
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="dp_smoke_"))
    shutil.rmtree(pathlib.Path(root) / "dp_fit", ignore_errors=True)
    try:
        np.savez(tmp / "host.npz", **{k: v for k, v in host.items()})
        ctx = torch.multiprocessing.get_context("spawn")
        q = ctx.Queue()
        port = _free_port()
        device = "cuda:0" if dev.type == "cuda" else "cpu"
        procs = [ctx.Process(target=_dp_rank, args=(
            r, DP_WORLD, port, device, str(tmp), str(root), over, q))
            for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        for proc in procs:
            proc.start()
        results, errors = {}, []
        try:
            for _ in range(DP_WORLD):
                rank, ok, value = q.get(timeout=DP_TIMEOUT_S)
                if not ok:
                    errors.append(f"rank {rank}:\n{value}")
                    break
                results[rank] = value
        finally:
            for proc in procs:
                proc.join(timeout=60 if not errors else 5)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        secs = time.perf_counter() - t0
        check(not errors, "a gloo rank failed:\n" + "\n".join(errors))
        ranks = [results[r] for r in range(DP_WORLD)]
        variables = [dict(np.load(tmp / f"rank{r}.npz"))
                     for r in range(DP_WORLD)]
        for r in range(1, DP_WORLD):
            check(ranks[r]["f32_metrics"] == ranks[0]["f32_metrics"]
                  and all(np.array_equal(v, variables[0][k])
                          for k, v in variables[r].items()),
                  f"dp gloo: rank {r}'s state after the step differs from "
                  f"rank 0's")
        got = {"metrics": ranks[0]["f32_metrics"],
               "loss_params": ranks[0]["f32_loss_params"],
               "variables": variables[0]}
        _dp_compare(f"dp gloo world {DP_WORLD} ({DP_RANK_B} windows a "
                    f"rank)", got, want, old)
        scatter = ring = 0
        for rank, res in enumerate(ranks):
            f_scatter, f_ring, f_b = res["f32"]
            spied, r_ring, r_scatter, r_b, r_ms, l0, l1, k_ms, bound_ms = \
                res["ring"]
            fit_ring, fit_scatter, fit_steps, fit_world, fit_ms = res["fit"]
            check((f_scatter, f_ring) == (1, 0) and f_b == DP_RANK_B * TRAIN_S,
                  f"dp gloo rank {rank}: float32 step launched scatter "
                  f"{f_scatter}, ring {f_ring} at B = {f_b}")
            check(spied == (1, 0) and (r_ring, r_scatter) == (
                DP_RING_STEPS, 0), f"dp gloo rank {rank}: ring steps "
                f"launched {spied} then ring {r_ring}, scatter {r_scatter}")
            check(fit_world == DP_WORLD and fit_scatter == 0
                  and fit_ring == fit_steps + 1,
                  f"dp gloo rank {rank}: fit at world {fit_world}, "
                  f"{fit_steps} steps, ring {fit_ring}, scatter "
                  f"{fit_scatter}")
            print(f"dp gloo rank {rank}/{DP_WORLD} on {res['device']}: "
                  f"float32 step one scatter launch at B = {f_b}, bit-equal;"
                  f" tree bf16 steps at B = {r_b}: {r_ms:.2f} ms/step over "
                  f"{DP_RING_STEPS} steps, one ring launch each (the first "
                  f"bit-equal; the kernel on its selection {k_ms:.4f} ms "
                  f"device time, bound {bound_ms * 1e3:.3f} us), loss "
                  f"{l0:.5g} -> {l1:.5g}; fit(epochs=1) "
                  f"{fit_steps} steps and a validation batch in "
                  f"{fit_ms:.0f} ms, ring launches {fit_ring}; "
                  f"{res['seconds']:.1f} s in the rank [{gpu}]")
            scatter += f_scatter
            ring += r_ring + fit_ring
            IO_LAUNCHES[IO_SLICE[0]] = (IO_LAUNCHES.get(IO_SLICE[0], 0)
                                        + res["io"])
        wd = pathlib.Path(root) / "dp_fit"
        records = _records(wd)
        steps = [r["step"] for r in records if r["split"] == "train"]
        n_val = sum(r["split"] == "val" for r in records)
        labels = sorted(int(p.name) for p in (wd / "checkpoints").iterdir())
        check(steps == list(range(1, ranks[0]["fit"][2] + 1)) and n_val == 1
              and labels and labels[-1] == steps[-1]
              and (wd / "best" / "params.pt").exists()
              and (wd / "trainer_meta.json").exists()
              and not list(wd.rglob("*.tmp.*")),
              f"dp gloo fit: steps {steps}, {n_val} validations, "
              f"checkpoints {labels}")
        print(f"dp gloo fit: one metrics.jsonl with steps {steps} and "
              f"{n_val} validation, checkpoints {labels}, best/ and "
              f"trainer_meta.json, from rank 0; {secs:.1f} s for the ranks "
              f"[{gpu}]")
        return scatter, ring, [r["ring"][4] for r in ranks], \
            ranks[0]["ring"][7:9] + ranks[0]["ring"][3:4]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_dp(dev, gpu, host, root, over=None):
    """Phase 18: data parallelism (:func:`phase_dp_one`, then
    :func:`phase_dp_two` on phase 11's tree). Returns (scatter launches,
    ring launches)."""
    t0 = time.perf_counter()
    s1, dp_ms, plain_ms, scatter_k, want, old = phase_dp_one(dev, gpu, host,
                                                             over)
    s2, ring, rank_ms, ring_k = phase_dp_two(dev, gpu, host, root, want, old,
                                             over)
    print(f"dp phase: {time.perf_counter() - t0:.1f} s; world 1 (NCCL) "
          f"{dp_ms:.2f} ms/step against mesh-less {plain_ms:.2f}; gloo "
          f"ranks on the tree's batch "
          f"{', '.join(f'{v:.2f}' for v in rank_ms)} ms/step; inside the "
          f"data-parallel steps the scatter kernel {scatter_k[0]:.4f} ms at "
          f"B = {scatter_k[2]} (bound {scatter_k[1] * 1e3:.3f} us), the "
          f"ring kernel {ring_k[0]:.4f} ms at B = {ring_k[2]} "
          f"(bound {ring_k[1] * 1e3:.3f} us); launches scatter {s1 + s2}, "
          f"ring {ring} [{gpu}]")
    return s1 + s2, ring


# ------------------------------------------------------------ slice 12

IO_BATCHES = (1, 9, 16, 144)        # held bit for bit at each
IO_TIMED = (1, 16, 144)             # and timed at these
IO_PLAIN_REPS = 10                  # replays of the plain versions' graphs
IMG5_NAMES = ("x", "y", "z", "remission", "depth")
# each kernel's largest difference from its plain version (phase 19)
IO_WORST = {"prologue": 0.0, "epilogue": 0.0}


@contextlib.contextmanager
def io_counted(label: str, expect: bool = True):
    """One slice's main paths: :func:`io_take` adds the prologue launches
    of each run to ``label``'s count; with ``expect``, the slice must have
    launched some."""
    IO_SLICE[0] = label
    IO_LAUNCHES[label] = 0
    try:
        yield
    finally:
        IO_SLICE[0] = None
    n = IO_LAUNCHES[label]
    print(f"proj_io launches on the main paths of {label}: prologue {n}, "
          f"epilogue {n}")
    if expect:
        check(n > 0, f"{label}: no projection on a packed route")


@contextlib.contextmanager
def plain_io():
    """The projection's plain prologue and epilogue in place of the
    operators (the PyTorch composition the kernels replace), for a
    before/after in one call."""
    saved = (pio.proj_prologue, pio.proj_epilogue)
    pio.proj_prologue = pio.proj_prologue_reference
    pio.proj_epilogue = pio.proj_epilogue_reference
    try:
        yield
    finally:
        pio.proj_prologue, pio.proj_epilogue = saved


def io_forms(cfg):
    """The epilogue's output forms: the 5-channel image in float32, and
    the configuration's normalised channels in bfloat16, float16 and
    float32."""
    ds = cfg.datasets
    out = {"img5 f32": epilogue_form(IMG5_NAMES)}
    for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16),
                     ("f32", torch.float32)):
        out[f"norm{len(ds.channels)} {name}"] = epilogue_form(
            ds.channels, ds.mean, ds.std, dt)
    return out


def _io_bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _io_select(route, words):
    if route == "ring":
        return ring_select(*words, H * W)
    return scatter_select(*words[1:], H * W, RQ_BITS)


def _io_eargs(route, sel, n, form):
    return (*sel, n, H, W, route, form["channels"], form["mean"],
            form["std"], form["out_dtype"])


def _io_check(label, route, planes, valid, forms):
    """Both kernels against their plain versions on the same card tensors,
    bit for bit as integers (signed zeros and NaN bits count), the
    epilogue in every form. Returns (prologue words, selected words)."""
    args = (*planes, valid, H, W, FU, FD, route)
    got = proj_prologue(*args)
    want = proj_prologue_reference(*args)
    torch.cuda.synchronize()
    check(all(g.shape == w.shape for g, w in zip(got, want)),
          f"proj_prologue {label} ({route}): shapes differ")
    IO_WORST["prologue"] = max([IO_WORST["prologue"]] + [
        float((g.long() - w.long()).abs().max()) for g, w in zip(got, want)
        if g.numel()])
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"proj_prologue {label} ({route}) differs from its plain version")
    sel = _io_select(route, got)
    for name, form in forms.items():
        ea = _io_eargs(route, sel, planes[0].shape[1], form)
        gi, gm = proj_epilogue(*ea)
        wi, wm = proj_epilogue_reference(*ea)
        torch.cuda.synchronize()
        for g, w in ((gi, wi), (gm, wm)):
            g, w = g.float(), w.float()
            same = (g == w) | (g.isnan() & w.isnan())
            d = torch.where(same, 0.0, (g - w).abs().nan_to_num(
                nan=float("inf")))
            IO_WORST["epilogue"] = max(IO_WORST["epilogue"], float(d.max()))
        check(gi.dtype == wi.dtype and gi.shape == wi.shape
              and torch.equal(_io_bits(gi), _io_bits(wi))
              and torch.equal(_io_bits(gm), _io_bits(wm)),
              f"proj_epilogue {label} ({route}, {name}) differs from its "
              f"plain version")
    return got, sel


def io_edge_batch(rng):
    """Eight full-width ring scans, one edge case each: a pure invalid
    tail, interleaved invalid points, every point invalid, a NaN
    remission on valid points, ranges past the key ceiling (and 1e20 m),
    ranges of 0 and at or below 1e-6, a scan in no order, and points
    that are NaN where invalid."""
    pts = synthetic_ring_batch(rng, 8, N)
    valid = np.ones((8, N), bool)
    valid[0, N * 5 // 8:] = False
    valid[1] = rng.uniform(size=N) >= 0.3
    valid[2] = False
    pts[3, ::97, 3] = np.nan
    pts[4, ::50, :3] *= np.float32(5e3)
    pts[4, 7, :3] = np.float32(1e20)
    pts[5, ::31, :3] = 0.0
    pts[5, 5::31, :3] = np.float32(3e-7)
    pts[6] = pts[6, rng.permutation(N)]
    valid[7, ::7] = False
    pts[7, ~valid[7]] = np.nan
    return pts, valid


def io_bounds(route, words, sel, form):
    """Bytes each stage must move and their time at 3.35 TB/s: the
    prologue reads 17 B a point (four float32 planes, the valid byte) and
    writes 16 (ring: pix, key, two words) or 12; the selection as
    :func:`selection_bound`; the epilogue reads 12 B a pixel and writes
    the image and the float32 mask. Returns {stage: (bytes, ms)} with
    "projection" their sum."""
    b, n = words[1].shape
    pro = (17 + (16 if route == "ring" else 12)) * b * n
    kernel = "ring" if route == "ring" else "scatter"
    sel_bytes, _, landed = selection_bound(
        kernel, words if route == "ring" else words[1:], sel)
    c = len(form["channels"])
    size = torch.empty((), dtype=form["out_dtype"]).element_size()
    epi = (12 + c * size + 4) * b * H * W
    out = {"prologue": pro, "selection": sel_bytes, "epilogue": epi,
           "projection": pro + sel_bytes + epi}
    return {k: (v, v / HBM_BYTES_PER_S * 1e3) for k, v in out.items()}, landed


def _io_projector(cfg, route):
    ds = cfg.datasets
    proj = dataclasses.replace(
        ds.projection, backend="pallas-ring" if route == "ring" else "pallas",
        kernel_aligned="off")
    from deeplio_tpu_torch.models.zoo import DTYPES
    return make_projector(proj, ds.channels, ds.mean, ds.std,
                          out_dtype=DTYPES[cfg.model.compute_dtype],
                          layout="planes")


def _io_timings(route, planes, valid, cfg, gpu):
    """Device times (graph replay) at one B: each kernel and its plain
    version, the whole projection (``make_projector``'s function in the
    training form) and the plain composition it replaces (plain
    prologue, the selection kernel, plain epilogue), beside their bounds.
    Returns (prologue ms, plain, epilogue ms, plain, projection ms,
    plain, bounds)."""
    b, n = planes[0].shape
    form = io_forms(cfg)[f"norm{len(cfg.datasets.channels)} bf16"]
    args = (*planes, valid, H, W, FU, FD, route)
    words = proj_prologue(*args)
    sel = _io_select(route, words)
    ea = _io_eargs(route, sel, n, form)
    fn = _io_projector(cfg, route)
    bounds, landed = io_bounds(route, words, sel, form)

    def plain_projection():
        w = proj_prologue_reference(*args)
        return proj_epilogue_reference(
            *_io_eargs(route, _io_select(route, w), n, form))

    t = (graph_ms(lambda: proj_prologue(*args)),
         graph_ms(lambda: proj_prologue_reference(*args), reps=IO_PLAIN_REPS),
         graph_ms(lambda: proj_epilogue(*ea)),
         graph_ms(lambda: proj_epilogue_reference(*ea), reps=IO_PLAIN_REPS),
         graph_ms(lambda: fn(planes, valid)),
         graph_ms(plain_projection, reps=IO_PLAIN_REPS))
    print(f"timing proj_io {route} B={b} (tree scans, {landed} pixels "
          f"landed): device (graph replay) prologue {t[0]:.4f} ms (plain "
          f"{t[1]:.4f}, bound {bounds['prologue'][1] * 1e3:.3f} us), "
          f"epilogue in bf16 {t[2]:.4f} ms (plain {t[3]:.4f}, bound "
          f"{bounds['epilogue'][1] * 1e3:.3f} us), the whole projection "
          f"{t[4]:.4f} ms (plain composition {t[5]:.4f}, bound of the "
          f"three stages {bounds['projection'][1] * 1e3:.3f} us: "
          f"{bounds['projection'][0]} B at 3.35 TB/s) [{gpu}]")
    return t + (bounds,)


def tally(labels) -> str:
    """``a x2, b x1``: how often each label occurs."""
    import collections
    return ", ".join(f"{k} x{n}"
                     for k, n in collections.Counter(labels).items())


def profiled_span(fn, span: str, wrap: bool = False):
    """``fn()`` under the profiler, and what it reports for the CPU span
    ``span`` (``wrap``: a span put around the call): the device ms and
    the kernels launched by the operators inside it, each counted once
    (one event of each operator id: a span's own device time counts a
    custom operator's kernels twice, its nested events sharing the id).
    The profiler may drop records on the card's machine (``graph_work``),
    so this is a reading, not a check. Returns (fn's result, device ms,
    kernels)."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(span) if wrap else contextlib.nullcontext():
            out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    spans = [e for e in events if e.name == span
             and e.device_type.name == "CPU"]
    check(len(spans) == 1, f"{len(spans)} {span} spans in the profile")
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    by_id = {}
    for e in events:
        if (e.device_type.name == "CPU" and e.kernels
                and t0 <= e.time_range.start <= t1):
            by_id.setdefault(e.id, e)
    ks = [k for e in by_id.values() for k in e.kernels]
    return out, sum(k.duration for k in ks) / 1e3, len(ks)


def _io_step(dev, gpu, cfg, host, route, bound_ms, plain_ms):
    """``train.project`` at a B = 144 step of ``cfg``, with the kernels
    and with the plain prologue and epilogue in turns (kernels, plain,
    kernels): the span's work (``make_model_batch`` with the step's
    projector) replayed in a CUDA graph for its device ms, and its nodes
    counted (``graph_work``); one step profiled each time, and the
    profiler's reading of the span printed beside. Returns (kernel ms,
    plain ms, kernels, plain kernels)."""
    from deeplio_tpu_torch.train.step import make_model_batch
    model = build_model(cfg, device=dev, seed=0)
    state = create_train_state(cfg, model)
    train_step, _ = build_train_step(cfg)
    raw = batch_to_device(host, dev)
    projector = _io_projector(cfg, route)
    for _ in range(2):
        state, _ = train_step(state, raw)
    out = {}
    for label, ctx in (("kernels", contextlib.nullcontext),
                       ("plain", plain_io), ("kernels again",
                                             contextlib.nullcontext)):
        with ctx():
            state, _ = train_step(state, raw)
            (state, _), prof_ms, prof_k = profiled_span(
                lambda: train_step(state, raw), "train.project")

            def span():
                return make_model_batch(cfg, projector, raw)

            ms = graph_ms(span)
            nodes = graph_work(span)[0]
        out[label] = (ms, len(nodes))
        print(f"proj_io step {route} B={raw['points_valid'].shape[0]} "
              f"({label}): train.project {ms:.4f} ms of device time in "
              f"{len(nodes)} kernels ({tally(nodes)}); "
              f"the profiler's reading of the step's span: {prof_ms:.4f} "
              f"ms in {prof_k} kernels [{gpu}]")
    ms = min(out["kernels"][0], out["kernels again"][0])
    print(f"proj_io step {route}: train.project {ms:.4f} ms with the "
          f"kernels against {out['plain'][0]:.4f} ms with the plain "
          f"prologue and epilogue; {out['kernels'][1]} against "
          f"{out['plain'][1]} kernels; the projection alone: plain "
          f"composition {plain_ms:.4f} ms, bound {bound_ms * 1e3:.3f} us "
          f"[{gpu}]")
    del state, model, train_step, raw
    torch.cuda.empty_cache()
    return ms, out["plain"][0], out["kernels"][1], out["plain"][1]


def phase_proj_io(dev, gpu, root, host, over=None):
    """Phase 19: the projection's prologue and epilogue kernels. Both
    held bit for bit against their plain versions on both routes at B =
    1, 9, 16 and 144, on the tree's ring scans and slice 2's unordered
    synthetic batch, and on the edge cases, in each output form; timed
    beside their plain versions and bounds at B = 1, 16 and 144; one
    projector call profiled (3 launches on ``pallas``, 4 on
    ``pallas-ring``); a slice-2 step (scatter) and a ring-route step on
    the tree at B = 144 profiled with the kernels and with the plain
    prologue and epilogue. Returns {"prologue" | "epilogue": (ms, plain
    ms, bound ms)} at B = 144 on the ring route, and the steps."""
    from deeplio_tpu_torch.data.dataset import build_dataset
    t0 = time.perf_counter()
    ring_cfg = kitti_config(root, over)
    tree = next(build_dataset(ring_cfg, "train").iter_batches(
        ring_cfg.train.batch_size, shuffle=False))
    forms = io_forms(ring_cfg)
    keys = ("points_x", "points_y", "points_z", "points_rem")
    cases = 0
    for source, batch in (("tree", tree), ("synthetic", host)):
        planes = [torch.from_numpy(batch[k]).to(dev) for k in keys]
        valid = torch.from_numpy(batch["points_valid"]).to(dev)
        for route in ("ring", "scatter"):
            for b in IO_BATCHES:
                _io_check(f"{source} B={b}", route,
                          [p[:b] for p in planes], valid[:b], forms)
                cases += 1
        del planes, valid
    pts, valid = io_edge_batch(np.random.default_rng(12))
    p = torch.from_numpy(pts).to(dev)
    v = torch.from_numpy(valid).to(dev)
    for route in ("ring", "scatter"):
        for layout, planes in (("planes", [p[..., c].contiguous()
                                           for c in range(4)]),
                               ("[B, N, 4]", [p[..., c] for c in range(4)])):
            _, sel = _io_check(f"edge cases as {layout}", route, planes, v,
                               forms)
            cases += 1
        check(bool((sel[0][2] == SENTINEL).all()),
              f"edge cases ({route}): the all-invalid scan landed")
    del p, v
    print(f"proj_io: both kernels bit-equal to their plain versions in "
          f"{cases} cases x {len(forms)} forms ({', '.join(forms)}) "
          f"[{gpu}]")

    planes = [torch.from_numpy(tree[k]).to(dev) for k in keys]
    valid = torch.from_numpy(tree["points_valid"]).to(dev)
    times = {}
    for route in ("ring", "scatter"):
        for b in IO_TIMED:
            times[route, b] = _io_timings(route, [q[:b] for q in planes],
                                          valid[:b], ring_cfg, gpu)
        fn = _io_projector(ring_cfg, route)
        fn(planes, valid)
        _, prof_ms, prof_k = profiled_span(
            lambda: fn(planes, valid), "proj_io.projector", wrap=True)
        nodes = graph_work(lambda: fn(planes, valid))[0]
        want = 4 if route == "ring" else 3
        print(f"proj_io projector {route} B={planes[0].shape[0]}: "
              f"{len(nodes)} device launches from planes to image and mask "
              f"({tally(nodes)}); the profiler around "
              f"the call alone read {prof_k} kernels, {prof_ms:.4f} ms "
              f"[{gpu}]")
        check(len(nodes) == want, f"projector on {route}: {len(nodes)} "
              f"launches, want {want}")
    del planes, valid
    torch.cuda.empty_cache()

    steps = {}
    bound = {r: times[r, IO_TIMED[-1]][6]["projection"][1]
             for r in ("ring", "scatter")}
    plain = {r: times[r, IO_TIMED[-1]][5] for r in ("ring", "scatter")}
    steps["scatter"] = _io_step(dev, gpu, slice2_config(**(over or {})),
                                host, "scatter", bound["scatter"],
                                plain["scatter"])
    steps["ring"] = _io_step(dev, gpu, ring_cfg, tree, "ring",
                             bound["ring"], plain["ring"])
    print(f"proj_io phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
    r = times["ring", IO_TIMED[-1]]
    return {"prologue": (r[0], r[1], r[6]["prologue"][1]),
            "epilogue": (r[2], r[3], r[6]["epilogue"][1])}, steps


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
    with io_counted("slice 1's stream"):
        launches, fps, so = phase_slice(dev, gpu)
    phase_profile(so, gpu)
    phase_dispatch(dev, gpu)
    phase_timings(dev, rng, gpu)
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
    with io_counted("slice 2's steps"):
        s_launches, step_ms, state, train_step, raw = phase_train(dev, gpu,
                                                                  host)
    phase_train_profile(state, train_step, raw, gpu, step_ms)
    del state
    torch.cuda.empty_cache()
    phase_overfit(dev, raw)
    phase_train_vs_cpu(dev)
    s_times = phase_scatter_timings(dev, rng, host, gpu)
    print(f"train rate: {step_ms:.2f} ms/step, "
          f"{TRAIN_PAIRS / step_ms * 1e3:.1f} pairs/s [{gpu}]")
    del raw
    torch.cuda.empty_cache()

    # slice 3: the training loop (Trainer), scatter kernel
    with io_counted("slice 3's fit"):
        f_launches, fit_ms = phase_fit(dev, gpu, ROOT / "build" / "fit_run")
    print(f"fit rate: {fit_ms:.2f} ms/step, "
          f"{TRAIN_PAIRS / fit_ms * 1e3:.1f} pairs/s inside fit, against "
          f"{step_ms:.2f} ms/step for the bare step above [{gpu}]")

    s_launches += f_launches
    torch.cuda.empty_cache()

    # slice 4: training on KITTI raw drives, ring kernel at B = 144;
    # slice 5: the command lines on the same tree (evaluation at B = 144,
    # streaming and the artifact at B = 1)
    import shutil
    import tempfile
    root = pathlib.Path(tempfile.mkdtemp(prefix="kitti_smoke_"))
    try:
        with io_counted("slice 4's KITTI paths"):
            k_launches, k_times, _ = phase_kitti(dev, gpu, root)
        with io_counted("slice 5's command lines"):
            c_launches = phase_cli(dev, gpu, root)
        # slice 6: PointSeg pretraining on the same tree, both kernels at
        # B = 16
        t0 = time.perf_counter()
        with io_counted("slice 6's pretraining"):
            p_ring, p_scatter = phase_pretrain(
                dev, gpu, root, ring16_ms=k_times[PREFILL_CHUNK][0])
        print(f"pretrain phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
        # slice 7: the model zoo as shipped, deeplio_kitti.yaml on the
        # same tree through the scatter kernel at B = 96
        t0 = time.perf_counter()
        with io_counted("slice 7's model zoo"):
            v_launches, v_worst, v_times, v_step_ms = phase_variants(
                dev, gpu, root)
        print(f"variants phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
        # slice 8: the JAX package's flagship as shipped (halves, no
        # kernel), its tower through the ring kernel at B = 144 (off,
        # and auto on the tree's scans)
        t0 = time.perf_counter()
        with io_counted("slice 8's flagship"):
            f_ring, f_worst, f_halves_ms, f_off_ms = phase_flagship(
                dev, gpu, root)
        print(f"flagship phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
        # slice 9: every backend and channel and the rest of the zoo on
        # the same tree, both kernels with index payloads at B = 144
        t0 = time.perf_counter()
        # every main path of slice 9 projects with exact payloads
        with io_counted("slice 9's backends", expect=False):
            n_ring, n_scatter, n_worst, n_times = phase_slice9(
                dev, gpu, root, step_ms)
        print(f"slice9 phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
        # slice 10: every optimizer, stem and Fire on the same tree, the
        # ring kernel under A and the scatter kernel under B at B = 144
        t0 = time.perf_counter()
        with io_counted("slice 10's towers"):
            t_ring, t_scatter, t_steps = phase_slice10(dev, gpu, root,
                                                       step_ms)
        print(f"slice10 phase: {time.perf_counter() - t0:.1f} s [{gpu}]")
        # slice 11: data parallelism, NCCL at world 1 and two gloo ranks
        # on the card, through the scatter kernel (slice 2's batch) and
        # the ring kernel (the tree)
        with io_counted("slice 11's data-parallel steps"):
            d_scatter, d_ring = phase_dp(dev, gpu, host, root)
        # slice 12: the projection's prologue and epilogue kernels around
        # both selections, on the tree and slice 2's batch
        io_times, io_steps = phase_proj_io(dev, gpu, root, host)
        del host
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"kernels: ring_project (ported, launches={k_launches} on the "
          f"KITTI training paths, {c_launches} on the command lines' paths, "
          f"{p_ring} on pretraining's, {f_ring} on the flagship's, "
          f"{n_ring} on slice 9's, {t_ring} on slice 10's, {d_ring} on "
          f"the data-parallel ranks', {launches} in the slice-1 stream, "
          f"bit-exact), proj_scatter (ported, launches={s_launches}: the "
          f"training step's and the fit's, {p_scatter} on pretraining's, "
          f"{v_launches} on the model zoo's, {n_scatter} on slice 9's, "
          f"{t_scatter} on slice 10's and {d_scatter} on the data-parallel "
          f"steps', bit-exact)")
    s_launches += p_scatter + v_launches + n_scatter + t_scatter + d_scatter
    k_ms, p_ms, bound_ms, k_worst = k_times[TRAIN_B * TRAIN_S]
    worst = max(worst, k_worst, k_times[PREFILL_CHUNK][3], f_worst, n_worst)
    # the scatter kernel on configs/deeplio_kitti.yaml's path (B = 96,
    # index payloads), where one library call finds the same winners
    sk_ms, sp_ms, s_bound_ms, s_lib_ms = v_times
    s_worst = max(s_worst, v_worst)
    print(f"deeplio_kitti.yaml: {v_step_ms:.2f} ms/step in fit; the scatter "
          f"kernel at B = 96 {sk_ms:.4f} ms, B = 144 (slice 2) "
          f"{s_times[TRAIN_B * TRAIN_S][0]:.4f} ms, B = 144 sort-sentinel "
          f"exact (slice 9) {n_times['sort-sentinel carry'][0]:.4f} ms; "
          f"the ring kernel at B = 144 ring exact (slice 9) "
          f"{n_times['ring carry'][0]:.4f} ms; inside slice 10's steps: "
          f"the ring kernel (A) {t_steps['A'][3]:.4f} ms, the scatter "
          f"kernel (B) {t_steps['B'][3]:.4f} ms [{gpu}]")
    io_total = sum(IO_LAUNCHES.values())
    print(f"kernels: proj_prologue and proj_epilogue (launches {io_total} "
          f"each on the main paths: "
          f"{'; '.join(f'{k} {n}' for k, n in IO_LAUNCHES.items())}; a "
          f"prologue launch on the ring route is two kernels, the pure-tail "
          f"pre-pass and the main pass; bit-exact); train.project at B = 144 with the kernels "
          f"against the plain prologue and epilogue: scatter "
          f"{io_steps['scatter'][0]:.4f} / {io_steps['scatter'][1]:.4f} ms "
          f"({io_steps['scatter'][2]} / {io_steps['scatter'][3]} kernels), "
          f"ring {io_steps['ring'][0]:.4f} / {io_steps['ring'][1]:.4f} ms "
          f"({io_steps['ring'][2]} / {io_steps['ring'][3]} kernels) [{gpu}]")
    print(json.dumps({"kernels": [{
        "name": "ring_project",
        "route": "cuda",
        "source": "deeplio_tpu_torch/csrc/ring_project.cu",
        "replaces": "deeplio_tpu/ops/projection_pallas_ring.py:62",
        "launches": (k_launches + c_launches + p_ring + f_ring + n_ring
                     + t_ring + d_ring),
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
        "library_ms": s_lib_ms,
    }] + [{
        "name": f"proj_{stage}",
        "route": "cuda",
        "source": "deeplio_tpu_torch/csrc/proj_io.cu",
        "replaces": replaces,
        "launches": io_total,
        "max_abs_err": IO_WORST[stage],
        "ms": io_times[stage][0],
        "plain_ms": io_times[stage][1],
        "bound_ms": io_times[stage][2],
        "bound_by": "bytes",
        "library_ms": None,
        "note": note,
    } for stage, replaces, note in (
        ("prologue", "deeplio_tpu/ops/projection_pallas_ring.py:490",
         "a launch on the ring route is two kernels, the pure-tail "
         "pre-pass and the main pass, and ms times both (ring route, "
         "B = 144); one kernel on the scatter route"),
        ("epilogue", "deeplio_tpu/ops/projection_pallas_ring.py:593",
         "one kernel a launch; ms on the ring route at B = 144, bf16 "
         "normalised"))]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
