"""Launch layouts of the point-scatter kernel, timed on one GPU.

    python -m deeplio_tpu_torch.bench.scatter_launch [--reps 30]

``csrc/proj_scatter.cu`` gives each CTA its own share of a scan's pixels,
and every CTA reads all of the scan's keys. ``scatter_plan`` groups the C
CTAs of a scan (C = 4 at 64x1024) into one thread-block cluster, which
makes them run at the same time. No CTA touches another's shared memory,
so the same CTAs also run as C clusters of one CTA each (``tiles = C``),
with nothing that makes them run together. This times both, for C = 2, 4
and 8, on the training slice's 144 unordered scans of 131072 points at
64x1024 (16 synthetic drives of 9 frames), on the first scan alone and
on one hot pixel. Every layout is first held bit-exact against
``scatter_select_reference``.

A time is the device time of one call inside a replayed CUDA graph of
ten, median of ``--reps`` replays. Each case is timed twice, the layouts
in one order and then in the reverse order, so that a drift of the card
shows. Exits non-zero without a CUDA device or when a layout disagrees.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from deeplio_tpu_torch.data.drives import SyntheticDrive
from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops import projection_scatter as tsc
from deeplio_tpu_torch.ops.projection import rq_bits_for

H, W, N = 64, 1024, 131072
FU, FD = 3.0, -25.0
DRIVES, FRAMES = 16, 9


def scan_cases():
    """name -> (points [B, N, 4], valid [B, N])."""
    pts, valid = zip(*(
        SyntheticDrive(n_frames=FRAMES, max_points=N, seed=s,
                       world_points=300_000).points(k)
        for s in range(DRIVES) for k in range(FRAMES)))
    pts, valid = np.stack(pts), np.stack(valid)
    rng = np.random.default_rng(0)
    hot = np.zeros((1, N, 4), np.float32)
    hot[0, :, 0] = rng.uniform(2.0, 70.0, N)      # every point straight ahead
    hot[0, :, 3] = rng.uniform(0.0, 1.0, N)
    return {f"B={len(pts)}": (pts, valid), "B=1": (pts[:1], valid[:1]),
            "1 hot pixel": (hot, np.ones((1, N), bool))}


def layouts(n_pix: int, rq_bits: int):
    """name -> ScatterPlan: C CTAs of n_pix / C slots each, as one cluster
    and as C clusters of one."""
    base = tsc.scatter_plan(N, n_pix, rq_bits)
    out = {}
    for c in (2, 4, 8):
        slots = -(-n_pix // c)
        out[f"cluster of {c}"] = base._replace(cluster=c, cta_slots=slots,
                                               tiles=1)
        out[f"{c} clusters of 1"] = base._replace(cluster=1, cta_slots=slots,
                                                  tiles=c)
    return out


def select(words, n_pix: int, rq_bits: int, plan: tsc.ScatterPlan):
    """One launch of the scatter kernel laid out by ``plan``."""
    lib = tsc._library()
    key, xy, zr = words
    b, n = key.shape
    out = [torch.empty((b, n_pix), dtype=torch.int32, device=key.device)
           for _ in range(3)]
    err = lib.dlt_proj_scatter(
        key.data_ptr(), xy.data_ptr(), zr.data_ptr(),
        *(o.data_ptr() for o in out), b, n, n_pix, rq_bits, *plan,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"proj_scatter launch failed with {plan}: "
                           f"{_kernels.error_string(lib, err)}")
    return out


def graph_ms(fn, reps: int, inner: int = 10) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    for _ in range(5):
        graph.replay()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs])) / inner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scatter_launch: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n_pix, rq_bits = H * W, rq_bits_for(H * W)
    plans = layouts(n_pix, rq_bits)
    if plans["cluster of 4"] != tsc.scatter_plan(N, n_pix, rq_bits):
        raise RuntimeError("scatter_plan no longer picks a cluster of 4")
    for name, (pts, vld) in scan_cases().items():
        p = torch.from_numpy(pts).to(dev)
        planes = [p[..., c].contiguous() for c in range(4)]
        words = tsc.scatter_prologue(*planes, torch.from_numpy(vld).to(dev),
                                     H, W, FU, FD)
        ref = tsc.scatter_select_reference(*words, n_pix, rq_bits)
        for label, plan in plans.items():
            got = select(words, n_pix, rq_bits, plan)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"{name}: {label} differs from the plain "
                                   f"version")
        landed = int((ref[0] != tsc.SENTINEL).sum())
        order = list(plans)
        times = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for label in seq:
                times[label].append(graph_ms(
                    lambda: select(words, n_pix, rq_bits, plans[label]),
                    args.reps))
        print(f"scatter launch {name} ({landed} pixels landed): "
              + ", ".join(f"{k} {t[0]:.4f} / {t[1]:.4f}"
                          for k, t in times.items())
              + f" ms [{gpu}]", flush=True)
        del p, planes, words, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())
