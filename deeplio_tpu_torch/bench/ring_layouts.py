"""Layouts of the ring kernel, timed on one GPU.

    python -m deeplio_tpu_torch.bench.ring_layouts [--reps 30]

``csrc/ring_project.cu`` cuts each scan into ``kCluster`` slices, one CTA
of ``kThreads`` threads each, every thread taking ``kItems`` consecutive
points per pass, and each CTA owning at most ``kWindow`` pixels per pass
(its shared memory: 8 B per point of a pass and 8 B per pixel). Those are
constants of the source. This builds the source once per layout with the
four constants replaced (a cluster of 16 CTAs needs the non-portable
cluster size, which the source sets itself when ``kCluster > 8``), holds
every layout bit-exact against ``ring_select_reference``, and times each
at the streaming path's shape (131072-point ring scans into 64x1024
pixels) at B = 1 and 9, at B = 1 with every point invalid, and at B = 1
on a 4097-point scan. At B = 1 each layout is also timed between plain
kernels, as the streaming path launches it: a graph of ten (elementwise
kernel, selection) pairs against ten elementwise kernels alone. Two empty
scans (N = 0) give each layout's floors: into 4 pixels, the launch and
the two cluster barriers; into 64x1024 pixels, those plus writing every
pixel. For scale, the three fills of 64x1024 words that the four-pass
kernel of the port's first slices needed are timed once, as plain kernels
in the same harness.

A time is the device time of one call inside a replayed CUDA graph of
ten, median of ``--reps`` replays. Each case is timed twice, the layouts
in one order and then in the reverse order. Exits non-zero without a CUDA
device or when a layout disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys

import numpy as np
import torch

from deeplio_tpu_torch.bench.scatter_launch import graph_ms
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.ops import _kernels
from deeplio_tpu_torch.ops import projection_ring as tring

H, W, N = 64, 1024, 131072
FU, FD = 3.0, -25.0
# name -> (kCluster, kThreads, kItems, kWindow); the first is the
# committed layout
LAYOUTS = {"C16 512x16": (16, 512, 16, 8192),
           "C16 512x16 w4096": (16, 512, 16, 4096),
           "C16 256x8 w1024": (16, 256, 8, 1024),
           "C16 1024x8": (16, 1024, 8, 8192),
           "C16 256x32": (16, 256, 32, 8192),
           "C8 512x32": (8, 512, 32, 8192),
           "C8 512x16": (8, 512, 16, 8192)}
CONSTANTS = ("kCluster", "kThreads", "kItems", "kWindow")


def source_constants():
    text = (_kernels.CSRC / "ring_project.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {c} = (\d+);", text)[1])
                 for c in CONSTANTS)


def build(layouts):
    """name -> loaded library of the source with that layout's constants,
    all ``nvcc`` processes at once."""
    src = (_kernels.CSRC / "ring_project.cu").read_text()
    out = _kernels.BUILD_DIR / "ring_layouts"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, values in layouts.items():
        text = src
        for c, v in zip(CONSTANTS, values):
            text, count = re.subn(rf"constexpr int {c} = \d+;",
                                  f"constexpr int {c} = {v};", text)
            if count != 1:
                raise RuntimeError(f"{c} not found once in ring_project.cu")
        tag = "_".join(map(str, values))
        cu, so = out / f"ring_{tag}.cu", out / f"libring_{tag}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = tring._bind(ctypes.CDLL(str(so)))
    return libs


def select(lib, words, n_pix: int):
    pix = words[0]
    b, n = pix.shape
    out = [torch.empty((b, n_pix), dtype=torch.int32, device=pix.device)
           for _ in range(3)]
    err = lib.dlt_ring_project(*(w.data_ptr() for w in words),
                               *(o.data_ptr() for o in out), b, n, n_pix,
                               torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ring_project launch failed: "
                           f"{_kernels.error_string(lib, err)}")
    return out


def scan_cases(dev):
    """name -> (pix, key, p1, p2, n_pix)."""
    rng = np.random.default_rng(0)
    out = {}
    for name, b, n, valid in (("B=1", 1, N, True), ("B=9", 9, N, True),
                              ("B=1 all invalid", 1, N, False),
                              ("B=1 N=4097", 1, 4097, True)):
        pts = synthetic_ring_batch(rng, b, -(-n // H) * H)[:, :n]
        pts = torch.from_numpy(np.ascontiguousarray(pts)).to(dev)
        planes = [pts[..., c].contiguous() for c in range(4)]
        v = torch.full((b, n), valid, dtype=torch.bool, device=dev)
        out[name] = (*tring.ring_prologue(*planes, v, H, W, FU, FD), H * W)
    empty = [torch.empty((1, 0), dtype=torch.int32, device=dev)
             for _ in range(4)]
    out["B=1 N=0 into 4 pixels"] = (*empty, 4)
    out["B=1 N=0 into 64x1024"] = (*empty, H * W)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_layouts: needs a CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    if source_constants() != next(iter(LAYOUTS.values())):
        raise RuntimeError("the committed layout is not the first of LAYOUTS")
    libs = build(LAYOUTS)
    dev = torch.device("cuda")
    for name, (*words, n_pix) in scan_cases(dev).items():
        ref = tring.ring_select_reference(*words, n_pix)
        for label, lib in libs.items():
            got = select(lib, words, n_pix)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f"{name}: {label} differs from the plain "
                                   f"version")
        order = list(libs)
        times = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for label in seq:
                times[label].append(graph_ms(
                    lambda: select(libs[label], words, n_pix), args.reps))
        print(f"ring layout {name}: "
              + ", ".join(f"{k} {t[0]:.4f} / {t[1]:.4f}"
                          for k, t in times.items())
              + f" ms [{gpu}]", flush=True)
        if name == "B=1":
            x = torch.zeros(1 << 20, device=dev)

            def other():
                x.add_(1.0)

            alone = graph_ms(other, args.reps)
            mixed = {k: graph_ms(lambda: (other(), select(libs[k], words,
                                                          n_pix)),
                                 args.reps) - alone for k in order}
            print(f"ring layout B=1 between elementwise kernels ({alone:.4f} "
                  f"ms each, subtracted): "
                  + ", ".join(f"{k} {t:.4f}" for k, t in mixed.items())
                  + f" ms [{gpu}]", flush=True)

    def fills():
        return [torch.full((1, H * W), v, dtype=torch.int32, device=dev)
                for v in (tring.SENTINEL, 0, 0)]

    print(f"three fills of 64x1024 words (plain kernels): "
          f"{graph_ms(fills, args.reps):.4f} ms [{gpu}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
