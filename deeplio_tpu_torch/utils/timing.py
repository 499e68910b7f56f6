"""Device timing and a throughput harness (counterpart of
``deeplio_tpu/utils/timing.py``).

What holds on the card:

1. PyTorch returns from a CUDA call before the card has run it, so a host
   clock around calls measures the enqueue. ``sync`` waits with
   ``torch.cuda.synchronize`` (every stream of the device), then fetches
   one element of the result: the copy orders after the work that made
   it, so an output produced on another stream is waited for too.
2. Repeating identical input buffers in a timing loop can give numbers
   that are too good (caches warm with exactly the data the next call
   reads): cycle several distinct inputs.

Host-clock times of a short call include the host's own issue time;
``chip_smoke.py::graph_ms`` (CUDA-graph replay) gives device time alone.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np
import torch


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values() if isinstance(tree, dict) else tree))
    return tree


def sync(tree) -> float:
    """Force completion of everything ``tree`` (a tensor, or a dict, list
    or tuple of them) depends on; returns a scalar fetched from the first
    leaf. Only one element crosses to the host."""
    leaf = _first_leaf(tree)
    if isinstance(leaf, torch.Tensor):
        if leaf.is_cuda:
            torch.cuda.synchronize(leaf.device)
        return float(leaf.reshape(-1)[0].item())
    return float(np.asarray(leaf).reshape(-1)[0])


def time_fn(fn: Callable, inputs: Sequence, iters: int = 10,
            warmup: int = 2) -> float:
    """Average seconds per call of ``fn`` over distinct ``inputs`` cycled.

    ``fn`` must return tensors whose values depend on the full computation
    being measured.
    """
    if not inputs:
        raise ValueError("time_fn needs at least one input")
    out = None
    for i in range(warmup):
        out = fn(inputs[i % len(inputs)])
    if out is not None:
        sync(out)
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(inputs[i % len(inputs)])
    sync(out)
    return (time.perf_counter() - t0) / iters


def throughput(fn: Callable, inputs: Sequence, items_per_call: int,
               iters: int = 10, warmup: int = 2) -> float:
    """Items/second of ``fn`` (e.g. frame-pairs/s of a train step)."""
    dt = time_fn(fn, inputs, iters=iters, warmup=warmup)
    return items_per_call / dt
