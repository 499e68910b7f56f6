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
``chip_smoke.py::graph_ms`` (CUDA-graph replay) gives device time alone,
and :func:`graph_work` lists the device work of one call.
"""

from __future__ import annotations

import os
import re
import tempfile
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


_NODE = re.compile(r'^\s*"graph_\d+_node_\d+"\s*\[', re.M)
# a kernel's name inside its mangled symbol, else the node's kind
_KERNEL = re.compile(r"\d([a-z][a-z_]*_kernel)")
_KIND = re.compile(r"\b(KERNEL|MEMSET|MEMCPY|MEM_ALLOC|MEM_FREE|HOST|EMPTY"
                   r"|EVENT_\w+)")


def graph_work(fn: Callable):
    """The device work one ``fn()`` call enqueues, read without the
    profiler (which drops records on some machines): ``fn`` run once on a
    side stream, then captured in a CUDA graph whose DOT dump is read,
    one label a node (a kernel's name, or the node's kind: a memset, a
    copy). The graph is then replayed once, so that ``fn``'s outputs hold
    its results. Returns (labels, ``fn``'s outputs, the graph, which owns
    the outputs' memory: keep it while they are used)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    # kept, so the dump can read the captured graph
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        out = fn()
    graph.instantiate()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    labels = []
    for block in _NODE.split(dot)[1:]:
        m = _KERNEL.search(block) or _KIND.search(block)
        labels.append(m.group(1) if m else block[:40].replace("\n", " "))
    if not labels:
        raise RuntimeError(f"no node in the captured graph's DOT dump: "
                           f"{dot[:800]!r}")
    graph.replay()
    return labels, out, graph
