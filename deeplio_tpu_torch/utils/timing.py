"""Device timing and the port's layer spans (counterpart of
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
:func:`graph_work` lists the device work of one call.

Layer spans: the training and eval steps and the streaming tick mark
each layer's host work with :func:`span` (``train.*``, ``eval.*``,
``stream.*``). A span costs a flag check and a profiler check when
nothing listens. Under ``torch.profiler`` it is a ``record_function``
annotation, on the trace's clock beside the device's operations. Inside
``with recording() as rec:`` it appends a :class:`SpanRecord` to ``rec``
on ``time.perf_counter_ns``'s clock. Both may listen at once. A span
decides when it is entered, so a step traced by ``torch.export`` with
neither listening holds no span.
"""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch.autograd.profiler import record_function


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


class SpanRecord(NamedTuple):
    """One span as the recorder keeps it: host times in ns on
    ``time.perf_counter_ns``'s clock, ``parent`` the innermost span open
    on the same thread when it began (None at the top)."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    thread: int


class Recording(list):
    """The :class:`SpanRecord` s of one :func:`recording`, in the order
    they began once its block is left."""

    def __init__(self):
        super().__init__()
        self.open: Dict[int, List[str]] = {}    # thread -> open spans


# the recording spans append to, or None
_recording: Optional[Recording] = None


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span entered inside the block, on any thread."""
    global _recording
    rec, outer = Recording(), _recording
    _recording = rec
    try:
        yield rec
    finally:
        _recording = outer
        rec.sort(key=lambda r: r.start_ns)


class _Span:
    __slots__ = ("name", "rec", "annotation", "stack", "t0")

    def __init__(self, name: str, rec: Optional[Recording], profiled: bool):
        self.name, self.rec = name, rec
        self.annotation = record_function(name) if profiled else None

    def __enter__(self):
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.rec is not None:
            self.stack = self.rec.open.setdefault(threading.get_ident(), [])
            self.stack.append(self.name)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            t1 = time.perf_counter_ns()
            self.stack.pop()
            self.rec.append(SpanRecord(
                self.name, self.stack[-1] if self.stack else None, self.t0,
                t1, threading.get_ident()))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking one layer's host work as ``name``: a
    ``record_function`` annotation while ``torch.profiler`` runs, a
    :class:`SpanRecord` inside :func:`recording`, nothing otherwise."""
    rec = _recording
    profiled = torch.autograd._profiler_enabled()
    if rec is None and not profiled:
        return _OFF
    return _Span(name, rec, profiled)


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
