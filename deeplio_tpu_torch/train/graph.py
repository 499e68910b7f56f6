"""The training step's forward, loss and backward as one CUDA graph
(``train/step.py::build_train_step``'s ``train_step`` on one CUDA device).

On the card the tuned step's model issues some 3,000 kernel launches from
the host, and the host takes longer to issue them than the card takes to
run them. :class:`StepGraphs` captures the trainables' forward in
training mode, the pose loss and the backward once for each layout of the
step's inputs, and replays it on every later step: one graph launch in
place of the launches. The projection before it and the optimizer after
it stay eager.

Which path a step takes follows from what the step can observe: the graph
on a state whose parameters are on a CUDA device, with autograd's anomaly
mode off; the eager forward and backward everywhere else (the CPU, and
anomaly mode, whose check of each backward output for NaN reads the value
on the host, which a capture cannot do and a replay would skip). The
data-parallel step calls :meth:`StepGraphs.eager` and never captures
(``train/step.py``). For one key (the trainables, and the shape, strides
and dtype of each model input and each ground-truth tensor):

1. the first step runs eagerly, on the side stream the capture uses, and
   is the capture's warm-up;
2. the second step copies its inputs into static buffers, captures the
   graph (which runs nothing, draws no dropout mask and moves no
   BatchNorm statistic), then replays it;
3. every later step copies its inputs into the static buffers and replays.

What a replay keeps equal to the eager step:

- dropout: ``state.generator`` is registered with the graph, so each
  replay draws its masks from the generator's state at that moment and
  advances it by the step's draws, as the eager step does (the capture
  advances nothing), and a checkpoint's generator state stays exact;
- gradients: the captured backward writes ``p.grad`` of every parameter
  (``sx`` and ``sq`` too) into buffers the graph owns. They are None when
  it is captured, so it writes them and accumulates nothing; replays do
  not zero them, and a replay binds them to the parameters again where
  something else (an eager step) set ``p.grad`` meanwhile;
- outputs: the metrics are cloned from the graph's static outputs after
  each replay, so a caller keeping step i's ``loss`` still reads step i's
  value after step i + 1.

``counts`` tallies the steps by path (``captures``, ``replays``, ``eager``;
a capturing step counts one capture and one replay).
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, NamedTuple, Optional

import torch

from deeplio_tpu_torch.utils.timing import span

Batch = Dict[str, torch.Tensor]
# the ground truth the loss reads from the raw batch
TRUTH = ("x_gt", "q_gt", "valid")


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Batch               # static model batch
    truth: Batch                # static ground truth
    outputs: Batch              # static metrics
    grads: list                 # (parameter, its gradient buffer)


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _static(t: torch.Tensor) -> torch.Tensor:
    """A buffer of ``t``'s layout holding a copy of it."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


class StepGraphs:
    """The forward and backward of ``train_step``: ``forward_backward(state,
    mb, raw) -> metrics`` run eagerly or through a CUDA graph (module
    docstring); ``raw`` is the raw batch, of which the loss reads the
    ground truth."""

    def __init__(self, forward_backward: Callable):
        self.forward_backward = forward_backward
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._owner: Optional[torch.nn.Module] = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: set = set()
        self._stream: Optional[torch.cuda.Stream] = None

    def eager(self, state, mb: Batch, raw: Batch) -> Batch:
        """The eager forward and backward, counted."""
        self.counts["eager"] += 1
        return self.forward_backward(state, mb, raw)

    def __call__(self, state, mb: Batch, raw: Batch) -> Batch:
        if (torch.is_anomaly_enabled()
                or not state.optimizer.params[0].is_cuda):
            return self.eager(state, mb, raw)
        if state.trainables is not self._owner:
            # graphs read and write one state's tensors: a step on another
            # state starts over
            self._owner = state.trainables
            self._graphs.clear()
            self._warm.clear()
        truth = {k: raw[k] for k in TRUTH if k in raw}
        key = (tuple((k, _layout(v)) for k, v in mb.items()),
               tuple((k, _layout(v)) for k, v in truth.items()))
        g = self._graphs.get(key)
        if g is None:
            if key not in self._warm:
                self._warm.add(key)
                self.counts["eager"] += 1
                return self._warm_up(state, mb, raw)
            g = self._graphs[key] = self._capture(state, mb, truth)
        return self._replay(g, mb, truth)

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, state, mb: Batch, raw: Batch) -> Batch:
        """The eager step on the capture's stream, so that what the work
        sets up lazily per stream exists before the capture."""
        dev = state.optimizer.params[0].device
        side, current = self._side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self.forward_backward(state, mb, raw)
        current.wait_stream(side)
        return metrics

    def _capture(self, state, mb: Batch, truth: Batch) -> _Graph:
        dev = state.optimizer.params[0].device
        inputs = {k: _static(v) for k, v in mb.items()}
        static_truth = {k: _static(v) for k, v in truth.items()}
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        # an object that the collector frees during the capture may call
        # the runtime from its destructor (an event, pinned host memory),
        # which invalidates the capture: collect first, then hold the
        # collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the data pipeline's producer thread may wait
            # on its own copies while this thread captures
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, stream=self._side_stream(dev),
                    capture_error_mode="thread_local"):
                # forward_backward sets the gradients to None before the
                # backward, so the graph writes them and accumulates
                # nothing
                outputs = self.forward_backward(state, inputs,
                                                static_truth)
        finally:
            if collecting:
                gc.enable()
        self.counts["captures"] += 1
        grads = [(p, p.grad) for p in state.optimizer.params
                 if p.grad is not None]
        return _Graph(graph, inputs, static_truth, outputs, grads)

    def _replay(self, g: _Graph, mb: Batch, truth: Batch) -> Batch:
        with span("train.forward"):
            for k, t in g.inputs.items():
                t.copy_(mb[k])
            for k, t in g.truth.items():
                t.copy_(truth[k])
            g.graph.replay()
            for p, grad in g.grads:
                if p.grad is not grad:
                    p.grad = grad
            metrics = {k: v.clone() for k, v in g.outputs.items()}
        # the backward ran inside the graph
        with span("train.backward"):
            pass
        self.counts["replays"] += 1
        return metrics

    def graph_counts(self) -> Dict[str, int]:
        """A copy of :attr:`counts`."""
        return dict(self.counts)
