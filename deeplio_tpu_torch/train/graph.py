"""The training step's forward, loss and backward, the eval call's
forward and loss, and the streaming tick, each as one CUDA graph
(``train/step.py::build_train_step``'s ``train_step`` and ``eval_step``
on one CUDA device; ``eval/streaming.py::StreamingStep``).

On the card the tuned step's model issues some 3,000 kernel launches from
the host, an eval call's some 1,300, and the host takes longer to issue
them than the card takes to run them. :class:`StepGraphs` captures the
trainables' forward in training mode, the pose loss and the backward once
for each layout of the step's inputs, and replays it on every later step:
one graph launch in place of the launches. The projection before it and
the optimizer after it stay eager. :class:`EvalGraphs` does the same for
the eval call's forward in eval mode, the pose loss and its metrics; the
projection before it stays eager, and so does the data-parallel reduction
after it. :class:`StreamGraphs` captures a whole streaming chunk: every
tick's projection, pair, model forward in eval mode and pose composition.

Which path a call takes follows from what the call can observe: the graph
on a state whose parameters are on a CUDA device (for the training step
also with autograd's anomaly mode off); the eager path everywhere else
(the CPU, and anomaly mode, whose check of each backward output for NaN
reads the value on the host, which a capture cannot do and a replay would
skip); the streaming tick takes the graph with grad mode off, outside
``torch.export``'s trace, and only after a warm-up that read nothing from
the host (:class:`StreamGraphs`). The data-parallel step and eval call
call ``eager`` and never capture (``train/step.py``). For one key (the
state's tensors the call reads, and the shape, strides and dtype of each
model input and each ground-truth tensor):

1. the first call runs eagerly, on the side stream the capture uses, and
   is the capture's warm-up;
2. the second call copies its inputs into static buffers, captures the
   graph (which runs nothing, draws no dropout mask and moves no
   BatchNorm statistic), then replays it;
3. every later call copies its inputs into the static buffers and
   replays.

A capture collects garbage first and holds the collector off until it
ends: an object freed mid-capture may call the runtime from its
destructor, which invalidates the capture. It also hands the caching
allocator's free blocks back to the device first: the warm-up's
activations lie cached there, where the graph's private pool cannot
reuse them, and a step whose activations fill half the card would
otherwise find no room to capture.

What a replay keeps equal to the eager call:

- state updated in place: the parameters, BatchNorm's running statistics
  and the LWS ``sx``/``sq`` are read where they live, so a replay reads
  what the optimizer, the running update or a checkpoint's restore (each
  a copy in place) left there;
- dropout: ``state.generator`` is registered with the training graph, so
  each replay draws its masks from the generator's state at that moment
  and advances it by the step's draws, as the eager step does (the
  capture advances nothing), and a checkpoint's generator state stays
  exact; the eval call draws nothing;
- gradients: the captured backward writes ``p.grad`` of every parameter
  (``sx`` and ``sq`` too) into buffers the graph owns. They are None when
  it is captured, so it writes them and accumulates nothing; replays do
  not zero them, and a replay binds them to the parameters again where
  something else (an eager step) set ``p.grad`` meanwhile;
- outputs: the metrics (and the eval call's predictions, the tick's
  carry, poses and motions) are cloned from the graph's static outputs
  after each replay, so a caller keeping call i's ``loss`` or ``x_pred``
  still reads call i's value after call i + 1.

``counts`` tallies the calls by path (``captures``, ``replays``,
``eager``; a capturing call counts one capture and one replay).
"""

from __future__ import annotations

import gc
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch._guards import detect_fake_mode

from deeplio_tpu_torch.utils.timing import span

Batch = Dict[str, torch.Tensor]
# the ground truth the loss reads from the raw batch
TRUTH = ("x_gt", "q_gt", "valid")


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Batch               # static model batch
    truth: Batch                # static ground truth
    outputs: Any                # static outputs of the captured call
    grads: list                 # (parameter, its gradient buffer)


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _static(t: torch.Tensor) -> torch.Tensor:
    """A buffer of ``t``'s layout holding a copy of it."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


class _Captures:
    """What both graphs share: ``fn(state, mb, raw)`` run eagerly or
    through the CUDA graph of its key (module docstring). A subclass
    says on which device a call may capture (``_device``), which of the
    state's objects its graphs read (``_owner_of``), how a graph is made
    (``_capture``, around :meth:`_record`) and replayed (``_replay``,
    around :meth:`_launch`)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self._owner: Tuple = ()
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: set = set()
        self._stream: Optional[torch.cuda.Stream] = None

    def eager(self, state, mb: Batch, raw: Batch):
        """The eager call, counted."""
        self.counts["eager"] += 1
        return self.fn(state, mb, raw)

    def __call__(self, state, mb: Batch, raw: Batch):
        dev = self._device(state)
        if dev is None:
            return self.eager(state, mb, raw)
        owner = self._owner_of(state)
        if len(owner) != len(self._owner) or any(
                a is not b for a, b in zip(owner, self._owner)):
            # graphs read and write one state's tensors: a call on another
            # state starts over
            self._owner = owner
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
                return self._warm_up(dev, state, mb, raw)
            g = self._graphs[key] = self._capture(dev, state, mb, truth)
        return self._replay(g, mb, truth)

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self._stream is None or self._stream.device != device:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, dev: torch.device, state, mb: Batch, raw: Batch):
        """The eager call on the capture's stream, so that what the work
        sets up lazily per stream exists before the capture."""
        side, current = self._side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(state, mb, raw)
        current.wait_stream(side)
        return out

    def _record(self, dev: torch.device, graph: "torch.cuda.CUDAGraph",
                state, mb: Batch, truth: Batch):
        """Capture ``fn`` on static copies of ``mb`` and ``truth`` into
        ``graph``: (static inputs, static truth, static outputs)."""
        inputs = {k: _static(v) for k, v in mb.items()}
        static_truth = {k: _static(v) for k, v in truth.items()}
        # an object that the collector frees during the capture may call
        # the runtime from its destructor (an event, pinned host memory),
        # which invalidates the capture: collect first, then hold the
        # collector off until the capture ends
        gc.collect()
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the data pipeline's producer thread may wait
            # on its own copies while this thread captures
            with torch.cuda.device(dev), torch.cuda.graph(
                    graph, stream=self._side_stream(dev),
                    capture_error_mode="thread_local"):
                outputs = self.fn(state, inputs, static_truth)
        finally:
            if collecting:
                gc.enable()
        self.counts["captures"] += 1
        return inputs, static_truth, outputs

    @staticmethod
    def _launch(g: _Graph, mb: Batch, truth: Batch) -> None:
        """This call's inputs into the static buffers, then the graph."""
        for k, t in g.inputs.items():
            t.copy_(mb[k])
        for k, t in g.truth.items():
            t.copy_(truth[k])
        g.graph.replay()

    def graph_counts(self) -> Dict[str, int]:
        """A copy of :attr:`counts`."""
        return dict(self.counts)


class StepGraphs(_Captures):
    """The forward and backward of ``train_step``: ``forward_backward(state,
    mb, raw) -> metrics`` run eagerly or through a CUDA graph (module
    docstring); ``raw`` is the raw batch, of which the loss reads the
    ground truth."""

    @staticmethod
    def _device(state) -> Optional[torch.device]:
        p = state.optimizer.params[0]
        if torch.is_anomaly_enabled() or not p.is_cuda:
            return None
        return p.device

    @staticmethod
    def _owner_of(state) -> Tuple:
        return (state.trainables,)

    def _capture(self, dev: torch.device, state, mb: Batch,
                 truth: Batch) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        # forward_backward sets the gradients to None before the backward,
        # so the graph writes them and accumulates nothing
        inputs, static_truth, outputs = self._record(dev, graph, state, mb,
                                                     truth)
        grads = [(p, p.grad) for p in state.optimizer.params
                 if p.grad is not None]
        return _Graph(graph, inputs, static_truth, outputs, grads)

    def _replay(self, g: _Graph, mb: Batch, truth: Batch) -> Batch:
        with span("train.forward"):
            self._launch(g, mb, truth)
            for p, grad in g.grads:
                if p.grad is not grad:
                    p.grad = grad
            metrics = {k: v.clone() for k, v in g.outputs.items()}
        # the backward ran inside the graph
        with span("train.backward"):
            pass
        self.counts["replays"] += 1
        return metrics


class EvalGraphs(_Captures):
    """The model and loss of ``eval_step``: ``model_loss(state, mb, raw)
    -> (x_pred, q_pred, metrics)``, the model already in eval mode, run
    eagerly or through a CUDA graph (module docstring). The caller holds
    the span ``eval.model`` around the call: on a replay it holds the
    input copies, the graph launch and the clones."""

    @staticmethod
    def _device(state) -> Optional[torch.device]:
        p = next(state.model.parameters())
        return p.device if p.is_cuda else None

    @staticmethod
    def _owner_of(state) -> Tuple:
        # the model and the loss's parameters the graph reads
        return (state.model,) + tuple(state.loss_params.values())

    def _capture(self, dev: torch.device, state, mb: Batch,
                 truth: Batch) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        inputs, static_truth, outputs = self._record(dev, graph, state, mb,
                                                     truth)
        return _Graph(graph, inputs, static_truth, outputs, [])

    def _replay(self, g: _Graph, mb: Batch, truth: Batch):
        self._launch(g, mb, truth)
        x_pred, q_pred, metrics = g.outputs
        self.counts["replays"] += 1
        return (x_pred.clone(), q_pred.clone(),
                {k: v.clone() for k, v in metrics.items()})


# the warning of a synchronising CUDA operation under
# torch.cuda.set_sync_debug_mode("warn")
_SYNC = "called a synchronizing CUDA operation"


class StreamGraphs(_Captures):
    """A chunk of streaming ticks: ``tick(step, mb, raw) -> (prev_img,
    pose, started, poses, dx, dq)``, ``step`` the ``StreamingStep``, ``mb``
    the carry and the chunk's inputs by name, ``raw`` empty, run eagerly
    or through a CUDA graph (module docstring). The projection, the pair,
    the model and the composition are all inside the graph.

    A layout is captured only after a warm-up that read nothing from the
    host (watched with ``torch.cuda.set_sync_debug_mode("warn")``): a host
    read cannot be captured, and a route that reads the host (the checked
    slot-aligned routes, ``kernel-aligned: auto | on``) chooses by data
    that a replay would not read again. Such a layout warms up again on
    its next call, so a constant made on a first call costs one more eager
    call, and a tick that reads the host on every call stays eager.

    On a replay the span ``stream.model`` holds the input copies, the
    graph launch and the outputs' clones; ``stream.project`` and
    ``stream.compose`` are entered empty, their work being in the graph."""

    @staticmethod
    def _device(step) -> Optional[torch.device]:
        p = next(step.model.parameters())
        if (not p.is_cuda or torch.is_grad_enabled()
                or torch.compiler.is_exporting()
                or detect_fake_mode() is not None):
            return None
        return p.device

    @staticmethod
    def _owner_of(step) -> Tuple:
        return (step.model,)

    def _warm_up(self, dev: torch.device, step, mb: Batch, raw: Batch):
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            # the mode's own notice that it is a prototype
            warnings.filterwarnings("ignore", "Synchronization debug mode")
            if mode == 0:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                out = super()._warm_up(dev, step, mb, raw)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        synced = False
        for w in seen:
            if _SYNC in str(w.message):
                synced = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        if synced:
            # the key _Captures.__call__ made for this call (no truth)
            self._warm.discard(
                (tuple((k, _layout(v)) for k, v in mb.items()), ()))
        return out

    def _capture(self, dev: torch.device, step, mb: Batch,
                 truth: Batch) -> _Graph:
        graph = torch.cuda.CUDAGraph()
        inputs, static_truth, outputs = self._record(dev, graph, step, mb,
                                                     truth)
        return _Graph(graph, inputs, static_truth, outputs, [])

    def _replay(self, g: _Graph, mb: Batch, truth: Batch):
        # the projection and the pair run inside the graph
        with span("stream.project"):
            pass
        with span("stream.model"):
            self._launch(g, mb, truth)
            out = tuple(t.clone() for t in g.outputs)
        # the composition runs inside the graph
        with span("stream.compose"):
            pass
        self.counts["replays"] += 1
        return out
