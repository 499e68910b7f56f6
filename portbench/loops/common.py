"""What the loops share: the system under test built from a cell's
configuration and the benchmark's weights, the reference built beside
it, and the timing of a closed loop of units."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import gen, weights
from portbench.harness import Cell, Window
from portbench.reference.model import DeepLIO, model_spec


@contextlib.contextmanager
def exact_float32():
    """TF32 off for the reference's products, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def shape(cfg: Dict):
    """(H, W, max_points, imu samples a pair, combos) of a configuration
    file's dictionary."""
    ds = cfg["datasets"]
    s = int(ds.get("sequence-size", 2))
    combos = [tuple(c) for c in ds.get("combinations", [])] or [
        (k, k + 1) for k in range(s - 1)]
    return (int(ds.get("image-height", 64)), int(ds.get("image-width", 1024)),
            int(ds.get("max-points", 131072)),
            int(ds.get("max-imu-per-pair", 16)), combos)


class Base:
    """A loop over one cell. Subclasses set up the program and define
    ``unit(i)`` (one timed unit, issued without waiting) and the check."""

    trace_units = 4
    issue_units = 10
    SPANS: Dict[str, tuple] = {}

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.trace_units = int(t.get("trace_units", self.trace_units))
        self.issue_units = int(t.get("issue_units", self.issue_units))
        self.spec = model_spec(cell.cfg)
        self.H, self.W, self.N, self.T, self.combos = shape(cell.cfg)
        # rings and azimuth steps of the sensor: two returns a pixel
        self.rings, self.steps = self.H, 2 * self.W
        self.flops_per_unit = 0
        self.items_per_unit = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the model's weights, for both sides ----------------------------
    def make_weights(self) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            shapes = DeepLIO(self.spec)
        g = gen.device_generator(self.seed, self.device, 3)
        return weights.make_state(shapes, g, self.device)

    def port_model(self, pcfg, state: Dict[str, torch.Tensor]):
        from deeplio_tpu_torch.models.zoo import build_model
        model = build_model(pcfg, self.device, seed=None)
        model.load_state_dict(state, strict=True)
        return model

    def reference(self, state: Dict[str, torch.Tensor],
                  precision: str = "float32") -> DeepLIO:
        ref = DeepLIO(self.spec).to(self.device)
        ref.load_state_dict(state, strict=True)
        return ref.set_precision(precision)

    # -- timing ---------------------------------------------------------
    def unit(self, i: int):
        raise NotImplementedError

    def window(self, seconds: float, started: Callable[[], None]) -> Window:
        """Units back to back until ``seconds`` have passed on the host,
        then wait for the device: the window runs from the first issue to
        the last result."""
        self.sync()
        started()
        t0 = time.perf_counter()
        i = 0
        while True:
            self.record(i, self.unit(i))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        return Window(i, i * self.items_per_unit, time.perf_counter() - t0)

    def record(self, i: int, out) -> None:
        """Keep what the check will judge of unit ``i``'s output."""

    def issue_times(self) -> List[float]:
        """Host seconds each of ``issue_units`` units takes to return,
        the device idle before each."""
        out = []
        for i in range(self.issue_units):
            self.sync()
            t0 = time.perf_counter()
            self.unit(i)
            out.append(time.perf_counter() - t0)
        self.sync()
        return out

    def projection_time(self):
        return None


def graph_s(calls: List[Callable[[], object]], reps: int = 20) -> float:
    """Device seconds of one call: the ``calls`` captured in one CUDA
    graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    s = start.elapsed_time(end) / 1e3 / (reps * len(calls))
    del graph
    return s


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[set] = None) -> List[tuple]:
    """Each leaf's gap between two norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger: (gap, leaf,
    system's norm, reference's norm), the worst first."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    med = vals[len(vals) // 2]
    return sorted(((abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30),
                    k, prog.get(k, 0.0), ref[k]) for k in names),
                  reverse=True)


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                    keep: Optional[set] = None) -> float:
    """The median leaf's gap (:func:`leaf_gaps`)."""
    g = leaf_gaps(prog, ref, keep)
    return g[len(g) // 2][0]


def mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of elements where ``a`` and ``b`` differ in value (all of
    them where the shapes differ)."""
    if a.shape != b.shape:
        return 1.0
    return float((a != b).sum().item()) / max(a.numel(), 1)
