"""The program's layer spans, by loop, and what the per-layer readers take
from them.

- :data:`MAP`: loop -> layer -> the program's spans that hold the
  layer's host work (``utils/timing.py::span`` in the system under test).
- :func:`issue_split`: host milliseconds a unit in each layer, from the
  loop's ``issue_units`` units under the program's span recorder, a
  synchronise before each as ``issue_times`` does; made once a run. Its
  coverage (the layers' sum over the recorded units' own time) and the
  time of the units run without the recorder between them go on a
  ``run.notes`` line.
- :func:`launches`: kernel launches a unit whose host call falls inside
  given spans, from the profiled window.

A program without the recorder, or without a layer's spans, reads None
there, and the metric is left out of the result line.
"""

from __future__ import annotations

import bisect
import statistics
import time
from typing import Dict, Iterable, Optional

MAP: Dict[str, Dict[str, tuple]] = {
    "train": {"project": ("train.project",),
              "model": ("train.forward", "train.backward"),
              "update": ("train.update",)},
    "evaluate": {"project": ("eval.project",),
                 "model": ("eval.model",)},
    "stream": {"copy": ("stream.to_device",),
               "project": ("stream.project",),
               "model": ("stream.model",)},
}


def spans(run, layer: str) -> tuple:
    """The spans of ``layer`` in the run's loop (empty where it has
    none)."""
    return MAP.get(run.cell.traffic["loop"], {}).get(layer, ())


def issue_split(run) -> Optional[Dict]:
    """``{"layers": {layer: ms a unit or None}, "unit_ms": ms, "bare_ms":
    ms}`` of the recorded units, or None where the program has no span
    recorder. Each recorded unit follows one unit without the recorder
    (``bare_ms``): the host's pace drifts by a third and more within a
    run, so the recorder's cost is read against units of the same
    moment."""
    if hasattr(run, "_issue_split"):
        return run._issue_split
    run._issue_split = None
    try:
        from deeplio_tpu_torch.utils.timing import recording
    except ImportError:
        run.notes.append("issue split: the program has no span recorder")
        return None
    loop = run.loop
    recs, units, bare = [], [], []
    for i in range(loop.issue_units):
        loop.sync()
        t0 = time.perf_counter_ns()
        loop.unit(i)
        bare.append(time.perf_counter_ns() - t0)
        loop.sync()
        with recording() as rec:
            t0 = time.perf_counter_ns()
            loop.unit(i)
            units.append(time.perf_counter_ns() - t0)
        recs += rec
    loop.sync()
    n = len(units)
    unit_ms = statistics.fmean(units) / 1e6
    bare_ms = statistics.fmean(bare) / 1e6
    layers = {}
    for layer, names in MAP.get(run.cell.traffic["loop"], {}).items():
        ds = [r.end_ns - r.start_ns for r in recs if r.name in names]
        layers[layer] = sum(ds) / n / 1e6 if ds else None
    covered = sum(v for v in layers.values() if v is not None)
    run.notes.append(
        "issue split: " + ", ".join(
            f"{k} {'none' if v is None else f'{v:.4f}'} ms"
            for k, v in layers.items())
        + f" of {unit_ms:.4f} ms a unit under the recorder "
          f"({covered / unit_ms * 100:.2f}% covered; {n} units), "
          f"{bare_ms:.4f} ms a unit without it (a unit without before "
          f"each recorded one)")
    run._issue_split = {"layers": layers, "unit_ms": unit_ms,
                        "bare_ms": bare_ms}
    return run._issue_split


def issue_ms(run, layer: str) -> Optional[float]:
    """Host ms a unit in ``layer`` (:func:`issue_split`)."""
    split = issue_split(run)
    return None if split is None else split["layers"].get(layer)


def launches(run, names: Iterable[str]) -> Optional[float]:
    """Kernel launches a unit whose host call falls inside any span named
    in ``names``, on any thread (autograd launches the backward from its
    own), or None where the profile has no such span or no launch."""
    t = run.trace()
    iv = sorted(iv for n in names for iv in t.spans.get(n, ()))
    if not iv or not t.launches:
        return None
    starts = [s for s, _ in iv]
    count = 0
    for ts, _ in t.launches.values():
        k = bisect.bisect_right(starts, ts) - 1
        if k >= 0 and iv[k][0] <= ts <= iv[k][1]:
            count += 1
    return count / t.units
