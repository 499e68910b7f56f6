"""The benchmark's data-driven core.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix.
Both are found by name under ``portbench/``:

- ``configs/<config>.yaml``: the configuration as it is run (the
  repository's YAML, with ``source``, ``reduced`` and ``assumed``);
- ``traffic/<traffic>.json``: the mix's parameters, among them the
  ``loop`` that drives it, ``loops/<loop>.py``;
- ``limits/<cell>.json``: the limit of each number the cell's check
  compares, with the readings it was set from;
- ``metrics/<family>.py``: one reader a metric family (the part of a
  metric's name before its first dot), ``read(run) -> value or None``.

A later cell, mix, configuration or metric is then a new file and an
entry, with no edit to a file that is here.
"""

from __future__ import annotations

import importlib
import json
import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import yaml

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    cfg: Dict                  # the configuration file's dictionary
    traffic: Dict              # the mix's parameters
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_bench(root: Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, bench: Optional[Dict] = None,
              overrides: Optional[Dict] = None) -> Cell:
    """The cell ``name`` with its files. ``overrides`` patch the
    configuration's dictionary (tests run tiny sizes on the CPU)."""
    bench = bench or load_bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    with open(HERE / "configs" / f"{w['config']}.yaml") as f:
        cfg = yaml.safe_load(f)
    for path, value in (overrides or {}).items():
        node = cfg
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = HERE / "limits" / f"{name}.json"
    limits = {}
    if limits_path.exists():
        with open(limits_path) as f:
            limits = {k: float(v["limit"])
                      for k, v in json.load(f)["numbers"].items()}
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric: in the cells it lists, or, listing none, in
    # every cell that reports the end-to-end metric it moves
    per = [m for m in bench["per_layer"]
           if name in m.get("workloads", ())
           or ("workloads" not in m and m["moves"] in e2e_names)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), cfg,
                traffic, limits, e2e, per)


def loop_class(cell: Cell):
    return importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']}").Loop


def reader(metric_name: str):
    """The reader module of a metric: ``metrics/<family>.py``."""
    family = metric_name.split(".")[0]
    return importlib.import_module(f"portbench.metrics.{family}")


@dataclass
class Window:
    """What the measured window did."""

    units: int                 # steps, eval calls or ticks issued
    items: int                 # pairs or frames they carried
    seconds: float             # from the first issue to the last result
    latencies: List[float] = field(default_factory=list)   # per unit, s


def quantile(values: List[float], q: float) -> float:
    """The ``q`` quantile by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Run:
    """One run of one cell: the loop, its window, and what the readers
    ask for, measured at most once each."""

    def __init__(self, cell: Cell, loop, t0: float):
        self.cell, self.loop, self.t0 = cell, loop, t0
        self.window: Optional[Window] = None
        self.setup_s: Optional[float] = None
        self._trace = None
        self._issue = None
        self._project = None
        self.notes: List[str] = []

    def measure(self, seconds: float) -> Window:
        self.window = self.loop.window(seconds, self._started)
        return self.window

    def _started(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    # -- what the per-layer readers read --------------------------------
    def trace(self):
        """The profiled steady window, profiled again once when records
        were dropped."""
        if self._trace is None:
            from portbench import trace as tr
            t = tr.profile(self.loop.unit, self.loop.trace_units,
                           self.loop.sync)
            if t.dropped:
                self.notes.append(
                    f"profile 1 dropped {t.dropped} of {t.n_launches} "
                    f"kernel records; profiling again")
                t = tr.profile(self.loop.unit, self.loop.trace_units,
                               self.loop.sync)
                if t.dropped:
                    self.notes.append(
                        f"profile 2 dropped {t.dropped} of {t.n_launches} "
                        f"kernel records: profiler readings are low")
            self._trace = t
        return self._trace

    def issue_s(self) -> float:
        """Mean host seconds to enqueue one unit, the device idle before
        each (a synchronise between units)."""
        if self._issue is None:
            self._issue = self.loop.issue_times()
        return statistics.fmean(self._issue)

    def project_s(self):
        """(device seconds of one projection call, its least bytes), or
        None where the loop has no projection."""
        if self._project is None:
            self._project = self.loop.projection_time()
        return self._project

    def mfu(self) -> Optional[float]:
        from portbench.counts import PEAK_BF16_FLOPS
        w = self.window
        if not w or not self.loop.flops_per_unit:
            return None
        return (self.loop.flops_per_unit * w.units / w.seconds
                / PEAK_BF16_FLOPS * 100.0)


def read_metrics(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
