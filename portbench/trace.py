"""Reading a ``torch.profiler`` trace of a few timed units.

The profile is exported as a Chrome trace (``traceEvents``) and reduced
here: the device's operations (kernels, copies, fills), the host's kernel
launch calls, the ``record_function`` spans, and the benchmark's own
``portbench.window`` span, which opens after a synchronise and closes
after another, so the device's busy time over its length is the traced
window's. No kernel name of the system under test is used.

Dropped records: every kernel launch call on the host names one kernel
on the device by its correlation id. A launch whose kernel is not in the
trace is a dropped record (the profiler loses some on the card's
machine); :attr:`Trace.dropped` counts them.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KEYS = ("LaunchKernel", "LaunchCooperativeKernel")


@dataclass
class Trace:
    """What one profiled window holds (times in seconds)."""

    units: int
    window: Tuple[float, float]
    device_ops: List[Tuple[float, float, str, Optional[int]]]
    launches: Dict[int, Tuple[float, int]]          # corr -> (ts, tid)
    calls: Dict[int, Tuple[float, int]]             # every runtime call
    spans: Dict[str, List[Tuple[float, float]]]
    host_ops: Dict[int, List[Tuple[float, float, str]]]
    kernel_corrs: set = field(default_factory=set)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def n_kernels(self) -> int:
        return len(self.kernel_corrs)

    @property
    def n_launches(self) -> int:
        return len(self.launches)

    @property
    def dropped(self) -> int:
        """Launch calls whose kernel record is missing."""
        return sum(1 for c in self.launches if c not in self.kernel_corrs)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, as disjoint sorted intervals."""
        lo, hi = self.window
        iv = sorted((max(s, lo), min(s + d, hi))
                    for s, d, _, _ in self.device_ops
                    if s + d > lo and s < hi)
        out: List[List[float]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def span_device_s(self, names: Iterable[str]) -> Optional[float]:
        """Device seconds of the operations launched inside any span
        named in ``names`` (the launch's host time within the span, on
        any thread: autograd launches the backward from its own), or
        None when no such span is in the trace."""
        iv = sorted(iv for n in names for iv in self.spans.get(n, ()))
        if not iv:
            return None
        starts = [s for s, _ in iv]
        total = 0.0
        for s, d, _, corr in self.device_ops:
            if corr is None or corr not in self.launches:
                continue
            ts = self.launches[corr][0]
            k = bisect.bisect_right(starts, ts) - 1
            if k >= 0 and iv[k][0] <= ts <= iv[k][1]:
                total += d
        return total

    def top_ops(self, k: int = 10) -> List[List]:
        """The device operations that took most time, by name."""
        by: Dict[str, float] = {}
        for _, d, name, _ in self.device_ops:
            by[name] = by.get(name, 0.0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:200], s] for n, s in top]

    def _host_label(self, corr: Optional[int]) -> str:
        """What the host was running when it issued ``corr`` (a launch
        or a copy): the innermost host operation or span around the
        runtime call."""
        if corr is None or corr not in self.calls:
            return "(call not traced)"
        ts, tid = self.calls[corr]
        best = None
        for s, e, name in self.host_ops.get(tid, ()):
            if s <= ts <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "(no host op)"

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The longest idle gaps in the window, each named by what the
        host was doing when it launched the operation that ended it."""
        busy = self.busy_intervals()
        lo, hi = self.window
        ops = sorted(self.device_ops)
        starts = [s for s, _, _, _ in ops]
        gaps = []
        prev = lo
        for s, e in busy + [(hi, hi)]:
            if s - prev > 0:
                j = bisect.bisect_left(starts, s)
                corr = ops[j][3] if j < len(ops) else None
                label = (self._host_label(corr) if s < hi
                         else "(window end)")
                gaps.append((s - prev, label))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[0])
        return [[label[:200], g] for g, label in gaps[:k]]


def parse(events: Sequence[dict], units: int) -> Trace:
    """Reduce Chrome trace events to a :class:`Trace`."""
    window = None
    device_ops, launches, calls, spans, host_ops = [], {}, {}, {}, {}
    corrs = set()
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        ts = float(ev.get("ts", 0.0)) * 1e-6
        dur = float(ev.get("dur", 0.0)) * 1e-6
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device_ops.append((ts, dur, name, corr))
            if cat == "kernel" and corr is not None:
                corrs.add(corr)
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            calls[corr] = (ts, ev.get("tid"))
            if any(k in name for k in LAUNCH_KEYS):
                launches[corr] = calls[corr]
        elif cat == "user_annotation":
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.setdefault(name, []).append((ts, ts + dur))
                host_ops.setdefault(ev.get("tid"), []).append(
                    (ts, ts + dur, name))
        elif cat == "cpu_op":
            host_ops.setdefault(ev.get("tid"), []).append(
                (ts, ts + dur, name))
    if window is None:
        raise RuntimeError(f"no {WINDOW} span in the profile")
    return Trace(units, window, device_ops, launches, calls, spans,
                 host_ops, corrs)


def profile(unit: Callable[[int], object], units: int,
            sync: Callable[[], None]) -> Trace:
    """Run ``unit(0)`` .. ``unit(units - 1)`` under ``torch.profiler``
    inside the window span and reduce the trace. The trace file is
    written to the temporary directory and deleted."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for i in range(units):
                unit(i)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events, units)
