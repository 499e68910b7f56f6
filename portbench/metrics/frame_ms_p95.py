"""``frame_ms_p95``: the 95th percentile, over every tick of the window,
of one real-time tick: the scan handed over as host arrays, through the
copy to the device and the step, to the pose back on the host (host
clock, milliseconds)."""

from portbench.harness import quantile


def read(run):
    w = run.window
    if not w or not w.latencies:
        return None
    return quantile(w.latencies, 0.95) * 1e3
