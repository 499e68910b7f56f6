"""``idle_share.*``: the share of the measured window, in %, in which no
operation ran on the device: 1 - the device's busy seconds a unit (the
union of the device operations' intervals in the profiled window, over
its units) over the measured window's seconds a unit. The profiler
stretches the host's time a unit, not the device's busy time, so the
busy time comes from the trace and the time a unit from the untraced
window."""


def read(run):
    t, w = run.trace(), run.window
    if not t.device_ops or not t.units or not w or not w.units:
        return None
    return (1.0 - (t.busy_s / t.units) / (w.seconds / w.units)) * 100.0
