"""``update_ms.*``: device milliseconds a step of the operations launched
inside the loop's update span (``train.update``: the clip and Adam), from
the profiled window."""


def read(run):
    spans = run.loop.SPANS.get("update")
    if not spans:
        return None
    t = run.trace()
    s = t.span_device_s(spans)
    return None if s is None else s / t.units * 1e3
