"""``model_ms.*``: device milliseconds a unit of the operations launched
inside the loop's model spans (``train.forward`` and ``train.backward``,
or ``stream.model``), from the profiled window."""


def read(run):
    spans = run.loop.SPANS.get("model")
    if not spans:
        return None
    t = run.trace()
    s = t.span_device_s(spans)
    return None if s is None else s / t.units * 1e3
