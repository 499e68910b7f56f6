"""``forward_ms.*``: device milliseconds a unit of the operations
launched inside the program's model spans (``layers.MAP``: ``eval.model``
in the eval loop), from the profiled window."""

from portbench import layers


def read(run):
    names = layers.spans(run, "model")
    t = run.trace()
    if not names or not t.device_ops:
        return None
    s = t.span_device_s(names)
    return None if s is None else s / t.units * 1e3
