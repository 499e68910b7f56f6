"""``model_launches.*``: kernel launches a unit whose host call falls
inside the program's model spans (``layers.MAP``: ``train.forward`` and
``train.backward``, ``eval.model`` or ``stream.model``), on any thread,
from the profiled window."""

from portbench import layers


def read(run):
    return layers.launches(run, layers.spans(run, "model"))
