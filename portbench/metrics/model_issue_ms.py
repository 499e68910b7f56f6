"""``model_issue_ms.*``: the host's milliseconds a unit inside the
program's model spans (``train.forward`` and ``train.backward``,
``eval.model`` or ``stream.model``), from the recorded pass of
``layers.issue_split`` (host clock)."""

from portbench import layers


def read(run):
    return layers.issue_ms(run, "model")
