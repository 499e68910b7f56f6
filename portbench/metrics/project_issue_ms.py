"""``project_issue_ms.*``: the host's milliseconds a unit inside the
program's projection span (``train.project``, ``eval.project`` or
``stream.project``), from the recorded pass of ``layers.issue_split``
(host clock)."""

from portbench import layers


def read(run):
    return layers.issue_ms(run, "project")
