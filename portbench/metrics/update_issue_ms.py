"""``update_issue_ms.*``: the host's milliseconds a step inside the
program's update span (``train.update``: the clip and the optimizer),
from the recorded pass of ``layers.issue_split`` (host clock)."""

from portbench import layers


def read(run):
    return layers.issue_ms(run, "update")
