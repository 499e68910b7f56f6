"""``copy_issue_ms.*``: the host's milliseconds a tick inside the
program's copy span (``stream.to_device``: the scan's host arrays to the
device), from the recorded pass of ``layers.issue_split`` (host
clock)."""

from portbench import layers


def read(run):
    return layers.issue_ms(run, "copy")
