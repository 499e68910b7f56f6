"""``issue_ms.*``: the host's milliseconds to enqueue one unit (a step,
an eval call, a tick up to its pose's copy), the device idle before each:
the loop's ``issue_units`` calls, each after a synchronise, averaged
(host clock)."""


def read(run):
    return run.issue_s() * 1e3
