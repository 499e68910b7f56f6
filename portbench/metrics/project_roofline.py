"""``project_roofline.*``: the projection's share of its roofline, in %:
the least time its bytes need at the HBM peak (each input plane read
once, 17 bytes a point, and the model batch written once:
``counts.projection_bytes``) over its device time, the loop's projection
calls on the cell's own distinct inputs captured in a CUDA graph and
replayed between CUDA events."""

from portbench.counts import roofline_s


def read(run):
    p = run.project_s()
    if p is None:
        return None
    seconds, nbytes = p
    return roofline_s(nbytes) / seconds * 100.0
