"""``stream_graph_share.*``: the share, in %, of the run's streaming step
calls that replayed the tick's CUDA graph, from the program's own
cumulative counter (``so.step.graph_counts()``, ``train/graph.py``):
replays over replays and eager calls, every call of the run up to the
read (the set-up's warm ticks, the measured window, the readers' passes).
On the card the eager calls of a run are its first ticks, the graph's
warm-up. None where the program's step has no counter or has run no
call."""


def read(run):
    so = getattr(run.loop, "so", None)
    counts = getattr(getattr(so, "step", None), "graph_counts", None)
    if counts is None:
        return None
    c = counts()
    calls = c["replays"] + c["eager"]
    return c["replays"] / calls * 100.0 if calls else None
