"""``eval_graph_share.*``: the share, in %, of the run's eval calls that
replayed the call's CUDA graph, from the program's own cumulative counter
(``eval_step.graph_counts()``, ``train/graph.py``): replays over replays
and eager calls, every call of the run up to the read (the set-up's
calls, the measured window, the readers' passes). On the card the one
eager call of a run is its first, the graph's warm-up. None where the
program's eval call has no counter or has run no call."""


def read(run):
    counts = getattr(getattr(run.loop, "eval_step", None), "graph_counts",
                     None)
    if counts is None:
        return None
    c = counts()
    calls = c["replays"] + c["eager"]
    return c["replays"] / calls * 100.0 if calls else None
