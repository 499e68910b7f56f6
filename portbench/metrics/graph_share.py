"""``graph_share.*``: the share, in %, of the run's training steps that
replayed the step's CUDA graph, from the program's own cumulative counter
(``train_step.graph_counts()``, ``train/graph.py``): replays over replays
and eager steps, every step of the run up to the read (the checked
steps, the measured window, the readers' passes). On the card the one
eager step of a run is its first, the graph's warm-up. None where the
program's step has no counter or has run no step."""


def read(run):
    counts = getattr(getattr(run.loop, "train_step", None), "graph_counts",
                     None)
    if counts is None:
        return None
    c = counts()
    steps = c["replays"] + c["eager"]
    return c["replays"] / steps * 100.0 if steps else None
