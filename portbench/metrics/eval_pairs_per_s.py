"""``eval_pairs_per_s``: frame pairs of every eval call completed in the
window, over the window's seconds, from the first issue to the last
result (host clock)."""


def read(run):
    w = run.window
    return w.items / w.seconds if w and w.items else None
