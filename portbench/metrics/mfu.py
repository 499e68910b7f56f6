"""``mfu.*``: the whole step's share of the chip's peak, in %: the model
FLOPs of every unit of the window (the reference's count on meta tensors
at the cell's shapes: forward, plus loss and backward for training) over
the window's seconds and the bfloat16 dense peak (``counts.py``)."""


def read(run):
    return run.mfu()
