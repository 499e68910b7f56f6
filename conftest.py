"""Loaded by pytest before any test of the repository (``tests/``,
``portbench/tests``): one budget of PyTorch intra-op threads for the
workers of a parallel run.

PyTorch's intra-op pool defaults to one thread a core, so ``-n 6``
pytest-xdist workers on 8 cores would spin some 48 threads on 8 cores.
Under xdist each worker gets ``max(1, cpus // workers)`` threads, where
``cpus`` is the number of cores this process may run on and ``workers``
is xdist's ``PYTEST_XDIST_WORKER_COUNT``; without xdist the count is left
as PyTorch sets it. The card's run (``--noconftest -m gpu``) does not
load this file.
"""

import os


def intra_op_threads():
    """The rule's thread count for this process, or None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    return max(1, len(os.sched_getaffinity(0)) // max(1, int(workers)))


_THREADS = intra_op_threads()
if _THREADS is not None:
    try:
        import torch
    except ImportError:                    # the JAX tests run without it
        pass
    else:
        torch.set_num_threads(_THREADS)
