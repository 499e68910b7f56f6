"""The thread budget of the root ``conftest.py``: under pytest-xdist each
worker runs ``max(1, cpus // workers)`` PyTorch intra-op threads; without
xdist the count is PyTorch's own."""

import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPUS = len(os.sched_getaffinity(0))


def _threads(workers):
    """PyTorch's intra-op threads in a fresh interpreter before and after
    it imports the root ``conftest.py``, with ``PYTEST_XDIST_WORKER_COUNT``
    set to ``workers`` (unset for None)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS")}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    run = subprocess.run(
        [sys.executable, "-c", "import torch; n = torch.get_num_threads(); "
         "import conftest; print(n, torch.get_num_threads())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return tuple(int(v) for v in run.stdout.split())


def test_this_process_runs_the_rule():
    """Under xdist this worker has its share of the cores; run without
    xdist it has PyTorch's default, as a fresh interpreter does."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert torch.get_num_threads() == _threads(None)[0]
    else:
        assert torch.get_num_threads() == max(1, CPUS // int(workers))


@pytest.mark.parametrize("workers", [None, 1, 6, 4 * CPUS])
def test_conftest_sets_the_rule(workers):
    before, after = _threads(workers)
    if workers is None:
        assert after == before
    else:
        assert after == max(1, CPUS // workers)
