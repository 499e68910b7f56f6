"""``metrics/graph_share.py``: None for a program whose step has no graph
counter, the share of the steps counted so far that replayed where it has
one, and 0% in a traced CPU run, where the training step never captures a
graph."""

from types import SimpleNamespace

from portbench import run
from portbench.metrics import graph_share
from portbench.tests.test_portbench_loops import SEED, TINY


def _run(counts=None):
    """A run whose loop's step has the counter ``counts``, or none."""
    def train_step(state, raw):
        return state, {}
    if counts is not None:
        train_step.graph_counts = lambda: dict(counts)
    return SimpleNamespace(loop=SimpleNamespace(train_step=train_step))


def test_a_program_without_the_counter_reads_none():
    assert graph_share.read(_run()) is None
    assert graph_share.read(SimpleNamespace(loop=object())) is None
    assert graph_share.read(
        _run({"captures": 0, "replays": 0, "eager": 0})) is None


def test_the_share_of_the_steps_that_replayed():
    for counts, want in (({"captures": 1, "replays": 7, "eager": 1}, 87.5),
                         ({"captures": 2, "replays": 6, "eager": 2}, 75.0),
                         ({"captures": 0, "replays": 0, "eager": 5}, 0.0)):
        assert graph_share.read(_run(counts)) == want


def test_traced_cpu_run_reads_no_replay():
    r = run.execute("deeplio_kitti_tpu.train", SEED, 0.3, True,
                    device="cpu", overrides=TINY, log=lambda *_: None)
    assert r["metrics"]["graph_share.train"] == {"value": 0.0, "unit": "%"}
    assert r["correct"] is True
