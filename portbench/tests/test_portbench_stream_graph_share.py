"""``metrics/stream_graph_share.py``: None for a program whose streaming
step has no graph counter, the share of the calls counted so far that
replayed where it has one, and 0% in a traced CPU run, where the step
never captures a graph."""

from types import SimpleNamespace

from portbench import run
from portbench.metrics import stream_graph_share
from portbench.tests.test_portbench_loops import SEED, TINY


def _run(counts=None):
    """A run whose loop's streaming step has the counter ``counts``, or
    none."""
    def step(*carry_and_inputs):
        return None
    if counts is not None:
        step.graph_counts = lambda: dict(counts)
    return SimpleNamespace(loop=SimpleNamespace(so=SimpleNamespace(
        step=step)))


def test_a_program_without_the_counter_reads_none():
    assert stream_graph_share.read(_run()) is None
    assert stream_graph_share.read(SimpleNamespace(loop=object())) is None
    assert stream_graph_share.read(SimpleNamespace(
        loop=SimpleNamespace(so=object()))) is None
    assert stream_graph_share.read(
        _run({"captures": 0, "replays": 0, "eager": 0})) is None


def test_the_share_of_the_calls_that_replayed():
    for counts, want in (({"captures": 1, "replays": 7, "eager": 1}, 87.5),
                         ({"captures": 1, "replays": 6, "eager": 2}, 75.0),
                         ({"captures": 0, "replays": 0, "eager": 5}, 0.0)):
        assert stream_graph_share.read(_run(counts)) == want


def test_traced_cpu_run_reads_no_replay():
    r = run.execute("deeplio_kitti_tpu.stream", SEED, 0.3, True,
                    device="cpu", overrides=TINY, log=lambda *_: None)
    assert r["metrics"]["stream_graph_share.stream"] == {"value": 0.0,
                                                         "unit": "%"}
    assert r["correct"] is True
