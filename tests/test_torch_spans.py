"""The port's layer spans (``utils/timing.py::span``): nothing when no one
listens, a ``user_annotation`` under ``torch.profiler``, a record inside
``recording()``; and the spans the training step, the eval step and the
streaming tick record (the model's ``model.lidar`` nested in the layer
that runs the model), on the CPU at a tiny size (the kitti-tpu model at
16x128, 2048 points, float32), where the training step runs no CUDA
graph."""

import copy
import json
import pathlib
import threading

import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from deeplio_tpu_torch.utils import timing  # noqa: E402
from deeplio_tpu_torch.utils.timing import recording, span  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KITTI_TPU = ROOT / "configs" / "deeplio_kitti_tpu.yaml"
NPTS = 2048


def _no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(timing, "record_function", refuse)


def test_span_off_enters_nothing_and_records_nothing(monkeypatch):
    _no_annotation(monkeypatch)
    with recording() as rec:
        pass
    with span("train.forward"):
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert rec == [] and timing._recording is None


def test_recorder_alone_enters_no_annotation(monkeypatch):
    _no_annotation(monkeypatch)
    with recording() as rec:
        with span("a"):
            with span("b"):
                pass
        with span("c"):
            pass
    assert [(r.name, r.parent) for r in rec] == [("a", None), ("b", "a"),
                                                 ("c", None)]
    a, b, c = rec
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns <= c.start_ns
    assert c.start_ns <= c.end_ns
    assert {r.thread for r in rec} == {threading.get_ident()}


def test_recorder_keeps_each_threads_parents():
    seen = []

    def other():
        with span("other"):
            pass
        seen.append(threading.get_ident())

    with recording() as rec:
        with span("outer"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    by = {r.name: r for r in rec}
    assert by["other"].parent is None and by["other"].thread == seen[0]
    assert by["outer"].thread == threading.get_ident()


def test_span_is_a_user_annotation_under_the_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("eval.project"):
                torch.ones(4).add_(1)
            with span("eval.model"):
                torch.ones(4).mul_(2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation"]
    assert "eval.project" in names and "eval.model" in names
    # the recorder listened at the same time
    assert [r.name for r in rec] == ["eval.project", "eval.model"]


def _config():
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": NPTS, "sequence-size": 3,
                          "window-stride": 2})
    d["train"]["batch-size"] = 2
    return port_config(d)


@pytest.fixture(scope="module")
def tiny():
    cfg = _config()
    host = next(iter(WindowDataset(
        cfg.datasets, [SyntheticDrive(n_frames=7, max_points=NPTS)]
    ).iter_batches(2, shuffle=False)))
    model = build_model(cfg, device="cpu", seed=0)
    return cfg, model, batch_to_device(host, "cpu")


def _layers(rec):
    """(name, parent) of each record, checking that no top-level record
    overlaps the next (layer spans do not nest in one another) and that
    each nested one (the model's ``model.lidar``, inside the span that
    runs the model) lies inside the last top-level record before it."""
    top = [r for r in rec if r.parent is None]
    for r, nxt in zip(top, top[1:]):
        assert r.start_ns <= r.end_ns <= nxt.start_ns
    for r in rec:
        if r.parent is not None:
            outer = [t for t in top if t.start_ns <= r.start_ns][-1]
            assert outer.name == r.parent
            assert r.start_ns <= r.end_ns <= outer.end_ns
    return [(r.name, r.parent) for r in rec]


TRAIN_LAYERS = [("train.project", None), ("train.forward", None),
                ("model.lidar", "train.forward"), ("train.backward", None),
                ("train.update", None)]


def test_train_and_eval_steps_record_their_layers(tiny):
    cfg, model, raw = tiny
    state = create_train_state(cfg, model, seed=0)
    train_step, eval_step = build_train_step(cfg)
    with recording() as rec:
        state, metrics = train_step(state, raw)
    assert _layers(rec) == TRAIN_LAYERS
    assert torch.isfinite(metrics["loss"])
    with recording() as rec:
        x, q, _ = eval_step(state, raw)
    assert _layers(rec) == [("eval.project", None), ("eval.model", None),
                            ("model.lidar", "eval.model")]
    assert x.shape[:2] == q.shape[:2] == raw["x_gt"].shape[:2]


def test_train_step_on_the_cpu_is_eager_and_counted(tiny):
    """Off the card ``train_step`` never captures a graph: every step runs
    the eager forward and backward, the counters read eager steps only,
    each step records the same four layers, and the step equals
    ``train_step.eager`` bit for bit."""
    cfg, model, raw = tiny
    train_step, _ = build_train_step(cfg)
    assert train_step.graph_counts() == {"captures": 0, "replays": 0,
                                         "eager": 0}
    start = copy.deepcopy(model.state_dict())
    runs = []
    for step in (train_step, train_step.eager):
        model.load_state_dict(start)
        state = create_train_state(cfg, model, seed=0)
        losses = []
        for _ in range(2):
            with recording() as rec:
                state, metrics = step(state, raw)
            assert _layers(rec) == TRAIN_LAYERS
            losses.append(metrics["loss"])
        runs.append((losses, copy.deepcopy(model.state_dict())))
    assert train_step.graph_counts() == {"captures": 0, "replays": 0,
                                         "eager": 2}
    (got, got_sd), (want, want_sd) = runs
    assert [float(v) for v in got] == [float(v) for v in want]
    assert got[0] is not got[1] and float(got[0]) != float(got[1])
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


def test_eval_step_on_the_cpu_is_eager_and_counted(tiny):
    """Off the card ``eval_step`` never captures a graph: every call runs
    the eager forward and loss, the counters read eager calls only (and
    ``eval_step.eager`` counts nothing), each call records
    ``eval.project`` then ``eval.model``, and the call returns what
    ``eval_step.eager`` returns, bit for bit."""
    cfg, model, raw = tiny
    state = create_train_state(cfg, model, seed=0)
    _, eval_step = build_train_step(cfg)
    assert eval_step.graph_counts() == {"captures": 0, "replays": 0,
                                        "eager": 0}
    for _ in range(2):
        with recording() as rec:
            x, q, m = eval_step(state, raw)
        assert [r.name for r in rec if r.parent is None] == [
            "eval.project", "eval.model"]
        with recording() as rec:
            ex, eq, em = eval_step.eager(state, raw)
        assert [r.name for r in rec if r.parent is None] == [
            "eval.project", "eval.model"]
        assert torch.equal(x, ex) and torch.equal(q, eq)
        assert m.keys() == em.keys()
        for k in m:
            assert torch.equal(m[k], em[k]), k
    assert eval_step.graph_counts() == {"captures": 0, "replays": 0,
                                        "eager": 2}
    assert not state.model.training


def test_stream_tick_records_its_layers(tiny):
    cfg, model, _ = tiny
    so = StreamingOdometry(cfg, model, chunk=1, device="cpu")
    _, host = next(so.host_chunks(SyntheticDrive(n_frames=2,
                                                 max_points=NPTS)))
    carry = so.init_carry()
    with recording() as rec, torch.no_grad():
        chunk = so.to_device(host)
        *carry, poses, _, _ = so.step(*carry, *(chunk[k] for k in so.keys))
    assert _layers(rec) == [("stream.to_device", None),
                            ("stream.project", None), ("stream.model", None),
                            ("model.lidar", "stream.model"),
                            ("stream.compose", None)]
    assert poses.shape == (1, 4, 4)


STREAM_LAYERS = [("stream.project", None), ("stream.model", None),
                 ("model.lidar", "stream.model"), ("stream.compose", None)]


def test_stream_step_on_the_cpu_is_eager_and_counted(tiny):
    """Off the card the streaming step never captures a graph: calls with
    grad mode off, with it on and under ``torch.export``'s trace all run
    the eager chunk and count as eager (``step.eager`` counts nothing),
    each eager call records the tick's three layers, and a call returns
    what ``step.eager`` returns, bit for bit."""
    cfg, model, _ = tiny
    so = StreamingOdometry(cfg, model, chunk=2, device="cpu")
    _, host = next(so.host_chunks(SyntheticDrive(n_frames=2,
                                                 max_points=NPTS)))
    chunk = so.to_device(host)
    inputs = tuple(chunk[k] for k in so.keys)
    step = so.step
    assert step.graph_counts() == {"captures": 0, "replays": 0, "eager": 0}
    carry = so.init_carry()
    for grad in (False, False, True):
        with torch.set_grad_enabled(grad):
            with recording() as rec:
                got = step(*carry, *inputs)
            assert _layers(rec) == STREAM_LAYERS * 2
            want = step.eager(*carry, *inputs)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        carry = got[:3]
    with torch.no_grad():
        torch.export.export(step, (*so.init_carry(), *inputs), strict=False)
    assert step.graph_counts() == {"captures": 0, "replays": 0, "eager": 4}
