"""``layers.py`` and its readers: the map against every loop, the launch
count and the device time inside spans on a hand-made trace, a program
without the span recorder, and the host split in a traced CPU run of
each cell."""

import importlib
import json
from types import SimpleNamespace

import pytest

from portbench import harness, layers, run, trace
from portbench.harness import HERE
from portbench.metrics import forward_ms, model_launches
from portbench.tests.test_portbench_loops import SEED, TINY

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_map_covers_every_loop():
    loops = {p.stem for p in (HERE / "loops").glob("*.py")} - {
        "__init__", "common"}
    assert set(layers.MAP) == loops
    for p in (HERE / "traffic").glob("*.json"):
        assert json.loads(p.read_text())["loop"] in layers.MAP
    for name in loops:
        loop = importlib.import_module(f"portbench.loops.{name}").Loop
        # the device-time readers and the host split read the same spans
        for layer, spans in loop.SPANS.items():
            assert layers.MAP[name][layer] == spans, (name, layer)
    for spans in layers.MAP.values():
        names = [n for ns in spans.values() for n in ns]
        assert len(names) == len(set(names))


def _ev(cat, name, ts, dur=0.0, corr=None, tid=1):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _run(loop, t):
    return SimpleNamespace(cell=SimpleNamespace(traffic={"loop": loop}),
                           trace=lambda: t, notes=[])


@pytest.fixture
def hand_made():
    """Two eval calls in a 1 ms window (times in us): kernels launched in
    ``eval.project`` (1), in ``eval.model`` from two threads (2, 3, 5)
    and outside every span (4)."""
    events = [
        _ev("user_annotation", trace.WINDOW, 0.0, 1000.0),
        _ev("user_annotation", "eval.project", 10.0, 80.0),
        _ev("user_annotation", "eval.model", 100.0, 300.0),
        _ev("user_annotation", "eval.model", 600.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, 2),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 350.0, 2.0, 3, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 500.0, 2.0, 4),
        _ev("cuda_runtime", "cudaLaunchKernel", 650.0, 2.0, 5),
        _ev("cuda_runtime", "cudaMemcpyAsync", 660.0, 2.0, 6),
    ]
    for corr, (ts, dur) in enumerate([(30, 5), (160, 7), (360, 11),
                                      (510, 13), (700, 17)], start=1):
        events.append(_ev("kernel", f"k{corr}", ts, dur, corr))
    events.append(_ev("gpu_memcpy", "Memcpy HtoD", 670.0, 19.0, 6))
    return trace.parse(events, units=2)


def test_launches_count_the_kernels_launched_inside_spans(hand_made):
    r = _run("evaluate", hand_made)
    assert layers.launches(r, ("eval.model",)) == 3 / 2
    assert layers.launches(r, ("eval.project",)) == 1 / 2
    assert layers.launches(r, ("eval.project", "eval.model")) == 4 / 2
    assert model_launches.read(r) == 3 / 2
    assert layers.launches(r, ("train.forward",)) is None
    # the loop's map names no span in this trace
    assert model_launches.read(_run("train", hand_made)) is None


def test_forward_ms_is_the_device_time_launched_inside_the_model(hand_made):
    r = _run("evaluate", hand_made)
    # kernels 2, 3 and 5 (7 + 11 + 17 us) over 2 calls; as model_ms, it
    # counts what launch calls started, not the copy issued in the span
    assert forward_ms.read(r) == pytest.approx((7 + 11 + 17) / 2 / 1e3)
    assert forward_ms.read(_run("train", hand_made)) is None


def test_a_trace_without_launches_reads_none():
    t = trace.parse([_ev("user_annotation", trace.WINDOW, 0.0, 100.0),
                     _ev("user_annotation", "eval.model", 10.0, 50.0)], 1)
    r = _run("evaluate", t)
    assert model_launches.read(r) is None and forward_ms.read(r) is None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    from deeplio_tpu_torch.utils import timing
    monkeypatch.delattr(timing, "recording")
    r = _run("stream", None)
    r.loop = None                       # never run
    assert layers.issue_split(r) is None
    assert layers.issue_ms(r, "copy") is None
    assert r.notes == ["issue split: the program has no span recorder"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reports_the_host_split(cell):
    notes = []
    r = run.execute(cell, SEED, 0.3, True, device="cpu", overrides=TINY,
                    log=notes.append)
    want = {m["name"] for m in BENCH["per_layer"]
            if "_issue_ms." in m["name"] and cell in m["workloads"]}
    assert want and want <= set(r["metrics"])
    for name in want:
        assert r["metrics"][name]["value"] > 0.0
        assert r["metrics"][name]["unit"] == "ms"
    # the CPU launches no kernel: the profile's counts are left out
    assert not any(k.startswith(("model_launches.", "forward_ms."))
                   for k in r["metrics"])
    split = [n for n in notes if n.startswith("issue split: ")]
    assert len(split) == 1 and "% covered" in split[0]
    assert r["correct"] is True
