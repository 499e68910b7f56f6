"""The harness finds every cell's configuration, mix, loop, limits and
metric readers by name, and ``BENCHMARK.json`` keeps to the contract's
shape."""

import importlib
import json
import re

import pytest

from portbench import harness

BENCH = harness.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.cfg["source"] and "datasets" in c.cfg
    assert harness.loop_class(c).__name__ == "Loop"
    assert c.limits, f"no limits/{cell}.json"
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):
            assert w in CELLS
    assert all(len(v) == 1 for v in layers.values())


def test_unknown_cell():
    with pytest.raises(KeyError):
        harness.load_cell("no.such.cell")


def test_overrides_patch_the_configuration():
    c = harness.load_cell(CELLS[0], overrides={"datasets/image-height": 16})
    assert c.cfg["datasets"]["image-height"] == 16


def test_every_loop_imports():
    for t in ("train", "evaluate", "stream"):
        importlib.import_module(f"portbench.loops.{t}")
