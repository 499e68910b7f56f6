"""Each mix end to end at a tiny size on the CPU (the timed command
itself refuses the CPU), and the check seeing ``correct`` come out false
when the timed path is broken underneath: a training step that leaves
its state unchanged, half of the batch left out with the mean over the
rest, one answer altered where it is produced. The faults are planted
by subclassing each mix's loop; the timed loops carry none."""

import subprocess
import sys

import pytest

from portbench import harness, run
from portbench.harness import HERE, ROOT
from portbench.loops import evaluate, stream, train

TINY = {"datasets/image-height": 16, "datasets/image-width": 128,
        "datasets/max-points": 4096, "train/batch-size": 2,
        "compute-dtype": "float32"}
SEED = 2**31 + 12345


class Frozen(train.Loop):
    """A step that returns its state unchanged."""

    def checked_steps(self, step_mod):
        self.state.optimizer.inner.step = lambda *a, **k: None
        return super().checked_steps(step_mod)


class Half(train.Loop):
    """Half of the batch left out, the mean taken over the rest."""

    def step(self, raw):
        b = self.windows // 2
        rows = b * self.frames
        return super().step({k: v[:rows] if k.startswith("points_")
                             else v[:b] for k, v in raw.items()})


class EvalAnswer(evaluate.Loop):
    """One answer altered where it is produced."""

    def unit(self, i):
        b, x, q, loss = super().unit(i)
        x = x.clone()
        x[0, 0, 0] += 1.0
        return b, x, q, loss


class StreamAnswer(stream.Loop):
    """The window's first tick's answer altered where it is produced."""

    fault_tick = None                   # set once the warm-up is done

    def setup(self):
        super().setup()
        self.fault_tick = self.tick + 1

    def unit(self, i):
        f, p, x, q = super().unit(i)
        if self.tick == self.fault_tick:
            x = x + 1.0
            p = p.clone()
            p[0, :3, 3] += 1.0
        return f, p, x, q


def execute(cell, trace=False):
    return run.execute(cell, SEED, 0.3, trace, device="cpu",
                       overrides=TINY, log=lambda *_: None)


@pytest.mark.parametrize("cell", ["deeplio_kitti_tpu.train",
                                  "deeplio_kitti.train",
                                  "deeplio_kitti_tpu.score",
                                  "deeplio_kitti_tpu.stream"])
def test_mix_runs(cell):
    r = execute(cell)
    assert set(r) >= {"correct", "attempted", "failed", "metrics",
                      "device", "checks"}
    assert list(r)[-1] == "checks"
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    assert r["attempted"] > 0
    for c in r["checks"].values():
        assert c["value"] >= 0.0
    # the CPU's float32 against the float32 reference: the same model batch
    assert r["checks"]["image_mismatch"]["value"] == 0.0


@pytest.mark.parametrize("cell,fault,numbers", [
    ("deeplio_kitti_tpu.train", Frozen, {"grad_gap", "change_gap"}),
    ("deeplio_kitti_tpu.train", Half, {"loss_gap", "image_mismatch"}),
    ("deeplio_kitti.train", Frozen, {"grad_gap", "change_gap"}),
    ("deeplio_kitti.train", Half, {"image_mismatch"}),
    ("deeplio_kitti_tpu.score", EvalAnswer, {"x_gap"}),
    ("deeplio_kitti_tpu.stream", StreamAnswer, {"x_gap", "pose_gap"}),
], ids=lambda v: getattr(v, "__name__", None))
def test_fault_is_not_correct(cell, fault, numbers, monkeypatch):
    monkeypatch.setattr(harness, "loop_class", lambda c: fault)
    r = execute(cell)
    over = {k for k, c in r["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]}
    assert numbers <= over
    assert r["correct"] is False and r["failed"] == len(over)


def test_traced_run_reads_per_layer_metrics_on_cpu_trace():
    r = execute("deeplio_kitti_tpu.score", trace=True)
    # the CPU has no device trace: host-clock metrics only
    assert "issue_ms.score" in r["metrics"]
    assert "mfu.score" in r["metrics"]


def test_command_refuses_without_a_card():
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "deeplio_kitti_tpu.train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
