"""The Darknet-53 cell and the data-parallel loop, on the CPU at tiny
sizes: the ``train_darknet`` loop runs, checks and compares; its FLOP
count at the configuration's own size, and the count the loop's set-up
keeps; and the ``train_dp`` loop's ranks (gloo on the CPU), their command channel and
its timeout."""

import subprocess
import sys
import textwrap
import time

import pytest
import torch

from portbench import harness, run, weights
from portbench.harness import ROOT
from portbench.loops import train, train_darknet, train_dp
from portbench.reference import darknet as rdk

TINY = {"datasets/image-height": 16, "datasets/image-width": 128,
        "datasets/max-points": 4096, "train/batch-size": 2,
        "compute-dtype": "float32"}
SEED = 2**31 + 12345
DARKNET = "deeplio_darknet53.train"
DP = "deeplio_kitti_tpu.train-dp4"


class Half(train_darknet.Loop):
    """Half of the batch left out, the mean taken over the rest."""

    def step(self, raw):
        b = self.windows // 2
        rows = b * self.frames
        return super().step({k: v[:rows] if k.startswith("points_")
                             else v[:b] for k, v in raw.items()})


def execute(cell):
    return run.execute(cell, SEED, 0.3, False, device="cpu",
                       overrides=TINY, log=lambda *_: None)


def test_darknet_mix_runs_and_checks():
    r = execute(DARKNET)
    assert "setup_s" in r["metrics"] and "train_pairs_per_s" in r["metrics"]
    assert r["attempted"] == train.CHECKED_STEPS
    checks = r["checks"]
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap",
                           "image_mismatch"}
    # the CPU's float32 against the float32 reference
    assert checks["image_mismatch"]["value"] == 0.0
    assert checks["loss_gap"]["value"] < 1e-3
    assert checks["grad_gap"]["value"] < 1e-3
    assert r["correct"] is True


def test_darknet_half_batch_is_not_correct(monkeypatch):
    monkeypatch.setattr(harness, "loop_class", lambda c: Half)
    r = execute(DARKNET)
    over = {k for k, c in r["checks"].items()
            if c["limit"] is not None and c["value"] > c["limit"]}
    assert {"loss_gap", "image_mismatch"} <= over
    assert r["correct"] is False


def test_darknet_flop_count_at_the_configurations_size():
    """261.9 GFLOP a pair forward at 64x1024 (the reference on meta
    tensors)."""
    cell = harness.load_cell(DARKNET)
    spec = rdk.model_spec(cell.cfg)
    fwd = train_darknet.model_flops(spec, 1, 1, 64, 1024, 16, train=False)
    assert abs(fwd / 261.9e9 - 1) < 1e-3


def test_reference_recomputation_leaves_the_step_unchanged():
    """The reference's recomputed stages give the gradients of the kept
    activations, and draw each channel-dropout mask once."""
    cell = harness.load_cell(DARKNET, overrides=TINY)
    spec = rdk.model_spec(cell.cfg)
    spec["darknet"].update(layers=21, stage_dropout=0.3)
    a = rdk.DeepLIO(spec).train()
    a.load_state_dict(weights.make_state(
        a, torch.Generator().manual_seed(0), "cpu"))
    b = rdk.DeepLIO(spec).train()
    b.load_state_dict(a.state_dict())
    b.recompute(False)
    imgs = torch.randn(2, 2, 4, 64, 10)
    imu, mask = torch.randn(2, 2, 16, 6), torch.ones(2, 2, 16)
    grads = []
    for net in (a, b):
        g = torch.Generator().manual_seed(3)
        x, q = net(imgs, imu, mask, g)
        grads.append(torch.autograd.grad((x.sum() + q.sum()),
                                         list(net.parameters())))
        grads[-1] += (g.get_state(),)
    for u, v in zip(*grads):
        assert torch.allclose(u.float(), v.float(), rtol=1e-5, atol=1e-6)


def test_darknet_setup_keeps_the_darknet_count():
    """The loop's FLOPs a unit are the Darknet reference's training step
    at the cell's shapes, not the PointSeg count ``train.Loop.setup``
    makes."""
    cell = harness.load_cell(DARKNET, overrides=TINY)
    loop = train_darknet.Loop(cell, SEED, torch.device("cpu"))
    try:
        loop.setup()
        want = train_darknet.model_flops(loop.spec, loop.windows,
                                         len(loop.combos), loop.H, loop.W,
                                         loop.T, train=True)
        assert loop.flops_per_unit == want
        assert loop.flops_per_unit > train.model_flops(
            loop.spec, loop.windows, len(loop.combos), loop.H, loop.W,
            loop.T, train=True)
    finally:
        loop.release()


def _dp_cell(world, windows, **traffic):
    """The four-chip cell as a later ``BENCHMARK.json`` entry would name
    it (its mix and limits are here; the cell is not in the benchmark,
    PERF.md §7), at a tiny size and ``world`` ranks."""
    bench = harness.load_bench()
    bench["workloads"].append({"name": DP, "config": "deeplio_kitti_tpu",
                               "traffic": "train_dp4", "chips": 4})
    cell = harness.load_cell(DP, bench=bench,
                             overrides={k: v for k, v in TINY.items()
                                        if k != "train/batch-size"})
    cell.traffic.update(world=world, windows=windows, **traffic)
    return cell


def test_dp_loop_over_gloo_ranks_runs_and_checks():
    """Two ranks over gloo on the CPU: rank 0 leads each unit, a unit's
    items are the global pairs, the FLOPs one rank's, and the check
    against the reference on the global batch (each rank's dropout masks)
    reads float32's noise."""
    cell = _dp_cell(2, 4)
    loop = train_dp.Loop(cell, SEED, torch.device("cpu"))
    try:
        loop.setup()
        assert (loop.windows, loop.global_windows) == (2, 4)
        assert loop.items_per_unit == 4 * len(loop.combos)
        w = loop.window(0.2, lambda: None)
        assert w.units >= 1 and w.items == w.units * loop.items_per_unit
        assert len(loop.issue_times()) == loop.issue_units
    finally:
        loop.release()
    assert all(p.exitcode == 0 for p in loop.procs)
    numbers = loop.check()
    assert numbers["image_mismatch"] == 0.0
    assert numbers["loss_gap"] < 1e-3 and numbers["grad_gap"] < 1e-3
    assert numbers["change_gap"] < 1e-2


def test_dp_rank_without_commands_ends_the_run():
    """Rank 0 sets up, then sends nothing: the other rank gives up after
    the mix's ``timeout_s`` and rank 0 ends its process with
    ``RANK_FAILED``, the other rank's traceback on standard error and
    nothing on standard output, well inside a minute of it."""
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        from portbench.tests.test_portbench_darknet import _dp_cell
        from portbench.loops import train_dp

        if __name__ == "__main__":
            torch.set_num_threads(2)
            loop = train_dp.Loop(_dp_cell(2, 4, timeout_s=3), 7,
                                 torch.device("cpu"))
            loop.setup()
            time.sleep(300)
            print("rank 0 was not ended")
    """)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == train_dp.RANK_FAILED, p.stderr[-2000:]
    assert p.stdout.strip() == ""
    assert "no command from rank 0 in 3.0 s" in p.stderr
    assert time.perf_counter() - t0 < 240
