"""The data-parallel ``Trainer`` and the projection cache's waiter, on the
CPU.

World 2 (two gloo processes, ``tests/_torch_dp.py``):
``configs/deeplo_synth.yaml`` cut to 16x64 images, 512 points and widths
of 8 to 16, float32, dropout 0, SGD, a global batch of 4 (2 rows a rank),
validation and a checkpoint every 2 steps. Each rank refuses a batch the
ranks cannot split and ``device-dataset`` (JAX's two errors), fits one
epoch, resumes in a fresh Trainer (the restored step and parameters are
the saved ones) and fits one more, then predicts the validation drive
over the mesh. Checked: both ranks hold the same parameters after each
epoch; the work directory has one ``metrics.jsonl`` with each step once,
JAX's checkpoint labels, ``best/`` and ``trainer_meta.json``, from rank 0
only; the run's losses equal a one-process run's on the same global
batches within 1e-5 of their magnitude at step 1 (the same weights) and,
as the ranks sum their halves in another order, after it within 1e-4
(``loss``, ``loss_x``; measured 5e-6) and 1e-3 (``loss_q``, the squared
quaternion residual, which magnifies the rest; measured 1.4e-4 by step
5); and the ranks' gathered predictions equal a one-process
``predict_drive`` from the same checkpoint within 1e-5 of their largest
magnitude.

In process: the waiter of ``ProjectionCache.ensure`` (a rank that is not
the primary, as ``tests/unit/test_proj_cache.py`` runs JAX's) returns when
the primary's file lands, raises ``RuntimeError`` once the heartbeat is
stale for ``stall_s`` and ``TimeoutError`` at ``timeout_s``; the primary
beats while it builds and removes its heartbeat after.
"""

import json
import pathlib
import threading
import time

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config_dict  # noqa: E402
from deeplio_tpu_torch.data import proj_cache  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_drives  # noqa: E402
from deeplio_tpu_torch.eval.runner import predict_drive  # noqa: E402
from deeplio_tpu_torch.parallel import multihost  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402
from tests._torch_dp import run_ranks, trainer_rank  # noqa: E402

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
WORLD = 2


def _dict():
    with open(CONFIGS / "deeplo_synth.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 64,
                          "max-points": 512, "synthetic-frames": 7,
                          "synthetic-train-drives": 2,
                          "synthetic-eval-drives": 1})
    d["deeplo"]["dropout"] = 0.0
    d["lidar-feat-simple-0"].update({"feature-size": 16, "base-channels": 8})
    d["odom-feat-rnn"]["hidden-size"] = 16
    d["optimizer"] = {"name": "sgd", "lr": 0.01, "momentum": 0.9}
    d["train"].update({"batch-size": 4, "log-every": 1,
                       "checkpoint-every-steps": 2, "keep-checkpoints": 2})
    return d


def _records(workdir):
    with open(pathlib.Path(workdir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module", autouse=True)
def no_optional_imports():
    """No TensorBoard (it imports TensorFlow) and no matplotlib here, as in
    the ranks and ``tests/test_torch_cli.py``: the metrics are the JSONL
    file."""
    import sys
    names = ("torch.utils.tensorboard", "matplotlib")
    saved = {n: sys.modules.get(n, False) for n in names}
    for n in names:
        sys.modules[n] = None                          # ImportError
    yield
    for n, m in saved.items():
        if m is False:
            del sys.modules[n]
        else:
            sys.modules[n] = m


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    d = _dict()
    wd = str(root / "dp2")
    ranks = run_ranks(trainer_rank, WORLD, d, wd, timeout=150.0)
    cfg = load_config_dict(d)
    # the ranks' intra-op threads (tests/_torch_dp.py): the one-process
    # run then sums in their order, which the comparisons' tolerances need
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = Trainer(cfg, str(root / "dp1"), device="cpu")
        one.fit(epochs=2)
        one.close()
        restored = Trainer(cfg, wd, resume=True, eval_only=True,
                           device="cpu")
        pred = predict_drive(cfg, restored.eval_step, restored.state,
                             build_drives(cfg, "validation")[0],
                             device="cpu")
        restored.close()
    finally:
        torch.set_num_threads(threads)
    return ranks, wd, str(root / "dp1"), pred


def test_ranks_refuse_what_jax_refuses(world):
    ranks, _, _, _ = world
    for r in ranks:
        assert "not divisible by data-parallel size 2" in r["odd_batch"]
        assert r["device_dataset"] == "device-dataset is single-process only"


def test_ranks_hold_the_same_parameters(world):
    ranks, _, _, _ = world
    a, b = ranks
    assert (a["primary"], b["primary"]) == (True, False)
    for k in ("params", "restored", "params2"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["sx_sq"] == b["sx_sq"]
    for r in ranks:
        assert r["restored_step"] == r["step"] and r["step2"] == 2 * r["step"]
        np.testing.assert_array_equal(r["restored"], r["params"])
        assert not np.array_equal(r["params2"], r["params"])


def test_only_rank_0_writes(world):
    ranks, wd, _, _ = world
    steps = ranks[0]["step2"]
    records = _records(wd)
    train = [r["step"] for r in records if r["split"] == "train"]
    assert train == list(range(1, steps + 1))
    assert [r["split"] for r in records].count("val") == 2
    ckpts = sorted(int(p.name) for p in (pathlib.Path(wd) /
                                         "checkpoints").iterdir())
    assert ckpts[-1] == steps and len(ckpts) == 2
    for name in ("best/params.pt", "trainer_meta.json"):
        assert (pathlib.Path(wd) / name).exists(), name
    assert not list(pathlib.Path(wd).rglob("*.tmp.*"))


def test_world_matches_one_process(world):
    _, wd, one_wd, _ = world
    got = [r for r in _records(wd) if r["split"] == "train"]
    want = [r for r in _records(one_wd) if r["split"] == "train"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for k in ("loss", "loss_x", "loss_q"):
            tol = 1e-5 if g["step"] == 1 else (1e-3 if k == "loss_q"
                                               else 1e-4)
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (g["step"], k)


def test_predict_drive_over_the_mesh(world):
    ranks, _, _, (dx, dq) = world
    for r in ranks:
        got_x, got_q = r["pred"]
        assert got_x.shape == dx.shape and got_q.shape == dq.shape
        assert float(np.abs(got_x - dx).max()) <= 1e-5 * float(
            np.abs(dx).max())
        assert float(np.abs(got_q - dq).max()) <= 1e-5 * float(
            np.abs(dq).max())


# ------------------------------------------------ the projection cache

class _Stub:
    start = 0

    def __init__(self, name):
        self.name = name

    def __len__(self):
        return 5


@pytest.fixture
def waiter(tmp_path, monkeypatch):
    """A cache seen from a rank that is not the primary, polling fast."""
    monkeypatch.setattr(multihost, "is_primary", lambda: False)
    monkeypatch.setattr(proj_cache, "POLL_S", 0.05)
    cfg = load_config_dict(_dict())
    return proj_cache.ProjectionCache(str(tmp_path), cfg.datasets,
                                      device="cpu")


def _beat(cache, stop, deliver=None, after=None):
    t0 = time.time()
    while not stop.is_set():
        with open(cache._heartbeat(), "w") as f:
            f.write("alive")
        if deliver is not None and time.time() - t0 > after:
            np.save(cache._path(deliver), np.zeros((1,), np.float16))
            return
        time.sleep(0.05)


def test_waiter_returns_when_the_file_lands(waiter):
    stub = _Stub("slow")
    stop = threading.Event()
    th = threading.Thread(target=_beat, args=(waiter, stop, stub, 0.5))
    th.start()
    try:
        t0 = time.time()
        waiter.ensure([stub], timeout_s=30.0, stall_s=0.3)
        assert 0.4 < time.time() - t0 < 10.0
    finally:
        stop.set()
        th.join(timeout=10.0)
    assert not th.is_alive()


def test_waiter_raises_on_a_stale_heartbeat(waiter):
    t0 = time.time()
    with pytest.raises(RuntimeError, match="heartbeat went stale"):
        waiter.ensure([_Stub("dead")], timeout_s=3600.0, stall_s=0.3)
    assert time.time() - t0 < 10.0


def test_waiter_times_out_on_a_live_heartbeat(waiter):
    stop = threading.Event()
    th = threading.Thread(target=_beat, args=(waiter, stop))
    th.start()
    try:
        with pytest.raises(TimeoutError, match="within the timeout"):
            waiter.ensure([_Stub("never")], timeout_s=0.5, stall_s=30.0)
    finally:
        stop.set()
        th.join(timeout=10.0)
    assert not th.is_alive()


def test_primary_beats_while_it_builds(tmp_path, monkeypatch):
    """The primary's heartbeat exists during the build (read from inside
    the projector) and is gone after it."""
    cfg = load_config_dict(_dict())
    cache = proj_cache.ProjectionCache(str(tmp_path), cfg.datasets,
                                       device="cpu")
    seen = []
    build = proj_cache.ProjectionCache._build

    def spy(self, drives, batch):
        seen.append(pathlib.Path(self._heartbeat()).exists())
        return build(self, drives, batch)

    monkeypatch.setattr(proj_cache.ProjectionCache, "_build", spy)
    drive = build_drives(cfg, "validation")[0]
    cache.ensure([drive], batch=4)
    assert seen == [True]
    assert pathlib.Path(cache._path(drive)).exists()
    assert not pathlib.Path(cache._heartbeat()).exists()
    cache.ensure([drive], batch=4)           # built: nothing to do
    assert seen == [True]
