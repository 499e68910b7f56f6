"""The port's ``Trainer`` against the JAX package's ``Trainer``, float32 on
the CPU, and the loop's host-side parts: the prefetcher on the CPU and the
plateau controller.

The run: ``configs/deeplio_kitti_tpu.yaml`` cut to 16x128 images,
2048-point scans, B = 2 windows of S = 3 frames (window stride 2), dropout
0, no augmentation, 2 synthetic train drives of 7 frames (6 windows, 3
steps an epoch) and 1 validation drive, ``log-every: 1``,
``checkpoint-every-steps: 2``, ``fit(epochs=2)``. The JAX Trainer runs
``backend: sort-sentinel`` packed (the same projection function as the
Pallas kernel) with ``data-parallel: 1`` on a one-device mesh; the port
runs ``backend: pallas`` (the kernel's plain version on the CPU) from the
JAX Trainer's initial variables, loaded through ``load_flax_variables``
before ``fit``.

Held exactly: the ``(step, split)`` sequence and the keys of
``metrics.jsonl``, the checkpoint labels and ``trainer_meta.json``'s
``epochs_done``. Held within tolerances, with their reasons:

* the first step's metrics within ``tests/test_torch_train.py``'s one-step
  tolerances (loss and loss_x 1e-4 of their magnitude, loss_q and
  grad_norm 1e-3; sx, sq equal: their initial values);
* the later training steps within its three-step tolerances (loss 1e-3,
  loss_x 1e-2, grad_norm 0.1, sx/sq 1e-4): Adam's first update keeps only
  the sign of each gradient, so elements whose gradient is zero up to
  rounding move 2 lr apart and the runs drift. Measured over 1 to 16 CPU
  threads, the worst by step 6 were loss 7.5e-4, loss_x 5.3e-3, grad_norm
  0.066, sx 1.7e-5. loss_q (the squared quaternion residual, 1e-4 of
  loss_x) is held on its own only through step 3, at the three-step 0.2
  (measured 0.018): from step 4 its relative drift reached 0.25 (4
  threads), so it is held there only through the total loss it enters;
* the validations' metrics (loss_q excluded for the same reason, measured
  0.10) and ``best_val`` to 1e-3 of their magnitude (measured 5.2e-5).
"""

import json
import pathlib
import shutil

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh  # noqa: E402
from deeplio_tpu.train import Trainer as JaxTrainer  # noqa: E402
from deeplio_tpu.train.optim import PlateauController as JaxPlateau  # noqa: E402
from deeplio_tpu.train.optim import make_optimizer as jax_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_dataset  # noqa: E402
from deeplio_tpu_torch.data.pipeline import DevicePrefetcher  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402
from deeplio_tpu_torch.train.optim import Optimizer, PlateauController  # noqa: E402
from deeplio_tpu_torch.train.step import batch_to_device  # noqa: E402

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
ONE_STEP = {"loss": 1e-4, "loss_x": 1e-4, "loss_q": 1e-3, "grad_norm": 1e-3}
LATER = {"loss": 1e-3, "loss_x": 1e-2, "grad_norm": 0.1, "sx": 1e-4,
         "sq": 1e-4}
FIRST_EPOCH_LOSS_Q = 0.2
VAL = {"loss": 1e-3, "loss_x": 1e-3, "sx": 1e-3, "sq": 1e-3}


def loop_dict(backend="pallas", **train):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({
        "image-height": 16, "image-width": 128, "max-points": 2048,
        "sequence-size": 3, "window-stride": 2, "backend": backend,
        "packed": True, "synthetic": True, "synthetic-frames": 7,
        "synthetic-train-drives": 2, "synthetic-eval-drives": 1})
    d["deeplio"]["dropout"] = 0.0
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 2, "data-parallel": 1,
                       **train})
    return d


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainers")
    jt = JaxTrainer(jax_config(loop_dict("sort-sentinel")),
                    workdir=str(root / "jax"),
                    mesh=make_mesh(data=1, devices=jax.devices()[:1]))
    variables = {"params": jax.device_get(jt.state.params),
                 "batch_stats": jax.device_get(jt.state.batch_stats)}
    jt.fit(epochs=2)
    jt.ckpt.wait()
    jax_labels = sorted(jt.ckpt._mgr.all_steps())
    jax_best, jax_step = jt.best_val, jt.step
    jt.close()

    pt = Trainer(port_config(loop_dict()), workdir=str(root / "port"),
                 device="cpu")
    load_flax_variables(pt.state.model, variables)
    pt.fit(epochs=2)
    port_labels = pt.ckpt.all_steps()
    port_best, port_step = pt.best_val, pt.step
    pt.close()
    out = {}
    for name, labels, best, step in (
            ("jax", jax_labels, jax_best, jax_step),
            ("port", port_labels, port_best, port_step)):
        with open(root / name / "trainer_meta.json") as f:
            meta = json.load(f)
        out[name] = {"metrics": _records(root / name / "metrics.jsonl"),
                     "labels": labels, "best": best, "step": step,
                     "meta": meta}
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_records_labels_and_meta_match_jax(runs):
    jm, pm = runs["jax"]["metrics"], runs["port"]["metrics"]
    assert [(r["step"], r["split"]) for r in pm] == \
        [(r["step"], r["split"]) for r in jm]
    assert [sorted(r) for r in pm] == [sorted(r) for r in jm]
    assert runs["port"]["labels"] == runs["jax"]["labels"] == [3, 4, 6]
    assert runs["port"]["step"] == runs["jax"]["step"] == 6
    assert runs["port"]["meta"]["epochs_done"] == \
        runs["jax"]["meta"]["epochs_done"] == 2
    assert runs["port"]["meta"]["plateau"] == runs["jax"]["meta"]["plateau"]


def test_first_step_matches_jax(runs):
    j, p = runs["jax"]["metrics"][0], runs["port"]["metrics"][0]
    assert (j["step"], j["split"]) == (1, "train")
    for k, tol in ONE_STEP.items():
        assert _rel(p[k], j[k]) <= tol, (k, p[k], j[k])
    assert (p["sx"], p["sq"]) == (j["sx"], j["sq"])


def test_later_steps_and_validations_match_jax(runs):
    for j, p in zip(runs["jax"]["metrics"][1:], runs["port"]["metrics"][1:]):
        where = (j["step"], j["split"])
        if j["split"] == "val":
            tols = VAL
        else:
            tols = dict(LATER)
            if j["step"] <= 3:
                tols["loss_q"] = FIRST_EPOCH_LOSS_Q
        for k, tol in tols.items():
            assert _rel(p[k], j[k]) <= tol, (where, k, p[k], j[k])
    assert _rel(runs["port"]["best"], runs["jax"]["best"]) <= VAL["loss"]
    assert runs["port"]["meta"]["best_val"] == runs["port"]["best"]


# ------------------------------------------------------------ prefetcher

@pytest.fixture(scope="module")
def small_ds():
    return build_dataset(port_config(loop_dict()), "train")


def test_prefetcher_yields_what_batch_to_device_gives(small_ds):
    want = [batch_to_device(b, "cpu")
            for b in small_ds.iter_batches(2, shuffle=True, seed=5)]
    it = DevicePrefetcher(small_ds.iter_batches(2, shuffle=True, seed=5),
                          "cpu", depth=1)
    got = list(it)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and "meta" not in g
        for k in w:
            assert g[k].device.type == "cpu"
            assert torch.equal(g[k], w[k]), k
    assert next(it, None) is None          # stays exhausted
    assert it.timings()["batches"] == 3


def test_prefetcher_propagates_producer_errors():
    def bad_iter():
        yield {"x": np.zeros((8, 2), np.float32)}
        raise RuntimeError("boom in loader")

    it = DevicePrefetcher(bad_iter(), "cpu", depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="boom in loader"):
        for _ in it:
            pass


def test_prefetcher_close_stops_the_producer(small_ds):
    it = DevicePrefetcher(small_ds.iter_batches(2, shuffle=False), "cpu",
                          depth=1)
    next(it)
    it.close()
    assert not it._thread.is_alive()


# ---------------------------------------------------------------- plateau

PLATEAU = {"name": "plateau", "gamma": 0.5, "patience": 2,
           "min-lr": 1.5e-4, "threshold": 1e-3}
VAL_LOSSES = [1.0, 0.9995, 0.8, 0.81, 0.805, 0.7999, 0.802, 0.9, 0.95,
              0.96, 0.97, 0.98, 0.99]


def test_plateau_controller_matches_jax():
    """The same validation losses give the same lr, best and bad counts,
    and the optimizer's lr is the float32 the JAX opt_state injects; a
    restored controller continues as the original does."""
    d = loop_dict()
    d["optimizer"]["scheduler"] = dict(PLATEAU)
    jcfg, pcfg = jax_config(d), port_config(d)
    tx = jax_optimizer(jcfg.optim)
    opt_state = tx.init({"w": np.zeros(3, np.float32)})
    jc, pc = JaxPlateau(jcfg.optim), PlateauController(pcfg.optim)
    opt = Optimizer(pcfg.optim, [torch.nn.Parameter(torch.zeros(3))])
    assert opt.learning_rate(0) == opt.learning_rate(10**6) == \
        float(np.float32(5e-4))
    lrs = []
    for i, v in enumerate(VAL_LOSSES):
        opt_state = jc.observe(v, opt_state)
        pc.observe(v, opt)
        assert pc.state_dict() == jc.state_dict(), i
        injected = float(opt_state[1].hyperparams["learning_rate"])
        assert opt.learning_rate(i) == injected, i
        lrs.append(pc.lr)
        if i == 5:
            saved = pc.state_dict()
    assert lrs[-1] == 1.5e-4 and len(set(lrs)) >= 3   # decays to the floor
    again = PlateauController(pcfg.optim)
    again.restore_state(saved)
    ref = JaxPlateau(jcfg.optim)
    ref.restore_state(saved)
    for v in VAL_LOSSES[6:]:
        ref.observe(v, None)
        again.observe(v, opt)
        assert again.state_dict() == ref.state_dict()


def test_plateau_fit_lowers_the_lr(tmp_path):
    """scheduler: plateau in the loop: a validation loss that never
    improves on the first lowers the lr, and resume keeps the lowered
    one."""
    d = loop_dict(**{"checkpoint-every-steps": 0, "log-every": 100})
    d["optimizer"]["scheduler"] = {"name": "plateau", "patience": 1,
                                   "threshold": 1e9}
    cfg = port_config(d)
    wd = tmp_path / "run"
    t = Trainer(cfg, workdir=str(wd), device="cpu")
    t.fit(epochs=2)
    lr = t.state.optimizer.lr
    t.close()
    # the threshold makes the second validation a bad one: one decay
    assert lr == float(np.float32(5e-4 * 0.5))
    t2 = Trainer(cfg, workdir=str(wd), resume=True, device="cpu")
    assert t2.state.optimizer.lr == lr and t2.plateau.lr == 5e-4 * 0.5
    t2.close()
    shutil.rmtree(wd)
