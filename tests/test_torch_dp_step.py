"""The port's data-parallel training step against its one-process step
and JAX's shard_map step, float32 on the CPU.

Two configurations, each one SGD step (momentum 0.9, so the first update
is ``-lr * clip(g)`` and the parameters compare after it) from the port's
seeded init, carried into JAX by ``models/from_flax.py`` (a flax init of
PointSeg costs many seconds), on one global batch of 4 all-valid windows
from the synthetic drives, dropout 0:

* ``deeplo``: ``tests/distributed/_mh_common.py``'s configuration
  (``configs/deeplo_synth.yaml`` at 16x128, 2048 points, float32), the
  scatter kernel's plain version through ``backend: sort``;
* ``deeplio``: ``configs/deeplio_synth.yaml`` cut to 16x64, 1024 points,
  hidden widths of 16, yaw augmentation off (PointSeg, LWS loss).

Three runs of the same step: the port at dp-2 (two gloo processes, each
with its 2 windows, ``tests/_torch_dp.py``), the port at dp-1 (a mesh of
one, in this process, on all 4 windows) and JAX at dp-2
(``build_train_step`` on a 2-device mesh). Each then runs its eval step
on the same rows, whose predictions come back gathered.

Tolerances. The two ranks hold the same state after the step: their
metrics, parameters, ``sx``/``sq``, BatchNorm statistics and gathered
predictions are bit-equal. Against dp-1 and JAX the sums are taken in
other orders (a two-rank mean of two halves, oneDNN against XLA): the
losses within 1e-5 (dp-1) and 1e-4 (JAX) of their magnitude,
``grad_norm`` and ``loss_q`` within 1e-4 and 1e-3; ``sx``/``sq`` within
1e-6 absolute; the BatchNorm statistics within 1e-5 of each leaf's
largest magnitude; the update of the parameters (new - old) within 1e-3
of its largest magnitude element by element and 2e-2 of its norm in L2;
the eval step's predictions within 1e-4 of their largest magnitude.
Measured with two threads a process: ``deeplo`` 7e-7 and 3e-6 of the
update (both references); ``deeplio``, whose last PointSeg BatchNorms
normalise over a few values per channel and magnify rounding, 3.3e-4
element by element and 1.6e-3 (dp-1) and 4.1e-3 (JAX) in L2; every
metric within 1e-5 of its magnitude.
"""

import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.losses import init_loss_params as jax_loss_params  # noqa: E402
from deeplio_tpu.models import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from deeplio_tpu.parallel.mesh import replicate, shard_batch  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_dataset  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from tests._torch_dp import run_ranks, step_rank  # noqa: E402
from tests.distributed._mh_common import make_cfg  # noqa: E402

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
GLOBAL_B = 4
WORLD = 2
THREADS = 2          # the ranks' intra-op threads, and dp-1's
SGD = {"name": "sgd", "lr": 0.05, "momentum": 0.9}


def _load(name):
    with open(CONFIGS / name) as f:
        return yaml.safe_load(f)


def _deeplo():
    """``_mh_common.make_cfg("deeplo")`` as a YAML dict (held equal to it
    below), with SGD, dropout 0 and the global batch."""
    d = _load("deeplo_synth.yaml")
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "synthetic-frames": 12})
    assert jax_config(d) == make_cfg("deeplo")
    d["deeplo"]["dropout"] = 0.0
    return d


def _deeplio():
    d = _load("deeplio_synth.yaml")
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 64,
                          "max-points": 1024, "synthetic-frames": 12,
                          "augment-yaw": False})
    d["deeplio"]["dropout"] = 0.0
    d["lidar-feat-pointseg"]["feature-size"] = 16
    for net in ("imu-feat-rnn", "odom-feat-rnn"):
        d[net]["hidden-size"] = 16
    return d


CASES = {"deeplo": _deeplo, "deeplio": _deeplio}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request):
    d = CASES[request.param]()
    d["optimizer"] = dict(SGD)
    d["train"]["batch-size"] = GLOBAL_B
    jcfg, pcfg = jax_config(d), port_config(d)
    host = next(build_dataset(pcfg, "train").iter_batches(
        GLOBAL_B, shuffle=False))
    assert host["valid"].all()

    variables = to_flax_variables(build_model(pcfg, device="cpu", seed=0))
    model = jax_build_model(jcfg, "data")

    # JAX dp-2
    mesh = jax_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    tx = make_optimizer(jcfg.optim, 100)
    state = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, jax_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    jstep, jeval = jax_build_train_step(jcfg, model, tx, mesh)
    state, jm = jstep(state, shard_batch(mesh, host))
    jx, jq, jem = jeval(state, shard_batch(mesh, host))
    jax_run = {"metrics": {k: float(v) for k, v in
                           jax.device_get(jm).items()},
               "variables": {"params": jax.device_get(state.params),
                             "batch_stats": jax.device_get(
                                 state.batch_stats)},
               "loss_params": {k: np.asarray(v) for k, v in
                               jax.device_get(state.loss_params).items()},
               "x": np.asarray(jx), "q": np.asarray(jq),
               "eval_metrics": {k: float(v) for k, v in
                                jax.device_get(jem).items()}}

    # port dp-1: a mesh of one process, all the rows
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        port = build_model(pcfg, device="cpu", seed=None)
        load_flax_variables(port, variables)
        pstate = port_state(pcfg, port, steps_per_epoch=100)
        pstep, peval = build_train_step(pcfg)
        raw = batch_to_device(host, "cpu")
        pstate, pm = pstep(pstate, raw)
        px, pq, pem = peval(pstate, raw)
    finally:
        torch.set_num_threads(threads)
    dp1 = {"metrics": {k: float(v) for k, v in pm.items()},
           "variables": to_flax_variables(port),
           "loss_params": {k: v.detach().numpy() for k, v in
                           pstate.loss_params.items()},
           "x": px.numpy(), "q": pq.numpy(),
           "eval_metrics": {k: float(v) for k, v in pem.items()}}

    ranks = run_ranks(step_rank, WORLD, d, variables, host, timeout=150.0)
    return request.param, variables, ranks, dp1, jax_run


def test_ranks_hold_the_same_state(runs):
    _, _, ranks, _, _ = runs
    a, b = ranks
    assert a["metrics"] == b["metrics"]
    assert a["eval_metrics"] == b["eval_metrics"]
    for k in ("x", "q"):
        np.testing.assert_array_equal(a[k], b[k])
    for k, v in a["loss_params"].items():
        np.testing.assert_array_equal(v, b["loss_params"][k])
    la, lb = _leaves(a["variables"]), _leaves(b["variables"])
    assert la.keys() == lb.keys()
    for k, v in la.items():
        np.testing.assert_array_equal(v, lb[k], err_msg=k)


@pytest.mark.parametrize("against", ["dp1", "jax"])
def test_dp2_step_matches(runs, against):
    name, old, ranks, dp1, jax_run = runs
    got = ranks[0]
    want = dp1 if against == "dp1" else jax_run
    loss_tol, norm_tol = (1e-5, 1e-4) if against == "dp1" else (1e-4, 1e-3)
    m, w = got["metrics"], want["metrics"]
    assert m.keys() == w.keys()
    for k in m:
        tol = norm_tol if k in ("grad_norm", "loss_q") else loss_tol
        assert _rel(m[k], w[k]) <= tol, (k, m[k], w[k])
    # sx, sq after the update
    assert got["loss_params"].keys() == want["loss_params"].keys()
    assert bool(got["loss_params"]) == (name in ("deeplo", "deeplio"))
    for k, v in got["loss_params"].items():
        ref = want["loss_params"][k]
        assert abs(float(v) - float(ref)) <= 1e-6, k
    new, ref = _leaves(got["variables"]), _leaves(want["variables"])
    assert new.keys() == ref.keys()
    before = _leaves(old)
    for k in (k for k in new if "batch_stats" in k):
        scale = float(np.abs(ref[k]).max())
        assert float(np.abs(new[k] - ref[k]).max()) <= 1e-5 * scale, k
    keys = sorted(k for k in new if "batch_stats" not in k)
    du = np.concatenate([(new[k] - before[k]).ravel() for k in keys])
    dw = np.concatenate([(ref[k] - before[k]).ravel() for k in keys])
    assert np.abs(du - dw).max() <= 1e-3 * np.abs(dw).max()
    assert np.linalg.norm(du - dw) <= 2e-2 * np.linalg.norm(dw)
    # the eval step's gathered predictions (global batch) and metrics
    for k in ("x", "q"):
        assert got[k].shape == want[k].shape
        assert got[k].shape[0] == GLOBAL_B
        scale = float(np.abs(want[k]).max())
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k
    for k, v in got["eval_metrics"].items():
        assert _rel(v, want["eval_metrics"][k]) <= norm_tol, k


def test_update_moved_every_leaf(runs):
    """The step did something: SGD moved nearly every parameter leaf (a
    rank that skipped its update, or kept its own, would fail the tests
    above only through small numbers)."""
    _, old, ranks, _, _ = runs
    before = _leaves(old["params"])
    after = _leaves(ranks[0]["variables"]["params"])
    moved = [k for k in before if not np.array_equal(before[k], after[k])]
    assert len(moved) >= 0.9 * len(before)
