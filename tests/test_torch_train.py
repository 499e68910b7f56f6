"""The port's training step against the JAX ``build_train_step``, float32
on the CPU.

The slice configuration (``configs/deeplio_kitti_tpu.yaml`` with
``backend: pallas``) cut to 16x128 images, 2048-point scans, B = 2 windows
of S = 3 frames (P = 2 pairs), dropout 0 and no augmentation. The JAX step
runs on a one-device mesh from the weights it initialises; the port loads
them through ``load_flax_variables``, takes the same host batch (the two
packages' ``WindowDataset`` give it bit for bit) and is compared through
``to_flax_variables``.

Tolerances, with their reasons. At this size the last ConvBN normalises
over 8 values per channel, which magnifies rounding: the port's gradients
of the lidar tower move by up to 6e-4 of the largest gradient with the
number of CPU threads alone (oneDNN splits its sums by thread), against
5e-5 between the port and JAX at one thread count.

* one step, the JAX step on ``backend: pallas`` (the Pallas kernel in
  interpret mode): the loss and ``loss_x`` within 1e-4 of their magnitude;
  ``loss_q`` (the squared quaternion residual, 5e-4 of ``loss_x`` here, so
  its relative error is that of the quaternion magnified) and
  ``grad_norm`` within 1e-3; ``sx``/``sq`` and the BatchNorm statistics
  within 1e-5 of the largest magnitude. Adam's first update is ``lr * g /
  (|g| + eps)``: it keeps the SIGN of every gradient element, so where a
  gradient is zero up to that rounding the two updates differ by 2 lr
  (measured: 0.2% of the elements, all with |g| < 2e-4 of the largest).
  So the update (new - old) is held to 1e-3 of its largest magnitude on
  every element whose gradient is at least 1e-3 of the largest gradient,
  and in L2 over all elements to 10% (measured 2% to 4% over 1 to 8
  threads);
* three steps, the JAX step on ``backend: sort-sentinel, packed: true``
  (the same projection function, fast): once the sign flips of step 1
  change a parameter the later steps drift apart. Measured over 1 to 8
  threads, the worst of each check is a fifth to a half of its tolerance:
  each step's loss to 1e-3 of its magnitude, ``loss_x`` to 1e-2,
  ``loss_q`` to 0.2 (the same magnification, 1e-4 of ``loss_x`` by step
  3), ``grad_norm`` to 0.1, ``sx``/``sq`` to 1e-4, the BatchNorm
  statistics to 0.1 of each leaf's largest magnitude and the summed update
  in L2 to 30%. The update rule itself is held against optax on identical
  gradients by ``tests/test_torch_train_parts.py``.
"""

import copy
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data.dataset import WindowDataset as JWindowDataset  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive  # noqa: E402
from deeplio_tpu.losses import init_loss_params as jax_loss_params  # noqa: E402
from deeplio_tpu.models import init_model  # noqa: E402
from deeplio_tpu.ops import projection_pallas as jpal  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
STEPS_PER_EPOCH = 100


def slice_dict(backend="pallas"):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2, "backend": backend})
    d["deeplio"]["dropout"] = 0.0
    d["train"]["batch-size"] = 2
    return d


@pytest.fixture(scope="module")
def batches():
    """Three host batches of 2 windows, identical from both packages."""
    jcfg, pcfg = jax_config(slice_dict()), port_config(slice_dict())
    want = list(JWindowDataset(
        jcfg.datasets, [JSyntheticDrive(n_frames=13, max_points=2048)]
    ).iter_batches(2, shuffle=False, workers=1))
    got = list(WindowDataset(
        pcfg.datasets, [SyntheticDrive(n_frames=13, max_points=2048)]
    ).iter_batches(2, shuffle=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    return got


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _run(batches, jax_backend, steps, monkeypatch):
    """``steps`` steps of both; per-step metrics, the variables before and
    after, and the port's last gradients in the flax layout."""
    jcfg = jax_config(slice_dict(jax_backend))
    pcfg = port_config(slice_dict())
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0),
                                  axis_name="data")
    variables = jax.tree.map(np.array, variables)
    state = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, jax_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    jstep, _ = jax_build_train_step(jcfg, model, tx, mesh)

    port = build_model(pcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    pstate = port_state(pcfg, port, steps_per_epoch=STEPS_PER_EPOCH)
    pstep, _ = build_train_step(pcfg)

    monkeypatch.setattr(jpal, "CHUNK", 512)
    jm, pm = [], []
    for s in range(steps):
        with pltpu.force_tpu_interpret_mode():
            state, m = jstep(state, shard_batch(mesh, batches[s]))
        jm.append({k: float(v) for k, v in jax.device_get(m).items()})
        pstate, m = pstep(pstate, batch_to_device(batches[s], "cpu"))
        pm.append({k: float(v) for k, v in m.items()})

    grads = copy.deepcopy(port)
    with torch.no_grad():
        for p, g in zip(port.parameters(), grads.parameters()):
            g.copy_(p.grad)
    return {"jax": jm, "port": pm, "old": _leaves(variables["params"]),
            "jax_params": _leaves(jax.device_get(state.params)),
            "jax_stats": _leaves(jax.device_get(state.batch_stats)),
            "jax_loss": {k: float(v) for k, v in
                         jax.device_get(state.loss_params).items()},
            "port_vars": {k: _leaves(v) for k, v in
                          to_flax_variables(port).items()},
            "port_loss": {k: float(v.detach()) for k, v in
                          pstate.loss_params.items()},
            "port_grads": _leaves(to_flax_variables(grads)["params"])}


def _updates(run):
    keys = sorted(run["old"])
    old = run["old"]
    dj = np.concatenate([(run["jax_params"][k] - old[k]).ravel()
                         for k in keys])
    dp = np.concatenate([(run["port_vars"]["params"][k] - old[k]).ravel()
                         for k in keys])
    g = np.concatenate([run["port_grads"][k].ravel() for k in keys])
    return dj, dp, g


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _check_stats(run, tol):
    got = run["port_vars"]["batch_stats"]
    assert got.keys() == run["jax_stats"].keys()
    for k, want in run["jax_stats"].items():
        err = float(np.abs(got[k] - want).max())
        scale = max(float(np.abs(want).max()), 1e-3)
        assert err <= tol * scale, k


def test_one_step_matches_jax_pallas(batches, monkeypatch):
    run = _run(batches, "pallas", 1, monkeypatch)
    (jm,), (pm,) = run["jax"], run["port"]
    assert pm.keys() == jm.keys()
    for k, tol in (("loss", 1e-4), ("loss_x", 1e-4), ("loss_q", 1e-3),
                   ("grad_norm", 1e-3)):
        assert _rel(pm[k], jm[k]) <= tol, (k, pm[k], jm[k])
    for k in ("sx", "sq"):
        assert pm[k] == jm[k]                       # the initial values
        assert abs(run["port_loss"][k] - run["jax_loss"][k]) <= \
            1e-5 * abs(run["jax_loss"][k]) + 1e-9
    _check_stats(run, 1e-5)
    dj, dp, g = _updates(run)
    assert np.linalg.norm(dp - dj) <= 0.1 * np.linalg.norm(dj)
    well = np.abs(g) >= 1e-3 * np.abs(g).max()
    assert well.mean() > 0.01          # the check covers a real share
    assert np.abs(dp - dj)[well].max() <= 1e-3 * np.abs(dj).max()


def test_three_steps_match_jax_sort_sentinel(batches, monkeypatch):
    run = _run(batches, "sort-sentinel", 3, monkeypatch)
    for jm, pm in zip(run["jax"], run["port"]):
        for k, tol in (("loss", 1e-3), ("loss_x", 1e-2), ("loss_q", 0.2),
                       ("grad_norm", 0.1), ("sx", 1e-4), ("sq", 1e-4)):
            assert _rel(pm[k], jm[k]) <= tol, (k, pm[k], jm[k])
    for k in ("sx", "sq"):
        assert _rel(run["port_loss"][k], run["jax_loss"][k]) <= 1e-4
    _check_stats(run, 0.1)
    dj, dp, _ = _updates(run)
    assert np.linalg.norm(dp - dj) <= 0.3 * np.linalg.norm(dj)


def test_step_projects_once_per_batch(batches, monkeypatch):
    """All B*S frames of a step go through ONE scatter selection (one
    kernel launch on the card), and the step counter advances."""
    calls = []
    select = tsc.scatter_select

    def counting(key, *a):
        calls.append(tuple(key.shape))
        return select(key, *a)

    monkeypatch.setattr(tsc, "scatter_select", counting)
    cfg = port_config(slice_dict())
    state = port_state(cfg, build_model(cfg, device="cpu", seed=0))
    train_step, eval_step = build_train_step(cfg)
    state, m = train_step(state, batch_to_device(batches[0], "cpu"))
    assert calls == [(6, 2048)] and state.step == 1
    assert all(torch.isfinite(v) for v in m.values())
    x, q, em = eval_step(state, batch_to_device(batches[0], "cpu"))
    assert x.shape == (2, 2, 3) and q.shape == (2, 2, 4)
    assert not state.model.training and len(calls) == 2
