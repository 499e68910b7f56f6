"""The slice's two configurations (``deeplio_tpu_torch/bench/slice10.py``)
in one float32 training step against JAX's ``build_train_step``, on the
CPU, cut to 16x64 images, 1024 points, windows of 3 frames and narrow
nets:

* ``A``: ``pallas-ring`` (the port's ring selection's plain version, JAX's
  XLA ring twin), the ``factorized`` stem and ``mixed`` Fires, SGD with
  momentum 0.9 and weight-decay 1e-4;
* ``B``: ``pallas`` (the scatter selection's plain version, the Pallas
  kernel in interpret mode), the ``s2d-pre`` stem and ``fused`` Fires,
  AdamW with weight-decay 0.01, ``param-dtype: bfloat16``.

From raw points, so the projection runs on both sides. Tolerances, those
of ``tests/test_torch_zoo_rest.py``'s step: loss and its parts within
1e-4 (``loss_q`` and the gradient norm 1e-3), the BatchNorm statistics
within 1e-5 of each leaf's largest magnitude, the parameter update in L2
within 10% of JAX's (Adam's first step keeps each gradient's sign) and
within 1e-3 of the largest where ``|g| >= 1e-3`` of the largest
gradient. SGD's update is the gradient itself scaled (its first trace is
``g + wd * p``): within 1e-2 in L2 (measured 1.5e-3: the two packages'
float32 gradients, summed in other orders).

And ``make_model_batch`` for every stem from cached images [B, S, H, W,
C] (the projection cache's and the device bank's contract) equal to
JAX's bit for bit.
"""

import copy
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
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
from deeplio_tpu.train.step import make_model_batch as jax_model_batch  # noqa: E402
from deeplio_tpu_torch.bench.slice10 import slice10_dict  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.models import zoo  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
    make_model_batch,
)

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
H, W, N, T = 16, 64, 1024, 16
STATS_TOL = 1e-5
STEPS_PER_EPOCH = 100


def cut_dict(which):
    """Configuration ``which`` on the shipped file cut to 16x64, 1024
    points, windows of 3 frames, narrow nets, float32, dropout 0."""
    with open(CONFIGS / "deeplio_kitti_tpu.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": N, "sequence-size": 3,
                          "window-stride": 2, "max-imu-per-pair": T})
    d["deeplio"]["dropout"] = 0.0
    d["lidar-feat-pointseg"].update({"feature-size": 16, "el-squeeze": 16})
    d["imu-feat-rnn"]["hidden-size"] = 12
    d["odom-feat-rnn"]["hidden-size"] = 16
    d["train"]["batch-size"] = 2
    return slice10_dict(d, which)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def check_train_step(which, monkeypatch):
    """One float32 step of configuration ``which`` against JAX's, at the
    tolerances above (``B`` runs in ``tests/test_torch_slice10_step_b.py``,
    so that the two JAX compiles run in separate test workers)."""
    d = cut_dict(which)
    jcfg, pcfg = jax_config(d), port_config(d)
    assert (pcfg.optim.name, pcfg.optim.weight_decay, pcfg.optim.momentum,
            pcfg.model.lidar.stem, pcfg.model.lidar.fire) == \
        (jcfg.optim.name, jcfg.optim.weight_decay, jcfg.optim.momentum,
         jcfg.model.lidar.stem, jcfg.model.lidar.fire)
    host = next(iter(JWindowDataset(
        jcfg.datasets, [JSyntheticDrive(n_frames=7, max_points=N)],
        with_points=True).iter_batches(2, shuffle=False, workers=1)))
    got = next(iter(WindowDataset(
        pcfg.datasets, [SyntheticDrive(n_frames=7, max_points=N)],
        with_points=True).iter_batches(2, shuffle=False)))
    for k in host:
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0),
                                  axis_name="data")
    variables = jax.tree.map(np.array, variables)
    state = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, jax_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    jstep, _ = jax_build_train_step(jcfg, model, tx, mesh)
    monkeypatch.setattr(jpal, "CHUNK", 512)      # as test_torch_train.py
    with pltpu.force_tpu_interpret_mode():
        state, jm = jstep(state, shard_batch(mesh, host))
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}

    port = zoo.build_model(pcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    assert {p.dtype for p in port.parameters()} == {torch.float32}
    pstate = port_state(pcfg, port, steps_per_epoch=STEPS_PER_EPOCH)
    pstep, _ = build_train_step(pcfg)
    pstate, pm = pstep(pstate, batch_to_device(got, "cpu"))
    pm = {k: float(v) for k, v in pm.items()}

    assert pm.keys() == jm.keys()
    for k, tol in (("loss", 1e-4), ("loss_x", 1e-4), ("loss_q", 1e-3),
                   ("grad_norm", 1e-3)):
        assert _rel(pm[k], jm[k]) <= tol, (k, pm[k], jm[k])
    port_vars = {k: _leaves(v) for k, v in to_flax_variables(port).items()}
    stats = _leaves(jax.device_get(state.batch_stats))
    assert port_vars["batch_stats"].keys() == stats.keys()
    for k, w in stats.items():
        err = float(np.abs(port_vars["batch_stats"][k] - w).max())
        assert err <= STATS_TOL * max(float(np.abs(w).max()), 1e-3), k
    old = _leaves(variables["params"])
    new = _leaves(jax.device_get(state.params))
    grads = copy.deepcopy(port)
    with torch.no_grad():
        for p, gp in zip(port.parameters(), grads.parameters()):
            gp.copy_(p.grad)
    gl = _leaves(to_flax_variables(grads)["params"])
    keys = sorted(old)
    dj = np.concatenate([(new[k] - old[k]).ravel() for k in keys])
    dp = np.concatenate([(port_vars["params"][k] - old[k]).ravel()
                         for k in keys])
    g = np.concatenate([gl[k].ravel() for k in keys])
    l2 = 1e-2 if which == "A" else 0.1
    assert np.linalg.norm(dp - dj) <= l2 * np.linalg.norm(dj)
    well = np.abs(g) >= 1e-3 * np.abs(g).max()
    assert well.sum() >= 1000
    assert np.abs(dp - dj)[well].max() <= 1e-3 * np.abs(dj).max()
    # the loss's sx/sq took the same update (the decay reaches them too)
    jl = jax.device_get(state.loss_params)
    for k, v in pstate.loss_params.items():
        assert abs(float(v.detach()) - float(jl[k])) <= 1e-6, k
    if which == "A":                       # SGD's momentum buffers exist
        bufs = [pstate.optimizer.inner.state[p]["momentum_buffer"]
                for p in pstate.optimizer.params]
        assert all(b is not None for b in bufs)


def test_one_train_step_matches_jax_a(monkeypatch):
    check_train_step("A", monkeypatch)


@pytest.mark.parametrize("stem", ["classic", "pair-split", "s2d-pre",
                                  "factorized"])
def test_model_batch_from_cached_images_matches_jax(stem):
    """The projection cache's (and the device bank's projected) images
    [B, S, H, W, C] become the model's batch as JAX's ``make_model_batch``
    makes it, bit for bit: the pair stack, the two frame stacks, the
    space-to-depth pairs or the frames themselves."""
    d = cut_dict("A")
    d["lidar-feat-pointseg"]["stem"] = stem
    d["datasets"]["combinations"] = [[0, 1], [0, 2], [1, 2]]
    jcfg, pcfg = jax_config(d), port_config(d)
    rng = np.random.default_rng(2)
    imgs = rng.normal(size=(2, 3, H, W, 5)).astype(np.float16)
    imu = rng.normal(size=(2, 3, T, 6)).astype(np.float32)
    mask = np.ones((2, 3, T), np.float32)
    raw = {"images": imgs, "imu": imu, "imu_mask": mask}
    want = jax_model_batch(jcfg, None, {k: jnp.asarray(v)
                                        for k, v in raw.items()})
    got = make_model_batch(pcfg, None, {k: torch.from_numpy(v)
                                        for k, v in raw.items()})
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
