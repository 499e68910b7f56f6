"""The model zoo's other archs and towers against the JAX package, float32
on the CPU: DeepIO, DeepLO with ``lidar-feat-simple-0``, ``-1`` and
PointSeg, and DeepLIO with ``pool: classic`` and ``cheap``.

Each model is built from a shipped configuration cut to 16x64 images and
hidden widths of 16 (PointSeg keeps its own widths), from the port's
seeded init with its BatchNorm statistics, scales and biases perturbed;
its tree must be JAX's (``jax.eval_shape`` of the flax init) and the
bridge (``to_flax_variables`` / ``load_flax_variables``) must carry it
both ways unchanged. The one-step tests start from JAX's own init.

Tolerances (float32, summation orders differ between XLA and oneDNN):
forwards in eval mode within 1e-4 of the output's largest magnitude; in
training mode (BatchNorm batch statistics, dropout 0) the outputs within
1e-4 and the updated running statistics within 1e-5 of each leaf's
largest magnitude. One training step of DeepIO and of DeepLO
(``lidar-feat-simple-0``, ``backend: sort``) against JAX's
``build_train_step``, at the tolerances of ``tests/test_torch_train.py``'s
one-step test: the loss and ``loss_x`` within 1e-4 of their magnitude,
``loss_q`` and ``grad_norm`` within 1e-3, the BatchNorm statistics within
1e-5, the update in L2 within 10% and element by element within 1e-3 of
its largest magnitude where the gradient is at least 1e-3 of the largest.
"""

import copy
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data.dataset import WindowDataset as JWindowDataset  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive  # noqa: E402
from deeplio_tpu.losses import init_loss_params as jax_loss_params  # noqa: E402
from deeplio_tpu.models import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.models import init_model  # noqa: E402
from deeplio_tpu.models.zoo import example_batch  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
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
)
from tests.test_torch_models import _close, _perturb  # noqa: E402

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
H, W, N = 16, 64, 1024
FWD_TOL, STATS_TOL = 1e-4, 1e-5
STEPS_PER_EPOCH = 100


def _dict(fname, **lidar):
    """A shipped config cut to size, float32, dropout 0."""
    with open(CONFIGS / fname) as f:
        d = yaml.safe_load(f)
    arch = d["arch"]
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": N, "sequence-size": 3,
                          "combinations": [[0, 1], [1, 2]],
                          "augment-yaw": False})
    d[arch]["dropout"] = 0.0
    for net in ("imu-feat-rnn", "odom-feat-rnn"):
        if net in d:
            d[net]["hidden-size"] = 16
    if "lidar-feat-net" in d[arch]:
        lname = lidar.pop("name", d[arch]["lidar-feat-net"]["name"])
        d[arch]["lidar-feat-net"] = {"name": lname}
        block = d.setdefault(lname, {})
        block.update({"feature-size": 16, "base-channels": 8, **lidar})
    d["train"]["batch-size"] = 2
    return d


VARIANTS = {
    "deepio": lambda: _dict("deepio_synth.yaml"),
    "deeplo-simple-0": lambda: _dict("deeplo_synth.yaml"),
    "deeplo-simple-1": lambda: _dict("deeplo_synth.yaml",
                                     name="lidar-feat-simple-1"),
    "deeplo-pointseg": lambda: _dict("deeplo_synth.yaml",
                                     name="lidar-feat-pointseg"),
    "deeplio-classic": lambda: _dict("deeplio_kitti.yaml"),
    "deeplio-cheap": lambda: _dict("deeplio_kitti.yaml", pool="cheap"),
}


def _batch(cfg, seed):
    """A model batch of 2 windows x 2 pairs: images where the arch reads
    them, IMU windows (with masked tails) where it reads those."""
    rng = np.random.default_rng(seed)
    c = 2 * cfg.datasets.num_image_channels
    mask = np.ones((2, 2, 16), np.float32)
    mask[0, 1, 9:] = 0
    mask[1, 0, 3:] = 0
    batch = {}
    if cfg.model.uses_lidar:
        batch["images"] = rng.normal(size=(2, 2, H, W, c)).astype(np.float32)
    if cfg.model.uses_imu:
        batch["imu"] = rng.normal(size=(2, 2, 16, 6)).astype(np.float32)
        batch["imu_mask"] = mask
    return batch


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    """The port's model from its seeded init, perturbed, carried into the
    JAX model (a flax init of PointSeg costs many seconds; the tree is
    held against JAX's by the first test)."""
    d = VARIANTS[request.param]()
    jcfg, pcfg = jax_config(d), port_config(d)
    port = zoo.build_model(pcfg, device="cpu", seed=0)
    variables = _perturb(to_flax_variables(port), seed=5)
    load_flax_variables(port, variables)
    return request.param, jax_build_model(jcfg), variables, port, pcfg, jcfg


def test_model_class_and_weights_round_trip(pair):
    """The port's tree is JAX's, leaf for leaf and shape for shape, and
    the bridge carries it both ways unchanged."""
    _, model, variables, port, cfg, jcfg = pair
    want = {"deepio": zoo.DeepIO, "deeplo": zoo.DeepLO,
            "deeplio": zoo.DeepLIO}[cfg.model.arch]
    assert type(port) is want
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, 2), train=False))
    shapes = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
              jax.tree_util.tree_leaves_with_path(shapes)}
    flat = _leaves(variables)
    assert {k: a.shape for k, a in flat.items()} == shapes
    got = _leaves(to_flax_variables(port))
    assert got.keys() == flat.keys()
    for k, a in flat.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_forward_eval_matches_jax(pair):
    _, model, variables, port, cfg, _ = pair
    batch = _batch(cfg, 6)
    x, q = model.apply(variables, {k: jnp.asarray(a)
                                   for k, a in batch.items()}, train=False)
    with torch.no_grad():
        tx, tq = port({k: torch.from_numpy(a) for k, a in batch.items()})
    _close(tx, x, FWD_TOL)
    _close(tq, q, FWD_TOL)


def test_forward_train_matches_jax(pair):
    """Training mode: BatchNorm normalises with the batch's statistics and
    updates its running ones (flax's rule)."""
    _, model, variables, port, cfg, _ = pair
    batch = _batch(cfg, 7)
    (x, q), upd = model.apply(
        variables, {k: jnp.asarray(a) for k, a in batch.items()}, train=True,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(2)})
    port.train()
    try:
        with torch.no_grad():
            tx, tq = port({k: torch.from_numpy(a) for k, a in batch.items()})
        got = to_flax_variables(port).get("batch_stats")
    finally:
        port.eval()
        load_flax_variables(port, variables)      # the shared fixture
    _close(tx, x, FWD_TOL)
    _close(tq, q, FWD_TOL)
    if "batch_stats" not in variables:
        assert cfg.model.arch == "deepio" and got is None
        return
    want = _leaves(upd["batch_stats"])
    got = _leaves(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, STATS_TOL)


# ------------------------------------------------------ one training step

def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("name", ["deepio", "deeplo-simple-0"])
def test_one_train_step_matches_jax(name):
    d = VARIANTS[name]()
    jcfg, pcfg = jax_config(d), port_config(d)
    with_points = pcfg.model.uses_lidar
    host = next(iter(JWindowDataset(
        jcfg.datasets, [JSyntheticDrive(n_frames=7, max_points=N)],
        with_points=with_points).iter_batches(2, shuffle=False, workers=1)))
    got = next(iter(WindowDataset(
        pcfg.datasets, [SyntheticDrive(n_frames=7, max_points=N)],
        with_points=with_points).iter_batches(2, shuffle=False)))
    assert got.keys() == host.keys()
    for k in host:
        np.testing.assert_array_equal(got[k], host[k], err_msg=k)
    assert ("points_x" in host) == with_points

    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    tx = make_optimizer(jcfg.optim, STEPS_PER_EPOCH)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0),
                                  axis_name="data")
    variables = jax.tree.map(np.array, variables)
    state = replicate(mesh, create_train_state(
        variables, jax.tree.map(np.array, jax_loss_params(jcfg.loss)), tx,
        jax.random.PRNGKey(1)))
    jstep, _ = jax_build_train_step(jcfg, model, tx, mesh)
    state, jm = jstep(state, shard_batch(mesh, host))
    jm = {k: float(v) for k, v in jax.device_get(jm).items()}

    port = zoo.build_model(pcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    pstate = port_state(pcfg, port, steps_per_epoch=STEPS_PER_EPOCH)
    pstep, _ = build_train_step(pcfg)
    pstate, pm = pstep(pstate, batch_to_device(got, "cpu"))
    pm = {k: float(v) for k, v in pm.items()}

    assert pm.keys() == jm.keys()
    for k, tol in (("loss", 1e-4), ("loss_x", 1e-4), ("loss_q", 1e-3),
                   ("grad_norm", 1e-3)):
        assert _rel(pm[k], jm[k]) <= tol, (k, pm[k], jm[k])
    port_vars = {k: _leaves(v) for k, v in to_flax_variables(port).items()}
    if name == "deepio":
        assert "batch_stats" not in port_vars
    else:
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
    assert np.linalg.norm(dp - dj) <= 0.1 * np.linalg.norm(dj)
    well = np.abs(g) >= 1e-3 * np.abs(g).max()
    assert well.mean() > 0.01
    assert np.abs(dp - dj)[well].max() <= 1e-3 * np.abs(dj).max()
