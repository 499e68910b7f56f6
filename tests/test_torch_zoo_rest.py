"""The rest of the reference zoo against the JAX package, float32 on the
CPU: the masked GRU and bidirectional RNNs, ``imu-feat-fc``,
``odom-feat-fc``, the decoder-bearing PointSeg tower (``part:
encoder+decoder``, ``bypass: true``), and whole models with them.

* ``MaskedRNN`` (LSTM and GRU, one and two directions, masked tails and
  a fully masked sequence) on weights carried from a flax init by
  ``load_flax_variables``: outputs and final state within 1e-5 of the
  largest magnitude;
* ``ImuFeatFC`` and ``OdomFeatFC`` alone, within 1e-5;
* three models cut from ``configs/deeplio_kitti_tpu.yaml`` (16x64 images,
  narrow widths): ``slice``, the slice's nets (GRU bidirectional IMU net,
  GRU odometry net, the decoder-bearing tower, the normals channel,
  ``backend: ring`` exact); ``fc``, the FC nets with ``bypass: true`` on
  ``sort-sentinel``; ``deepio-gru``, DeepIO with the bidirectional GRU.
  Their trees equal JAX's and the bridge carries them both ways; forwards
  in eval and training mode within ``tests/test_torch_variants.py``'s
  tolerances (1e-4 of the output's largest magnitude, 1e-5 for the
  running statistics);
* one float32 training step of each against JAX's ``build_train_step``
  from raw points (so the projection with its normals runs on both sides)
  at the one-step tolerances of ``tests/test_torch_variants.py``.
  ``compute_normals`` differs from XLA's CPU result by a few ulps
  (``tests/test_torch_normals.py``), inside those tolerances.
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
from deeplio_tpu.models import feat_nets as jf  # noqa: E402
from deeplio_tpu.models import init_model  # noqa: E402
from deeplio_tpu.models.zoo import example_batch  # noqa: E402
from deeplio_tpu.ops import rnn as jrnn  # noqa: E402
from deeplio_tpu.parallel.mesh import make_mesh, replicate, shard_batch  # noqa: E402
from deeplio_tpu.train import build_train_step as jax_build_train_step  # noqa: E402
from deeplio_tpu.train import create_train_state, make_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.models import feat_nets as tf  # noqa: E402
from deeplio_tpu_torch.models import zoo  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.ops.rnn import MaskedRNN  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state as port_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from tests.test_torch_models import _close, _perturb  # noqa: E402

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
H, W, N, T = 16, 64, 1024, 16
NET_TOL, FWD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
STEPS_PER_EPOCH = 100


def _mask(b, t, seed):
    """[b, t] validity with ragged tails, one row fully masked."""
    rng = np.random.default_rng(seed)
    m = np.ones((b, t), np.float32)
    for i in range(b):
        m[i, rng.integers(1, t + 1):] = 0
    m[-1] = 0
    return m


# ------------------------------------------------------------- the nets

@pytest.mark.parametrize("bidi", [False, True], ids=["uni", "bidi"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_masked_rnn_matches_jax(cell, bidi):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 9, 6)).astype(np.float32)
    mask = _mask(5, 9, 2)
    jmod = jrnn.MaskedRNN(8, num_layers=2, cell=cell, bidirectional=bidi)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    y, final = jmod.apply(v, jnp.asarray(x), jnp.asarray(mask))
    port = MaskedRNN(6, 8, 2, cell, bidi)
    load_flax_variables(port, v)
    assert sorted(dict(port.named_children())) == sorted(v["params"])
    with torch.no_grad():
        ty, tfinal = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert ty.shape == (5, 9, 8 * (1 + bidi))
    _close(ty, y, NET_TOL)
    _close(tfinal, final, NET_TOL)
    # a fully masked sequence keeps the zero state
    assert not tfinal[-1].any()


def test_imu_feat_fc_matches_jax():
    rng = np.random.default_rng(3)
    imu = rng.normal(size=(6, T, 6)).astype(np.float32)
    mask = _mask(6, T, 4)
    imu[mask == 0] = 1e3          # padding must not leak
    jmod = jf.ImuFeatFC(hidden_size=12, num_layers=3)
    v = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(imu),
                           jnp.asarray(mask)))
    want = jmod.apply(v, jnp.asarray(imu), jnp.asarray(mask))
    port = tf.ImuFeatFC(T, 6, 12, 3)
    load_flax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(imu), torch.from_numpy(mask))
    _close(got, want, NET_TOL)


def test_odom_feat_fc_matches_jax():
    x = np.random.default_rng(5).normal(size=(3, 4, 20)).astype(np.float32)
    jmod = jf.OdomFeatFC(hidden_size=10, num_layers=2)
    v = _perturb(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jmod.apply(v, jnp.asarray(x))
    port = tf.OdomFeatFC(20, 10, 2)
    load_flax_variables(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, want, NET_TOL)


# --------------------------------------------------------- whole models

def _dict(variant):
    """``configs/deeplio_kitti_tpu.yaml`` cut to 16x64, 1024 points,
    windows of 3 frames, narrow nets, float32 and dropout 0, with the
    variant's nets."""
    with open(CONFIGS / "deeplio_kitti_tpu.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    ds = d["datasets"]
    ds.update({"image-height": H, "image-width": W, "max-points": N,
               "sequence-size": 3, "window-stride": 2,
               "max-imu-per-pair": T})
    d["deeplio"]["dropout"] = 0.0
    d["lidar-feat-pointseg"].update({"feature-size": 16, "el-squeeze": 16})
    d["imu-feat-rnn"]["hidden-size"] = 12
    d["odom-feat-rnn"]["hidden-size"] = 16
    d["train"]["batch-size"] = 2
    if variant == "slice":
        ds.update({"backend": "ring", "packed": False,
                   "channels": ["x", "y", "z", "remission", "depth",
                                "normals"],
                   "mean": ds["mean"] + [0.0] * 3,
                   "std": ds["std"] + [1.0] * 3})
        d["imu-feat-rnn"].update({"type": "gru", "bidirectional": True})
        d["odom-feat-rnn"]["type"] = "gru"
        d["lidar-feat-pointseg"]["part"] = "encoder+decoder"
    elif variant == "fc":
        ds.update({"backend": "sort-sentinel", "packed": False})
        d["deeplio"]["imu-feat-net"] = {"name": "imu-feat-fc"}
        d["deeplio"]["odom-feat-net"] = {"name": "odom-feat-fc"}
        d["imu-feat-fc"] = {"hidden-size": 12, "num-layers": 2}
        d["odom-feat-fc"] = {"hidden-size": 16, "num-layers": 2}
        d["lidar-feat-pointseg"]["bypass"] = True
        del d["lidar-feat-pointseg"]["part"]
    else:                                                   # deepio-gru
        d["arch"] = "deepio"
        d["deepio"] = {"dropout": 0.0, "imu-feat-net": {"name":
                                                        "imu-feat-rnn"},
                       "odom-feat-net": {"name": "odom-feat-rnn"}}
        d["imu-feat-rnn"].update({"type": "gru", "bidirectional": True,
                                  "num-layers": 1})
    return d


VARIANTS = ("slice", "fc", "deepio-gru")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.model.uses_lidar:
        c = 2 * cfg.datasets.num_image_channels
        batch["images"] = rng.normal(size=(2, 2, H, W, c)).astype(np.float32)
    if cfg.model.uses_imu:
        batch["imu"] = rng.normal(size=(2, 2, T, 6)).astype(np.float32)
        batch["imu_mask"] = _mask(4, T, seed).reshape(2, 2, T)
    return batch


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request):
    d = _dict(request.param)
    jcfg, pcfg = jax_config(d), port_config(d)
    port = zoo.build_model(pcfg, device="cpu", seed=0)
    variables = _perturb(to_flax_variables(port), seed=5)
    load_flax_variables(port, variables)
    return request.param, jax_build_model(jcfg), variables, port, pcfg, jcfg


def test_config_parses_as_jax(pair):
    name, _, _, _, cfg, jcfg = pair
    assert cfg.datasets.num_image_channels == \
        jcfg.datasets.num_image_channels
    for block in ("imu", "odom"):
        p, j = getattr(cfg.model, block), getattr(jcfg.model, block)
        for f in ("name", "rnn_type", "hidden_size", "num_layers"):
            assert getattr(p, f) == getattr(j, f), (block, f)
    assert cfg.model.imu.bidirectional == jcfg.model.imu.bidirectional
    if cfg.model.lidar is not None:
        for f in ("part", "bypass"):
            assert getattr(cfg.model.lidar, f) == getattr(jcfg.model.lidar, f)
    if name != "deepio-gru":
        assert cfg.model.lidar.part == "encoder+decoder"


def test_tree_equals_jax_and_round_trips(pair):
    _, model, variables, port, _, jcfg = pair
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
        load_flax_variables(port, variables)
    _close(tx, x, FWD_TOL)
    _close(tq, q, FWD_TOL)
    if "batch_stats" not in variables:
        assert got is None
        return
    want, got = _leaves(upd["batch_stats"]), _leaves(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        _close(got[k], w, STATS_TOL)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("name", VARIANTS)
def test_one_train_step_matches_jax(name):
    d = _dict(name)
    jcfg, pcfg = jax_config(d), port_config(d)
    with_points = pcfg.model.uses_lidar
    host = next(iter(JWindowDataset(
        jcfg.datasets, [JSyntheticDrive(n_frames=7, max_points=N)],
        with_points=with_points).iter_batches(2, shuffle=False, workers=1)))
    got = next(iter(WindowDataset(
        pcfg.datasets, [SyntheticDrive(n_frames=7, max_points=N)],
        with_points=with_points).iter_batches(2, shuffle=False)))
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
    if "batch_stats" in port_vars:
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
    # the decoder's largest gradients leave under 1% of the entries above
    # 1e-3 of the largest: count them instead
    well = np.abs(g) >= 1e-3 * np.abs(g).max()
    assert well.sum() >= 1000
    assert np.abs(dp - dj)[well].max() <= 1e-3 * np.abs(dj).max()
