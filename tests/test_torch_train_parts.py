"""The parts of the port's training step against the JAX reference, float32
on the CPU: the pose loss, the optimizer, BatchNorm and dropout in
training mode, yaw augmentation and the window dataset.

Tolerances: the loss and its gradients within 1e-5 of their magnitude
(XLA and PyTorch round transcendental functions differently); five
optimizer steps from identical gradients within 1e-5 of the largest
update (torch's Adam and optax order the same arithmetic differently)
plus one float32 ulp of the parameter per step (each step rounds it);
ConvBN within 1e-5 (summation order); yaw rotation within 1e-6 (cos/sin
ulps); the window dataset bit for bit.
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
from deeplio_tpu.config.schema import LossConfig as JLossConfig  # noqa: E402
from deeplio_tpu.config.schema import OptimConfig as JOptimConfig  # noqa: E402
from deeplio_tpu.data.dataset import WindowDataset as JWindowDataset  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive  # noqa: E402
from deeplio_tpu.losses import pose as jpose  # noqa: E402
from deeplio_tpu.models import blocks as jb  # noqa: E402
from deeplio_tpu.ops.augment import yaw_augment  # noqa: E402
from deeplio_tpu.train.optim import make_optimizer as jax_optimizer  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.config.schema import LossConfig, OptimConfig  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.losses import pose as tpose  # noqa: E402
from deeplio_tpu_torch.models import blocks as tb  # noqa: E402
from deeplio_tpu_torch.models import feat_nets as tf  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.ops import augment as taug  # noqa: E402
from deeplio_tpu_torch.train import optim as topt  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"


def _close(got, want, tol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + atol, \
        f"max err {err} vs tol {tol} * {scale} + {atol}"


# ------------------------------------------------------------------- loss

def _pose_inputs(seed, valid_kind):
    rng = np.random.default_rng(seed)
    x_pred = rng.normal(size=(3, 4, 3)).astype(np.float32)
    x_gt = rng.normal(size=(3, 4, 3)).astype(np.float32)
    q_pred = rng.normal(size=(3, 4, 4)).astype(np.float32)
    q_gt = rng.normal(size=(3, 4, 4)).astype(np.float32)
    # the other hemisphere, not exactly: at a residual of exactly 0 the
    # subgradient of |r| is 1 in JAX and 0 in PyTorch
    q_gt[0, 0] = q_pred[0, 0] * -2.0 + 0.01
    valid = {"none": None,
             "partial": (rng.uniform(size=(3, 4)) > 0.4).astype(np.float32),
             "zero": np.zeros((3, 4), np.float32)}[valid_kind]
    return x_pred, q_pred, x_gt, q_gt, valid


@pytest.mark.parametrize("valid_kind", ["none", "partial", "zero"])
@pytest.mark.parametrize("active,x_norm,q_norm", [
    ("lws", "l2", "l2"), ("lws", "l1", "l1"), ("lws", "l2", "geodesic"),
    ("hws", "l2", "l2"), ("hws", "l1", "geodesic"), ("hws", "l2", "l1")])
def test_pose_loss_and_gradients_match(active, x_norm, q_norm, valid_kind):
    kw = dict(active=active, x_norm=x_norm, q_norm=q_norm, beta=300.0,
              sx=0.3, sq=-2.0)
    jcfg, tcfg = JLossConfig(**kw), LossConfig(**kw)
    x_pred, q_pred, x_gt, q_gt, valid = _pose_inputs(3, valid_kind)

    def jloss(lp, xp, qp):
        return jpose.pose_loss(jcfg, lp, xp, qp, jnp.asarray(x_gt),
                               jnp.asarray(q_gt),
                               None if valid is None else jnp.asarray(valid))

    jlp = jpose.init_loss_params(jcfg)
    (jtotal, jm), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                              has_aux=True)(
        jlp, jnp.asarray(x_pred), jnp.asarray(q_pred))
    tlp = tpose.init_loss_params(tcfg)
    txp = torch.tensor(x_pred, requires_grad=True)
    tqp = torch.tensor(q_pred, requires_grad=True)
    total, tm = tpose.pose_loss(
        tcfg, tlp, txp, tqp, torch.from_numpy(x_gt), torch.from_numpy(q_gt),
        None if valid is None else torch.from_numpy(valid))
    total.backward()
    assert tm.keys() == jm.keys()
    for k in jm:
        _close(tm[k], jm[k], 1e-5)
    _close(txp.grad, jgrads[1], 1e-5)
    _close(tqp.grad, jgrads[2], 1e-5)
    for k in tlp:
        _close(tlp[k].grad, jgrads[0][k], 1e-5)


# -------------------------------------------------------------- optimizer

@pytest.mark.parametrize("optimizer", [
    {"lr": 5e-4, "grad-clip": 10.0},                        # clip idle
    {"lr": 5e-4, "grad-clip": 0.5},                         # clip fires
    {"lr": 5e-4, "grad-clip": 10.0,
     "scheduler": {"name": "step", "step-size": 1, "gamma": 0.5}},
    {"lr": 1e-3, "scheduler": {"name": "step", "step-size": 1,
                               "gamma": 0.1, "warmup-steps": 2}},
    {"lr": 1e-3, "scheduler": {"name": "cosine", "step-size": 2}},
], ids=["clip-idle", "clip-fires", "staircase", "warmup", "cosine"])
def test_five_steps_match_optax(optimizer):
    """Two steps per epoch, so the staircase decays every second step."""
    jcfg = JOptimConfig.from_dict({"name": "adam", **optimizer})
    tcfg = OptimConfig.from_dict({"name": "adam", **optimizer})
    rng = np.random.default_rng(4)
    shapes = {"w": (6, 5), "b": (5,), "sx": ()}
    # parameters of the updates' order, so their float32 ulp stays small
    params = {k: rng.normal(0, 0.01, size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 0.3, size=s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    tx = jax_optimizer(jcfg, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.tensor(v))
               for k, v in params.items()}
    opt = topt.Optimizer(tcfg, tparams.values(), steps_per_epoch=2)
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = tx.update(jg, state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        norm = opt.step(step)
        want_norm = float(np.sqrt(sum((v ** 2).sum() for v in g.values())))
        assert abs(float(norm) - want_norm) <= 1e-6 * want_norm
    for k in params:
        # each step rounds the parameter to its own float32 ulp, in either
        # package: allow one ulp per step on top of the relative tolerance
        ulp = float(np.spacing(np.abs(np.asarray(jp[k])).max()))
        _close(tparams[k].detach().numpy() - params[k],
               np.asarray(jp[k]) - params[k], 1e-5, atol=len(grads) * ulp)


@pytest.mark.parametrize("sched", [
    {"name": "step", "step-size": 3, "gamma": 0.5},
    {"name": "step", "step-size": 2, "gamma": 0.1, "warmup-steps": 4},
    {"name": "cosine", "step-size": 2},
    {"name": "none", "warmup-steps": 3}])
def test_schedule_matches_optax(sched):
    from deeplio_tpu.train.optim import make_schedule
    jcfg = JOptimConfig.from_dict({"lr": 1e-3, "scheduler": sched})
    tcfg = OptimConfig.from_dict({"lr": 1e-3, "scheduler": sched})
    want = make_schedule(jcfg, steps_per_epoch=5)
    got = topt.make_schedule(tcfg, steps_per_epoch=5)
    for count in range(40):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6,
                                           abs=1e-12), count


def test_clip_has_no_epsilon():
    """optax clips to exactly max_norm (clip_grad_norm_ would add 1e-6)."""
    g = [torch.full((4,), 3.0), torch.full((9,), 4.0)]
    total_norm = torch.nn.utils.get_total_norm
    topt.clip_by_global_norm_(g, 1.0, total_norm(g))
    assert float(total_norm(g)) == pytest.approx(1.0, abs=1e-7)
    g2 = [torch.full((4,), 0.1)]
    topt.clip_by_global_norm_(g2, 1.0, total_norm(g2))
    assert torch.equal(g2[0], torch.full((4,), 0.1))


# --------------------------------------------------- BatchNorm and dropout

@pytest.mark.parametrize("hw,strides", [((16, 32), (2, 4)), ((9, 7), (1, 1))])
def test_convbn_train_mode_matches_flax(hw, strides):
    """Output with batch statistics and the running statistics after two
    updates, against flax ``mutable=["batch_stats"]`` (biased variance,
    momentum 0.99)."""
    rng = np.random.default_rng(5)
    xs = [rng.normal(1.0, 2.0, size=(3, *hw, 6)).astype(np.float32)
          for _ in range(2)]
    mod = jb.ConvBN(8, (3, 3), strides)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), train=False)
    v = jax.tree.map(np.array, v)
    v["params"]["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, 8).astype(
        np.float32)
    v["batch_stats"]["BatchNorm_0"]["var"] = rng.uniform(0.5, 1.5, 8).astype(
        np.float32)
    port = tb.ConvBN(6, 8, (3, 3), strides)
    load_flax_variables(port, v)
    port.train()
    stats = v["batch_stats"]
    for x in xs:
        want, mut = mod.apply({"params": v["params"], "batch_stats": stats},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        stats = mut["batch_stats"]
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5)
    bn = port.BatchNorm_0
    _close(bn.running_mean, stats["BatchNorm_0"]["mean"], 1e-5)
    _close(bn.running_var, stats["BatchNorm_0"]["var"], 1e-5)
    port.eval()                          # eval mode uses what it learned
    want = mod.apply({"params": v["params"], "batch_stats": stats},
                     jnp.asarray(xs[0]), train=False)
    got = port(torch.from_numpy(xs[0].transpose(0, 3, 1, 2).copy()))
    _close(got.detach().numpy().transpose(0, 2, 3, 1), want, 1e-5)


def test_dropout_draws_from_the_generator():
    heads = tf.PoseHeads(64, dropout=0.25)
    x = torch.randn(4000, 64, generator=torch.Generator().manual_seed(0))
    y = tf.inverted_dropout(x, 0.25, True,
                            torch.Generator().manual_seed(1))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    heads.train()
    a = heads(x, torch.Generator().manual_seed(2))
    b = heads(x, torch.Generator().manual_seed(2))
    c = heads(x, torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    heads.eval()                         # eval: no dropout, any generator
    torch.testing.assert_close(heads(x, torch.Generator().manual_seed(3)),
                               heads(x))
    assert torch.equal(tf.inverted_dropout(x, 0.0, True), x)


def test_model_modes():
    """build_model gives eval mode; train() reaches every BatchNorm and
    dropout, and the rates come from the config."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["lidar-feat-pointseg"]["dropout"] = 0.1
    model = build_model(port_config(d), device="cpu", seed=0)
    assert not model.training
    assert model.heads.dropout == 0.25 and model.lidar_feat.dropout == 0.1
    model.train()
    assert all(m.training for m in model.modules())
    bns = [m for m in model.modules() if isinstance(m, tb.FlaxBatchNorm2d)]
    assert len(bns) == sum(1 for m in model.modules()
                           if isinstance(m, torch.nn.BatchNorm2d))


# ------------------------------------------------------------ augmentation

def test_yaw_rotate_matches_yaw_augment():
    rng = np.random.default_rng(6)
    b, s, n, p, t = 3, 4, 64, 3, 5
    raw = {"points_x": rng.normal(size=(b * s, n)),
           "points_y": rng.normal(size=(b * s, n)),
           "points_z": rng.normal(size=(b * s, n)),
           "points_rem": rng.uniform(size=(b * s, n)),
           "x_gt": rng.normal(size=(b, p, 3)),
           "q_gt": rng.normal(size=(b, p, 4)),
           "imu": rng.normal(size=(b, p, t, 6))}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    key = jax.random.PRNGKey(7)
    want = yaw_augment({k: jnp.asarray(v) for k, v in raw.items()}, key)
    phi = jax.random.uniform(key, (b,), minval=-jnp.pi, maxval=jnp.pi)
    got = taug.yaw_rotate({k: torch.from_numpy(v) for k, v in raw.items()},
                          torch.from_numpy(np.asarray(phi)))
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-6)
    for k in ("points_z", "points_rem"):
        assert got[k] is not None and np.array_equal(got[k].numpy(), raw[k])


def test_draw_yaw_range_and_determinism():
    a = taug.draw_yaw(torch.Generator().manual_seed(0), 10000,
                      torch.device("cpu"))
    b = taug.draw_yaw(torch.Generator().manual_seed(0), 10000,
                      torch.device("cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= -np.pi and float(a.max()) < np.pi
    assert abs(float(a.mean())) < 0.1


# --------------------------------------------------------------- dataset

def _ds_dict(**datasets):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"max-points": 1024, **datasets})
    return d


@pytest.mark.parametrize("datasets", [
    {"sequence-size": 3, "window-stride": 2},
    {"sequence-size": 4, "window-stride": 1,
     "combinations": [[0, 1], [0, 3], [2, 3]]},
    {"sequence-size": 9, "window-stride": 8, "max-imu-per-pair": 4}])
def test_window_dataset_bit_identical(datasets):
    d = _ds_dict(**datasets)
    jds = JWindowDataset(jax_config(d).datasets,
                         [JSyntheticDrive(n_frames=11, max_points=1024,
                                          seed=s) for s in (0, 3)])
    tds = WindowDataset(port_config(d).datasets,
                        [SyntheticDrive(n_frames=11, max_points=1024, seed=s)
                         for s in (0, 3)])
    assert tds.index == jds.index
    for shuffle, drop_last in ((True, True), (False, False)):
        kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last)
        want = list(jds.iter_batches(2, workers=1, **kw))
        got = list(tds.iter_batches(2, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ------------------------------------------------- the step's own wiring

def _small_dict(**over):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 1024, "sequence-size": 3,
                          "window-stride": 2, "backend": "pallas", **over})
    d["train"]["batch-size"] = 2
    return d


def test_augment_yaw_is_honoured():
    """With ``augment-yaw`` the step rotates the batch by angles drawn from
    the state's generator before anything else draws from it: the same as
    rotating by those angles and stepping without augmentation."""
    on, off = port_config(_small_dict(**{"augment-yaw": True})), \
        port_config(_small_dict())
    ds = WindowDataset(on.datasets, [SyntheticDrive(n_frames=5,
                                                    max_points=1024)])
    raw = batch_to_device(next(ds.iter_batches(2, shuffle=False)), "cpu")
    model = build_model(on, device="cpu", seed=0)
    sa = create_train_state(on, copy.deepcopy(model), seed=5)
    sb = create_train_state(off, copy.deepcopy(model), seed=5)
    # the same draw from sb's generator leaves it where sa's step leaves
    # its own for the dropout masks that follow
    phi = taug.draw_yaw(sb.generator, 2, torch.device("cpu"))
    _, ma = build_train_step(on)[0](sa, raw)
    _, mb = build_train_step(off)[0](sb, taug.yaw_rotate(raw, phi))
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    _, mc = build_train_step(off)[0](
        create_train_state(off, copy.deepcopy(model), seed=5), raw)
    assert not torch.equal(ma["loss"], mc["loss"])


def test_dropout_in_the_step_is_seeded():
    """Dropout 0.25 on the heads: the same seed gives the same step, another
    seed another one."""
    cfg = port_config(_small_dict())
    ds = WindowDataset(cfg.datasets, [SyntheticDrive(n_frames=5,
                                                     max_points=1024)])
    raw = batch_to_device(next(ds.iter_batches(2, shuffle=False)), "cpu")
    model = build_model(cfg, device="cpu", seed=0)
    step = build_train_step(cfg)[0]
    losses = [float(step(create_train_state(cfg, copy.deepcopy(model),
                                            seed=s), raw)[1]["loss"])
              for s in (1, 1, 2)]
    assert losses[0] == losses[1] != losses[2]
