"""Port modules against the JAX reference, float32 on the CPU.

Every flax module is initialised by JAX, its BatchNorm statistics, scales
and biases perturbed (so running statistics and every bias matter), loaded
into the port's module with ``load_flax_variables``, and both forwards run
on the same numpy input. Images are NHWC on the JAX side and NCHW on the
port's module side; the full model takes the NHWC batch on both.

Tolerances (float32, summation order differs between XLA and oneDNN):
single modules within 1e-5 of the output's largest magnitude, the whole
DeepLIO tower within 1e-4.
"""

import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.models import blocks as jb  # noqa: E402
from deeplio_tpu.models import feat_nets as jf  # noqa: E402
from deeplio_tpu.models import init_model  # noqa: E402
from deeplio_tpu.ops import rnn as jr  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.models import blocks as tb  # noqa: E402
from deeplio_tpu_torch.models import feat_nets as tf  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.ops import rnn as tr  # noqa: E402

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4


def _perturb(variables, seed=0):
    """Random BN statistics/scales and biases (init leaves them 1/0)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        a = np.asarray(a, np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "b", "mean"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _flax(module, *inputs, **kw):
    v = module.init(jax.random.PRNGKey(1), *[jnp.asarray(i) for i in inputs],
                    **kw)
    v = _perturb(v)
    out = module.apply(v, *[jnp.asarray(i) for i in inputs], **kw)
    return v, out


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} vs tol {tol} * {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _img(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("hw,kernel,strides", [
    ((16, 128), (3, 3), (2, 4)),     # the stem: pads H (0, 1), W (0, 0)
    ((15, 33), (3, 3), (2, 2)),      # odd sizes: the reducer ConvBNs
    ((8, 12), (1, 1), (1, 2)),       # Fire entry squeeze
    ((7, 9), (3, 3), (1, 1)),
])
def test_convbn_strided_same(hw, kernel, strides):
    x = _img((2, *hw, 5))
    v, want = _flax(jb.ConvBN(8, kernel, strides), x, train=False)
    port = tb.ConvBN(5, 8, kernel, strides).eval()
    load_flax_variables(port, v)
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


@pytest.mark.parametrize("strides", [(1, 1), (1, 2)])
def test_fire(strides):
    x = _img((2, 6, 16, 12))
    v, want = _flax(jb.Fire(8, 16, 16, strides=strides), x, train=False)
    port = tb.Fire(12, 8, 16, 16, strides).eval()
    load_flax_variables(port, v)
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


def test_selayer():
    x = _img((2, 4, 8, 64))
    v, want = _flax(jb.SELayer(), x)
    port = tb.SELayer(64)
    load_flax_variables(port, v)
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


@pytest.mark.parametrize("squeeze", [8, 0])
def test_aspp(squeeze):
    x = _img((2, 8, 10, 16))
    v, want = _flax(jb.ASPP(24, squeeze=squeeze), x)
    port = tb.ASPP(16, 24, squeeze=squeeze)
    load_flax_variables(port, v)
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


def test_lidar_pointseg_feat():
    x = _img((2, 16, 128, 10))
    kw = dict(h_stride=2, w_stride=4, el_squeeze=16, pool="stride")
    v, want = _flax(jf.LidarPointSegFeat(feature_size=32, **kw), x,
                    train=False)
    port = tf.LidarPointSegFeat(10, 32, h_stride=2, w_stride=4,
                                el_squeeze=16).eval()
    load_flax_variables(port, v)
    _close(port(_nchw(x)), want, MODEL_TOL)


def test_masked_rnn_masked_tails():
    """Masked steps carry h, c and emit the carried h: tails of every
    length, including a fully masked row."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 7, 6)).astype(np.float32)
    mask = np.ones((4, 7), np.float32)
    mask[1, 5:] = 0
    mask[2, 1:] = 0
    mask[3, :] = 0
    mod = jr.MaskedRNN(12, num_layers=2)
    v, (ys, final) = _flax(mod, x, mask)
    port = tr.MaskedRNN(6, 12, num_layers=2)
    load_flax_variables(port, v)
    tys, tfinal = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(tys, ys, MODULE_TOL)
    _close(tfinal, final, MODULE_TOL)
    assert not tys[3].any()                       # never a valid step
    torch.testing.assert_close(tys[2, 1:], tys[2, :1].expand(6, -1),
                               rtol=0, atol=0)   # carried through


@pytest.mark.parametrize("kind", ["soft", "hard"])
def test_fusion_layer(kind):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 20)).astype(np.float32)
    b = rng.normal(size=(3, 8)).astype(np.float32)
    v, want = _flax(jf.FusionLayer(kind), a, b)
    port = tf.FusionLayer(20, 8, kind)
    load_flax_variables(port, v)
    _close(port(torch.from_numpy(a), torch.from_numpy(b)), want,
           MODULE_TOL)


def test_pose_heads():
    x = np.random.default_rng(4).normal(size=(5, 24)).astype(np.float32)
    v, (xo, qo) = _flax(jf.PoseHeads(), x, train=False)
    port = tf.PoseHeads(24)
    load_flax_variables(port, v)
    txo, tqo = port(torch.from_numpy(x))
    _close(txo, xo, MODULE_TOL)
    _close(tqo, qo, MODULE_TOL)
    torch.testing.assert_close(tqo.norm(dim=-1), torch.ones(5))


def _kitti_dict(h=16, w=128):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": h, "image-width": w,
                          "max-points": 2048})
    return d


@pytest.fixture(scope="module")
def deeplio_pair():
    d = _kitti_dict()
    jcfg = jax_config(d)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    variables = _perturb(variables, seed=5)
    port = build_model(port_config(d), device="cpu", seed=None)
    load_flax_variables(port, variables)
    return model, variables, port


def test_deeplio_full_forward(deeplio_pair):
    """The whole model at the kitti-tpu knobs, 16x128, 2 windows x 2
    pairs, float32."""
    model, variables, port = deeplio_pair
    rng = np.random.default_rng(6)
    mask = np.ones((2, 2, 16), np.float32)
    mask[0, 1, 9:] = 0
    mask[1, 0, 3:] = 0
    batch = {"images": rng.normal(size=(2, 2, 16, 128, 10)).astype(np.float32),
             "imu": rng.normal(size=(2, 2, 16, 6)).astype(np.float32),
             "imu_mask": mask}
    x, q = model.apply(variables, {k: jnp.asarray(a) for k, a in
                                   batch.items()}, train=False)
    with torch.no_grad():
        tx, tq = port({k: torch.from_numpy(a) for k, a in batch.items()})
    _close(tx, x, MODEL_TOL)
    _close(tq, q, MODEL_TOL)


def test_parameter_count_matches(deeplio_pair):
    """Same parameters and statistics as the flax tree (5,550,495 values at
    the full config: the tree's shapes do not depend on image size)."""
    _, variables, port = deeplio_pair
    flax_n = sum(np.size(a) for a in jax.tree_util.tree_leaves(variables))
    port_n = sum(t.numel() for k, t in port.state_dict().items()
                 if not k.endswith("num_batches_tracked"))
    assert port_n == flax_n == 5_550_495


def test_seeded_init_is_deterministic():
    cfg = port_config(_kitti_dict())
    a = build_model(cfg, device="cpu", seed=3).state_dict()
    b = build_model(cfg, device="cpu", seed=3).state_dict()
    c = build_model(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["heads.x_fc.weight"], c["heads.x_fc.weight"])
    torch.testing.assert_close(a["heads.q_out.bias"],
                               torch.tensor([1.0, 0.0, 0.0, 0.0]))
