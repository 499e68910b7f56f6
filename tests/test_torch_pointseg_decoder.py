"""The port's PointSeg decoder, classifier head and transposed convolution
against the JAX package's flax modules, float32 on the CPU.

Each module's variables (flax's init for the single modules, the port's
seeded init for the whole net, which saves a JAX compile) get perturbed
biases and BatchNorm statistics (so each matters), are carried into the
other package's module (``load_flax_variables`` / ``to_flax_variables``),
and both run on the same numpy input (NHWC on the JAX side, NCHW on the
port's).

Tolerances (float32; XLA and oneDNN sum in different orders): a single
module within 1e-5 of its output's largest magnitude, the whole
segmentation net (about 35 layers) within 1e-4, in eval mode and in
training mode (batch statistics, and the running statistics they update
within 1e-5 of each leaf's largest magnitude). The weight bridge is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplio_tpu.models import blocks as jb
from deeplio_tpu.models import pointseg as jps
from deeplio_tpu_torch.models import blocks as tb
from deeplio_tpu_torch.models import pointseg as tps
from deeplio_tpu_torch.models.from_flax import (
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.zoo import init_parameters

import flax.linen as nn  # noqa: E402

MODULE_TOL = 1e-5
NET_TOL = 1e-4
STATS_TOL = 1e-5
H, W, C = 16, 128, 10
CLASSES = 5
# (h_stride, w_stride, el_squeeze): the kitti-tpu tower (its (4, 8) head)
# and the default strides (the (1, 4) head)
NETS = {"h2w4": (2, 4, 16), "h1w2": (1, 2, 0)}


def _perturb(variables, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(path[-1].key)
        a = np.asarray(a, np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(leaf, variables)


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} vs tol {tol} * {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("kernel,strides", [((1, 4), (1, 2)),
                                            ((4, 8), (2, 4)),
                                            ((1, 8), (1, 4)),
                                            ((3, 3), (1, 1))])
def test_same_conv_transpose_matches_flax(kernel, strides):
    x = np.random.default_rng(1).normal(size=(2, 4, 8, 6)).astype(np.float32)
    mod = nn.ConvTranspose(5, kernel, strides=strides, padding="SAME")
    v = _perturb(jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(mod.apply)(v, jnp.asarray(x))
    port = tb.SameConvTranspose2d(6, 5, kernel, strides)
    load_flax_variables(port, v)
    got = _nhwc(port(_nchw(x)))
    assert got.shape == (2, 4 * strides[0], 8 * strides[1], 5)
    _close(got, want, MODULE_TOL)


def test_transpose_pads_are_lax_same():
    from jax._src.lax.convolution import _conv_transpose_padding
    for k in range(1, 9):
        for s in range(1, 5):
            assert tb.transpose_pads(k, s) == _conv_transpose_padding(
                k, s, "SAME")


def test_fire_deconv_matches_flax():
    x = np.random.default_rng(2).normal(size=(2, 4, 16, 24)).astype(
        np.float32)
    mod = jb.FireDeconv(8, 12, 12)
    v = _perturb(jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(mod.apply)(v, jnp.asarray(x))
    port = tb.FireDeconv(24, 8, 12, 12)
    load_flax_variables(port, v)
    assert sorted(dict(port.named_children())) == sorted(v["params"])
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


def _jax_net(h, w, el, part="encoder+decoder", classes=CLASSES):
    return jps.PointSegNet(part=part, num_classes=classes, h_stride=h,
                           w_stride=w, el_squeeze=el, pool="stride")


def _port_net(h, w, el, part="encoder+decoder", classes=CLASSES):
    return tps.PointSegNet(C, part=part, num_classes=classes, h_stride=h,
                           w_stride=w, el_squeeze=el)


@pytest.fixture(scope="module", params=list(NETS))
def nets(request):
    """The port's net from the port's seeded init, perturbed, carried into
    JAX's net, which runs in eval and in training mode in one program."""
    h, w, el = NETS[request.param]
    x = np.random.default_rng(3).normal(size=(2, H, W, C)).astype(
        np.float32)
    port = _port_net(h, w, el)
    init_parameters(port, torch.Generator().manual_seed(0))
    v = _perturb(to_flax_variables(port))
    load_flax_variables(port, v)
    jnet = _jax_net(h, w, el)

    @jax.jit
    def run(v, a):
        return (jnet.apply(v, a, train=False),
                jnet.apply(v, a, train=True, mutable=["batch_stats"]))

    ev, tr = run(v, jnp.asarray(x))
    return {"x": x, "v": v, "port": port, "net": (h, w, el),
            "eval": np.asarray(ev), "train": tr}


def test_segmentation_net_matches_jax_eval(nets):
    port = nets["port"].eval()
    with torch.no_grad():
        got = _nhwc(port(_nchw(nets["x"])))
    assert got.shape == (2, H, W, CLASSES)
    _close(got, nets["eval"], NET_TOL)


def test_segmentation_net_matches_jax_train(nets):
    port = nets["port"]
    state = {k: t.clone() for k, t in port.state_dict().items()}
    try:
        port.train()
        with torch.no_grad():
            got = _nhwc(port(_nchw(nets["x"])))
        logits, mut = nets["train"]
        _close(got, logits, NET_TOL)
        want = _flat(jax.tree.map(np.asarray, mut["batch_stats"]))
        have = _flat(to_flax_variables(port)["batch_stats"])
        assert have.keys() == want.keys()
        for k in want:
            _close(have[k], want[k], STATS_TOL)
    finally:
        port.load_state_dict(state)
        port.eval()


def test_weight_bridge_round_trip_with_transposed_convs(nets):
    """A flax tree -> the port -> the flax layout again, bit for bit, the
    transposed convs' flipped kernels included, with JAX's tree's paths
    and shapes."""
    got = _flat(to_flax_variables(nets["port"]))
    want = _flat(nets["v"])
    assert got.keys() == want.keys()
    shapes = _flat(jax.eval_shape(lambda a: _jax_net(*nets["net"]).init(
        jax.random.PRNGKey(0), a, train=False),
        jax.ShapeDtypeStruct((1, H, W, C), jnp.float32)))
    assert shapes.keys() == want.keys()
    assert all(shapes[k].shape == want[k].shape for k in want)
    deconvs = [k for k in want if "ConvTranspose_0/kernel" in k]
    assert len(deconvs) == 4      # three FireDeconvs and the head
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_encoder_part_keeps_its_parameter_names():
    """The odometry model's encoder: the same tensors as before the
    decoder existed (``encoder.*`` only) and JAX's ``part=encoder``
    tree."""
    port = _port_net(2, 4, 128, part="encoder", classes=None)
    keys = list(port.state_dict())
    assert keys and all(k.startswith("encoder.") for k in keys)
    assert not hasattr(port, "decoder") and not hasattr(port, "Conv_0")
    v = jax.eval_shape(lambda a: _jax_net(
        2, 4, 128, part="encoder", classes=None).init(
            jax.random.PRNGKey(0), a, train=False),
        jax.ShapeDtypeStruct((1, H, W, C), jnp.float32))
    want = _flat(v)
    got = _flat(to_flax_variables(port))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)


def test_head_runs_float32_under_autocast():
    """Under bf16 autocast the transposed conv runs in bf16 and the 1x1
    classifier in float32 on a float32 input."""
    port = _port_net(2, 4, 16).eval()
    seen = {}

    def up(m, i, o):
        seen["up"] = o.dtype

    def head(m, i, o):
        seen["head"] = (i[0].dtype, o.dtype)
    port.ConvTranspose_0.register_forward_hook(up)
    port.Conv_0.register_forward_hook(head)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = port(torch.zeros(1, C, H, W))
    assert seen == {"up": torch.bfloat16,
                    "head": (torch.float32, torch.float32)}
    assert out.dtype == torch.float32


@pytest.mark.parametrize("pool", ["classic", "cheap"])
def test_pooled_encoder_feeds_the_decoder(pool):
    """``pool: classic`` (3x3 max-pools at stride (1, 2), lax's SAME
    padding) and ``cheap``: the stage-entry Fires run unstrided and the
    pools downsample, so the skips keep the stride-pool widths, the
    decoder and head need no change, the tree equals the stride pool's,
    and the segmentation net matches JAX's (eval mode, NET_TOL)."""
    x = np.random.default_rng(4).normal(size=(2, H, W, C)).astype(
        np.float32)
    port = tps.PointSegNet(C, part="encoder+decoder", num_classes=CLASSES,
                           pool=pool)
    init_parameters(port, torch.Generator().manual_seed(1))
    v = _perturb(to_flax_variables(port), seed=2)
    load_flax_variables(port, v)
    stride = tps.PointSegNet(C, part="encoder+decoder", num_classes=CLASSES)
    load_flax_variables(stride, v)              # the same tree
    port.eval()
    with torch.no_grad():
        _, skips = port.encoder(_nchw(x))
        _, want_skips = stride.encoder(_nchw(x))
        got = _nhwc(port(_nchw(x)))
    assert [s.shape for s in skips] == [s.shape for s in want_skips] == [
        (2, 64, H, W // 2), (2, 128, H, W // 4), (2, 256, H, W // 8)]
    jnet = jps.PointSegNet(part="encoder+decoder", num_classes=CLASSES,
                           pool=pool)
    want = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(
        v, jnp.asarray(x))
    assert got.shape == (2, H, W, CLASSES)
    _close(got, want, NET_TOL)


def test_same_max_pool_is_flax_max_pool():
    """-inf padding with the extra column on the right (not
    ``F.max_pool2d``'s symmetric padding), on odd and even sizes."""
    for hw in ((5, 8), (4, 9)):
        x = np.random.default_rng(5).normal(size=(2, *hw, 3)).astype(
            np.float32) - 10.0                  # all negative: -inf shows
        for k, s in (((3, 3), (1, 2)), ((1, 2), (1, 2))):
            want = nn.max_pool(jnp.asarray(x), k, strides=s, padding="SAME")
            got = _nhwc(tb.same_max_pool(_nchw(x), k, s))
            np.testing.assert_array_equal(got, np.asarray(want))
