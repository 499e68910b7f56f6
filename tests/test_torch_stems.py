"""Every PointSeg stem and Fire against the JAX package, float32 on the CPU.

* ``space_to_depth`` and ``space_to_depth_pairs`` equal JAX's bit for bit
  (pure data movement), and refuse blocks that do not tile the image;
* the fused ``Fire`` and ``FactorizedStem`` alone, within 1e-5 of the
  output's largest magnitude (``tests/test_torch_models.py``'s module
  tolerance);
* the encoder for every stem x Fire case: ``tests/test_torch_stem_encoders.py``;
* ``factorize_stem_variables`` equal to JAX's bit for bit; the port's own
  ``factorized`` model equal to its classic one on transplanted weights
  (JAX's ``test_factorized_stem_parity_with_classic``, its tolerance) and
  ``s2d-pre`` equal to ``s2d`` bit for bit (JAX's
  ``test_s2d_pre_parity_with_s2d``).
"""

import copy
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deeplio_tpu.models import blocks as jb  # noqa: E402
from deeplio_tpu.models import factorize_stem_variables as jax_factorize  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.models import blocks as tb  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.pointseg import PointSegNet  # noqa: E402
from deeplio_tpu_torch.models.zoo import (  # noqa: E402
    build_model,
    factorize_stem_variables,
)
from tests.test_torch_models import (  # noqa: E402
    MODULE_TOL,
    _close,
    _flax,
    _img,
    _nchw,
    _nhwc,
    _perturb,
)

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
STATS_TOL = 1e-5
B, H, W, C = 2, 16, 128, 5          # frames of C channels, pairs of 2C
HS, WS = 2, 4


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------ layouts

@pytest.mark.parametrize("h,w", [(2, 4), (1, 2), (4, 1)])
def test_space_to_depth_bit_exact(h, w):
    x = _img((3, 8, 16, 7), seed=1)
    want = np.asarray(jb.space_to_depth(jnp.asarray(x), h, w))
    got = tb.space_to_depth(torch.from_numpy(x), h, w).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combos", [((0, 1), (1, 2)), ((0, 2), (1, 1)),
                                    ((0, 0),)])
def test_space_to_depth_pairs_bit_exact(combos):
    frames = _img((2, 3, 8, 16, 5), seed=2)
    want = np.asarray(jb.space_to_depth_pairs(jnp.asarray(frames), combos,
                                              HS, WS))
    got = tb.space_to_depth_pairs(torch.from_numpy(frames), combos, HS,
                                  WS).numpy()
    np.testing.assert_array_equal(got, want)
    # the pair's layout is space_to_depth of the pair concat
    for k, (i, j) in enumerate(combos):
        cat = np.concatenate([frames[:, i], frames[:, j]], -1)
        np.testing.assert_array_equal(
            got[:, k], tb.space_to_depth(torch.from_numpy(cat), HS,
                                         WS).numpy())


@pytest.mark.parametrize("hw", [(15, 16), (16, 18)])
def test_space_to_depth_refuses_partial_blocks(hw):
    with pytest.raises(ValueError, match="tile"):
        tb.space_to_depth(torch.zeros((1, *hw, 3)), HS, WS)


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("strides", [(1, 1), (1, 2)])
def test_fused_fire(strides):
    x = _img((2, 6, 16, 12))
    v, want = _flax(jb.Fire(8, 16, 16, strides=strides, fused=True), x,
                    train=False)
    port = tb.Fire(12, 8, 16, 16, strides, fused=True).eval()
    load_flax_variables(port, v)
    assert set(dict(port.named_children())) == {"ConvBN_0"}
    _close(_nhwc(port(_nchw(x))), want, MODULE_TOL)


@pytest.mark.parametrize("combos", [((0, 1), (1, 2)), ((0, 2),)])
def test_factorized_stem(combos):
    frames = _img((2, 3, 16, 32, C), seed=3)
    v, want = _flax(jb.FactorizedStem(combos, 8, (3, 3), (HS, WS)), frames,
                    train=False)
    port = tb.FactorizedStem(C, 8, (3, 3), (HS, WS)).eval()
    load_flax_variables(port, v)
    assert port.Conv_0.bias is None        # no bias under the BatchNorm
    x = torch.from_numpy(frames).permute(0, 1, 4, 2, 3)   # NCHW frames
    _close(_nhwc(port(x, combos)), want, MODULE_TOL)


# ------------------------------------------------- the stems' own parities

def _dict(stem="classic"):
    """``configs/deeplio_kitti_tpu.yaml`` cut to 16x128, windows of 3,
    narrow nets, float32, with ``stem``."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2048, "sequence-size": 3})
    d["lidar-feat-pointseg"].update({"feature-size": 16, "el-squeeze": 16,
                                     "stem": stem})
    d["imu-feat-rnn"]["hidden-size"] = 12
    d["odom-feat-rnn"]["hidden-size"] = 16
    return d


def test_factorize_stem_variables_matches_jax():
    """On a classic DeepLIO's variables in the flax layout (params and
    statistics, perturbed): the same tree as JAX's function gives, bit for
    bit, and it loads into the factorized model."""
    cfg = port_config(_dict())
    variables = jax.tree.map(np.asarray, _perturb(to_flax_variables(
        build_model(cfg, device="cpu", seed=3)), seed=2))
    c = cfg.datasets.num_image_channels
    want = _leaves(jax_factorize(variables, c))
    got_tree = factorize_stem_variables(copy.deepcopy(variables), c)
    got = _leaves(got_tree)
    assert got.keys() == want.keys()
    assert any("FactorizedStem_0" in k for k in got)
    assert not any("encoder']['ConvBN_0" in k for k in got)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k], a, err_msg=k)
    port = build_model(port_config(_dict("factorized")), device="cpu",
                       seed=None)
    load_flax_variables(port, got_tree)
    with pytest.raises(ValueError, match="input channels"):
        factorize_stem_variables(variables, c + 1)


def test_factorize_carries_a_stem_bias():
    """A classic stem bias b becomes concat([b, 0]), as in JAX."""
    tree = {"params": {"encoder": {"ConvBN_0": {"Conv_0": {
        "kernel": _img((3, 3, 4, 6)), "bias": _img((6,), seed=1)}}}}}
    got = factorize_stem_variables(tree, 2)
    want = jax_factorize(tree, 2)
    for k, a in _leaves(want).items():
        np.testing.assert_array_equal(_leaves(got)[k], a, err_msg=k)
    conv = got["params"]["encoder"]["FactorizedStem_0"]["Conv_0"]
    assert conv["kernel"].shape == (3, 3, 2, 12)
    np.testing.assert_array_equal(conv["bias"][6:], 0.0)


def test_factorized_model_equals_classic():
    """The port's classic model on the pair stack against its factorized
    model on the frames, on the classic weights through
    ``factorize_stem_variables`` (JAX's parity test and tolerance)."""
    classic = build_model(port_config(_dict()), device="cpu", seed=3)
    cfg_f = port_config(_dict("factorized"))
    fact = build_model(cfg_f, device="cpu", seed=None)
    load_flax_variables(fact, factorize_stem_variables(
        to_flax_variables(classic), cfg_f.datasets.num_image_channels))
    rng = np.random.default_rng(0)
    c = cfg_f.datasets.num_image_channels
    frames = rng.normal(size=(2, 3, H, W, c)).astype(np.float32)
    combos = cfg_f.datasets.effective_combinations
    pairs = np.stack([np.concatenate([frames[:, i], frames[:, j]], -1)
                      for i, j in combos], 1)
    imu = rng.normal(size=(2, len(combos), 16, 6)).astype(np.float32)
    mask = np.ones((2, len(combos), 16), np.float32)
    common = {"imu": torch.from_numpy(imu), "imu_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        xc, qc = classic({"images": torch.from_numpy(pairs), **common})
        xf, qf = fact({"frames": torch.from_numpy(frames), **common})
    np.testing.assert_allclose(xf.numpy(), xc.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(qf.numpy(), qc.numpy(), rtol=1e-4, atol=1e-5)


def test_s2d_pre_equals_s2d_bit_for_bit():
    """The same weights on the pair concat (``s2d``) and on its
    data-side layout (``s2d-pre``): the identical conv on an identical
    tensor."""
    kw = dict(part="encoder", h_stride=HS, w_stride=WS, el_squeeze=8)
    net_s = PointSegNet(2 * C, stem="s2d", **kw).eval()
    net_p = PointSegNet(2 * C, stem="s2d-pre", **kw).eval()
    net_p.load_state_dict(net_s.state_dict())
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(2, H, W, C)).astype(np.float32)
            for _ in range(2))
    pair = np.concatenate([a, b], -1)
    pre = tb.space_to_depth_pairs(torch.from_numpy(np.stack([a, b], 1)),
                                  ((0, 1),), HS, WS)[:, 0]
    with torch.no_grad():
        ys = net_s(_nchw(pair))
        yp = net_p(pre.permute(0, 3, 1, 2))
    assert torch.equal(ys, yp)
