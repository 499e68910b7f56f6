"""The JAX package's flagship (``__graft_entry__._FLAGSHIP``) in the port,
on the CPU: its configuration, the pair-split stem and the stride-fold
pool against the JAX package, and the pair batches of training and
streaming.

- ``bench/flagship.py``'s YAML equals ``_FLAGSHIP`` and loads in the port
  unedited; its parse equals JAX's field for field, also with
  ``kernel-aligned`` set to ``off``, ``auto``, ``on`` and ``trust``.
- The tower in float32 at 8x64 images (h-stride 2, w-stride 4,
  el-squeeze 128, narrow RNNs): ``SplitInputConv`` against JAX's within
  1e-5 of the output's largest magnitude (two sums of products, each in
  its own order); ``PointSegEncoder`` with ``stride-fold`` and both stems,
  and DeepLIO's forward in eval and training mode, within 1e-4 (as
  ``tests/test_torch_models.py``'s whole models); a classic-stem flax
  checkpoint loaded into a pair-split port model within 1e-4 of the
  classic model. The folded stem's width check (the JAX package's
  ``ValueError``, "use pool=stride") never fires for a 3x3 stem: the
  composed stride with the unfolded SAME pads always gives the unfolded
  width; the test holds that over every width up to 256.
- ``make_model_batch`` under pair-split equals JAX's, bit for bit, for
  consecutive and gathered pairs; streaming with the pair-split stem
  equals streaming with the classic stem on the same weights.
"""

import copy
import dataclasses

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as graft  # noqa: E402
from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.models import blocks as jb  # noqa: E402
from deeplio_tpu.models import build_model as jax_build_model  # noqa: E402
from deeplio_tpu.models.pointseg import PointSegEncoder as JEncoder  # noqa: E402
from deeplio_tpu.train.step import make_model_batch as jax_model_batch  # noqa: E402
from deeplio_tpu_torch.bench.flagship import FLAGSHIP_YAML, flagship_dict  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_drives  # noqa: E402
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models import blocks as tb  # noqa: E402
from deeplio_tpu_torch.models import zoo  # noqa: E402
from deeplio_tpu_torch.models.from_flax import (  # noqa: E402
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.pointseg import PointSegEncoder  # noqa: E402
from deeplio_tpu_torch.train.pretrain import build_pointseg  # noqa: E402
from deeplio_tpu_torch.train.step import make_model_batch  # noqa: E402
from tests.test_torch_models import _close, _flax, _img, _nchw, _nhwc, _perturb  # noqa: E402

H, W, N = 8, 64, 2 * 8 * 64
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4


def small_dict(**ds):
    """The flagship's keys at 8x64 images, 2 slots a pixel, 3-frame
    windows, narrow RNNs and features, float32, dropout 0."""
    d = flagship_dict()
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": N, "sequence-size": 3,
                          "window-stride": 2, "synthetic-frames": 5,
                          "synthetic-eval-drives": 1, **ds})
    d["deeplio"]["dropout"] = 0.0
    for net in ("imu-feat-rnn", "odom-feat-rnn"):
        d[net]["hidden-size"] = 16
    d["lidar-feat-pointseg"]["feature-size"] = 16
    d["train"]["batch-size"] = 2
    return d


def _fields(port, ref, where=""):
    """Every dataclass field the two parses share, recursively: the
    compared paths."""
    seen = []
    for f in dataclasses.fields(port):
        if not hasattr(ref, f.name):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        path = f"{where}{f.name}"
        if dataclasses.is_dataclass(a):
            seen += _fields(a, b, path + ".")
        else:
            assert a == b, (path, a, b)
            seen.append(path)
    return seen


def test_flagship_yaml_equals_jax():
    assert yaml.safe_load(graft._FLAGSHIP) == yaml.safe_load(FLAGSHIP_YAML)
    assert flagship_dict() == yaml.safe_load(graft._FLAGSHIP)


@pytest.mark.parametrize("aligned", ["halves", "off", "auto", "on",
                                     "trust"])
def test_flagship_parse_matches_jax(aligned):
    d = yaml.safe_load(graft._FLAGSHIP)
    d["datasets"]["kernel-aligned"] = aligned
    port, ref = port_config(copy.deepcopy(d)), jax_config(d)
    seen = _fields(port, ref)
    for path in ("datasets.projection.kernel_aligned", "datasets.slot_bin",
                 "model.lidar.stem", "model.lidar.pool",
                 "model.lidar.el_squeeze", "model.imu.hidden_size",
                 "model.odom.num_layers", "model.fusion.kind",
                 "loss.sq", "optim.lr", "train.batch_size"):
        assert path in seen, path
    assert (port.model.lidar.stem, port.model.lidar.pool) == (
        "pair-split", "stride-fold")


@pytest.mark.parametrize("pads,strides", [
    (None, (2, 4)),                       # SAME
    (((0, 1), (0, 0)), (2, 8)),           # the folded stem's explicit pads
    (((1, 1), (1, 2)), (1, 1)),
])
@pytest.mark.parametrize("bias", [False, True])
def test_split_input_conv_matches_jax(pads, strides, bias):
    a, b = _img((2, H, W, 5), 1), _img((2, H, W, 5), 2)
    mod = jb.SplitInputConv(8, (3, 3), strides, pads or "SAME", bias,
                            jnp.float32)
    v, want = _flax(mod, a, b)
    port = tb.SplitInputConv(10, 8, (3, 3), strides, bias=bias)
    load_flax_variables(port, v)
    _close(_nhwc(port((_nchw(a), _nchw(b)), pads)), want, MODULE_TOL)
    # the split input equals the one conv over the concat
    whole = port(_nchw(np.concatenate([a, b], -1)), pads)
    _close(port((_nchw(a), _nchw(b)), pads), whole.detach().numpy(),
           MODULE_TOL)


@pytest.mark.parametrize("stem", ["classic", "pair-split"])
def test_encoder_stride_fold_matches_jax(stem):
    a, b = _img((2, H, W, 5), 3), _img((2, H, W, 5), 4)
    kw = dict(h_stride=2, w_stride=4, el_squeeze=128)
    x = (jnp.asarray(a), jnp.asarray(b)) if stem == "pair-split" else \
        jnp.asarray(np.concatenate([a, b], -1))
    mod = JEncoder(pool="stride-fold", stem=stem, **kw)
    port = PointSegEncoder(10, pool="stride-fold", **kw).eval()
    v = _perturb(to_flax_variables(port), seed=1)
    load_flax_variables(port, v)
    (want, _) = jax.jit(lambda v, x: mod.apply(v, x, train=False))(v, x)
    px = (_nchw(a), _nchw(b)) if stem == "pair-split" else \
        _nchw(np.concatenate([a, b], -1))
    with torch.no_grad():
        got, _ = port(px)
        # the fold is an exact rewrite of pool=stride on the same weights
        unfolded = PointSegEncoder(10, pool="stride", **kw).eval()
        load_flax_variables(unfolded, v)
        ref, _ = unfolded(_nchw(np.concatenate([a, b], -1)))
    _close(_nhwc(got), want, MODEL_TOL)
    _close(got, ref.numpy(), MODULE_TOL)


def test_fold_width_check_never_fires_for_a_3x3_stem():
    """Every width 1..256 at w-strides 1..8: the folded stem's width is
    ceil(ceil(W / w) / 2), so the check passes where JAX's does."""
    enc = PointSegEncoder(4, pool="stride-fold", h_stride=2, w_stride=1)
    for ws in range(1, 9):
        enc.strides = (2, ws)
        for w in range(1, 257):
            (ph, pw) = enc._fold_pads(torch.zeros(1, 4, 8, w))
            assert (w + sum(pw) - 3) // (2 * ws) + 1 == -(-(-(-w // ws))
                                                          // 2)


@pytest.fixture(scope="module")
def flagship_pair():
    """The small flagship DeepLIO: the port's seeded init, perturbed, in
    JAX's model."""
    d = small_dict()
    port = zoo.build_model(port_config(d), device="cpu", seed=0)
    variables = _perturb(to_flax_variables(port), seed=5)
    load_flax_variables(port, variables)
    return jax_build_model(jax_config(d)), variables, port


def _pair_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((2, 2, 16), np.float32)
    mask[0, 1, 9:] = 0
    return {"images": rng.normal(size=(2, 2, H, W, 5)).astype(np.float32),
            "images2": rng.normal(size=(2, 2, H, W, 5)).astype(np.float32),
            "imu": rng.normal(size=(2, 2, 16, 6)).astype(np.float32),
            "imu_mask": mask}


@pytest.mark.parametrize("train", [False, True])
def test_deeplio_forward_matches_jax(flagship_pair, train):
    model, variables, port = flagship_pair
    batch = _pair_batch(6 + train)
    jb_ = {k: jnp.asarray(a) for k, a in batch.items()}
    if train:
        (x, q), _ = jax.jit(lambda v, b: model.apply(
            v, b, train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(2)}))(variables, jb_)
    else:
        x, q = jax.jit(lambda v, b: model.apply(v, b, train=False))(
            variables, jb_)
    port.train(train)
    try:
        with torch.no_grad():
            tx, tq = port({k: torch.from_numpy(a) for k, a in batch.items()})
    finally:
        port.eval()
        load_flax_variables(port, variables)
    _close(tx, x, MODEL_TOL)
    _close(tq, q, MODEL_TOL)


def test_classic_checkpoint_loads_into_pair_split(flagship_pair):
    """The stems share one parameter tree: a classic-stem flax model's
    variables load into the pair-split port model, whose output on the
    two frames equals the classic model's on their concat."""
    _, variables, _ = flagship_pair
    d = small_dict()
    d["lidar-feat-pointseg"]["stem"] = "classic"
    classic = jax_build_model(jax_config(d))
    port = zoo.build_model(port_config(small_dict()), device="cpu",
                           seed=None)
    load_flax_variables(port, variables)
    batch = _pair_batch(8)
    cat = dict(batch, images=np.concatenate(
        [batch.pop("images"), batch.pop("images2")], -1))
    x, q = jax.jit(lambda v, b: classic.apply(v, b, train=False))(
        variables, {k: jnp.asarray(a) for k, a in cat.items()})
    with torch.no_grad():
        tx, tq = port({k: torch.from_numpy(a)
                       for k, a in _pair_batch(8).items()})
    _close(tx, x, MODEL_TOL)
    _close(tq, q, MODEL_TOL)


@pytest.mark.parametrize("combos", [None, [[0, 2], [1, 2]]])
def test_make_model_batch_pair_split_matches_jax(combos):
    """Cached images [B, S, H, W, C] -> ``images`` / ``images2``: frame
    slices for consecutive pairs, gathers otherwise."""
    d = small_dict()
    if combos:
        d["datasets"]["combinations"] = combos
    imgs = _img((2, 3, H, W, 5), 9).astype(np.float16)
    raw = {"images": imgs, "imu": _img((2, 2, 16, 6), 10),
           "imu_mask": np.ones((2, 2, 16), np.float32)}
    want = jax_model_batch(jax_config(d), None,
                           {k: jnp.asarray(a) for k, a in raw.items()})
    got = make_model_batch(port_config(d), None,
                           {k: torch.from_numpy(a) for k, a in raw.items()})
    assert got.keys() == want.keys() == {"images", "images2", "imu",
                                         "imu_mask"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_streaming_pair_split_equals_classic_stem(flagship_pair):
    """The streaming tick hands the pair-split stem the previous and the
    new frame apart (JAX's ``images`` / ``images2``); on the classic
    stem's weights it must give the classic model's poses. Drives: the
    test split's synthetic drive, slot-binned into the halves layout."""
    d = small_dict()
    cfg = port_config(d)
    split = flagship_pair[2]
    d["lidar-feat-pointseg"]["stem"] = "classic"
    classic = zoo.build_model(port_config(d), device="cpu", seed=None)
    classic.load_state_dict(split.state_dict())
    (drive,) = build_drives(cfg, "test")
    assert drive.slot_layout == "halves"
    got = StreamingOdometry(cfg, split, chunk=2, device="cpu").run(drive)
    want = StreamingOdometry(port_config(d), classic, chunk=2,
                             device="cpu").run(drive)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= MODEL_TOL * max(np.abs(w).max(), 1e-6)


def test_pretraining_builds_the_stride_pool_and_grafts():
    """Pretraining a flagship config builds the segmentation net with
    ``pool: stride`` (its decoder needs the unfolded skips); its encoder's
    tensors are the folded encoder's, name for name and shape for shape."""
    cfg = port_config(small_dict())
    net = build_pointseg(cfg, 20)
    model = zoo.build_model(cfg, device="cpu", seed=None)
    assert net.encoder.fold is False
    assert model.lidar_feat.pointseg.encoder.fold is True
    want = {k: v.shape for k, v in
            model.lidar_feat.pointseg.encoder.state_dict().items()}
    assert {k: v.shape for k, v in net.encoder.state_dict().items()} == want
