"""The port's reference-checkpoint importer (``models/import_torch.py``)
against the JAX package's ``deeplio_tpu/models/import_torch.py``, on the
CPU.

Reference state dicts are built in code from live ``torch.nn`` modules
(``Conv2d``, ``ConvTranspose2d``, ``Linear``, ``BatchNorm2d``, ``LSTM``)
shaped like the port's models, with seeded random values:

* every layout converter bit-equal to JAX's on the same tensors;
* ``import_state_dict`` on a DeepLIO (the kitti-tpu model) and on the
  segmentation ``PointSegNet`` (its transposed convs): the port's trees,
  walked from the port model's own tree, equal JAX's, walked from JAX's
  (``jax.eval_shape`` of the flax init), bit for bit;
* the strict errors (a leftover torch key, a missing tensor, a shape
  mismatch) on both sides;
* ``nn.GRU`` and bidirectional ``nn.LSTM`` tensors, in a converter call
  and in a DeepIO state dict whose IMU net is a GRU or a bidirectional
  LSTM: the port's trees equal JAX's bit for bit;
* checkpoint files wrapped as the reference wraps them;
* a narrow DeepLIO imported through both packages, the two forwards on
  one batch within 1e-4 of the output's largest magnitude (float32,
  ``tests/test_torch_models.py``'s tolerance), after
  ``tests/integration/test_import_e2e.py``.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from deeplio_tpu.config import load_config_dict as jax_config
from deeplio_tpu.models import build_model as jax_build_model
from deeplio_tpu.models import example_batch
from deeplio_tpu.models import import_torch as jit
from deeplio_tpu.models import pointseg as jps
from deeplio_tpu_torch.config import load_config_dict as port_config
from deeplio_tpu_torch.models import import_torch as tit
from deeplio_tpu_torch.models.from_flax import (
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.pointseg import PointSegNet
from deeplio_tpu_torch.models.zoo import build_model
from deeplio_tpu_torch.ops.rnn import GruCellScan, MaskedRNN

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
MODEL_TOL = 1e-4
H, W, C = 16, 128, 5


def _randomize(module: nn.Module, g: torch.Generator) -> nn.Module:
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
    return module


def reference_state_dict(model: nn.Module, seed: int = 0):
    """A reference-layout state dict for ``model``: each of its convs,
    transposed convs, Linears and BatchNorms as the stock module of that
    shape, each masked RNN as an ``nn.LSTM`` or ``nn.GRU`` with its
    directions, under the port's names, with random values from
    ``seed``."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.ConvTranspose2d):
            ref = nn.ConvTranspose2d(mod.in_channels, mod.out_channels,
                                     mod.kernel_size,
                                     bias=mod.bias is not None)
        elif isinstance(mod, nn.Conv2d):
            ref = nn.Conv2d(mod.in_channels, mod.out_channels,
                            mod.kernel_size, bias=mod.bias is not None)
        elif isinstance(mod, nn.Linear):
            ref = nn.Linear(mod.in_features, mod.out_features)
        elif isinstance(mod, nn.BatchNorm2d):
            ref = nn.BatchNorm2d(mod.num_features)
        elif isinstance(mod, MaskedRNN):
            cell = mod.l0_fwd
            kind = nn.GRU if isinstance(cell, GruCellScan) else nn.LSTM
            ref = kind(cell.w_ih.shape[0], cell.hidden_size,
                       mod.num_layers, batch_first=True,
                       bidirectional=mod.bidirectional)
        else:
            continue
        for k, t in _randomize(ref, g).state_dict().items():
            sd[f"{name}.{k}"] = t
    return sd


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def _kitti_dict():
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2048})
    return d


# ------------------------------------------------------------ converters

def test_converters_bit_equal_to_jax():
    g = torch.Generator().manual_seed(1)
    conv = _randomize(nn.Conv2d(3, 5, (3, 2)), g)
    deconv = _randomize(nn.ConvTranspose2d(4, 6, (1, 4)), g)
    square = _randomize(nn.ConvTranspose2d(6, 6, (4, 8)), g)
    dense = _randomize(nn.Linear(7, 3), g)
    bn = _randomize(nn.BatchNorm2d(9), g)
    lstm = _randomize(nn.LSTM(6, 8, num_layers=2), g)
    pairs = [
        (tit.convert_conv(conv.weight, conv.bias),
         jit.convert_conv(conv.weight, conv.bias)),
        (tit.convert_conv(conv.weight), jit.convert_conv(conv.weight)),
        (tit.convert_conv_transpose(deconv.weight, deconv.bias),
         jit.convert_conv_transpose(deconv.weight, deconv.bias)),
        (tit.convert_conv_transpose(square.weight, square.bias),
         jit.convert_conv_transpose(square.weight, square.bias)),
        (tit.convert_dense(dense.weight, dense.bias),
         jit.convert_dense(dense.weight, dense.bias)),
        (dict(zip("ps", tit.convert_batchnorm(
            bn.weight, bn.bias, bn.running_mean, bn.running_var))),
         dict(zip("ps", jit.convert_batchnorm(
             bn.weight, bn.bias, bn.running_mean, bn.running_var)))),
        (tit.convert_rnn(lstm.state_dict(), "", 2, "lstm"),
         jit.convert_rnn(lstm.state_dict(), "", 2, "lstm")),
    ]
    for got, want in pairs:
        _assert_trees_equal(got, want)


@pytest.mark.parametrize("cell,bidi", [("gru", False), ("lstm", True)])
def test_gru_and_bidirectional_raise_naming_item_5(cell, bidi):
    """Once refused, now converted: a GRU's tensors (its two biases kept
    apart) and a bidirectional RNN's (``*_reverse`` -> ``l{k}_bwd``), bit
    for bit as JAX's converter; and the converted weights compute what
    the torch module computes."""
    g = torch.Generator().manual_seed(3)
    rnn = _randomize((nn.GRU if cell == "gru" else nn.LSTM)(
        6, 8, num_layers=2, bidirectional=bidi, batch_first=True), g)
    got = tit.convert_rnn(rnn.state_dict(), "", 2, cell, bidi)
    _assert_trees_equal(got, jit.convert_rnn(rnn.state_dict(), "", 2, cell,
                                             bidi))
    port = MaskedRNN(6, 8, 2, cell, bidi)
    load_flax_variables(port, {"params": got})
    x = torch.randn(3, 5, 6, generator=g)
    with torch.no_grad():
        want, _ = rnn(x)
        have, _ = port(x)
    assert float((have - want).abs().max()) <= 1e-5


# ------------------------------------------------- trees against JAX's

@pytest.fixture(scope="module")
def deeplio():
    """The kitti-tpu DeepLIO: the port model, a reference state dict for
    it, and JAX's model with its tree's shapes."""
    d = _kitti_dict()
    port = build_model(port_config(d), device="cpu", seed=0)
    jcfg = jax_config(d)
    jmodel = jax_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0),
         "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, 2), train=False))
    return port, reference_state_dict(port, seed=2), jmodel, shapes


def _both(sd, template, shapes, **kw):
    got = tit.import_state_dict(sd, template["params"],
                                template.get("batch_stats"), **kw)
    want = jit.import_state_dict(sd, shapes["params"],
                                 shapes.get("batch_stats"), **kw)
    return got, want


def test_deeplio_trees_equal_jax(deeplio):
    port, sd, _, shapes = deeplio
    (gp, gs), (wp, ws) = _both(sd, to_flax_variables(port), shapes)
    _assert_trees_equal(gp, wp)
    _assert_trees_equal(gs, ws)
    assert "MaskedRNN_0" in gp["imu_feat"] and gs


def test_segmentation_net_trees_equal_jax():
    port = PointSegNet(2 * C, part="encoder+decoder", num_classes=7,
                       h_stride=2, w_stride=4, el_squeeze=16)
    net = jps.PointSegNet(part="encoder+decoder", num_classes=7, h_stride=2,
                          w_stride=4, el_squeeze=16, pool="stride")
    shapes = jax.eval_shape(lambda: net.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 2 * C)), train=False))
    sd = reference_state_dict(port, seed=3)
    (gp, gs), (wp, ws) = _both(sd, to_flax_variables(port), shapes)
    _assert_trees_equal(gp, wp)
    _assert_trees_equal(gs, ws)
    # and the port module loads it: its transposed convs hold the torch
    # weights unflipped again
    tit.import_into(port, sd)
    for k, v in sd.items():
        assert torch.equal(port.state_dict()[k], v), k


def _strict_cases(sd):
    key = "lidar_feat.Dense_0.weight"
    extra = dict(sd, **{"lidar_feat.extra.weight": torch.zeros(3)})
    missing = {k: v for k, v in sd.items() if k != key}
    wrong = dict(sd, **{key: sd[key][:, :-1]})
    return {"unconsumed torch key": extra, "missing": missing,
            "shape mismatch": wrong}


@pytest.mark.parametrize("what", ["unconsumed torch key", "missing",
                                  "shape mismatch"])
def test_strict_errors_as_jax(deeplio, what):
    port, sd, _, shapes = deeplio
    bad = _strict_cases(sd)[what]
    tmpl = to_flax_variables(port)
    with pytest.raises(ValueError, match=what):
        tit.import_state_dict(bad, tmpl["params"], tmpl["batch_stats"])
    with pytest.raises(ValueError, match=what):
        jit.import_state_dict(bad, shapes["params"], shapes["batch_stats"])
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with pytest.raises(ValueError):
        tit.import_into(port, bad)
    assert all(torch.equal(before[k], v) for k, v in
               port.state_dict().items())


@pytest.mark.parametrize("cell,bidi", [("gru", False), ("lstm", True)])
def test_gru_and_bidirectional_state_dicts_raise_naming_item_5(cell, bidi):
    """Once refused, now imported: a reference whose IMU RNN is a GRU or
    a bidirectional LSTM (and, with the GRU, its odometry RNN a GRU too),
    into a DeepIO built with those nets: the port's trees, walked from
    its own model's tree, equal JAX's, walked from JAX's, bit for bit;
    the imported model holds the state dict's tensors."""
    d = _kitti_dict()
    d["arch"] = "deepio"
    d["deepio"] = {"imu-feat-net": {"name": "imu-feat-rnn"},
                   "odom-feat-net": {"name": "odom-feat-rnn"}}
    d["imu-feat-rnn"].update({"type": cell, "bidirectional": bidi})
    d["odom-feat-rnn"]["type"] = cell
    port = build_model(port_config(d), device="cpu", seed=0)
    jcfg = jax_config(d)
    shapes = jax.eval_shape(lambda: jax_build_model(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, 2), train=False))
    sd = reference_state_dict(port, seed=6)
    assert ("imu_feat.MaskedRNN_0.weight_ih_l0_reverse" in sd) == bidi
    (gp, _), (wp, _) = _both(sd, to_flax_variables(port), shapes)
    _assert_trees_equal(gp, wp)
    tit.import_into(port, sd)
    rnn = port.imu_feat.MaskedRNN_0
    want = sd["imu_feat.MaskedRNN_0.weight_hh_l1"].numpy().T
    np.testing.assert_array_equal(rnn.l1_fwd.w_hh.detach().numpy(), want)
    if bidi:
        want = sd["imu_feat.MaskedRNN_0.weight_ih_l1_reverse"].numpy().T
        np.testing.assert_array_equal(rnn.l1_bwd.w_ih.detach().numpy(),
                                      want)


@pytest.mark.parametrize("wrap", [None, "state_dict", "model",
                                  "model_state_dict"])
def test_checkpoint_file_wrappings(tmp_path, wrap):
    port = PointSegNet(2 * C, h_stride=2, w_stride=4, el_squeeze=16)
    sd = reference_state_dict(port, seed=4)
    path = tmp_path / "ref.pt"
    torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
    tit.load_reference_checkpoint(str(path), port)
    assert all(torch.equal(port.state_dict()[k], v) for k, v in sd.items())


def test_deeplio_forward_imported_through_both(deeplio):
    """The reference state dict through each package's importer into its
    own DeepLIO; both forwards on one batch (eval mode, float32)."""
    port, sd, jmodel, shapes = deeplio
    tit.import_into(port, sd)
    params, stats = jit.import_state_dict(sd, shapes["params"],
                                          shapes["batch_stats"])
    rng = np.random.default_rng(6)
    mask = np.ones((2, 2, 16), np.float32)
    mask[0, 1, 9:] = 0
    batch = {"images": rng.normal(size=(2, 2, H, W, 2 * C)).astype(
        np.float32),
        "imu": rng.normal(size=(2, 2, 16, 6)).astype(np.float32),
        "imu_mask": mask}
    x, q = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        {"params": params, "batch_stats": stats},
        {k: jnp.asarray(a) for k, a in batch.items()})
    with torch.no_grad():
        tx, tq = port.eval()({k: torch.from_numpy(a)
                              for k, a in batch.items()})
    for got, want in ((tx, x), (tq, q)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        assert np.abs(got.numpy() - want).max() <= MODEL_TOL * scale
