"""The reference-checkpoint importer on the stems and Fires of the model
variants, against the JAX package, on the CPU.

* ``import_reference_checkpoint`` on a file the test writes bare and
  under each of the three wrappings (``state_dict``, ``model``,
  ``model_state_dict``): the port's trees equal JAX's bit for bit;
* a classic reference ``state_dict`` onto a ``factorized`` config,
  imported onto the classic tree and passed through
  ``factorize_stem_variables`` on both sides: the trees equal bit for bit,
  and both factorized models on one batch of frames within 1e-4 of the
  output's largest magnitude (``tests/test_torch_models.py``'s tolerance);
* ``fire: fused`` raises under strict import on both sides: the fused
  Fire's parameters are not the reference Fire's.
"""

import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deeplio_tpu.config import load_config_dict as jax_config
from deeplio_tpu.models import build_model as jax_build_model
from deeplio_tpu.models import example_batch
from deeplio_tpu.models import factorize_stem_variables as jax_factorize
from deeplio_tpu.models import import_torch as jit
from deeplio_tpu_torch.config import load_config_dict as port_config
from deeplio_tpu_torch.models import import_torch as tit
from deeplio_tpu_torch.models.from_flax import (
    load_flax_variables,
    to_flax_variables,
)
from deeplio_tpu_torch.models.zoo import build_model, factorize_stem_variables
from tests.test_torch_import_torch import (
    _assert_trees_equal,
    reference_state_dict,
)

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
MODEL_TOL = 1e-4
H, W = 16, 128


def _dict(**lidar):
    """``configs/deeplio_kitti_tpu.yaml`` cut to 16x128, windows of 3,
    narrow nets, float32."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": 2048, "sequence-size": 3})
    d["lidar-feat-pointseg"].update({"feature-size": 16, "el-squeeze": 16,
                                     **lidar})
    d["imu-feat-rnn"]["hidden-size"] = 12
    d["odom-feat-rnn"]["hidden-size"] = 16
    return d


def _shapes(jcfg):
    return jax.eval_shape(lambda: jax_build_model(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(jcfg, 2), train=False))


@pytest.fixture(scope="module")
def classic():
    d = _dict()
    port = build_model(port_config(d), device="cpu", seed=0)
    return d, port, reference_state_dict(port, seed=8), \
        _shapes(jax_config(d))


@pytest.mark.parametrize("wrap", [None, "state_dict", "model",
                                  "model_state_dict"])
def test_import_reference_checkpoint_matches_jax(tmp_path, classic, wrap):
    _, port, sd, shapes = classic
    path = tmp_path / "ref.pt"
    torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
    tmpl = to_flax_variables(port)
    gp, gs = tit.import_reference_checkpoint(
        str(path), tmpl["params"], tmpl["batch_stats"])
    wp, ws = jit.import_reference_checkpoint(
        str(path), shapes["params"], shapes["batch_stats"])
    _assert_trees_equal(gp, wp)
    _assert_trees_equal(gs, ws)


def test_classic_state_dict_onto_factorized_matches_jax(classic):
    d, port, sd, shapes = classic
    c = port_config(d).datasets.num_image_channels
    tmpl = to_flax_variables(port)
    gp, gs = tit.import_state_dict(sd, tmpl["params"], tmpl["batch_stats"])
    got = factorize_stem_variables({"params": gp, "batch_stats": gs}, c)
    wp, ws = jit.import_state_dict(sd, shapes["params"],
                                   shapes["batch_stats"])
    want = jax_factorize({"params": wp, "batch_stats": ws}, c)
    _assert_trees_equal(got, want)

    fd = _dict(stem="factorized")
    fcfg, jfcfg = port_config(fd), jax_config(fd)
    fport = build_model(fcfg, device="cpu", seed=None)
    load_flax_variables(fport, got)
    rng = np.random.default_rng(3)
    p = fcfg.datasets.num_pairs
    mask = np.ones((2, p, 16), np.float32)
    mask[1, 0, 5:] = 0
    batch = {"frames": rng.normal(size=(2, 3, H, W, c)).astype(np.float32),
             "imu": rng.normal(size=(2, p, 16, 6)).astype(np.float32),
             "imu_mask": mask}
    x, q = jax.jit(lambda v, b: jax_build_model(jfcfg).apply(
        v, b, train=False))(jax.tree.map(jnp.asarray, want),
                            {k: jnp.asarray(a) for k, a in batch.items()})
    with torch.no_grad():
        tx, tq = fport({k: torch.from_numpy(a) for k, a in batch.items()})
    for a, b in ((tx, x), (tq, q)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-6)
        assert np.abs(a.numpy() - b).max() <= MODEL_TOL * scale


@pytest.mark.parametrize("fire", ["fused", "mixed"])
def test_fused_fire_refuses_a_reference_state_dict(classic, fire):
    """The reference's Fire (squeeze and two expands) has no home in a
    fused Fire's one 3x3 ConvBN: strict import raises on both sides, and
    the port model is left as it was."""
    _, _, sd, _ = classic
    d = _dict(fire=fire)
    port = build_model(port_config(d), device="cpu", seed=1)
    shapes = _shapes(jax_config(d))
    tmpl = to_flax_variables(port)
    with pytest.raises(ValueError, match="torch import mismatch"):
        tit.import_state_dict(sd, tmpl["params"], tmpl["batch_stats"])
    with pytest.raises(ValueError, match="torch import mismatch"):
        jit.import_state_dict(sd, shapes["params"], shapes["batch_stats"])
    before = copy.deepcopy(port.state_dict())
    with pytest.raises(ValueError):
        tit.import_into(port, sd)
    assert all(torch.equal(before[k], v) for k, v in
               port.state_dict().items())
