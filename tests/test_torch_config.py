"""The port's config reads the JAX package's YAML keys, and refuses the
settings it cannot compute yet, naming the slice that adds them; the
settings it has since learned parse as the JAX package parses them."""

import copy
import dataclasses
import pathlib

import pytest
import yaml

pytest.importorskip("torch")

from deeplio_tpu.config import load_config as jax_load  # noqa: E402
from deeplio_tpu.config import load_config_dict as jax_load_dict  # noqa: E402
from deeplio_tpu_torch.config import (  # noqa: E402
    ConfigError,
    load_config,
    load_config_dict,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KITTI_TPU = ROOT / "configs" / "deeplio_kitti_tpu.yaml"


@pytest.fixture(scope="module")
def kitti():
    with open(KITTI_TPU) as f:
        return yaml.safe_load(f)


def test_kitti_tpu_config_matches_jax_parse():
    port, ref = load_config(KITTI_TPU), jax_load(str(KITTI_TPU))
    pp, rp = port.datasets.projection, ref.datasets.projection
    for f in ("height", "width", "fov_up_deg", "fov_down_deg", "max_points",
              "packed", "backend", "kernel_spb", "kernel_packed",
              "kernel_aligned"):
        assert getattr(pp, f) == getattr(rp, f), f
    for f in ("channels", "mean", "std", "max_imu_per_pair"):
        assert getattr(port.datasets, f) == getattr(ref.datasets, f), f
    pm, rm = port.model, ref.model
    assert (pm.arch, pm.compute_dtype, pm.fusion.kind) == (
        rm.arch, rm.compute_dtype, rm.fusion.kind)
    for f in ("feature_size", "h_stride", "w_stride", "se", "el_squeeze",
              "stem", "fire", "pool", "part"):
        assert getattr(pm.lidar, f) == getattr(rm.lidar, f), f
    for f in ("hidden_size", "num_layers", "rnn_type"):
        assert getattr(pm.imu, f) == getattr(rm.imu, f), f
        assert getattr(pm.odom, f) == getattr(rm.odom, f), f


def _set(d, path, value):
    node = d
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _ported_parse_matches_jax(d, path, value):
    """A setting the port computes: it parses, and to the JAX package's
    values for the block it sets."""
    port, ref = load_config_dict(d), jax_load_dict(d)
    if path[0] == "datasets":
        assert port.datasets.projection.backend == \
            ref.datasets.projection.backend
        for f in ("channels", "mean", "std", "num_image_channels"):
            assert getattr(port.datasets, f) == getattr(ref.datasets, f), f
    elif path[0] == "lidar-feat-pointseg":
        for f in ("part", "bypass", "stem", "fire", "pool"):
            assert getattr(port.model.lidar, f) == \
                getattr(ref.model.lidar, f), f
    else:
        for block in ("imu", "odom"):
            p, r = getattr(port.model, block), getattr(ref.model, block)
            for f in ("name", "rnn_type", "hidden_size", "num_layers"):
                assert getattr(p, f) == getattr(r, f), (block, f)
        assert port.model.imu.bidirectional == ref.model.imu.bidirectional
    return port


# each case: the setting, and whether the port computes it (ported, held
# against JAX's parse) or still refuses it naming the slice that adds it
@pytest.mark.parametrize("path,value,ported", [
    (("lidar-feat-pointseg", "stem"), "s2d", True),
    (("lidar-feat-pointseg", "stem"), "s2d-pre", True),
    (("lidar-feat-pointseg", "fire"), "fused", True),
    (("lidar-feat-pointseg", "part"), "encoder+decoder", True),
    (("imu-feat-rnn", "type"), "gru", True),
    (("odom-feat-rnn", "type"), "gru", True),
    (("imu-feat-rnn", "bidirectional"), True, True),
    (("datasets", "channels"), ["x", "y", "z", "depth", "normals"], True),
    (("lidar-feat-pointseg", "fire"), "mixed", True),
    (("datasets", "backend"), "ring", True),
    (("datasets", "backend"), "sort-sentinel", True),
    (("deeplio", "imu-feat-net"), {"name": "imu-feat-fc"}, True),
    (("deeplio", "odom-feat-net"), {"name": "odom-feat-fc"}, True),
])
def test_unsupported_setting_raises(kitti, path, value, ported):
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    if not ported:
        with pytest.raises(ValueError, match="slice"):
            load_config_dict(d)
        return
    if path[-1] == "channels":     # normals are three channels: 7 in all
        d["datasets"]["mean"] = [0.0, 0.0, -1.0, 12.0, 0.0, 0.0, 0.0]
        d["datasets"]["std"] = [12.0, 12.0, 1.5, 12.0, 1.0, 1.0, 1.0]
    port = _ported_parse_matches_jax(d, path, value)
    got = {"channels": port.datasets.channels,
           "backend": port.datasets.projection.backend,
           "part": getattr(port.model.lidar, "part", None),
           "stem": getattr(port.model.lidar, "stem", None),
           "fire": getattr(port.model.lidar, "fire", None),
           "bidirectional": port.model.imu.bidirectional,
           "imu-feat-net": {"name": port.model.imu.name},
           "odom-feat-net": {"name": port.model.odom.name}}.get(path[-1])
    if path[-1] == "type":
        got = getattr(port.model, path[0].split("-")[0]).rnn_type
    assert got == (tuple(value) if isinstance(value, list) else value)


@pytest.mark.parametrize("path,value", [
    (("datasets", "kernel-packed"), "sideways"),
    (("datasets", "mean"), [0.0, 1.0]),
    (("datasets", "std"), [1.0, 1.0, 0.0, 1.0, 1.0]),
    (("fusion-net",), None),
])
def test_invalid_setting_raises(kitti, path, value):
    d = copy.deepcopy(kitti)
    if path == ("fusion-net",):
        del d["deeplio"]["fusion-net"]
    else:
        _set(d, path, value)
    with pytest.raises(ConfigError):
        load_config_dict(d)


@pytest.mark.parametrize("key,value", [("kernel-spb", 4),
                                       ("kernel-packed", "off"),
                                       ("packed", False)])
def test_schedule_only_keys_are_accepted(kitti, key, value):
    """kernel-spb / kernel-packed pick the TPU kernel's schedule only (its
    results are bit-identical), and the ring route is always packed: the
    port parses them and computes the same thing."""
    d = copy.deepcopy(kitti)
    d["datasets"][key] = value
    cfg = load_config_dict(d)
    assert getattr(cfg.datasets.projection, key.replace("-", "_")) == value


def test_training_blocks_match_jax_parse(kitti):
    """The slice configuration (pallas backend, yaw augmentation) and the
    loss, optimizer and train fields the training step reads."""
    from deeplio_tpu.config import load_config_dict as jax_load_dict
    d = copy.deepcopy(kitti)
    d["datasets"].update({"backend": "pallas", "augment-yaw": True,
                          "combinations": [[0, 1], [0, 8]]})
    d["lidar-feat-pointseg"]["dropout"] = 0.1
    d["optimizer"]["scheduler"]["warmup-steps"] = 7
    port, ref = load_config_dict(d), jax_load_dict(d)
    assert port.datasets.projection.backend == "pallas"
    for f in ("sequence_size", "combinations", "window_stride", "augment_yaw",
              "effective_combinations", "num_pairs"):
        assert getattr(port.datasets, f) == getattr(ref.datasets, f), f
    assert port.model.dropout == ref.model.dropout == 0.25
    assert port.model.lidar.dropout == ref.model.lidar.dropout == 0.1
    for f in ("active", "x_norm", "q_norm", "beta", "sx", "sq"):
        assert getattr(port.loss, f) == getattr(ref.loss, f), f
    for f in ("name", "lr", "scheduler", "step_size", "gamma",
              "warmup_steps", "grad_clip"):
        assert getattr(port.optim, f) == getattr(ref.optim, f), f
    for f in ("batch_size", "seed"):
        assert getattr(port.train, f) == getattr(ref.train, f), f


# where each setting lands in the parsed config, the same in both
_FIELDS = {("optimizer", "name"): ("optim", "name"),
           ("optimizer", "weight-decay"): ("optim", "weight_decay"),
           ("optimizer", "momentum"): ("optim", "momentum"),
           ("lidar-feat-pointseg", "stem"): ("model", "lidar", "stem"),
           ("lidar-feat-pointseg", "fire"): ("model", "lidar", "fire"),
           ("param-dtype",): ("model", "param_dtype"),
           ("train", "data-parallel"): ("train", "data_parallel")}


def _field(cfg, path):
    for name in _FIELDS[path]:
        cfg = getattr(cfg, name)
    return cfg


@pytest.mark.parametrize("path,value,ported", [
    (("optimizer", "name"), "sgd", True),
    (("optimizer", "weight-decay"), 0.1, True),
    (("lidar-feat-pointseg", "stem"), "factorized", True),
    (("param-dtype",), "bfloat16", True),
    (("train", "data-parallel"), 2, True),
    (("datasets", "backend"), "sort-sentinel", True),
    (("lidar-feat-pointseg", "fire"), "mixed", True),
    (("train", "data-parallel"), 4, True),
    (("datasets", "backend"), "ring", True),
])
def test_untrained_settings_raise_naming_their_queue(kitti, path, value,
                                                    ported):
    """The settings this test refused before they were ported (``ported``
    says so of every one now) parse as JAX parses them: the backends with
    and without ``packed``, the optimizer, stem, Fire, ``param-dtype`` and
    ``data-parallel`` (2 and 4: the processes of a run) to JAX's values
    (and SGD's momentum to JAX's default 0.9)."""
    assert ported
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    if path[0] != "datasets":
        port, ref = load_config_dict(d), jax_load_dict(d)
        assert _field(port, path) == _field(ref, path) == value
        for f in ("name", "lr", "weight_decay", "momentum"):
            assert getattr(port.optim, f) == getattr(ref.optim, f), f
        assert port.optim.momentum == 0.9
        return
    for packed in (True, False):
        d["datasets"]["packed"] = packed
        port = _ported_parse_matches_jax(d, path, value)
        assert (port.datasets.projection.backend,
                port.datasets.projection.packed) == (value, packed)


@pytest.mark.parametrize("path,value", [
    (("lidar-feat-pointseg", "pool"), "stride-fold"),
    (("lidar-feat-pointseg", "stem"), "pair-split"),
    (("datasets", "kernel-aligned"), "auto"),
    (("datasets", "kernel-aligned"), "on"),
    (("datasets", "kernel-aligned"), "trust"),
    (("datasets", "kernel-aligned"), "halves"),
    (("datasets", "slot-bin"), True),
])
def test_ported_settings_match_jax_parse(kitti, path, value):
    """The settings the flagship slice ported parse as the JAX package
    parses them (``trust`` and ``halves`` with the slot binning that their
    gate asks for on KITTI drives)."""
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    if value in ("trust", "halves"):
        d["datasets"]["slot-bin"] = True
    port, ref = load_config_dict(d), jax_load_dict(d)
    assert port.datasets.slot_bin == ref.datasets.slot_bin
    assert (port.datasets.projection.kernel_aligned
            == ref.datasets.projection.kernel_aligned)
    for f in ("stem", "pool", "part"):
        assert getattr(port.model.lidar, f) == getattr(ref.model.lidar, f)
    got = (port.datasets if path[0] == "datasets" else port.model.lidar)
    field = path[-1].replace("-", "_")
    got = getattr(got.projection if field == "kernel_aligned" else got,
                  field)
    assert got == value


def test_loop_keys_match_jax_parse(kitti):
    """The keys the training loop reads (the plateau schedule, flat-update,
    the train block's cadence and checkpoints, the synthetic drives and the
    warm starts) parse to the JAX package's values."""
    from deeplio_tpu.config import load_config_dict as jax_load_dict
    d = copy.deepcopy(kitti)
    d["optimizer"].update({"flat-update": True, "scheduler": {
        "name": "plateau", "gamma": 0.3, "patience": 5, "min-lr": 1e-6,
        "threshold": 0.01}})
    d["train"].update({"epochs": 7, "log-every": 3, "eval-every-epochs": 2,
                       "checkpoint-dir": "ck", "checkpoint-every-steps": 11,
                       "keep-checkpoints": 4, "prefetch": 3,
                       "steps-per-call": 4, "seed": 9, "data-parallel": 1})
    d["datasets"].update({"synthetic": True, "synthetic-frames": 25,
                          "synthetic-eval-frames": 9,
                          "synthetic-train-drives": 16,
                          "synthetic-eval-drives": 3,
                          "synthetic-world": "origin"})
    d["deeplio"].update({"pretrained": True, "model-path": "/m"})
    d["lidar-feat-pointseg"].update({"pretrained": True, "model-path": "/s"})
    port, ref = load_config_dict(d), jax_load_dict(d)
    for f in ("scheduler", "gamma", "patience", "min_lr", "threshold",
              "flat_update"):
        assert getattr(port.optim, f) == getattr(ref.optim, f), f
    for f in ("epochs", "log_every", "eval_every_epochs", "checkpoint_dir",
              "checkpoint_every_steps", "keep_checkpoints", "prefetch",
              "steps_per_call", "seed", "batch_size"):
        assert getattr(port.train, f) == getattr(ref.train, f), f
    for f in ("synthetic", "synthetic_frames", "synthetic_eval_frames",
              "synthetic_train_drives", "synthetic_eval_drives",
              "synthetic_world"):
        assert getattr(port.datasets, f) == getattr(ref.datasets, f), f
    for f in ("pretrained", "model_path"):
        assert getattr(port.model, f) == getattr(ref.model, f), f
        assert getattr(port.model.lidar, f) == getattr(ref.model.lidar, f), f
    # and the defaults
    port, ref = load_config(KITTI_TPU), jax_load(str(KITTI_TPU))
    for block in ("optim", "train"):
        for f in (f.name for f in dataclasses.fields(getattr(port, block))):
            assert getattr(getattr(port, block), f) == \
                getattr(getattr(ref, block), f), (block, f)


def test_plateau_with_warmup_raises(kitti):
    d = copy.deepcopy(kitti)
    d["optimizer"]["scheduler"] = {"name": "plateau", "warmup-steps": 10}
    with pytest.raises(ConfigError, match="warmup"):
        load_config_dict(d)


def test_kitti_splits_raise_naming_item_3(kitti):
    """Without ``synthetic`` the splits name KITTI drives under
    ``root-path``, which the KITTI data slice (Queue 1 item 3) reads: with
    no devkit tree there, building a split raises FileNotFoundError, as in
    the JAX package, and so does a Trainer."""
    from deeplio_tpu.data.dataset import build_drives as jax_build_drives
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.train import Trainer
    d = copy.deepcopy(kitti)
    d["datasets"]["kitti"]["root-path"] = str(ROOT / "no-kitti-tree-here")
    cfg, ref = load_config_dict(d), jax_load_dict(d)
    for split in ("train", "validation", "test"):
        with pytest.raises(FileNotFoundError):
            jax_build_drives(ref, split)
        with pytest.raises(FileNotFoundError, match="no-kitti-tree-here"):
            build_drives(cfg, split)
    with pytest.raises(FileNotFoundError):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("path,value", [
    *((("lidar-feat-pointseg", "stem"), v) for v in
      ("classic", "pair-split", "s2d", "s2d-pre", "factorized")),
    *((("lidar-feat-pointseg", "fire"), v) for v in
      ("classic", "fused", "mixed")),
    (("optimizer", "name"), "adam"), (("optimizer", "name"), "sgd"),
    (("optimizer", "momentum"), 0.0), (("optimizer", "weight-decay"), 0.01),
    *((("param-dtype",), v) for v in ("float32", "bfloat16", "float16")),
])
def test_every_variant_value_parses_as_jax(kitti, path, value):
    """Every stem, Fire, optimizer and ``param-dtype`` value the JAX
    package parses loads in the port, to JAX's value."""
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    port, ref = load_config_dict(d), jax_load_dict(d)
    assert _field(port, path) == _field(ref, path) == value


def test_param_dtype_is_parsed_and_never_read(kitti):
    """A kept quirk of the reference: JAX passes ``param-dtype`` to no
    module, so its parameters stay float32 whatever the file says; the
    port's do too (ROADMAP Queue 3)."""
    import jax
    import numpy as np
    import torch

    from deeplio_tpu.models import build_model as jax_build_model
    from deeplio_tpu.models.zoo import example_batch
    from deeplio_tpu_torch.models.zoo import build_model

    d = copy.deepcopy(kitti)
    d["param-dtype"] = "bfloat16"
    d["datasets"].update({"image-height": 8, "image-width": 64,
                          "max-points": 512})
    port_cfg, ref_cfg = load_config_dict(d), jax_load_dict(d)
    assert port_cfg.model.param_dtype == ref_cfg.model.param_dtype == \
        "bfloat16"
    net = jax_build_model(ref_cfg)
    shapes = jax.eval_shape(lambda: net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        example_batch(ref_cfg, 1), train=False))
    assert {np.dtype(a.dtype) for a in jax.tree_util.tree_leaves(
        shapes)} == {np.dtype(np.float32)}
    model = build_model(port_cfg, device="cpu", seed=0)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
