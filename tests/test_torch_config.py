"""The port's config reads the JAX package's YAML keys, and refuses the
settings this slice cannot compute, naming the slice that adds them."""

import copy
import pathlib

import pytest
import yaml

pytest.importorskip("torch")

from deeplio_tpu.config import load_config as jax_load  # noqa: E402
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


@pytest.mark.parametrize("path,value", [
    (("lidar-feat-pointseg", "pool"), "classic"),
    (("lidar-feat-pointseg", "stem"), "pair-split"),
    (("lidar-feat-pointseg", "fire"), "fused"),
    (("lidar-feat-pointseg", "part"), "encoder+decoder"),
    (("imu-feat-rnn", "type"), "gru"),
    (("odom-feat-rnn", "type"), "gru"),
    (("imu-feat-rnn", "bidirectional"), True),
    (("datasets", "channels"), ["x", "y", "z", "depth", "normals"]),
    (("datasets", "kernel-aligned"), "halves"),
    (("datasets", "backend"), "sort"),
    (("datasets", "slot-bin"), True),
    (("arch",), "deepio"),
    (("deeplio", "lidar-feat-net"), {"name": "lidar-feat-simple-0"}),
])
def test_unsupported_setting_raises(kitti, path, value):
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    with pytest.raises(ValueError, match="slice"):
        load_config_dict(d)


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


@pytest.mark.parametrize("path,value", [
    (("optimizer", "name"), "sgd"),
    (("optimizer", "weight-decay"), 0.1),
    (("optimizer", "scheduler"), {"name": "plateau"}),
    (("optimizer", "flat-update"), True),
    (("train", "steps-per-call"), 4),
    (("train", "cache-projections"), True),
    (("train", "device-dataset"), True),
    (("train", "data-parallel"), 4),
    (("deeplio", "pretrained"), True),
])
def test_untrained_settings_raise_naming_their_queue(kitti, path, value):
    d = copy.deepcopy(kitti)
    _set(d, path, value)
    with pytest.raises(ConfigError, match=r"PyTorch port yet; .*Queue 1"):
        load_config_dict(d)
