"""The port imports nothing of JAX or of the JAX package, and its entry
points run on CUDA unless asked for the CPU."""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config, load_config_dict  # noqa: E402
from deeplio_tpu_torch.data.pipeline import DevicePrefetcher  # noqa: E402
from deeplio_tpu_torch.device import resolve_device  # noqa: E402
from deeplio_tpu_torch.cli import train as train_cli  # noqa: E402
from deeplio_tpu_torch.eval.export import export_streaming  # noqa: E402
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402
from deeplio_tpu_torch.train.step import batch_to_device  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deeplio_tpu")
PORT_FILES = sorted((ROOT / "deeplio_tpu_torch").rglob("*.py"))


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
            elif node.level:
                yield "<relative>"


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_forbidden_matcher():
    assert _forbidden("jax.numpy") and _forbidden("deeplio_tpu.ops")
    assert _forbidden("flax") and _forbidden("deeplio_tpu")
    assert not _forbidden("deeplio_tpu_torch.ops.projection")
    assert not _forbidden("jaxtyping_like") and not _forbidden("numpy")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if _forbidden(n) or n == "<relative>"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_its_modules():
    mods = {p.relative_to(ROOT / "deeplio_tpu_torch").as_posix()
            for p in PORT_FILES if "deeplio_tpu_torch" in p.parts}
    for want in ("device.py", "config/schema.py", "config/loader.py",
                 "utils/spatial.py", "ops/projection.py",
                 "ops/projection_ring.py", "ops/_kernels.py", "ops/rnn.py",
                 "models/blocks.py", "models/pointseg.py",
                 "models/feat_nets.py", "models/zoo.py",
                 "models/from_flax.py", "data/synthetic.py",
                 "data/np_spatial.py", "data/drives.py",
                 "eval/streaming.py", "ops/projection_scatter.py",
                 "ops/augment.py", "losses/pose.py", "data/dataset.py",
                 "train/optim.py", "train/state.py", "train/step.py",
                 "train/loop.py", "train/checkpoint.py", "data/pipeline.py",
                 "utils/meters.py", "utils/logger.py",
                 "data/proj_cache.py", "data/device_bank.py",
                 "bench/kitti_tree.py", "eval/metrics.py",
                 "eval/trajectory.py", "eval/plot.py", "eval/runner.py",
                 "eval/export.py", "utils/timing.py", "cli/train.py",
                 "cli/test.py", "cli/stream.py", "cli/export.py",
                 "native/__init__.py", "bench/flagship.py"):
        assert want in mods, want
    for src in ("csrc/ring_project.cu", "csrc/proj_scatter.cu",
                "native/slot_bin_core.cpp", "native/slot_bin_trig.cpp"):
        assert (ROOT / "deeplio_tpu_torch" / src).exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    """With no device argument and no GPU the entry points raise, not fall
    back to the CPU."""
    cfg = load_config(ROOT / "configs" / "deeplio_kitti_tpu.yaml")
    with pytest.raises(RuntimeError):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError):
        StreamingOdometry(cfg, model)
    StreamingOdometry(cfg, model, device="cpu")
    host = {"x_gt": np.zeros((1, 1, 3), np.float32)}
    with pytest.raises(RuntimeError):
        batch_to_device(host)
    assert batch_to_device(host, "cpu")["x_gt"].device.type == "cpu"
    with pytest.raises(RuntimeError):
        DevicePrefetcher(iter([host]))
    assert next(DevicePrefetcher(iter([host]), "cpu"))["x_gt"].device.type \
        == "cpu"
    import yaml
    with open(ROOT / "configs" / "deeplio_kitti_tpu.yaml") as f:
        d = yaml.safe_load(f)
    d["datasets"].update({"synthetic": True, "synthetic-frames": 3,
                          "max-points": 64, "sequence-size": 2})
    synth = load_config_dict(d)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(synth, workdir=str(tmp_path))
    assert not any(tmp_path.iterdir())        # raised before any output
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_streaming(cfg, model, str(tmp_path / "art"), chunk=1)
    assert not any(tmp_path.iterdir())
    cfg_path = tmp_path.parent / f"{tmp_path.name}.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(d, f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["-c", str(cfg_path), "--workdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
