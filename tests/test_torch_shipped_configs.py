"""Every file under ``configs/`` loads in the port as shipped, with the
JAX loader's values in every field both configs have, and each arch
trains through ``Trainer.fit`` on the CPU; every file under
``configs/torch/`` loads in the port and trains the same way.

``configs/torch/`` holds the port-only configurations: those naming what
only the port has (``lidar-feat-darknet``), which the JAX loader refuses.
They live apart so that ``configs/*.yaml`` stays the set both packages
load, held field by field against JAX's loader here.

The fits take the shipped files with only the image (16x64), the scan
capacity (1024 points) and the data cut (synthetic drives of a few
frames, batches of 2, ``synthetic: true`` for the KITTI file, float32),
so the model widths are the files' own: two steps, finite losses, one
projection a step for the LiDAR archs and none for DeepIO.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu.config import load_config as jax_load  # noqa: E402
from deeplio_tpu_torch.config import load_config, load_config_dict  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402

CONFIGS = sorted((pathlib.Path(__file__).resolve().parents[1]
                  / "configs").glob("*.yaml"))
PORT_ONLY = sorted((CONFIGS[0].parent / "torch").glob("*.yaml"))


def _same_fields(port, ref, where):
    """Every dataclass field of ``port`` that ``ref`` also has, equal;
    nested configs compared field by field. Returns the names compared."""
    seen = []
    for f in dataclasses.fields(port):
        if not hasattr(ref, f.name):
            continue
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.is_dataclass(b), (where, f.name)
            seen += _same_fields(a, b, f"{where}.{f.name}")
        elif a is None or b is None:
            assert a is None and b is None, (where, f.name)
        else:
            assert a == b, (where, f.name, a, b)
        seen.append(f"{where}.{f.name}")
    return seen


def test_every_shipped_config_is_there():
    assert [p.name for p in CONFIGS] == [
        "deepio_synth.yaml", "deeplio_kitti.yaml", "deeplio_kitti_tpu.yaml",
        "deeplio_synth.yaml", "deeplio_synth_gen.yaml",
        "deeplio_synth_gen2.yaml", "deeplio_synth_gen2_packed.yaml",
        "deeplo_synth.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_shipped_config_loads_as_jax_does(path):
    port, ref = load_config(path), jax_load(str(path))
    seen = _same_fields(port, ref, "cfg")
    for must in ("cfg.model.arch", "cfg.datasets.projection.backend",
                 "cfg.datasets.projection.chunk", "cfg.datasets.projection"
                 ".packed", "cfg.datasets.synthetic_world",
                 "cfg.optim.scheduler", "cfg.train.batch_size"):
        assert must in seen
    if port.model.lidar is not None:
        assert "cfg.model.lidar.pool" in seen
        assert "cfg.model.lidar.base_channels" in seen


def _fit_dict(name):
    with open(pathlib.Path(CONFIGS[0]).parent / name) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({
        "image-height": 16, "image-width": 64, "max-points": 1024,
        "synthetic": True, "synthetic-frames": 6, "synthetic-eval-frames": 5,
        "synthetic-train-drives": 1, "synthetic-eval-drives": 1})
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 0})
    return d


@pytest.mark.parametrize("name,launches", [
    ("deepio_synth.yaml", 0), ("deeplo_synth.yaml", 1),
    ("deeplio_kitti.yaml", 1)])
def test_two_step_fit_per_arch(name, launches, tmp_path, monkeypatch):
    """Two training steps and the validation of the file's own model
    through ``Trainer.fit``; the projections the steps make."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    calls = []
    for mod, attr in ((tsc, "scatter_select"), (tring, "ring_select")):
        real = getattr(mod, attr)

        def spy(*a, _real=real, _attr=attr):
            calls.append((_attr, tuple(a[0].shape)))
            return _real(*a)
        monkeypatch.setattr(mod, attr, spy)
    cfg = load_config_dict(_fit_dict(name))
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    try:
        assert trainer.train_ds.with_points == (launches > 0)
        state = trainer.fit(epochs=1)
        val_batches = len(trainer.val_ds) // 2
        val = trainer.validate()
    finally:
        trainer.close()
    assert state.step == 2 and val_batches >= 1
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["split"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert np.isfinite(val["loss"])
    # one selection a train step and a validation batch (the epoch's
    # validation and the one above), all the window's frames at once
    S = cfg.datasets.sequence_size
    assert calls == [("scatter_select", (2 * S, 1024))] * (
        launches * (2 + 2 * val_batches))


@pytest.mark.parametrize("path", PORT_ONLY, ids=[p.stem for p in PORT_ONLY])
def test_port_only_config_loads_and_fits_two_steps(path, tmp_path,
                                                   monkeypatch):
    """A ``configs/torch/`` file loads in the port as shipped and, cut as
    :func:`_fit_dict` cuts the shipped files (the image, the scan
    capacity, synthetic drives, batches of 2, float32), trains two steps
    and validates once at its own widths through ``Trainer.fit``."""
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert load_config(path).model.arch in ("deepio", "deeplo", "deeplio")
    cfg = load_config_dict(_fit_dict(str(path.relative_to(CONFIGS[0].parent))))
    trainer = Trainer(cfg, str(tmp_path / "run"), device="cpu")
    try:
        state = trainer.fit(epochs=1)
    finally:
        trainer.close()
    assert state.step == 2
    recs = [json.loads(line) for line in
            (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["split"] == "train"] == [1, 2]
    assert [r["split"] for r in recs].count("val") == 1
    assert all(np.isfinite(r["loss"]) for r in recs)
