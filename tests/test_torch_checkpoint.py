"""Checkpoints, resume and the loop's step grouping of the port, on the CPU.

Bit for bit, no tolerance: the same process runs the same float32 ops on
the same inputs, so a resumed run, a run in groups of two steps and a
restored state must equal their counterparts exactly. The resume runs use
dropout 0.25 and ``augment-yaw: true``, so the generator's state (yaw
angles, dropout masks) is part of what is checked. The mirrors of
``tests/integration/test_train_smoke.py`` keep its checks.
"""

import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config_dict  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train import Trainer  # noqa: E402
from deeplio_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager,
    load_pointseg_backbone,
    save_params,
)
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"


def small_cfg(frames=7, dropout=0.0, augment=False, **train):
    """16x128, 2048 points, B = 2 windows of 3 frames, 2 train drives of
    ``frames`` frames (7: 3 steps an epoch; 5: 2) and 1 validation drive."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({
        "image-height": 16, "image-width": 128, "max-points": 2048,
        "sequence-size": 3, "window-stride": 2, "backend": "pallas",
        "synthetic": True, "synthetic-frames": frames,
        "synthetic-train-drives": 2, "synthetic-eval-drives": 1,
        "augment-yaw": augment})
    d["deeplio"]["dropout"] = dropout
    d["train"].update({"batch-size": 2, "log-every": 1,
                       "checkpoint-every-steps": 2, **train})
    return load_config_dict(d)


def _snapshot(state):
    """Everything the step mutates, copied to the host."""
    return copy.deepcopy(state.state_dict())


def _assert_equal(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where


def _losses(workdir):
    with open(pathlib.Path(workdir) / "metrics.jsonl") as f:
        return [(r["step"], r["split"], r["loss"], r["loss_x"], r["loss_q"])
                for r in map(json.loads, f)]


def test_restore_gives_back_the_saved_state(tmp_path):
    cfg = small_cfg(dropout=0.25, augment=True)
    t = Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    t.fit(epochs=1)
    saved = _snapshot(t.state)
    t.close()
    again = Trainer(cfg, workdir=str(tmp_path / "run"), resume=True,
                    device="cpu")
    _assert_equal(_snapshot(again.state), saved)
    again.close()


def test_steps_per_call_checkpoint_labels_match_state(tmp_path):
    """Every label names the step counter inside the state it holds: a
    save boundary (3) inside a 2-step group saves at the group's end."""
    cfg = small_cfg(frames=9, **{"steps-per-call": 2,
                                 "checkpoint-every-steps": 3})
    t = Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    t.fit(epochs=1)                   # 8 windows, 4 steps in 2 groups
    labels = t.ckpt.all_steps()
    assert labels == [4]
    for label in labels:
        probe = create_train_state(cfg, build_model(cfg, device="cpu"))
        assert t.ckpt.restore(probe, step=label).step == label
    t.close()


def test_steps_per_call_exceeding_epoch_rejected(tmp_path):
    with pytest.raises(ValueError, match="steps-per-call"):
        Trainer(small_cfg(**{"steps-per-call": 4}),
                workdir=str(tmp_path / "run"), device="cpu")


def test_forced_metrics_save_keeps_sole_checkpoint(tmp_path):
    """A forced save with metrics over a label without them is refused
    when that label is the only checkpoint; with a second label it
    overwrites."""
    cfg = small_cfg()
    state = create_train_state(cfg, build_model(cfg, device="cpu"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), save_every_steps=5)
    assert not mgr.maybe_save(state, step=4)       # off the cadence
    assert mgr.maybe_save(state, step=5)           # periodic, no metrics
    assert not mgr.maybe_save(state, step=5)       # a duplicate
    assert not mgr.maybe_save(state, metrics={"val_loss": 1.0},
                              force=True, step=5)
    assert mgr.latest_step() == 5 and mgr.metrics(5) == {}
    assert mgr.restore(state, step=5).step == state.step
    state.step = 10
    assert mgr.maybe_save(state, step=10)
    assert mgr.maybe_save(state, metrics={"val_loss": 0.5}, force=True,
                          step=10)
    assert mgr.metrics(10) == {"val_loss": 0.5}
    assert not mgr.maybe_save(state, metrics={"val_loss": 0.4},
                              force=True, step=10)
    assert mgr.all_steps() == [5, 10]
    mgr.close()


def test_keeps_the_newest_checkpoints(tmp_path):
    cfg = small_cfg()
    state = create_train_state(cfg, build_model(cfg, device="cpu"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2,
                            save_every_steps=1)
    for step in (1, 2, 3, 7):
        state.step = step
        assert mgr.maybe_save(state)
    assert mgr.all_steps() == [3, 7] and mgr.latest_step() == 7
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["3", "7"]                    # no temporary file left behind


def test_resume_restores_trainer_meta(tmp_path):
    cfg = small_cfg(**{"checkpoint-every-steps": 5, "log-every": 100})
    t = Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    t.fit(epochs=2)
    best, epochs = t.best_val, t._epochs_done
    assert np.isfinite(best) and epochs == 2
    t.close()
    t2 = Trainer(cfg, workdir=str(tmp_path / "run"), resume=True,
                 device="cpu")
    assert t2.best_val == best
    assert t2._epochs_done == 2
    t2.close()


def test_whole_model_pretrained_load(tmp_path):
    cfg = small_cfg(**{"checkpoint-every-steps": 0})
    t = Trainer(cfg, workdir=str(tmp_path / "a"), device="cpu")
    t.fit(epochs=1)
    trained = {k: p.detach().clone()
               for k, p in t.state.model.named_parameters()}
    save_params(str(tmp_path / "snap"), t.state.model)
    t.close()
    cfg2 = cfg.replace(model=dataclasses.replace(
        cfg.model, pretrained=True, model_path=str(tmp_path / "snap")))
    t2 = Trainer(cfg2, workdir=str(tmp_path / "b"), device="cpu")
    loaded = dict(t2.state.model.named_parameters())
    assert loaded.keys() == trained.keys()
    for k, v in trained.items():
        assert torch.equal(loaded[k], v), k
    t2.close()


def test_load_pointseg_backbone_replaces_only_the_encoder(tmp_path):
    cfg = small_cfg()
    donor = build_model(cfg, device="cpu", seed=1)
    save_params(str(tmp_path / "seg"), donor.lidar_feat.pointseg)
    model = build_model(cfg, device="cpu", seed=2)
    before = copy.deepcopy(model.state_dict())
    load_pointseg_backbone(model, str(tmp_path / "seg"))
    enc = "lidar_feat.pointseg.encoder."
    donor_sd = donor.state_dict()
    params = dict(model.named_parameters())
    changed = 0
    for k, v in model.state_dict().items():
        if k.startswith(enc) and k in params:
            assert torch.equal(v, donor_sd[k]), k
            changed += not torch.equal(v, before[k])
        else:               # the rest, and the encoder's BatchNorm stats
            assert torch.equal(v, before[k]), k
    assert changed > 10
    # through the config, as the Trainer reads it
    lidar = dataclasses.replace(cfg.model.lidar, pretrained=True,
                                model_path=str(tmp_path / "seg"))
    cfg2 = cfg.replace(model=dataclasses.replace(cfg.model, lidar=lidar))
    t = Trainer(cfg2, workdir=str(tmp_path / "run"), device="cpu")
    for k, p in t.state.model.named_parameters():
        if k.startswith(enc):
            assert torch.equal(p, donor_sd[k]), k
    t.close()
    save_params(str(tmp_path / "heads"), donor.heads)
    with pytest.raises(KeyError):
        load_pointseg_backbone(model, str(tmp_path / "heads"))
