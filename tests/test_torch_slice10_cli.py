"""The slice's two configurations (``deeplio_tpu_torch/bench/slice10.py``)
through the command lines on the CPU (``--device cpu``), each on a tiny
synthetic setup (16x128, 2048 points, float32, windows of 3, batch 2, 2
train drives of 7 frames): ``cli.train --epochs 1``, then ``--resume``
for a second epoch, whose restored optimizer state (SGD's momentum
buffers, AdamW's moments) equals the checkpoint's bit for bit;
``cli.test`` and ``cli.stream`` with finite scores under the JAX
package's keys; ``cli.export --chunk 1``. ``eval/runner.py`` and the
command lines take the new stems, Fires and optimizers with no code of
their own: the schema and the model carry them.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from deeplio_tpu_torch.bench.slice10 import slice10_dict
from deeplio_tpu_torch.cli import export as export_cli
from deeplio_tpu_torch.cli import stream as stream_cli
from deeplio_tpu_torch.cli import test as test_cli
from deeplio_tpu_torch.cli import train as train_cli
from deeplio_tpu_torch.cli._common import restore_trainer
from deeplio_tpu_torch.config import load_config
from tests.test_torch_cli import (  # noqa: F401
    EVAL_KEYS,
    STREAM_KEYS,
    no_optional_imports,
    write_config,
)


def _config(root, which):
    path = write_config(root / "tiny.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)
    d["datasets"]["backend"] = "pallas-ring"           # the file's
    d = slice10_dict(d, which)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


@pytest.mark.parametrize("which", ["A", "B"])
def test_train_resume_test_stream_export(tmp_path, which):
    cfg_path = _config(tmp_path, which)
    cfg = load_config(cfg_path)
    assert (cfg.optim.name, cfg.model.lidar.stem) == \
        {"A": ("sgd", "factorized"), "B": ("adam", "s2d-pre")}[which]
    wd = str(tmp_path / "run")
    common = ["-c", cfg_path, "--workdir", wd, "--device", "cpu"]
    train_cli.main(common + ["--epochs", "1"])
    saved = torch.load(pathlib.Path(wd) / "checkpoints" / "3" / "state.pt",
                       weights_only=True)
    assert saved["optimizer"]["name"] == cfg.optim.name
    tr = restore_trainer(cfg, wd, "cpu")
    try:
        got = tr.state.optimizer.state_dict()["inner"]["state"]
    finally:
        tr.close()
    want = saved["optimizer"]["inner"]["state"]
    assert got.keys() == want.keys() and want
    key = "momentum_buffer" if which == "A" else "exp_avg_sq"
    for i, st in want.items():
        assert torch.equal(got[i][key], st[key]), i
    train_cli.main(common + ["--epochs", "1", "--resume"])
    recs = [json.loads(line) for line in
            open(pathlib.Path(wd) / "metrics.jsonl")]
    steps = [r["step"] for r in recs if r["split"] == "train"]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in recs)

    test_cli.main(common)
    scores = json.load(open(pathlib.Path(wd) / "eval" / "scores.json"))
    (s,) = scores.values()
    assert list(s) == EVAL_KEYS and np.isfinite(s["ate_m"])
    stream_cli.main(common + ["--chunk", "4"])
    scores = json.load(open(pathlib.Path(wd) / "stream" / "scores.json"))
    (s,) = scores.values()
    assert list(s) == STREAM_KEYS and s["frames"] == 7
    art = export_cli.main(common + ["--chunk", "1"])
    assert (pathlib.Path(art) / "streaming_step.pt2").exists()
