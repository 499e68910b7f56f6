"""The port's command lines on the CPU (``--device cpu``): train -> test ->
test ``--use-best`` -> stream -> export on a tiny synthetic config written
to a temporary directory (the kitti-tpu model at 16x128, 2048 points,
float32, ``backend: pallas``, windows of 3, batch 2, 2 train drives of 7
frames, 1 validation and 1 test drive, 1 epoch).

Checked against the JAX package's CLIs: the same flags (``--device`` added;
export's ``--platforms`` replaced by it), the same files, and the same
score keys (``deeplio_tpu/cli/test.py`` writes ``evaluate_drive``'s keys,
``cli/stream.py:67-74`` its own). ``scores.json`` equals ``evaluate_drive``
called directly on the restored state, exactly (the same process, the same
float32 operations); the export writes the artifact's files and manifest.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import yaml

from deeplio_tpu.cli import export as jax_export_cli
from deeplio_tpu.cli import test as jax_test_cli
from deeplio_tpu.cli import train as jax_train_cli
from deeplio_tpu_torch.cli import export as export_cli
from deeplio_tpu_torch.cli import stream as stream_cli
from deeplio_tpu_torch.cli import test as test_cli
from deeplio_tpu_torch.cli import train as train_cli
from deeplio_tpu_torch.cli._common import restore_trainer
from deeplio_tpu_torch.config import load_config
from deeplio_tpu_torch.data.dataset import build_drives
from deeplio_tpu_torch.eval.runner import evaluate_drive
from deeplio_tpu_torch.models.zoo import build_model
from deeplio_tpu_torch.train.checkpoint import save_params

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
EVAL_KEYS = ["ate_m", "rpe_trans_m", "rpe_rot_rad", "t_rel_pct",
             "r_rel_deg_per_100m", "n_segments"]
STREAM_KEYS = ["frames", "frames_per_sec", "real_time_factor", "ate_m",
               "rpe_trans_m", "t_rel_pct", "r_rel_deg_per_100m",
               "n_segments"]


def write_config(path):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({
        "image-height": 16, "image-width": 128, "max-points": 2048,
        "sequence-size": 3, "window-stride": 2, "backend": "pallas",
        "synthetic": True, "synthetic-frames": 7,
        "synthetic-train-drives": 2, "synthetic-eval-drives": 1})
    d["deeplio"]["dropout"] = 0.0
    d["train"].update({"batch-size": 2, "log-every": 1, "epochs": 3})
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def no_optional_imports():
    """Neither TensorBoard nor matplotlib imports here, as on the card's
    machine: ``MetricsWriter`` then writes no TensorBoard mirror (the JSONL
    metrics are the source of truth; the mirror is
    ``tests/test_torch_trainer.py``'s) and ``evaluate_drive`` no PNG
    (``test_torch_eval.py`` draws one). Importing TensorBoard pulls in
    TensorFlow, most of this file's time otherwise."""
    import sys
    names = ("torch.utils.tensorboard", "matplotlib")
    saved = {n: sys.modules.get(n, False) for n in names}
    for n in names:
        sys.modules[n] = None                          # ImportError
    yield
    for n, m in saved.items():
        if m is False:
            del sys.modules[n]
        else:
            sys.modules[n] = m


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One epoch trained through the CLI (``--epochs`` overrides 3)."""
    root = tmp_path_factory.mktemp("cli")
    cfg_path = write_config(root / "tiny.yaml")
    wd = str(root / "run")
    train_cli.main(["-c", cfg_path, "--workdir", wd, "--epochs", "1",
                    "--device", "cpu"])
    return cfg_path, wd


def _direct_scores(cfg_path, wd, params_of=None):
    """``evaluate_drive`` on the restored state, with ``params_of``'s
    parameters (not its BatchNorm statistics) copied over it."""
    cfg = load_config(cfg_path)
    tr = restore_trainer(cfg, wd, "cpu")
    if params_of is not None:
        with torch.no_grad():
            for p, q in zip(tr.state.model.parameters(),
                            params_of.parameters()):
                p.copy_(q)
    try:
        return {d.name: evaluate_drive(cfg, tr.eval_step, tr.state, d,
                                       device="cpu")
                for d in build_drives(cfg, "test")}
    finally:
        tr.close()


def test_train_writes_metrics_checkpoints_and_best(run):
    _, wd = run
    recs = [json.loads(line) for line in
            open(pathlib.Path(wd) / "metrics.jsonl")]
    assert [r["step"] for r in recs if r["split"] == "train"] == [1, 2, 3]
    assert [r["split"] for r in recs].count("val") == 1
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert (pathlib.Path(wd) / "checkpoints" / "3" / "state.pt").exists()
    assert (pathlib.Path(wd) / "best" / "params.pt").exists()
    meta = json.load(open(pathlib.Path(wd) / "trainer_meta.json"))
    assert meta["epochs_done"] == 1


@pytest.fixture(scope="module")
def latest_scores(run):
    """``evaluate_drive`` called directly on the latest checkpoint."""
    return _direct_scores(*run)


def test_test_cli_scores_equal_evaluate_drive(run, latest_scores):
    cfg_path, wd = run
    test_cli.main(["-c", cfg_path, "--workdir", wd, "--device", "cpu"])
    out = pathlib.Path(wd) / "eval"
    scores = json.load(open(out / "scores.json"))
    assert list(scores) == ["synth_200"]
    assert list(scores["synth_200"]) == EVAL_KEYS
    assert {p.name for p in out.iterdir()} == {
        "scores.json", "synth_200_pred.txt", "synth_200_gt.txt"}
    assert json.dumps(scores, sort_keys=True) == json.dumps(
        json.loads(json.dumps(latest_scores)), sort_keys=True)
    pred = np.loadtxt(out / "synth_200_pred.txt")
    assert pred.shape == (7, 12) and np.isfinite(pred).all()


def test_test_cli_use_best_loads_the_best_snapshot(run, latest_scores,
                                                   tmp_path):
    """``--use-best`` scores ``<workdir>/best``: replace it by other
    weights and the scores follow them."""
    cfg_path, wd = run
    cfg = load_config(cfg_path)
    other = build_model(cfg, device="cpu", seed=5)
    best = pathlib.Path(wd) / "best"
    kept = (best / "params.pt").read_bytes()
    try:
        save_params(str(best), other, overwrite=True)
        test_cli.main(["-c", cfg_path, "--workdir", wd, "--device", "cpu",
                       "--use-best", "--out", str(tmp_path / "best")])
    finally:
        (best / "params.pt").write_bytes(kept)
    got = json.load(open(tmp_path / "best" / "scores.json"))
    want = json.loads(json.dumps(_direct_scores(cfg_path, wd, other)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert latest_scores["synth_200"]["ate_m"] != got["synth_200"]["ate_m"]


def test_stream_cli_writes_scores_and_trajectory(run):
    cfg_path, wd = run
    stream_cli.main(["-c", cfg_path, "--workdir", wd, "--chunk", "4",
                     "--device", "cpu"])
    out = pathlib.Path(wd) / "stream"
    scores = json.load(open(out / "scores.json"))
    s = scores["synth_200"]
    assert list(s) == STREAM_KEYS
    assert s["frames"] == 7 and s["frames_per_sec"] > 0
    assert s["real_time_factor"] == pytest.approx(s["frames_per_sec"] / 10)
    poses = np.loadtxt(out / "synth_200_stream.txt")
    assert poses.shape == (7, 12) and np.isfinite(poses).all()
    np.testing.assert_array_equal(poses[0], np.eye(4)[:3].ravel())


def test_export_cli_artifact_serves_a_chunk(run):
    """The CLI restores the checkpoint and writes the artifact: its files,
    a manifest for this config on the CPU, and the initial carry. That the
    artifact serves, bit for bit against ``StreamingOdometry.run``, is
    ``tests/test_torch_export.py``'s (one export there, none loaded
    here)."""
    cfg_path, wd = run
    art = export_cli.main(["-c", cfg_path, "--workdir", wd, "--chunk", "1",
                           "--device", "cpu"])
    assert art == str(pathlib.Path(wd) / "artifact")
    assert sorted(p.name for p in pathlib.Path(art).iterdir()) == [
        "carry_init.pt", "manifest.json", "streaming_step.pt2"]
    with open(pathlib.Path(art) / "manifest.json") as f:
        manifest = json.load(f)
    ds = load_config(cfg_path).datasets
    h, w, n = (ds.projection.height, ds.projection.width,
               ds.projection.max_points)
    assert manifest["kind"] == "deeplio_tpu_torch.streaming_step"
    assert (manifest["arch"], manifest["device"], manifest["chunk"]) == \
        ("deeplio", "cpu", 1)
    assert manifest["inputs"]["points"] == [[1, n, 4], "float32"]
    assert manifest["inputs"]["valid"] == [[1, n], "bool"]
    assert manifest["image"]["height"] == h and \
        manifest["image"]["width"] == w
    carry = torch.load(pathlib.Path(art) / "carry_init.pt", weights_only=True)
    assert [[list(c.shape), str(c.dtype).replace("torch.", "")]
            for c in carry] == manifest["carry"]
    assert float(carry[2]) == 0.0                   # not started


@pytest.mark.parametrize("cli", [test_cli, export_cli, stream_cli],
                         ids=["test", "export", "stream"])
def test_no_checkpoint_exits(cli, tmp_path):
    cfg_path = write_config(tmp_path / "tiny.yaml")
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["-c", cfg_path, "--workdir", str(tmp_path / "empty"),
                  "--device", "cpu"])


@pytest.mark.parametrize("flags,error", [
    (["--data-parallel", "2"], r"mesh 2x1 needs 2 devices, have 1"),
    (["--coordinator", "localhost:1234", "--num-processes", "2"],
     "requires DEEPLIO_NUM_PROCESSES and DEEPLIO_PROCESS_ID"),
    (["--coordinator", "localhost:1234"],
     "requires DEEPLIO_NUM_PROCESSES and DEEPLIO_PROCESS_ID")],
    ids=["flags0", "flags1", "flags2"])
def test_data_parallel_raises_naming_item_6(flags, error, tmp_path,
                                            monkeypatch):
    """The data-parallel flags parse to the JAX CLI's values. In one
    process with no cluster, ``--data-parallel 2`` raises ``make_mesh``'s
    error (two devices wanted, one process), and a coordinator without the
    process count and id raises ``maybe_initialize``'s, as in JAX, before
    the work directory is made."""
    for var in ("DEEPLIO_COORDINATOR", "DEEPLIO_NUM_PROCESSES",
                "DEEPLIO_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    cfg_path = write_config(tmp_path / "tiny.yaml")
    argv = ["-c", cfg_path, "--workdir", str(tmp_path / "w"), *flags]
    keys = ("data_parallel", "coordinator", "num_processes", "process_id")
    got, want = vars(train_cli.parse_args(argv)), vars(
        jax_train_cli.parse_args(argv))
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    with pytest.raises(ValueError, match=error):
        train_cli.main(argv + ["--device", "cpu"])
    assert not (tmp_path / "w").exists()


def test_flags_match_jax():
    base = ["-c", "x.yaml"]
    pairs = [(train_cli, jax_train_cli, set()),
             (test_cli, jax_test_cli, set()),
             (export_cli, jax_export_cli, {"platforms"})]
    for port, jax_cli, dropped in pairs:
        got = set(vars(port.parse_args(base)))
        want = set(vars(jax_cli.parse_args(base)))
        assert got == (want - dropped) | {"device"}, port.__name__
    args = train_cli.parse_args(base + ["--epochs", "4", "--lr", "0.5",
                                        "--batch-size", "3", "--seed", "9"])
    jargs = jax_train_cli.parse_args(base + ["--epochs", "4", "--lr", "0.5",
                                             "--batch-size", "3",
                                             "--seed", "9"])
    assert (args.epochs, args.lr, args.batch_size, args.seed) == \
        (jargs.epochs, jargs.lr, jargs.batch_size, jargs.seed)
    assert args.device == "cuda"                   # the card by default


# ------------------------------------------------------------ pretraining

def write_pretrain_config(root, **pointseg):
    """The kitti-tpu file at 16x128, float32, on a devkit tree of one
    ring-ordered drive of 6 frames with SemanticKITTI label files, drive
    27 as the train and validation split (windows of 3 at stride 2)."""
    from deeplio_tpu_torch.bench.kitti_tree import (
        DATE,
        make_tree,
        write_labels,
    )
    if not (root / DATE).exists():
        make_tree(str(root), [27], n_frames=6, max_points=1024, rings=16,
                  world_points=4000)
        write_labels(str(root), str(root / "labels"), [27])
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({
        "image-height": 16, "image-width": 128, "max-points": 1024,
        "sequence-size": 3, "window-stride": 2,
        "kitti": {"root-path": str(root), "train": {DATE: [27]},
                  "validation": {DATE: [27]}},
        "labels-path": str(root / "labels"), "label-map": {40: 1, 50: 2},
        "labels-num-classes": 3})
    d["lidar-feat-pointseg"].update(pointseg)
    d["train"].update({"batch-size": 2, "log-every": 1})
    path = root / ("graft.yaml" if pointseg else "pretrain.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


def test_pretrain_cli_snapshot_grafts_into_trainer(tmp_path):
    """``cli.pretrain_pointseg --device cpu`` writes an encoder snapshot;
    a ``Trainer`` with ``pretrained: true, model-path`` starts from it:
    its encoder holds the snapshot, its other tensors the seeded init, and
    it trains a step."""
    from deeplio_tpu_torch.cli import pretrain_pointseg as pre_cli
    from deeplio_tpu_torch.train import Trainer
    out = tmp_path / "pre"
    res = pre_cli.main(["-c", write_pretrain_config(tmp_path), "--out",
                        str(out), "--steps", "2", "--batch-size", "2",
                        "--device", "cpu"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    saved = torch.load(out / "params.pt", weights_only=True)
    cfg = load_config(write_pretrain_config(
        tmp_path, pretrained=True, **{"model-path": str(out)}))
    trainer = Trainer(cfg, workdir=str(tmp_path / "run"), device="cpu")
    try:
        got = trainer.state.model.state_dict()
        init = build_model(cfg, device="cpu", seed=cfg.train.seed)
        enc = "lidar_feat.pointseg.encoder."
        assert all(torch.equal(got[enc + k[len("encoder."):]], v)
                   for k, v in saved.items())
        rest = [k for k in got if not k.startswith(enc)]
        assert rest and all(torch.equal(got[k], init.state_dict()[k])
                            for k in rest)
        trainer.fit(epochs=1)
        assert trainer.step == 1
    finally:
        trainer.close()


def test_pretrain_flags_match_jax(monkeypatch):
    """The same flags give the same ``pretrain_pointseg`` arguments."""
    from deeplio_tpu.cli import pretrain_pointseg as jax_pre_cli
    from deeplio_tpu_torch.cli import pretrain_pointseg as pre_cli
    seen = {}

    def capture(name):
        def fn(cfg, out_dir, **kw):
            seen[name] = dict(kw, out_dir=out_dir)
            return {"loss": 0.0, "acc": 0.0}
        return fn
    monkeypatch.setattr(jax_pre_cli, "load_config", lambda p: None)
    monkeypatch.setattr(jax_pre_cli, "pretrain_pointseg", capture("jax"))
    monkeypatch.setattr(pre_cli, "load_config", lambda p: None)
    monkeypatch.setattr(pre_cli, "pretrain_pointseg", capture("port"))
    for flags in ([], ["--steps", "3", "--batch-size", "2", "--lr", "0.5",
                       "--seed", "9"]):
        argv = ["-c", "x.yaml", "--out", "o"] + flags
        jax_pre_cli.main(argv)
        pre_cli.main(argv)
        assert seen["port"].pop("device") == "cuda"   # the card by default
        assert seen["port"] == seen["jax"]
