"""The port's paths end to end on the card: the command lines (train,
test, stream, export, pretraining) of every configuration family,
data parallelism at world 1 over NCCL and with two gloo ranks on the one
card, a loss that falls on one batch, float32 steps against the same
steps on the CPU, the streamed drive in bfloat16 and float32, every
projection backend, and the projection's prologue and epilogue on
full-width edge cases.

Each run counts the launches of the two selection kernels and of the
prologue and epilogue kernels: one selection a projection, and one
prologue and one epilogue a projection on a packed route. Every test
needs a CUDA device and skips without one. This file imports neither JAX
nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_paths.py -q
"""

import copy
import functools
import json
import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config, load_config_dict  # noqa: E402
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch  # noqa: E402
from deeplio_tpu_torch.ops import projection_io as tio  # noqa: E402
from deeplio_tpu_torch.ops import projection_ring as tring  # noqa: E402
from deeplio_tpu_torch.ops import projection_scatter as tsc  # noqa: E402
from tests.test_torch_gpu import _bits_equal, _int_bits  # noqa: E402

pytestmark = pytest.mark.gpu
CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "configs"
DATE = "2011_10_03"
H, W, N = 16, 128, 2048                     # the cut image and scans
# the tree's drives: 27 to train and validate, 42 to test and stream
# (long enough for the KITTI segment errors of 100 m and more)
TRAIN_FRAMES, TEST_FRAMES = 11, 137
EVAL_KEYS = ["ate_m", "rpe_trans_m", "rpe_rot_rad", "t_rel_pct",
             "r_rel_deg_per_100m", "n_segments"]
# one float32 step on the card (TF32 off) against the CPU: the loss
# within 1e-4 of its magnitude, grad_norm within 1e-2, the BatchNorm
# statistics within 1e-4 of each leaf's largest value and the parameter
# update within 20% in L2. At 16x128, 2 windows of 3 frames, the last
# ConvBN normalises 8 values a channel, which magnifies the rounding of
# other summation orders, and Adam's first update keeps only each
# gradient's sign (flips where |g| is at the rounding level).
LOSS_RTOL, NORM_RTOL, STATS_RTOL, UPDATE_L2 = 1e-4, 1e-2, 1e-4, 0.2
# pretraining's BatchNorms normalise 2 x 2 x 16 x 32 values a channel:
# its update stays within 1e-3 in L2
PRETRAIN_UPDATE_L2 = 1e-3
# a float32 data-parallel SGD step against the mesh-less step on the same
# weights and batch: the ranks take BatchNorm's statistics as flax does
# and average their gradients in another order than the one sum
DP_LOSS_RTOL, DP_STATS_RTOL, DP_UPDATE_MAX, DP_UPDATE_L2 = (
    1e-5, 1e-5, 2e-4, 2e-3)
DP_SGD = {"name": "sgd", "lr": 0.01, "momentum": 0.9}
PRETRAIN_B = 8


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    """float32 on the card as on the CPU: TF32 off for convolutions and
    matrix products."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _counts():
    return {"ring": tring._OP.launches, "scatter": tsc._OP.launches,
            "prologue": tio._PROLOGUE.launches,
            "epilogue": tio._EPILOGUE.launches}


class Launches:
    """The four kernels' launches inside a ``with`` block (``.n``)."""

    def __enter__(self):
        torch.cuda.synchronize()
        self.before = _counts()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.n = {k: v - self.before[k] for k, v in _counts().items()}


def _packed(cfg) -> bool:
    """Whether ``cfg``'s projector runs the prologue and epilogue kernels
    around its selection: ``pallas`` and ``pallas-ring`` always, the
    other backends under ``packed``."""
    p = cfg.datasets.projection
    return p.backend in ("pallas", "pallas-ring") or p.packed


def _want(cfg, kernel, n: int) -> dict:
    """The launches of ``n`` projections of ``cfg`` by ``kernel`` (``ring``,
    ``scatter``, or None for the slot-aligned routes, which launch none)."""
    if kernel is None:
        n = 0
    io = n if _packed(cfg) else 0
    return {"ring": n if kernel == "ring" else 0,
            "scatter": n if kernel == "scatter" else 0,
            "prologue": io, "epilogue": io}


class First:
    """A selection that passes every call to ``op`` and keeps copies of
    the first call's arguments and outputs."""

    def __init__(self, op):
        self.op, self.first = op, None

    def __call__(self, *args):
        out = self.op(*args)
        if self.first is None:
            self.first = ([a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args], [o.clone() for o in out])
        return out

    def held(self, plain):
        """The first call's outputs equal ``plain`` on its arguments."""
        args, outs = self.first
        return all(torch.equal(a, r) for a, r in zip(outs, plain(*args)))


PLAIN = {"ring": tring.ring_select_reference,
         "scatter": tsc.scatter_select_reference}


def _spy(monkeypatch, kernel):
    """``kernel``'s selection spied on where the projector looks it up."""
    mod, name = ((tring, "ring_select") if kernel == "ring"
                 else (tsc, "scatter_select"))
    spy = First(getattr(mod, name))
    monkeypatch.setattr(mod, name, spy)
    return spy


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _variables(model):
    from deeplio_tpu_torch.models.from_flax import to_flax_variables
    return _flat(to_flax_variables(model))


def _records(workdir):
    with open(pathlib.Path(workdir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


# ------------------------------------------------------ the configurations

def _load(name):
    with open(CONFIGS / name) as f:
        return yaml.safe_load(f)


def _cut(d, **datasets):
    """``d`` at 16x128, 2048 points, windows of 3 at stride 2, batches of
    2, logging every step; ``datasets`` sets more keys."""
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": N, "sequence-size": 3,
                          "window-stride": 2, **datasets})
    d["train"].update({"batch-size": 2, "log-every": 1, "prefetch": 2,
                       "checkpoint-every-steps": 0})
    return d


def _on_tree(d, root, **datasets):
    """``d`` cut (:func:`_cut`) on the devkit tree at ``root``: drive 27
    to train and validate, drive 42 to test and stream."""
    d = _cut(d, synthetic=False, **datasets)
    d["datasets"]["kitti"] = {"root-path": str(root),
                              "train": {DATE: [27]},
                              "validation": {DATE: [27]},
                              "test": {DATE: [42]}}
    return d


def _kitti_tpu(root):
    """``configs/deeplio_kitti_tpu.yaml``: ``pallas-ring``, bfloat16."""
    return _on_tree(_load("deeplio_kitti_tpu.yaml"), root)


def _deeplio_kitti(root):
    """``configs/deeplio_kitti.yaml``: the classic encoder, ``sort``."""
    return _on_tree(_load("deeplio_kitti.yaml"), root)


def _zoo_rest(root, fc=False):
    """The kitti-tpu file with ``backend: ring`` exact, the normals
    channel, a bidirectional GRU IMU net, a GRU odometry net and the
    decoder-bearing tower; ``fc``: the FC nets and ``bypass`` on
    ``sort-sentinel``, exact too."""
    d = _kitti_tpu(root)
    ds = d["datasets"]
    ds.update({"backend": "sort-sentinel" if fc else "ring",
               "packed": False, "channels": ds["channels"] + ["normals"],
               "mean": ds["mean"] + [0.0] * 3, "std": ds["std"] + [1.0] * 3})
    if fc:
        d["deeplio"]["imu-feat-net"] = {"name": "imu-feat-fc"}
        d["deeplio"]["odom-feat-net"] = {"name": "odom-feat-fc"}
        d["imu-feat-fc"] = {"hidden-size": 128, "num-layers": 2}
        d["odom-feat-fc"] = {"hidden-size": 256, "num-layers": 2}
        d["lidar-feat-pointseg"].pop("part", None)
        d["lidar-feat-pointseg"]["bypass"] = True
    else:
        d["imu-feat-rnn"].update({"type": "gru", "bidirectional": True})
        d["odom-feat-rnn"]["type"] = "gru"
        d["lidar-feat-pointseg"]["part"] = "encoder+decoder"
    return d


def _slice10(root, which):
    """``bench/slice10.py``'s A (factorized stem, mixed Fires, SGD, the
    ring kernel) or B (s2d-pre stem, fused Fires, AdamW, the scatter
    kernel) on the kitti-tpu file."""
    from deeplio_tpu_torch.bench.slice10 import slice10_dict
    return slice10_dict(_kitti_tpu(root), which)


def _flagship(root, **datasets):
    """The JAX benchmark's configuration (``bench/flagship.py``) with two
    slots a pixel: ``auto`` falls back to the ring kernel on the tree's
    compacted scans, ``slot-bin`` with ``halves`` bins each scan in the
    loader and launches no kernel."""
    from deeplio_tpu_torch.bench.flagship import flagship_dict
    return _on_tree(flagship_dict(), root, **{"max-points": 2 * H * W,
                                              **datasets})


# name: (the configuration on a tree, its selection kernel)
PATHS = {
    "kitti_tpu": (_kitti_tpu, "ring"),
    "deeplio_kitti": (_deeplio_kitti, "scatter"),
    "zoo_rest": (_zoo_rest, "ring"),
    "zoo_rest_fc": (functools.partial(_zoo_rest, fc=True), "scatter"),
    "slice10_A": (functools.partial(_slice10, which="A"), "ring"),
    "slice10_B": (functools.partial(_slice10, which="B"), "scatter"),
    "flagship_auto": (functools.partial(
        _flagship, **{"kernel-aligned": "auto"}), "ring"),
    "flagship_slot_bin": (functools.partial(
        _flagship, **{"kernel-aligned": "halves", "slot-bin": True}), None),
}


@pytest.fixture(scope="module")
def tree(card, tmp_path_factory):
    """A KITTI devkit tree of ring-ordered scans of 2048 points on 16
    rings, drive 27 of 11 frames and drive 42 of 137, with SemanticKITTI
    label files."""
    from deeplio_tpu_torch.bench.kitti_tree import make_tree, write_labels
    root = tmp_path_factory.mktemp("kitti_paths")
    for drive, frames in ((27, TRAIN_FRAMES), (42, TEST_FRAMES)):
        make_tree(str(root), [drive], n_frames=frames, max_points=N,
                  rings=16, world_points=6000)
    write_labels(str(root), str(root / "labels"), [27, 42])
    return root


def _write(d, path):
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return str(path)


@pytest.fixture(scope="module", params=list(PATHS))
def trained(request, tree, tmp_path_factory):
    """``cli.train --epochs 1`` of one configuration on the tree, its
    launches counted."""
    from deeplio_tpu_torch.cli import train as train_cli
    from deeplio_tpu_torch.data.dataset import build_dataset
    name = request.param
    build, kernel = PATHS[name]
    base = tmp_path_factory.mktemp(name)
    cfg_path = _write(build(tree), base / f"{name}.yaml")
    cfg = load_config(cfg_path)
    wd = str(base / "run")
    common = ["-c", cfg_path, "--workdir", wd, "--device", "cuda"]
    bs = cfg.train.batch_size
    spe = len(build_dataset(cfg, "train")) // bs
    n_val = len(build_dataset(cfg, "validation")) // bs
    with Launches() as counted:
        train_cli.main(common + ["--epochs", "1"])
    return {"name": name, "cfg": cfg, "kernel": kernel, "wd": wd,
            "common": common, "spe": spe, "n_val": n_val,
            "launches": counted.n}


def test_cli_train_on_the_card(trained):
    """One epoch: a record a step and one validation, finite losses, one
    selection a train step and a validation batch (none on the
    slot-binned route), the checkpoint and the best snapshot written."""
    t = trained
    recs = _records(t["wd"])
    assert [r["step"] for r in recs if r["split"] == "train"] == \
        list(range(1, t["spe"] + 1))
    assert [r["split"] for r in recs].count("val") == 1
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert t["launches"] == _want(t["cfg"], t["kernel"],
                                  t["spe"] + t["n_val"])
    wd = pathlib.Path(t["wd"])
    assert (wd / "checkpoints" / str(t["spe"]) / "state.pt").exists()
    assert (wd / "best" / "params.pt").exists()


def _eval_batches(cfg):
    from deeplio_tpu_torch.data.dataset import build_drives
    n = len(build_drives(cfg, "test")[0])
    return -(-(n - cfg.datasets.sequence_size + 1) // cfg.train.batch_size)


def _cli_test(t, monkeypatch, out, extra=()):
    """``cli.test`` on the test drive: one selection an eval batch, the
    first bit-equal to the plain version on the same card tensors, and
    finite scores under the JAX package's keys."""
    from deeplio_tpu_torch.cli import test as test_cli
    cfg, kernel = t["cfg"], t["kernel"]
    spy = _spy(monkeypatch, kernel) if kernel else None
    with Launches() as counted:
        scores = test_cli.main(t["common"] + ["--out", str(out), *extra])
    assert counted.n == _want(cfg, kernel, _eval_batches(cfg))
    (s,) = scores.values()
    assert list(s) == EVAL_KEYS and s["n_segments"] > 0
    assert all(np.isfinite(v) for v in s.values())
    if spy is not None:
        assert spy.first[0][0].shape[0] == \
            cfg.train.batch_size * cfg.datasets.sequence_size
        assert spy.held(PLAIN[kernel])
    return s


def test_cli_test_on_the_card(trained, monkeypatch, tmp_path):
    _cli_test(trained, monkeypatch, tmp_path / "eval")


@pytest.mark.parametrize("trained", ["kitti_tpu"], indirect=True)
def test_cli_test_use_best_on_the_card(trained, monkeypatch, tmp_path):
    _cli_test(trained, monkeypatch, tmp_path / "best", ["--use-best"])


def test_cli_stream_on_the_card(trained, monkeypatch):
    """``cli.stream``: one selection a tick that runs the operators, finite
    scores, and the first pose of the trajectory the identity. The chunks
    after the CUDA graph's capture replay it (``eval/streaming.py``), and
    a replay's launches leave the operators' counters alone: every
    configuration captures once, except ``auto`` on the slot grid, whose
    check reads the host every tick and keeps every chunk eager."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    made = []

    class Kept(stream_cli.StreamingOdometry):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(stream_cli, "StreamingOdometry", Kept)
    t = trained
    with Launches() as counted:
        scores = stream_cli.main(t["common"] + ["--chunk", "4"])
    ((name, s),) = scores.items()
    (so,) = made
    c = so.step.graph_counts()
    assert c["replays"] + c["eager"] == -(-s["frames"] // 4)
    reads_host = t["cfg"].datasets.projection.kernel_aligned == "auto"
    assert c["captures"] == (0 if reads_host else 1)
    # a call that only replays is a whole chunk of 4 ticks
    ticks = s["frames"] - 4 * (c["replays"] - c["captures"])
    assert counted.n == _want(t["cfg"], t["kernel"], ticks)
    assert s["frames"] == TEST_FRAMES and np.isfinite(s["ate_m"])
    poses = np.loadtxt(pathlib.Path(t["wd"]) / "stream" /
                       f"{name}_stream.txt")
    assert np.isfinite(poses).all()
    np.testing.assert_array_equal(poses[0], np.eye(4)[:3].ravel())


@pytest.mark.parametrize("trained", ["kitti_tpu", "slice10_B",
                                     "flagship_slot_bin"], indirect=True)
def test_cli_export_on_the_card(trained, card):
    """``cli.export --chunk 4``, then the artifact fed the test drive
    chunk by chunk (the last padded) against the eager chunk step of
    ``StreamingOdometry`` on the restored weights (``so.step.eager``) and
    against its CUDA graph (``so.step``: one warm-up, one capture, the
    rest replays): poses, dx, dq bit for bit, one selection a tick in
    the eager step and in the artifact."""
    from deeplio_tpu_torch.cli import export as export_cli
    from deeplio_tpu_torch.cli._common import restore_trainer
    from deeplio_tpu_torch.data.dataset import build_drives
    from deeplio_tpu_torch.eval.export import load_streaming_artifact
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    t = trained
    cfg = t["cfg"]
    art = export_cli.main(t["common"] + ["--chunk", "4"])
    step, init_carry, manifest = load_streaming_artifact(art)
    assert manifest["device"] == "cuda"
    trainer = restore_trainer(cfg, t["wd"], "cuda")
    try:
        so = StreamingOdometry(cfg, trainer.state.model, chunk=4,
                               device=card)
        chunks = list(so.host_chunks(build_drives(cfg, "test")[0],
                                     pad=True))

        def through(chunk_step):
            def call(carry, inp):
                with torch.no_grad():
                    *carry, p, x, q = chunk_step(*carry,
                                                 *(inp[k] for k in so.keys))
                return carry, (p, x, q)
            return call

        outs, launched = {}, {}
        for name, fn, c0 in (("eager", through(so.step.eager),
                              so.init_carry),
                             ("graph", through(so.step), so.init_carry),
                             ("artifact", step, init_carry)):
            carry, got = c0(), []
            with Launches() as counted:
                for n_real, host in chunks:
                    carry, res = fn(carry, so.to_device(host))
                    got.append([r[:n_real].cpu().numpy() for r in res])
            outs[name] = [np.concatenate(o) for o in zip(*got)]
            launched[name] = counted.n
        graph_counts = so.step.graph_counts()
    finally:
        trainer.close()
    assert counted.n == _want(cfg, t["kernel"], 4 * len(chunks))
    assert launched["eager"] == counted.n
    assert graph_counts == {"captures": 1, "replays": len(chunks) - 1,
                            "eager": 1}
    for a, e, g in zip(outs["artifact"], outs["eager"], outs["graph"]):
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, e)
        np.testing.assert_array_equal(a, g)


@pytest.mark.parametrize("trained", ["slice10_A"], indirect=True)
def test_cli_resume_restores_sgd_momentum_on_the_card(trained):
    """The checkpoint's SGD momentum buffers restored bit for bit, then
    ``--resume`` for one more epoch: its steps follow on, one selection a
    step and a validation batch."""
    from deeplio_tpu_torch.cli import train as train_cli
    from deeplio_tpu_torch.cli._common import restore_trainer
    t = trained
    wd = pathlib.Path(t["wd"])
    last = max(int(p.name) for p in (wd / "checkpoints").iterdir())
    saved = torch.load(wd / "checkpoints" / str(last) / "state.pt",
                       map_location="cpu", weights_only=True)["optimizer"]
    trainer = restore_trainer(t["cfg"], str(wd), "cuda")
    try:
        got = trainer.state.optimizer.state_dict()["inner"]["state"]
    finally:
        trainer.close()
    want = saved["inner"]["state"]
    assert saved["name"] == "sgd" and want and got.keys() == want.keys()
    for i, st in want.items():
        assert torch.equal(got[i]["momentum_buffer"].cpu(),
                           st["momentum_buffer"]), i
    with Launches() as counted:
        train_cli.main(t["common"] + ["--epochs", "1", "--resume"])
    steps = [r["step"] for r in _records(wd) if r["split"] == "train"]
    assert steps[-t["spe"]:] == list(range(last + 1, last + t["spe"] + 1))
    assert counted.n == _want(t["cfg"], t["kernel"], t["spe"] + t["n_val"])


# ------------------------------------------------------------ pretraining

def _pretrain_dict(root, name):
    """A tree configuration for ``cli.pretrain_pointseg``: the kitti-tpu
    file with the tree's label files and SemanticKITTI's 20 classes
    (``labels``), or geometric labels (the others)."""
    if name == "labels":
        d = _kitti_tpu(root)
        d["datasets"].update({"labels-path": str(root / "labels"),
                              "label-map": LEARNING_MAP,
                              "labels-num-classes": 20})
        return d
    return PATHS[{"geometric": "kitti_tpu", "exact_z": "zoo_rest"}.get(
        name, name)][0](root)


# SemanticKITTI's learning map (raw id -> one of 20 train ids)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5}
# name: (steps, (ring, scatter) launches a step, the graft's kernel)
PRETRAIN = {"labels": (30, (1, 1), "ring"),
            "geometric": (4, (1, 1), "ring"),
            "exact_z": (4, (1, 1), "ring"),
            "slice10_A": (4, (1, 1), "ring"),
            "slice10_B": (4, (0, 2), "scatter")}


@pytest.mark.parametrize("name", list(PRETRAIN))
def test_pretrain_cli_then_graft_on_the_card(name, tree, monkeypatch,
                                             tmp_path):
    """``cli.pretrain_pointseg`` at 8 scans a step: the model input and the
    label image each one selection a step (B's pair both through the
    scatter kernel), the first of each bit-equal to the plain version,
    finite losses (with label files, 30 steps whose last 5 average below
    the first 5; the exact-z labels carry index payloads); then a
    ``Trainer`` with ``pretrained: true`` holds the snapshot's encoder
    and its seeded init elsewhere, and trains a step with one
    selection."""
    from deeplio_tpu_torch.cli import pretrain_pointseg as pre_cli
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train import Trainer
    from deeplio_tpu_torch.train.step import batch_to_device
    steps, per_step, graft_kernel = PRETRAIN[name]
    d = _pretrain_dict(tree, name)
    cfg_path = _write(d, tmp_path / "pretrain.yaml")
    cfg = load_config(cfg_path)
    out = tmp_path / "pretrained"
    spies = {k: _spy(monkeypatch, k) for k in ("ring", "scatter")}
    with Launches() as counted:
        res = pre_cli.main(["-c", cfg_path, "--out", str(out), "--steps",
                            str(steps), "--batch-size", str(PRETRAIN_B),
                            "--device", "cuda"])
    monkeypatch.undo()
    io = steps * (int(_packed(cfg)) + int(bool(cfg.datasets.labels_path)
                                          or cfg.datasets.projection.packed))
    assert counted.n == {"ring": steps * per_step[0],
                         "scatter": steps * per_step[1],
                         "prologue": io, "epilogue": io}
    for kernel, spy in spies.items():
        if spy.first is not None:
            assert spy.first[0][0].shape[0] == PRETRAIN_B
            assert spy.held(PLAIN[kernel])
    if name == "exact_z":
        key, idx = spies["scatter"].first[0][:2]
        assert torch.equal(idx[0], torch.arange(key.shape[1],
                                                dtype=torch.int32,
                                                device=idx.device))
    losses = res["losses"]
    assert len(losses) == steps and np.isfinite(losses).all()
    if name == "labels":
        assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses

    d["lidar-feat-pointseg"].update({"pretrained": True,
                                     "model-path": str(out)})
    cfg = load_config_dict(d)
    saved = torch.load(out / "params.pt", map_location="cpu",
                       weights_only=True)
    trainer = Trainer(cfg, workdir=str(tmp_path / "graft"), device="cuda")
    try:
        got = {k: v.cpu() for k, v in
               trainer.state.model.state_dict().items()}
        init = build_model(cfg, device="cpu", seed=cfg.train.seed)
        enc = "lidar_feat.pointseg.encoder."
        assert all(torch.equal(got[enc + k[len("encoder."):]], v)
                   for k, v in saved.items())
        rest = [k for k in got if not k.startswith(enc)]
        assert rest and all(torch.equal(got[k], init.state_dict()[k])
                            for k in rest)
        host = next(trainer.train_ds.iter_batches(cfg.train.batch_size,
                                                  shuffle=False))
        raw = batch_to_device(host, "cuda")
        with Launches() as counted:
            trainer.state, m = trainer.train_step(trainer.state, raw)
    finally:
        trainer.close()
    assert counted.n == _want(cfg, graft_kernel, 1)
    assert np.isfinite(float(m["loss"]))


def test_pretrain_step_on_the_card_equals_the_cpu(card, no_tf32):
    """One float32 pretraining step of 2 ring scans with labels at 16x128
    on the card against the same step on the CPU, identical weights."""
    from deeplio_tpu_torch.models.zoo import init_parameters
    from deeplio_tpu_torch.train import pretrain as tpre
    from deeplio_tpu_torch.train.step import batch_to_device
    d = _cut(_load("deeplio_kitti_tpu.yaml"))
    d["compute-dtype"] = "float32"
    d["datasets"].update({"labels-path": "/unused/labels",
                          "label-map": LEARNING_MAP,
                          "labels-num-classes": 20})
    cfg = load_config_dict(d)
    rng = np.random.default_rng(9)
    pts = synthetic_ring_batch(rng, 2, N, rings=H)
    host = {k: np.ascontiguousarray(pts[..., c])
            for c, k in enumerate(tpre.PLANES)}
    host.update(points_valid=np.ones((2, N), bool),
                labels=rng.integers(0, 20, (2, N)).astype(np.int32))
    cpu_model = tpre.build_pointseg(cfg, 20)
    init_parameters(cpu_model, torch.Generator().manual_seed(0))
    old = _variables(cpu_model)
    out = {}
    for name, model, dev in (("cpu", cpu_model, "cpu"),
                             ("cuda", copy.deepcopy(cpu_model).to(card),
                              card)):
        opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                               eps=tpre.ADAM_EPS)
        step = tpre.build_pretrain_step(cfg, model, opt, 20)
        loss, _ = step(batch_to_device(host, dev))
        out[name] = (float(loss), _variables(model))
    (lc, new_c), (lg, new_g) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= LOSS_RTOL * abs(lc)
    assert _stats_gap(new_g, new_c) <= STATS_RTOL
    assert _update_gap(new_g, new_c, old) <= PRETRAIN_UPDATE_L2


# ------------------------------------------------- the card against the CPU

def _stats_gap(got, want):
    """The largest BatchNorm statistic's difference over its leaf's
    largest value (0 with no BatchNorm)."""
    return max([float(np.abs(got[k] - want[k]).max()
                      / max(np.abs(want[k]).max(), 1e-3))
                for k in want if k.startswith("batch_stats/")] or [0.0])


def _update_gap(got, want, old):
    """The parameter update's difference in L2 over the update's norm."""
    params = sorted(k for k in old if k.startswith("params/"))
    du_g = np.concatenate([(got[k] - old[k]).ravel() for k in params])
    du_w = np.concatenate([(want[k] - old[k]).ravel() for k in params])
    return float(np.linalg.norm(du_g - du_w) / np.linalg.norm(du_w))


def _f32(d):
    """float32, no dropout, no yaw augmentation."""
    d["compute-dtype"] = "float32"
    d[d["arch"]]["dropout"] = 0.0
    if "lidar-feat-pointseg" in d:
        d["lidar-feat-pointseg"]["dropout"] = 0.0
    d["datasets"]["augment-yaw"] = False
    return d


def _synthetic(d, frames=5, points=N, rings=0):
    """The first batch of 2 windows of one synthetic drive under ``d``."""
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    cfg = load_config_dict(d)
    drive = SyntheticDrive(n_frames=frames, max_points=points, rings=rings,
                           **({"world_points": 300_000} if rings else {}))
    ds = WindowDataset(cfg.datasets, [drive],
                       with_points=cfg.model.uses_lidar)
    return cfg, next(ds.iter_batches(2, shuffle=False))


def _full_width(d):
    """``d`` at the file's 64x1024 and 131072 points, windows of 3."""
    d["datasets"].update({"image-height": 64, "image-width": 1024,
                          "max-points": 131072, "sequence-size": 3,
                          "window-stride": 2})
    return d


def _projected_on_card(cfg, host, card):
    """``host`` with its scans replaced by their images projected on the
    card (``images`` [B, S, H, W, C] float32, the projection cache's
    form), so that the card's and the CPU's steps see the same input: the
    CPU's projection may put a boundary point in the next pixel (trig
    ulps), and the normals turn such a flip into changes of order 1 in
    its neighbours. The flips are held to 1e-3 of the points."""
    from deeplio_tpu_torch.ops.projection import make_projector
    ds = cfg.datasets
    fn = make_projector(ds.projection, ds.channels, ds.mean, ds.std,
                        layout="planes")
    keys = ("points_x", "points_y", "points_z", "points_rem")
    out = {}
    for dev in (card, torch.device("cpu")):
        img, mask = fn([torch.from_numpy(host[k]).to(dev) for k in keys],
                       torch.from_numpy(host["points_valid"]).to(dev))
        out[dev.type] = (img.cpu(), mask.cpu())
    (gi, gm), (_, cm) = out[card.type], out["cpu"]
    assert int((gm != cm).sum()) <= 1e-3 * host["points_valid"].size
    b = host["x_gt"].shape[0]
    return {"images": gi.reshape((b, -1) + tuple(gi.shape[1:])).numpy(),
            **{k: v for k, v in host.items() if not k.startswith("points_")}}


def _kitti_tpu_pallas():
    return _f32(_cut(_load("deeplio_kitti_tpu.yaml"), backend="pallas"))


def _zoo_file(name):
    return _f32(_cut(_load(name)))


def _flagship_f32():
    from deeplio_tpu_torch.bench.flagship import flagship_dict
    return _f32(_cut(flagship_dict(), **{
        "image-height": 32, "max-points": 2 * 32 * W,
        "kernel-aligned": "halves"}))


def _projected(build):
    """The configuration ``build(root)`` at full width in float32, on 2
    windows of a synthetic ring drive projected on the card."""
    def make(card):
        d = _f32(_full_width(build(pathlib.Path("/unused"))))
        d["datasets"]["synthetic"] = True
        cfg, host = _synthetic(d, points=131072, rings=64)
        return cfg, _projected_on_card(cfg, host, card)
    return make


def _batch(make_dict, **kw):
    def make(card):
        return _synthetic(make_dict(), **kw)
    return make


def _flagship_batch(card):
    from deeplio_tpu_torch.bench.flagship import raw_batch
    cfg = load_config_dict(_flagship_f32())
    return cfg, raw_batch(cfg, 2, seed=1)


# name: the configuration and its batch
STEPS = {
    "kitti_tpu_pallas": _batch(_kitti_tpu_pallas),
    "deepio": _batch(functools.partial(_zoo_file, "deepio_synth.yaml")),
    "deeplo": _batch(functools.partial(_zoo_file, "deeplo_synth.yaml")),
    "flagship_halves": _flagship_batch,
    "zoo_rest": _projected(_zoo_rest),
    "zoo_rest_fc": _projected(functools.partial(_zoo_rest, fc=True)),
    "slice10_A": _projected(functools.partial(_slice10, which="A")),
    "slice10_B": _projected(functools.partial(_slice10, which="B")),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_on_the_card_equals_the_cpu(name, card, no_tf32):
    """One float32 training step on the card against the same step on
    the CPU from the same weights and batch: the loss, grad_norm, the
    BatchNorm statistics and the update (the tolerances above)."""
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    cfg, host = STEPS[name](card)
    cpu_model = build_model(cfg, device="cpu", seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(card)
    old = _variables(cpu_model)
    train_step, _ = build_train_step(cfg)
    _, mc = train_step(create_train_state(cfg, cpu_model),
                       batch_to_device(host, "cpu"))
    _, mg = train_step(create_train_state(cfg, gpu_model),
                       batch_to_device(host, card))
    mc = {k: float(v) for k, v in mc.items()}
    mg = {k: float(v) for k, v in mg.items()}
    rel = {k: abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc}
    new_c, new_g = _variables(cpu_model), _variables(gpu_model)
    assert rel["loss"] <= LOSS_RTOL, rel
    assert rel["grad_norm"] <= NORM_RTOL, rel
    assert _stats_gap(new_g, new_c) <= STATS_RTOL
    assert _update_gap(new_g, new_c, old) <= UPDATE_L2


@pytest.mark.parametrize("name", ["kitti_tpu_pallas", "slice10_A"])
def test_loss_falls_on_one_batch_on_the_card(name, card):
    """20 bfloat16 steps on one batch of 4 windows, no augmentation and no
    dropout, with Adam (the kitti-tpu file) and with SGD (slice 10's A):
    finite losses, the last below the first."""
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    d = (_kitti_tpu_pallas() if name == "kitti_tpu_pallas" else
         _f32(_cut(_slice10(pathlib.Path("/unused"), "A"), synthetic=True)))
    d["compute-dtype"] = "bfloat16"
    cfg = load_config_dict(d)
    ds = WindowDataset(cfg.datasets, [SyntheticDrive(n_frames=9,
                                                     max_points=N)])
    raw = batch_to_device(next(ds.iter_batches(4, shuffle=False)), card)
    state = create_train_state(cfg, build_model(cfg, device=card, seed=0))
    train_step, _ = build_train_step(cfg)
    losses = []
    for _ in range(20):
        state, m = train_step(state, raw)
        losses.append(m["loss"])
    losses = [float(v) for v in losses]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# ------------------------------------------------------------ the stream

def test_stream_on_the_card_in_bfloat16_and_float32(card, no_tf32):
    """``configs/deeplio_kitti_tpu.yaml`` at full width, 8 synthetic ring
    frames streamed: one ring selection, prologue and epilogue a frame,
    finite poses, the first tick the identity; bfloat16 within 5% of the
    largest motion of the float32 run on the card; the float32 model on
    the card against the CPU on one frame pair, within 1e-3, the
    projectors differing in at most 1e-3 of the pixels."""
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry
    from deeplio_tpu_torch.models.zoo import build_model
    cfg = load_config(CONFIGS / "deeplio_kitti_tpu.yaml")
    proj = cfg.datasets.projection
    drive = SyntheticDrive(n_frames=8, max_points=proj.max_points, seed=0,
                           world_points=300_000, rings=proj.height)
    so = StreamingOdometry(cfg, build_model(cfg, device=card, seed=0),
                           chunk=8, device=card)
    with Launches() as counted:
        poses, dx, dq = so.run(drive)
    assert counted.n == _want(cfg, "ring", 8)
    assert all(np.isfinite(a).all() for a in (poses, dx, dq))
    np.testing.assert_array_equal(poses[0], np.eye(4, dtype=np.float32))
    assert not dx[0].any() and np.array_equal(dq[0], [1, 0, 0, 0])

    cfg32 = load_config_dict({**_load("deeplio_kitti_tpu.yaml"),
                              "compute-dtype": "float32"})
    model32 = build_model(cfg32, device=card, seed=0)
    _, dx32, dq32 = StreamingOdometry(cfg32, model32, chunk=8,
                                      device=card).run(drive)
    for a, b in ((dx, dx32), (dq, dq32)):
        assert np.abs(a - b).max() <= 0.05 * np.abs(b).max()

    fn = so.projector
    cpu = [fn(torch.from_numpy(p)[None], torch.from_numpy(v)[None])
           for p, v in (drive.points(0), drive.points(1))]
    p1, v1 = drive.points(1)
    img, mask = fn(torch.from_numpy(p1)[None].to(card),
                   torch.from_numpy(v1)[None].to(card))
    flips = int((img.cpu() != cpu[1][0]).any(-1).sum()
                + (mask.cpu() != cpu[1][1]).sum())
    assert flips <= 1e-3 * proj.height * proj.width
    imu = np.asarray(drive.imu_between(drive.frame_time(0),
                                       drive.frame_time(1)), np.float32)
    imu = torch.from_numpy(imu[None, None, :16])
    batch = {"images": torch.cat([cpu[0][0][0], cpu[1][0][0]],
                                 -1)[None, None],
             "imu": imu, "imu_mask": torch.ones(imu.shape[:3])}
    model_cpu = build_model(cfg32, device="cpu", seed=0)
    with torch.no_grad():
        xc, qc = model_cpu(batch)
        xg, qg = model32({k: v.to(card) for k, v in batch.items()})
    for g, c in ((xg, xc), (qg, qc)):
        assert float((g.cpu() - c).abs().max()) <= 1e-3 * float(
            c.abs().max())


# ------------------------------------------------ the KITTI loop's routes

def test_fit_replays_the_step_graph_on_the_card(tree, tmp_path):
    """``Trainer.fit`` for 2 epochs on the tree: the first step eager,
    the second captured, every later one a replay of its graph."""
    from deeplio_tpu_torch.train import Trainer
    cfg = load_config_dict(_kitti_tpu(tree))
    trainer = Trainer(cfg, workdir=str(tmp_path), device="cuda")
    try:
        spe = trainer.train_ds.steps_per_epoch(cfg.train.batch_size)
        trainer.fit(epochs=2)
        assert trainer.step == 2 * spe
        assert trainer.train_step.graph_counts() == {
            "captures": 1, "replays": 2 * spe - 1, "eager": 1}
    finally:
        trainer.close()


def test_cached_fit_on_the_card_launches_no_kernel(tree, tmp_path):
    """``cache-projections: true``: the prefill projects every frame
    through the ring kernel once, then the fit's steps and validations
    read the cached images and launch nothing."""
    from deeplio_tpu_torch.train import Trainer
    d = _kitti_tpu(tree)
    d["train"]["cache-projections"] = True
    cfg = load_config_dict(d)
    with Launches() as prefill:
        trainer = Trainer(cfg, workdir=str(tmp_path), device="cuda")
    try:
        assert prefill.n["ring"] > 0
        with Launches() as counted:
            trainer.fit(epochs=1)
        spe = trainer.train_ds.steps_per_epoch(cfg.train.batch_size)
        assert trainer.step == spe
    finally:
        trainer.close()
    assert counted.n == _want(cfg, None, 0)
    assert all(np.isfinite(r["loss"]) for r in _records(tmp_path))


SYNTH_FILES = ("deepio_synth.yaml", "deeplo_synth.yaml", "deeplio_synth.yaml",
               "deeplio_synth_gen.yaml", "deeplio_synth_gen2.yaml",
               "deeplio_synth_gen2_packed.yaml")


@pytest.mark.parametrize("name", SYNTH_FILES)
def test_synthetic_file_fits_on_the_card(name, card, tmp_path):
    """Each synthetic file as shipped, its drives cut to 2 of 10 frames
    and one validation drive: one epoch through ``Trainer.fit``, one
    scatter selection a step and a validation batch (none for DeepIO);
    ``deeplo_synth.yaml`` then streamed by ``cli.stream`` with no IMU
    input, one selection a tick."""
    from deeplio_tpu_torch.cli import stream as stream_cli
    from deeplio_tpu_torch.train import Trainer
    d = _load(name)
    d["datasets"].update({"synthetic-frames": 10,
                          "synthetic-eval-frames": 10,
                          "synthetic-train-drives": 2,
                          "synthetic-eval-drives": 1})
    d["train"].update({"log-every": 1, "checkpoint-every-steps": 0})
    cfg_path = _write(d, tmp_path / name)
    cfg = load_config(cfg_path)
    wd = tmp_path / "run"
    trainer = Trainer(cfg, workdir=str(wd), device="cuda")
    try:
        bs = cfg.train.batch_size
        spe = trainer.train_ds.steps_per_epoch(bs)
        n_val = len(trainer.val_ds) // bs
        with Launches() as counted:
            trainer.fit(epochs=1)
        assert trainer.step == spe
    finally:
        trainer.close()
    kernel = "scatter" if cfg.model.uses_lidar else None
    assert counted.n == _want(cfg, kernel, spe + n_val)
    assert all(np.isfinite(r["loss"]) for r in _records(wd))
    if name == "deeplo_synth.yaml":
        with Launches() as counted:
            scores = stream_cli.main(["-c", cfg_path, "--workdir", str(wd),
                                      "--device", "cuda"])
        ((_, s),) = scores.items()
        assert counted.n == _want(cfg, "scatter", s["frames"])
        assert np.isfinite(s["ate_m"])


# ------------------------------------------------ the projection's routes

def test_every_backend_projects_with_one_launch(card):
    """``make_projector`` on each backend with the normals channel at
    16x128 on 6 ring scans: one selection a projection, of its kernel;
    ``ring`` packed bit for bit the ``pallas-ring`` projector's result;
    the image finite."""
    from deeplio_tpu_torch.config.schema import ProjectionConfig
    from deeplio_tpu_torch.ops.projection import make_projector
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(synthetic_ring_batch(rng, 6, N, rings=H)).to(card)
    planes = [pts[..., c].contiguous() for c in range(4)]
    valid = torch.from_numpy(rng.uniform(size=(6, N)) >= 0.1).to(card)
    chans = ("x", "y", "z", "remission", "depth", "normals")
    outs = {}
    for backend, packed, kernel in (("ring", False, "ring"),
                                    ("ring", True, "ring"),
                                    ("pallas-ring", True, "ring"),
                                    ("pallas", True, "scatter"),
                                    ("sort", False, "scatter"),
                                    ("sort-sentinel", False, "scatter"),
                                    ("sort-sentinel", True, "scatter")):
        proj = ProjectionConfig(height=H, width=W, max_points=N,
                                packed=packed, backend=backend)
        fn = make_projector(proj, chans, layout="planes")
        with Launches() as counted:
            outs[backend, packed] = fn(planes, valid)
        n = counted.n
        assert (n["ring"], n["scatter"]) == (
            (1, 0) if kernel == "ring" else (0, 1)), (backend, packed)
        img = outs[backend, packed][0]
        assert img.shape == (6, H, W, 8) and bool(torch.isfinite(img).all())
    assert _bits_equal(outs["ring", True], outs["pallas-ring", True])


def _io_edge_scans(rng, n=131072):
    """Eight full-width ring scans, one edge case each: a pure invalid
    tail, interleaved invalid points, every point invalid, a NaN
    remission on valid points, ranges past the key ceiling (and 1e20 m),
    ranges of 0 and at or below 1e-6, a scan in no order, and points
    that are NaN where invalid."""
    pts = synthetic_ring_batch(rng, 8, n)
    valid = np.ones((8, n), bool)
    valid[0, n * 5 // 8:] = False
    valid[1] = rng.uniform(size=n) >= 0.3
    valid[2] = False
    pts[3, ::97, 3] = np.nan
    pts[4, ::50, :3] *= np.float32(5e3)
    pts[4, 7, :3] = np.float32(1e20)
    pts[5, ::31, :3] = 0.0
    pts[5, 5::31, :3] = np.float32(3e-7)
    pts[6] = pts[6, rng.permutation(n)]
    valid[7, ::7] = False
    pts[7, ~valid[7]] = np.nan
    return pts, valid


@pytest.mark.parametrize("route", ["ring", "scatter"])
def test_proj_io_on_full_width_edge_cases(card, route):
    """The prologue and epilogue kernels on eight full-width edge scans
    (64x1024, 131072 points), as planes and as strided [B, N, 4] views,
    bit for bit as integers against their plain versions, the epilogue
    in the 5-channel float32 image and in the kitti-tpu file's normalised
    channels in bfloat16, float16 and float32; the all-invalid scan
    selects nothing."""
    h, w = 64, 1024
    cfg = load_config(CONFIGS / "deeplio_kitti_tpu.yaml")
    ds = cfg.datasets
    forms = [tio.epilogue_form(("x", "y", "z", "remission", "depth"))] + [
        tio.epilogue_form(ds.channels, ds.mean, ds.std, dt)
        for dt in (torch.bfloat16, torch.float16, torch.float32)]
    pts, valid = _io_edge_scans(np.random.default_rng(12))
    p = torch.from_numpy(pts).to(card)
    v = torch.from_numpy(valid).to(card)
    n = pts.shape[1]
    for planes in ([p[..., c].contiguous() for c in range(4)],
                   [p[..., c] for c in range(4)]):
        args = (*planes, v, h, w, 3.0, -25.0, route)
        got = tio.proj_prologue(*args)
        want = tio.proj_prologue_reference(*args)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            assert g.shape == r.shape and torch.equal(g, r)
        if route == "ring":
            sel = tring.ring_select(*got, h * w)
            empty = tring.SENTINEL
        else:
            sel = tsc.scatter_select(*got[1:], h * w,
                                     tsc.rq_bits_for(h * w))
            empty = tsc.SENTINEL
        assert bool((sel[0][2] == empty).all())
        for form in forms:
            eargs = (*sel, n, h, w, route, form["channels"], form["mean"],
                     form["std"], form["out_dtype"])
            gi, gm = tio.proj_epilogue(*eargs)
            wi, wm = tio.proj_epilogue_reference(*eargs)
            torch.cuda.synchronize()
            assert gi.dtype == wi.dtype and gi.shape == wi.shape
            assert torch.equal(_int_bits(gi), _int_bits(wi))
            assert torch.equal(_int_bits(gm), _int_bits(wm))


# --------------------------------------------------- data parallelism

def _dp_f32_dict(**datasets):
    """The kitti-tpu file at 16x128 on synthetic drives, ``backend:
    pallas`` (the scatter kernel), float32, no augmentation, no dropout,
    SGD: the data-parallel and the mesh-less updates then compare element
    by element."""
    d = _f32(_cut(_load("deeplio_kitti_tpu.yaml"), backend="pallas",
                  **datasets))
    d["optimizer"] = dict(DP_SGD)
    return d


def _dp_batch(cfg):
    """4 windows of 3 frames of one synthetic drive."""
    from deeplio_tpu_torch.data.dataset import WindowDataset
    from deeplio_tpu_torch.data.drives import SyntheticDrive
    ds = WindowDataset(cfg.datasets, [SyntheticDrive(n_frames=9,
                                                     max_points=N)])
    return next(ds.iter_batches(4, shuffle=False))


def _step_result(cfg, model, host, dev, mesh=None):
    """One step of ``model`` (moved to ``dev``) on ``host``: its metrics,
    sx/sq after it and the variables."""
    from deeplio_tpu_torch.parallel import shard_batch
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    state = create_train_state(cfg, model.to(dev), mesh=mesh)
    train_step, _ = build_train_step(cfg, mesh)
    rows = host if mesh is None else shard_batch(mesh, host)
    state, m = train_step(state, batch_to_device(rows, dev))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "loss_params": {k: float(v)
                            for k, v in state.loss_params.items()},
            "variables": _variables(state.model)}


def _assert_dp_close(got, want, old):
    for k, w in want["metrics"].items():
        if k in ("loss", "loss_x", "loss_q"):
            assert abs(got["metrics"][k] - w) <= DP_LOSS_RTOL * abs(w), k
    for k, w in want["loss_params"].items():
        assert abs(got["loss_params"][k] - w) <= DP_LOSS_RTOL * abs(w), k
    g, w = got["variables"], want["variables"]
    assert _stats_gap(g, w) <= DP_STATS_RTOL
    params = sorted(k for k in w if k.startswith("params/"))
    du = np.concatenate([(g[k] - old[k]).ravel() for k in params])
    dw = np.concatenate([(w[k] - old[k]).ravel() for k in params])
    assert float(np.abs(du - dw).max() / np.abs(dw).max()) <= DP_UPDATE_MAX
    assert float(np.linalg.norm(du - dw) / np.linalg.norm(dw)) <= \
        DP_UPDATE_L2


def test_data_parallel_world_one_over_nccl(card, no_tf32, monkeypatch):
    """NCCL at world 1 through the data-parallel path (DDP, BatchNorm
    synchronised over the group): three bfloat16 steps of the kitti-tpu
    file on ``pallas``, one scatter selection, prologue and epilogue a
    step, the first selection bit-equal to the plain version; a float32
    SGD step against the mesh-less step on the same weights within the
    DP tolerances."""
    import torch.distributed as dist

    from deeplio_tpu_torch.models.zoo import build_model
    from deeplio_tpu_torch.parallel import make_mesh, maybe_initialize
    from deeplio_tpu_torch.train.state import create_train_state
    from deeplio_tpu_torch.train.step import batch_to_device, build_train_step
    from tests._torch_dp import free_port
    maybe_initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(device=card)
        assert mesh.group is not None and mesh.data == 1
        d = _cut(_load("deeplio_kitti_tpu.yaml"), backend="pallas")
        cfg = load_config_dict(d)
        raw = batch_to_device(_dp_batch(cfg), card)
        state = create_train_state(
            cfg, build_model(cfg, device=card, seed=0), mesh=mesh)
        train_step, _ = build_train_step(cfg, mesh)
        spy = _spy(monkeypatch, "scatter")
        with Launches() as counted:
            for _ in range(3):
                state, m = train_step(state, raw)
                assert bool(torch.isfinite(m["loss"]))
        monkeypatch.undo()
        assert counted.n == _want(cfg, "scatter", 3)
        assert spy.first[0][0].shape[0] == raw["points_valid"].shape[0]
        assert spy.held(PLAIN["scatter"])

        cfg = load_config_dict(_dp_f32_dict())
        base = build_model(cfg, device="cpu", seed=0)
        old = _variables(base)
        host = _dp_batch(cfg)
        want = _step_result(cfg, copy.deepcopy(base), host, card)
        got = _step_result(cfg, copy.deepcopy(base), host, card, mesh)
        _assert_dp_close(got, want, old)
    finally:
        dist.destroy_process_group()


def test_data_parallel_two_gloo_ranks_on_the_card(tree, no_tf32, tmp_path):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    GPU): the float32 SGD step on each rank's rows, one scatter selection
    a rank and bit-equal to the plain version, the ranks' states equal to
    each other and within the DP tolerances of the mesh-less step; then
    ``Trainer.fit(epochs=1)`` at world 2 on the tree, one ring selection
    a step and a validation batch a rank, its metrics, checkpoint,
    ``best/`` and ``trainer_meta.json`` written once, by rank 0."""
    from deeplio_tpu_torch.models.zoo import build_model
    from tests._torch_dp import card_rank, run_ranks
    d = _dp_f32_dict()
    cfg = load_config_dict(d)
    base = build_model(cfg, device="cpu", seed=0)
    old = _variables(base)
    host = _dp_batch(cfg)
    want = _step_result(cfg, copy.deepcopy(base), host, "cuda")
    tree_d = _kitti_tpu(tree)
    tree_d["train"]["batch-size"] = 4           # 2 windows a rank
    wd = tmp_path / "dp_fit"
    ranks = run_ranks(card_rank, 2, d, host, tree_d, str(wd), timeout=600.0)
    for r in ranks:
        assert r["f32_launches"] == {"ring": 0, "scatter": 1,
                                     "prologue": 1, "epilogue": 1}
        assert r["f32_held"] and r["f32_b"] == 2 * 3
        assert r["fit_world"] == 2 and r["fit_launches"] == _want(
            load_config_dict(tree_d), "ring", r["fit_steps"] + 1)
    for k, v in ranks[1]["variables"].items():
        np.testing.assert_array_equal(v, ranks[0]["variables"][k])
    assert ranks[1]["metrics"] == ranks[0]["metrics"]
    _assert_dp_close(ranks[0], want, old)
    recs = _records(wd)
    steps = [r["step"] for r in recs if r["split"] == "train"]
    assert steps == list(range(1, ranks[0]["fit_steps"] + 1))
    assert [r["split"] for r in recs].count("val") == 1
    labels = sorted(int(p.name) for p in (wd / "checkpoints").iterdir())
    assert labels and labels[-1] == steps[-1]
    assert (wd / "best" / "params.pt").exists()
    assert (wd / "trainer_meta.json").exists()
    assert not list(wd.rglob("*.tmp.*"))
