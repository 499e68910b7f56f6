"""The port's ``lidar-feat-darknet`` tower (RangeNet++'s Darknet-53,
``deeplio_tpu_torch/models/darknet.py``) against the plain reference
``tests/reference_darknet.py``, on the CPU in float32, at Darknet-53's
published widths and a 4x64 image (the width's output stride of 32
leaves two columns): the forward, one training step (the loss, every
leaf's gradient, the parameters after Adam) and the channel dropout's
masks. Then the repository's configuration
``configs/torch/deeplio_darknet53.yaml`` as shipped, one DeepLO step, one
eval step and one streaming tick through the port's entry points, on
4x64 synthetic scans.

The JAX package has no Darknet tower, so the reference here is plain
PyTorch, written from lidar-bonnetal's ``darknet.py`` and not from the
port.
"""

import copy
import pathlib

import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config, load_config_dict  # noqa: E402
from deeplio_tpu_torch.config.schema import ConfigError  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models.darknet import channel_dropout  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from deeplio_tpu_torch.utils.timing import recording  # noqa: E402

from tests import reference_darknet as ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
DARKNET = ROOT / "configs" / "torch" / "deeplio_darknet53.yaml"
B, P, H, W, T = 2, 2, 4, 64, 16


def _dict(h=H, w=W, arch="deeplio"):
    with open(DARKNET) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": h, "image-width": w,
                          "max-points": 1024})
    if arch != "deeplio":
        d["arch"] = arch
        d[arch] = {k: v for k, v in d.pop("deeplio").items()
                   if k not in ("imu-feat-net", "fusion-net")}
    return d


@pytest.fixture(scope="module")
def pair():
    """The port's DeepLIO at the shipped widths (float32, 4x64) and the
    reference holding the same weights."""
    cfg = load_config_dict(_dict())
    port = build_model(cfg, device="cpu", seed=3)
    plain = ref.DeepLIO(5, 512, 53, 0.01, 0.0, 0.25)
    plain.load_state_dict(port.state_dict(), strict=True)
    return cfg, port, plain


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"images": torch.randn(B, P, H, W, 10, generator=g),
            "imu": torch.randn(B, P, T, 6, generator=g),
            "imu_mask": (torch.rand(B, P, T, generator=g) > 0.2).float(),
            "x_gt": torch.randn(B, P, 3, generator=g),
            "q_gt": torch.randn(B, P, 4, generator=g)}


def test_counts_and_published_shape(pair):
    """The shipped configuration builds Darknet-53 as published: 40.59 M
    parameters in the encoder, 45.79 M in the model; a 4x64 pair stack
    leaves [B * P, 1024, 4, 2] after the encoder."""
    _, port, plain = pair
    assert ref.param_count(plain) == {"all": 45_790_151,
                                      "darknet": 40_586_944}
    assert sum(p.numel() for p in port.parameters()) == 45_790_151
    x = torch.zeros(B * P, 10, H, W)
    with torch.no_grad():
        assert port.lidar_feat.darknet.eval()(x).shape == (B * P, 1024, H, 2)


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_reference(pair, training):
    """The forward in eval mode (running statistics) and in training mode
    (batch statistics, every dropout mask drawn from generators seeded
    alike). Tolerance: 2e-4 of the output's scale. The two compute the
    same float32 sums, the BatchNorm statistics in a different order
    (PyTorch's fused kernel against the reference's ``var_mean``); at 4x64
    the last stage normalises 4 x 2 x 4 values a channel, so those
    roundings grow through the 53 convolutions to ~1e-5 (measured)."""
    _, port, plain = pair
    mb = _batch()
    port.train(training)
    plain.train(training)
    sd = copy.deepcopy(port.state_dict())
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    with torch.no_grad():
        x1, q1 = port(mb, g1)
        x2, q2 = plain(mb["images"], mb["imu"], mb["imu_mask"], g2)
    port.load_state_dict(sd)
    plain.load_state_dict(sd)
    for a, b in ((x1, x2), (q1, q2)):
        assert torch.allclose(a, b, rtol=0, atol=2e-4 * b.abs().max()), \
            (a - b).abs().max()
    # the same draws, in the same order, from both generators
    assert torch.equal(g1.get_state(), g2.get_state())


def test_tower_gradients_match_reference_in_float64(pair):
    """The Darknet tower alone in training mode, port and reference both
    in float64 (the port's layers take any dtype): the output and every
    leaf's gradient of a fixed random projection of it to 1e-9 of the
    leaf's largest magnitude (float64 rounding through 57 BatchNorms),
    the masks drawn alike. In float32 this comparison is not sharp at
    4x64: the deep stages normalise 16 to 32 values a channel, and their
    backward amplifies rounding, so that the float32 gradients of the
    early leaves, port's and reference's alike, move by 0.5% to 34% of
    their magnitude with the thread count (measured, 1 to 3 threads);
    :func:`test_training_step_matches_reference` holds the float32 step
    to what that leaves."""
    _, port, plain = pair
    tower = copy.deepcopy(port.lidar_feat).double().train()
    other = copy.deepcopy(plain.lidar_feat).double().train()
    x = torch.randn(2, 10, H, W, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    outs, grads = [], []
    for net in (tower, other):
        out = net(x, torch.Generator().manual_seed(9))
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(5),
                        dtype=torch.float64)
        names, leaves = zip(*net.named_parameters())
        grads.append(dict(zip(names, torch.autograd.grad((out * w).sum(),
                                                         leaves))))
        outs.append(out.detach())
    assert torch.allclose(outs[0], outs[1], rtol=1e-9, atol=1e-12)
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[1].items():
        gap = float((grads[0][n] - g).abs().max())
        assert gap <= 1e-9 * max(float(g.abs().max()), 1e-30), (n, gap)


def test_training_step_matches_reference(pair):
    """One float32 training step through the port's trainables and
    optimizer (the pieces ``build_train_step`` runs) against the
    reference in float64 (its float32 gradients are as noisy as the
    port's at this size, :func:`test_tower_gradients_match_reference_in_float64`),
    with the same dropout draws. Tolerances, each from 1 to 3 threads'
    measurements: the loss 1e-5 relative (~1e-6); each gradient outside
    the Darknet encoder (the tail, LSTMs, fusion, heads, sx, sq) 1e-3 of
    its leaf's largest magnitude (up to 1.3e-4); the encoder's median
    leaf 0.1 (0.7e-4 to 2.4e-2, the early leaves' amplified rounding);
    the parameters after the update equal to the reference's global-norm
    clip (10) and Adam (lr 5e-4) applied in float64 to the port's own
    gradients, to 1e-6 (float32 rounding of a 5e-4 step); the BatchNorm
    running statistics 1e-4 relative (the port takes them in float32)."""
    cfg, port, plain = pair
    start = copy.deepcopy(port.state_dict())
    mb = _batch(1)
    model = copy.deepcopy(port)
    state = create_train_state(cfg, model, seed=5)
    total, _ = state.trainables.train()(mb, mb,
                                        torch.Generator().manual_seed(11))
    state.optimizer.zero_grad()
    total.backward()
    names = [k for k, _ in model.named_parameters()] + ["loss.sx",
                                                        "loss.sq"]
    port_grads = [p.grad.detach().double().clone()
                  for p in state.optimizer.params]
    state.optimizer.step(0)

    r = copy.deepcopy(plain).double().train()
    r.load_state_dict(start)
    sx = torch.tensor(0.0, dtype=torch.float64, requires_grad=True)
    sq = torch.tensor(-2.5, dtype=torch.float64, requires_grad=True)
    params = list(r.parameters()) + [sx, sq]
    x, q = r(mb["images"], mb["imu"], mb["imu_mask"],
             torch.Generator().manual_seed(11))
    want = ref.pose_loss(x, q, mb["x_gt"].double(), mb["q_gt"].double(),
                         sx, sq)
    grads = torch.autograd.grad(want, params)
    assert abs(float(total.detach()) - float(want.detach())) <= \
        1e-5 * abs(float(want.detach()))
    encoder = []
    for n, got, g in zip(names, port_grads, grads):
        gap = float((got - g).abs().max()) / max(float(g.abs().max()),
                                                 1e-30)
        if "darknet" in n:
            encoder.append(gap)
        else:
            assert gap <= 1e-3, (n, gap)
    assert sorted(encoder)[len(encoder) // 2] <= 0.1
    # the update: clip and Adam on the port's own gradients
    with torch.no_grad():
        for (n, p) in r.named_parameters():
            p.copy_(start[n])
        sx.fill_(0.0)
        sq.fill_(-2.5)
    ref.clip_(port_grads, 10.0)
    ref.Adam(params, 5e-4).step(port_grads)
    got = dict(model.named_parameters())
    got.update({f"loss.{k}": v for k, v in state.loss_params.items()})
    for n, p in zip(names, params):
        gap = float((got[n].detach().double() - p.detach()).abs().max())
        assert gap <= 1e-6, (n, gap)
    bufs = dict(model.named_buffers())
    for n, buf in r.named_buffers():
        if "running" in n:
            assert torch.allclose(bufs[n].double(), buf, rtol=1e-4,
                                  atol=1e-7), n


def test_channel_dropout_masks_match_reference():
    """``Dropout2d``'s masks: the same draws as the reference from one
    generator state, one a sample and channel (every pixel of a channel
    kept or dropped together), kept values over the keep probability;
    the identity in eval mode or at rate 0."""
    x = torch.randn(6, 40, 3, 5) + 3.0
    got = channel_dropout(x, 0.5, True, torch.Generator().manual_seed(2))
    want = ref.dropout2d(x, 0.5, True, torch.Generator().manual_seed(2))
    assert torch.equal(got, want)
    kept = got != 0
    assert torch.equal(kept, kept[:, :, :1, :1].expand_as(kept))
    assert 0 < int(kept[:, :, 0, 0].sum()) < 240
    assert torch.equal(got[kept], x[kept] / 0.5)
    assert channel_dropout(x, 0.5, False) is x
    assert channel_dropout(x, 0.0, True) is x


def test_shipped_config_loads_and_refuses_bad_keys():
    """``configs/torch/deeplio_darknet53.yaml`` as shipped is
    ``configs/deeplio_kitti.yaml`` with the tower swapped; a depth other
    than 21 or 53, or a rate out of [0, 1), is refused."""
    cfg = load_config(DARKNET)
    kitti = load_config(ROOT / "configs" / "deeplio_kitti.yaml")
    lc = cfg.model.lidar
    assert (lc.name, lc.layers, lc.feature_size, lc.stage_dropout,
            lc.dropout) == ("lidar-feat-darknet", 53, 512, 0.01, 0.0)
    assert cfg.datasets == kitti.datasets and cfg.optim == kitti.optim
    assert cfg.model.imu == kitti.model.imu
    assert cfg.model.odom == kitti.model.odom
    for key, value in (("layers", 50), ("stage-dropout", 1.0),
                       ("dropout", -0.1)):
        d = _dict()
        d["lidar-feat-darknet"][key] = value
        with pytest.raises(ConfigError):
            load_config_dict(d)


@pytest.fixture(scope="module")
def small():
    """Synthetic windows of 3 frames at 4x64 (1024 points), batches of 2."""
    def make(arch):
        d = _dict(H, W, arch)
        d["datasets"].update({"sequence-size": 3, "window-stride": 2})
        cfg = load_config_dict(d)
        host = next(iter(WindowDataset(
            cfg.datasets, [SyntheticDrive(n_frames=7, max_points=1024)]
        ).iter_batches(2, shuffle=False)))
        return cfg, batch_to_device(host, "cpu")
    return make


def test_deeplo_step_trains_on_the_darknet_tower(small):
    """A DeepLO training step through ``build_train_step``: finite loss,
    every encoder parameter moved, the tower under ``model.lidar``."""
    cfg, raw = small("deeplo")
    model = build_model(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.named_parameters()}
    state = create_train_state(cfg, model, seed=0)
    train_step, _ = build_train_step(cfg)
    with recording() as rec:
        state, metrics = train_step(state, raw)
    assert torch.isfinite(metrics["loss"])
    assert ("model.lidar", "train.forward") in [(r.name, r.parent)
                                                for r in rec]
    moved = [k for k, v in model.named_parameters()
             if "darknet" in k and not torch.equal(v, before[k])]
    assert len(moved) == sum(1 for k in before if "darknet" in k)


def test_eval_step_and_streaming_tick(pair, small):
    """The DeepLIO eval step and one streaming tick on the tower (the
    model of ``pair``: the window's keys do not change its widths)."""
    cfg, raw = small("deeplio")
    model = copy.deepcopy(pair[1])
    state = create_train_state(cfg, model, seed=0)
    _, eval_step = build_train_step(cfg)
    x, q, metrics = eval_step(state, raw)
    assert x.shape == raw["x_gt"].shape and torch.isfinite(metrics["loss"])
    so = StreamingOdometry(cfg, model, chunk=1, device="cpu")
    _, host = next(so.host_chunks(SyntheticDrive(n_frames=2,
                                                 max_points=1024)))
    carry = so.init_carry()
    with torch.no_grad():
        chunk = so.to_device(host)
        *carry, poses, dx, _ = so.step(*carry, *(chunk[k] for k in so.keys))
    assert poses.shape == (1, 4, 4) and torch.isfinite(poses).all()
