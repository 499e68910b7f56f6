"""The port's ``lidar-feat-rangevit`` tower (RangeViT's convolutional stem
and ViT encoder, ``deeplio_tpu_torch/models/rangevit.py``) against the
benchmark's plain reference ``portbench/reference/rangevit.py``, on the
CPU in float32 (float64 for the gradients) with seeded random weights, at
a small size: an 8x64 image, 2x8 patches (4x8 tokens and the class
token), 48 wide, 2 heads, 2 blocks, stem widths 8 and 16. The forward in
both modes, the tower's gradients, one training step, the drop-path
masks and their order, the token grid's layout, the schema's checks;
then ``configs/torch/deeplio_rangevit.yaml`` as shipped, one DeepLO step,
one eval step and one streaming tick through the port's entry points.

The JAX package has no RangeViT tower, so the reference is plain
PyTorch, written from the paper's equations and not from the port.
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
from deeplio_tpu_torch.models.rangevit import drop_path  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import (  # noqa: E402
    batch_to_device,
    build_train_step,
)
from deeplio_tpu_torch.utils.timing import recording  # noqa: E402

from portbench.reference import loss as rloss  # noqa: E402
from portbench.reference import rangevit as ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANGEVIT = ROOT / "configs" / "torch" / "deeplio_rangevit.yaml"
B, P, H, W, T = 2, 2, 8, 64, 16
SMALL = {"embed-dim": 48, "heads": 2, "depth": 2, "stem-width": 8,
         "stem-hidden": 16}


def _dict(h=H, w=W, arch="deeplio", **vit):
    with open(RANGEVIT) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": h, "image-width": w,
                          "max-points": 1024})
    d["lidar-feat-rangevit"].update(SMALL, **vit)
    if arch != "deeplio":
        d["arch"] = arch
        d[arch] = {k: v for k, v in d.pop("deeplio").items()
                   if k not in ("imu-feat-net", "fusion-net")}
    return d


@pytest.fixture(scope="module")
def pair():
    """The port's DeepLIO at the small size (drop-path 0.1 at the last
    block, the heads' dropout 0.25) and the reference holding the same
    weights."""
    d = _dict()
    port = build_model(load_config_dict(d), device="cpu", seed=3)
    plain = ref.DeepLIO(ref.model_spec(d))
    plain.load_state_dict(port.state_dict(), strict=True)
    return load_config_dict(d), port, plain


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"images": torch.randn(B, P, H, W, 10, generator=g),
            "imu": torch.randn(B, P, T, 6, generator=g),
            "imu_mask": (torch.rand(B, P, T, generator=g) > 0.2).float(),
            "x_gt": torch.randn(B, P, 3, generator=g),
            "q_gt": torch.randn(B, P, 4, generator=g)}


def test_published_widths_and_init():
    """The shipped configuration builds ViT-S over 4,097 tokens: 27.89 M
    parameters in the model, 24.16 M in the tower's stem and encoder
    (1.29 M in the stem); the position embedding, class token and the
    encoder's Linears drawn at std 0.02, the Linears' biases zero, the
    LayerNorms unit."""
    model = build_model(load_config(RANGEVIT), device="cpu", seed=0)
    vit = model.lidar_feat.rangevit
    count = sum(p.numel() for p in model.parameters())
    assert count == 27_887_463
    assert sum(p.numel() for p in vit.parameters()) == 24_158_816
    assert sum(p.numel() for p in vit.stem.parameters()) == 1_290_848
    assert vit.pos_embed.shape == (1, 4097, 384) and vit.depth == 12
    blk = vit.Block_11
    assert blk.attn.heads == 6 and blk.mlp.fc1.out_features == 1536
    assert blk.rate == pytest.approx(0.1) and vit.Block_0.rate == 0.0
    for t in (vit.pos_embed, blk.attn.qkv.weight, blk.mlp.fc2.weight):
        assert abs(float(t.detach().std()) - 0.02) < 0.002
    assert float(vit.cls_token.detach().abs().max()) > 0.0
    assert float(blk.attn.qkv.bias.detach().abs().max()) == 0.0
    assert torch.equal(vit.norm.weight, torch.ones(384))


@pytest.mark.parametrize("training", [False, True])
def test_forward_matches_reference(pair, training):
    """The forward in eval mode and in training mode (batch statistics,
    drop-path and dropout drawn from generators seeded alike), port
    against reference in float32. Tolerance: 1e-5 of the output's scale;
    the two differ in the order of float32 sums (the fused attention
    against the written-out softmax, PyTorch's LayerNorm and BatchNorm
    against ``var_mean``), ~1e-6 measured."""
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
        assert torch.allclose(a, b, rtol=0, atol=1e-5 * b.abs().max()), \
            (a - b).abs().max()
    # the same draws, in the same order, from both generators
    assert torch.equal(g1.get_state(), g2.get_state())


def test_tower_gradients_match_reference_in_float64(pair):
    """The tower alone in training mode (drop-path raised to 0.5 so that
    it drops), port and reference both in float64 and with every
    recomputation of the reference on: the output and every leaf's
    gradient of a fixed random projection of it, to 1e-9 of the leaf's
    largest magnitude (float64 rounding), the masks drawn alike."""
    _, port, plain = pair
    tower = copy.deepcopy(port.lidar_feat).double().train()
    other = copy.deepcopy(plain.lidar_feat).double().train()
    for net in (tower.rangevit, other.rangevit):
        net.Block_1.rate = 0.5
    x = torch.randn(3, 10, H, W, generator=torch.Generator().manual_seed(4),
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
    reference's float32 step (its recomputation on, its loss, global-norm
    clip and Adam), with the same dropout and drop-path draws.
    Tolerances, from float32's rounding at this size: the loss 1e-5
    relative; each leaf's gradient 1e-3 of its largest magnitude (the
    early BatchNorms normalise 128 values a channel); the parameters
    after the update equal to the reference's clip (10) and Adam (lr
    5e-4) applied to the port's own gradients, to 1e-6 (float32 rounding
    of a 5e-4 step)."""
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
    port_grads = [p.grad.detach().clone() for p in state.optimizer.params]
    state.optimizer.step(0)

    r = copy.deepcopy(plain).train()
    r.load_state_dict(start)
    sx = torch.tensor(0.0, requires_grad=True)
    sq = torch.tensor(-2.5, requires_grad=True)
    params = list(r.parameters()) + [sx, sq]
    x, q = r(mb["images"], mb["imu"], mb["imu_mask"],
             torch.Generator().manual_seed(11))
    want, _ = rloss.pose_loss(x, q, mb["x_gt"], mb["q_gt"], sx, sq)
    grads = torch.autograd.grad(want, params)
    assert abs(float(total.detach()) - float(want.detach())) <= \
        1e-5 * abs(float(want.detach()))
    for n, got, g in zip(names, port_grads, grads):
        gap = float((got - g).abs().max()) / max(float(g.abs().max()),
                                                 1e-30)
        assert gap <= 1e-3, (n, gap)
    # the update: clip and Adam on the port's own gradients
    with torch.no_grad():
        for (n, p) in r.named_parameters():
            p.copy_(start[n])
        sx.fill_(0.0)
        sq.fill_(-2.5)
    rloss.clip_(port_grads, 10.0)
    rloss.Adam(params, 5e-4).step(port_grads)
    got = dict(model.named_parameters())
    got.update({f"loss.{k}": v for k, v in state.loss_params.items()})
    for n, p in zip(names, params):
        gap = float((got[n].detach() - p.detach()).abs().max())
        assert gap <= 1e-6, (n, gap)


def test_drop_path_masks_and_their_order():
    """Drop-path: one draw a sample (a sample's whole branch kept, over
    the keep probability, or zero), the identity in eval mode or at rate
    0. The tower draws, from one generator, block 1's attention mask,
    then its MLP's, block by block (block 0, at rate 0, draws nothing),
    then the tower's dropout: the generator's state after a forward is
    that of those draws made by hand."""
    x = torch.randn(64, 5, 7) + 3.0
    got = drop_path(x, 0.5, True, torch.Generator().manual_seed(2))
    keep = torch.bernoulli(torch.full((64, 1, 1), 0.5),
                           generator=torch.Generator().manual_seed(2))
    assert torch.equal(got, torch.where(keep.bool(), x / 0.5,
                                        torch.zeros_like(x)))
    kept = got != 0
    assert torch.equal(kept, kept[:, :1, :1].expand_as(kept))
    assert 0 < int(kept[:, 0, 0].sum()) < 64
    assert drop_path(x, 0.5, False) is x and drop_path(x, 0.0, True) is x

    d = _dict(depth=3, dropout=0.2)
    tower = build_model(load_config_dict(d), device="cpu",
                        seed=0).lidar_feat.train()
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        tower(torch.randn(4, 10, H, W), g)
    want = torch.Generator().manual_seed(6)
    for blk in (tower.rangevit.Block_1, tower.rangevit.Block_2):
        for _ in ("attn", "mlp"):
            torch.bernoulli(torch.full((4, 1, 1), 1.0 - blk.rate),
                            generator=want)
    torch.bernoulli(torch.full((4, 512), 0.8), generator=want)
    assert torch.equal(g.get_state(), want.get_state())


def test_token_grid_layout_and_class_token_dropped():
    """The tokens are the stem's (H / 2) x (W / 8) grid in row-major
    order behind the class token, and the tail reads them back at their
    grid places without the class token: with the blocks' branches
    zeroed and the position embedding zero, the map the tail takes is the
    final LayerNorm of each stem pixel's channels, in place."""
    d = _dict(depth=1)
    model = build_model(load_config_dict(d), device="cpu", seed=0)
    vit = model.lidar_feat.rangevit
    assert vit.grid == (H // 2, W // 8)
    with torch.no_grad():
        for lin in (vit.Block_0.attn.proj, vit.Block_0.mlp.fc2):
            lin.weight.zero_()
            lin.bias.zero_()
        vit.pos_embed.zero_()
        vit.cls_token.fill_(100.0)
    x = torch.randn(3, 10, H, W)
    seen = {}
    model.lidar_feat.ConvBN_0.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("tail", args[0]))
    with torch.no_grad():
        stem = vit.stem(x)
        model.lidar_feat(x)
    assert stem.shape == (3, 48, H // 2, W // 8)
    want = torch.nn.functional.layer_norm(
        stem.permute(0, 2, 3, 1), (48,), eps=1e-6).permute(0, 3, 1, 2)
    assert seen["tail"].shape == want.shape
    assert torch.allclose(seen["tail"], want, atol=1e-5)


@pytest.mark.parametrize("key,value", [
    ("heads", 5), ("embed-dim", 0), ("patch", [3, 8]), ("patch", [2, 6]),
    ("patch", [2]), ("drop-path", 1.0), ("depth", 0)])
def test_schema_refuses_bad_sizes(key, value):
    """Heads that do not divide ``embed-dim``, a size below 1, a patch
    that does not divide the image (8x64) or is not two sizes, and a
    drop-path rate out of [0, 1) are ``ConfigError``."""
    d = _dict()
    d["lidar-feat-rangevit"][key] = value
    with pytest.raises(ConfigError):
        load_config_dict(d)


def test_shipped_config_loads():
    """``configs/torch/deeplio_rangevit.yaml`` as shipped is
    ``configs/torch/deeplio_darknet53.yaml`` with the tower swapped and
    batches of 16 windows."""
    cfg = load_config(RANGEVIT)
    dk = load_config(ROOT / "configs" / "torch" / "deeplio_darknet53.yaml")
    lc = cfg.model.lidar
    assert (lc.name, lc.embed_dim, lc.depth, lc.heads, lc.mlp_ratio,
            lc.patch, lc.stem_width, lc.stem_hidden, lc.drop_path,
            lc.feature_size, lc.dropout) == (
        "lidar-feat-rangevit", 384, 12, 6, 4, (2, 8), 32, 256, 0.1, 512,
        0.0)
    assert cfg.datasets == dk.datasets and cfg.optim == dk.optim
    assert cfg.model.imu == dk.model.imu and cfg.model.odom == dk.model.odom
    assert cfg.loss == dk.loss
    assert (cfg.train.batch_size, dk.train.batch_size) == (16, 32)


@pytest.fixture(scope="module")
def small():
    """Synthetic windows of 3 frames at 8x64 (1024 points), batches of 2."""
    def make(arch):
        d = _dict(H, W, arch)
        d["datasets"].update({"sequence-size": 3, "window-stride": 2})
        cfg = load_config_dict(d)
        host = next(iter(WindowDataset(
            cfg.datasets, [SyntheticDrive(n_frames=7, max_points=1024)]
        ).iter_batches(2, shuffle=False)))
        return cfg, batch_to_device(host, "cpu")
    return make


def test_deeplo_step_trains_on_the_rangevit_tower(small):
    """A DeepLO training step through ``build_train_step``: finite loss,
    every encoder parameter moved, the stem and the encoder under their
    spans inside ``model.lidar``."""
    cfg, raw = small("deeplo")
    model = build_model(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.named_parameters()}
    state = create_train_state(cfg, model, seed=0)
    train_step, _ = build_train_step(cfg)
    with recording() as rec:
        state, metrics = train_step(state, raw)
    assert torch.isfinite(metrics["loss"])
    pairs = [(r.name, r.parent) for r in rec]
    assert ("model.lidar", "train.forward") in pairs
    assert ("lidar.stem", "model.lidar") in pairs
    assert ("lidar.encoder", "model.lidar") in pairs
    moved = [k for k, v in model.named_parameters()
             if "rangevit" in k and not torch.equal(v, before[k])]
    assert len(moved) == sum(1 for k in before if "rangevit" in k)


def test_eval_step_and_streaming_tick(pair, small):
    """The DeepLIO eval step and one streaming tick on the tower."""
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
