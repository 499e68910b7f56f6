"""The port's PointSeg pretraining (``train/pretrain.py``) against the JAX
package's ``deeplio_tpu/train/pretrain.py``, float32 on the CPU.

* ``geometric_labels`` bit for bit and ``masked_xent`` within 1e-5 of its
  value (against a float64 reference the port's float32 loss is within
  1e-7 and XLA's within 5e-6: its sum over 4096 pixels rounds more);
* the label image: the port's one scatter projection with each point's
  premapped label in the remission word against JAX's second pass,
  ``project_batch(packed=False)`` with the raw label in the remission
  slot and its rules applied after, bit for bit, with raw ids >= 2048 and
  0xFFFF, with and without a label map. The clouds put every point within
  a quarter pixel of a pixel's centre, so no trig ulp moves a point across
  a pixel boundary, and hold B x N = 2048 points, one chunk of PyTorch's
  CPU ``sqrt`` (ROADMAP.md Queue 3);
* the scans drawn: the same (drive, frame) sequence as JAX's
  ``pretrain_pointseg`` for a seed, the batch JAX draws for its init
  included (JAX's net, projector and checkpoint stubbed, so nothing big
  compiles);
* one step against JAX's step rebuilt from ``PointSegNet``,
  ``masked_xent`` and ``optax.adam`` on the same inputs and weights, two
  intra-op threads (measured: loss 5.5e-6, gradients 5.2e-6 of the
  largest, update 1.2e-4 element-wise and 1.7e-5 in L2): the loss within
  3e-5 of its magnitude (XLA's float32 sum alone is 5e-6 off, above),
  the accuracy within 2 pixels, the BatchNorm statistics within 1e-5 of
  each leaf's largest magnitude, every gradient within 1e-4 of the
  largest, and Adam's first update, which keeps each gradient's sign,
  element-wise within 1e-3 of its largest magnitude where ``|g| >= 1e-3``
  of the largest gradient (as ``tests/test_torch_train.py``) and in L2
  within 1% over all elements;
* ``pretrain_pointseg`` end to end on a ring-ordered devkit tree with
  label files, its snapshot grafted by ``load_pointseg_backbone``;
* exact-z geometric labels (``packed: false`` without labels) bit for
  bit against JAX's, and one step with them; the refusal of missing
  label files.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from deeplio_tpu.models import pointseg as jps
from deeplio_tpu.ops import projection as jproj
from deeplio_tpu.train import pretrain as jpre
from deeplio_tpu_torch.bench.kitti_tree import DATE, make_tree, write_labels
from deeplio_tpu_torch.config import ConfigError
from deeplio_tpu_torch.config import load_config_dict as port_config
from deeplio_tpu_torch.data import dataset as tdataset
from deeplio_tpu_torch.data.drives import SyntheticDrive
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.models.from_flax import to_flax_variables
from deeplio_tpu_torch.models.zoo import build_model, init_parameters
from deeplio_tpu_torch.ops import projection_scatter as tsc
from deeplio_tpu_torch.train import pretrain as tpre
from deeplio_tpu_torch.train.checkpoint import load_pointseg_backbone

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
H, W, FU, FD = 16, 128, 3.0, -25.0
B, N = 2, 1024
XENT_TOL = 1e-5
LOSS_TOL, STATS_TOL, GRAD_TOL = 3e-5, 1e-5, 1e-4
ACC_PIXELS = 2
UPDATE_TOL, G_FLOOR, UPDATE_L2 = 1e-3, 1e-3, 0.01
RAW_IDS = np.array([0, 1, 10, 40, 44, 50, 70, 252, 2047, 2048, 2049, 3000,
                    40000, 0xFFFF], np.int64)
# raw -> train ids; 3000 -> 9 is past the 8 classes, so it is clipped
LABEL_MAP = {10: 1, 40: 2, 44: 2, 48: 3, 50: 4, 70: 5, 252: 6, 2049: 7,
             3000: 9, 0xFFFF: 3}


def slice_dict(**datasets):
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": N, **datasets})
    return d


# ------------------------------------------------------ labels and loss

def test_geometric_labels_match_jax():
    rng = np.random.default_rng(0)
    img5 = rng.normal(-1.2, 0.5, (B, H, W, 5)).astype(np.float32)
    img5[0, 0, :4, 2] = [-1.2, np.nextafter(np.float32(-1.2), -2),
                         np.nextafter(np.float32(-1.2), 0), 0.0]
    mask = (rng.uniform(size=(B, H, W)) > 0.3).astype(np.float32)
    want = np.asarray(jpre.geometric_labels(jnp.asarray(img5),
                                            jnp.asarray(mask)))
    got = tpre.geometric_labels(torch.from_numpy(img5),
                                torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2}


@pytest.mark.parametrize("k", [3, 20])
def test_masked_xent_matches_jax(k):
    rng = np.random.default_rng(k)
    logits = rng.normal(0, 3, (B, H, W, k)).astype(np.float32)
    labels = rng.integers(0, k, (B, H, W)).astype(np.int32)
    labels[:, :4] = 0
    want = float(jpre.masked_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  k))
    got = float(tpre.masked_xent(
        torch.from_numpy(logits.transpose(0, 3, 1, 2)),
        torch.from_numpy(labels).long(), k))
    assert abs(got - want) <= XENT_TOL * abs(want)


# ----------------------------------------------------------- label image

def _centred_cloud(seed):
    """B scans of N points, each within a quarter pixel of the centre of
    one of 600 pixels (several points a pixel, so winners matter), 10%
    invalid, 40 exact duplicates (ties to the smaller index), raw
    SemanticKITTI labels with instance ids in the high bits."""
    rng = np.random.default_rng(seed)
    pix = rng.choice(H * W, 600, replace=False)
    p = pix[rng.integers(0, 600, (B, N))]
    u = p % W + 0.5 + rng.uniform(-0.25, 0.25, (B, N))
    v = p // W + 0.5 + rng.uniform(-0.25, 0.25, (B, N))
    yaw = np.pi * (1.0 - 2.0 * u / W)
    fd, fov = np.deg2rad(FD), np.deg2rad(FU - FD)
    pitch = fd + fov * (1.0 - v / H)
    r = rng.uniform(2.0, 60.0, (B, N))
    pts = np.stack([r * np.cos(pitch) * np.cos(yaw),
                    r * np.cos(pitch) * np.sin(yaw), r * np.sin(pitch),
                    rng.uniform(0, 1, (B, N))], -1).astype(np.float32)
    src = rng.choice(N, 40, replace=False)
    dst = rng.choice(np.setdiff1d(np.arange(N), src), 40, replace=False)
    pts[:, dst, :3] = pts[:, src, :3]
    valid = rng.uniform(size=(B, N)) >= 0.1
    raw = RAW_IDS[rng.integers(0, RAW_IDS.size, (B, N))]
    inst = rng.integers(0, 1 << 16, (B, N))
    return pts, valid, ((raw | (inst << 16)) & 0xFFFF).astype(np.int32)


def _jax_label_image(pts, valid, labels, lut, k):
    """JAX ``pretrain_pointseg``'s label pass (train/pretrain.py:142-161):
    the host label map, the packed pass for the mask and the exact pass
    with the label in the remission slot."""
    if lut is not None:
        labels = lut[np.clip(labels, 0, (1 << 16) - 1)]
    p, v = jnp.asarray(pts), jnp.asarray(valid)
    _, mask5 = jproj.project_batch(p, v, H, W, FU, FD, packed=True)
    pts_lab = p.at[..., 3].set(jnp.asarray(labels).astype(p.dtype))
    imgl, _ = jproj.project_batch(pts_lab, v, H, W, FU, FD, packed=False)
    lab = jnp.round(imgl[..., 3]).astype(jnp.int32)
    lab = jnp.where(mask5 > 0.5, lab, 0)
    if lut is None:
        lab = jnp.where((lab >= 0) & (lab < k), lab, 0)
    else:
        lab = jnp.clip(lab, 0, k - 1)
    return np.asarray(lab)


@pytest.mark.parametrize("label_map,k", [(LABEL_MAP, 8), (None, 20)],
                         ids=["map", "raw-ids"])
def test_label_image_bit_equal_to_jax_two_pass(label_map, k):
    pts, valid, raw = _centred_cloud(k)
    lut = tpre.label_lut(label_map or {})
    lab = raw if lut is None else lut[np.clip(raw, 0, (1 << 16) - 1)]
    pre = tpre.premap_labels(lab, k, lut is not None)
    planes = [torch.from_numpy(np.ascontiguousarray(pts[..., c]))
              for c in range(4)]
    got = tpre.label_image(planes, torch.from_numpy(valid),
                           torch.from_numpy(pre), H, W, FU, FD).numpy()
    want = _jax_label_image(pts, valid, raw, lut, k)
    np.testing.assert_array_equal(got, want)
    assert (want != 0).sum() >= 100 and len(np.unique(want)) >= 3


def test_more_classes_than_float16_holds_raise():
    d = slice_dict(**{"labels-path": "/labels", "labels-num-classes": 3000})
    with pytest.raises(ConfigError, match="float16"):
        tpre.pretrain_pointseg(port_config(d), "/nowhere", steps=1,
                               device="cpu")


# ------------------------------------------------------ the scans drawn

class Recording:
    """A drive that logs each frame read, by name."""

    def __init__(self, inner, log):
        self.inner, self.log, self.name = inner, log, inner.name

    def __len__(self):
        return len(self.inner)

    def points(self, i):
        self.log.append((self.name, i))
        return self.inner.points(i)

    def points_planes(self, i):
        self.log.append((self.name, i))
        return self.inner.points_planes(i)


def test_scans_drawn_match_jax(monkeypatch, tmp_path):
    """Two steps of 3 scans from 3 drives of different lengths, seed 5:
    the init batch and both step batches, in JAX's order."""
    import flax.linen as fnn
    from deeplio_tpu.config import load_config_dict as jax_config
    from deeplio_tpu.data import dataset as jdataset
    from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive

    lengths = (4, 7, 5)
    jlog, plog = [], []
    monkeypatch.setattr(jdataset, "build_drives", lambda cfg, split: [
        Recording(JSyntheticDrive(n_frames=n, max_points=N, seed=s), jlog)
        for s, n in enumerate(lengths)])
    monkeypatch.setattr(tdataset, "build_drives", lambda cfg, split: [
        Recording(SyntheticDrive(n_frames=n, max_points=N, seed=s), plog)
        for s, n in enumerate(lengths)])

    class Tiny(fnn.Module):    # stands in for JAX's PointSegNet
        num_classes: int = 3

        @fnn.compact
        def __call__(self, x, train=True):
            x = fnn.BatchNorm(use_running_average=not train)(x[..., :1])
            return fnn.Dense(self.num_classes, name="encoder")(x)

    monkeypatch.setattr(jpre, "PointSegNet", lambda **kw: Tiny())
    monkeypatch.setattr(jpre, "make_projector", lambda *a, **k: (
        lambda p, v: (jnp.zeros(p.shape[:1] + (H, W, 5)),
                      jnp.zeros(p.shape[:1] + (H, W)))))
    monkeypatch.setattr(jpre, "project_batch", lambda p, v, *a, **k: (
        jnp.zeros(p.shape[:1] + (H, W, 5)), jnp.zeros(p.shape[:1] + (H, W))))
    monkeypatch.setattr(jpre, "save_params", lambda *a, **k: None)
    d = slice_dict(synthetic=True)
    jpre.pretrain_pointseg(jax_config(d), str(tmp_path / "j"), steps=2,
                           batch_size=3, seed=5)
    tpre.pretrain_pointseg(port_config(d), str(tmp_path / "p"), steps=2,
                           batch_size=3, seed=5, device="cpu")
    assert len(jlog) == 9 and plog == jlog


# --------------------------------------------------------- one step

def _jax_step(cfg, k, lr):
    """JAX ``pretrain_pointseg``'s step (train/pretrain.py:169-185) on
    given inputs, with the gradients."""
    lc = cfg.model.lidar
    net = jps.PointSegNet(part="encoder+decoder", num_classes=k,
                          dtype=jnp.float32, with_se=lc.se,
                          h_stride=lc.h_stride, w_stride=lc.w_stride,
                          el_squeeze=lc.el_squeeze, pool="stride")
    tx = optax.adam(lr)

    @jax.jit
    def step(params, batch_stats, x, labels):
        def loss_fn(p):
            logits, mut = net.apply(
                {"params": p, "batch_stats": batch_stats}, x, train=True,
                mutable=["batch_stats"])
            return (jpre.masked_xent(logits, labels, k),
                    (mut["batch_stats"], logits))

        (loss, (stats, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(
            jnp.float32))
        return (optax.apply_updates(params, updates), stats, loss, acc,
                grads)

    return step


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_one_step_matches_jax():
    """The kitti-tpu tower (h2/w4, el-squeeze 128, SE) at 16x128 on two
    ring scans with geometric labels, lr 1e-3."""
    lr = 1e-3
    cfg = port_config(slice_dict())
    k = tpre.NUM_CLASSES
    model = tpre.build_pointseg(cfg, k)
    init_parameters(model, torch.Generator().manual_seed(0))
    v0 = to_flax_variables(model)
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=tpre.ADAM_EPS)
    step = tpre.build_pretrain_step(cfg, model, opt, k)
    pts = synthetic_ring_batch(np.random.default_rng(1), B, N, rings=H)
    batch = {k: torch.from_numpy(np.ascontiguousarray(pts[..., c]))
             for c, k in enumerate(tpre.PLANES)}
    batch["points_valid"] = torch.ones(B, N, dtype=torch.bool)
    x, target = tpre.build_inputs(cfg)(batch)
    loss, acc = step(batch)
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters()}

    x_nhwc = x.permute(0, 2, 3, 1).numpy()
    jnew, jstats, jloss, jacc, jgrads = _jax_step(cfg, k, lr)(
        v0["params"], v0["batch_stats"], jnp.asarray(x_nhwc),
        jnp.asarray(target.numpy().astype(np.int32)))
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(acc) - float(jacc)) <= ACC_PIXELS / target.numel()

    v1 = to_flax_variables(model)
    have, want = _flat(v1["batch_stats"]), _flat(jstats)
    for name in want:
        scale = max(np.abs(want[name]).max(), 1e-6)
        assert np.abs(have[name] - want[name]).max() <= STATS_TOL * scale
    # the port's gradients in the flax layout
    for n, p in model.named_parameters():
        p.data.copy_(grads[n])
    g = _flat(to_flax_variables(model)["params"])
    jg = _flat(jgrads)
    old, new, jn = _flat(v0["params"]), _flat(v1["params"]), _flat(jnew)
    gmax = max(np.abs(a).max() for a in jg.values())
    du = np.concatenate([(new[n] - old[n]).ravel() for n in sorted(old)])
    jdu = np.concatenate([(jn[n] - old[n]).ravel() for n in sorted(old)])
    big = np.concatenate([(np.abs(jg[n]) >= G_FLOOR * gmax).ravel()
                          for n in sorted(old)])
    assert big.mean() > 0.05
    assert np.abs(du - jdu)[big].max() <= UPDATE_TOL * np.abs(jdu).max()
    assert np.linalg.norm(du - jdu) <= UPDATE_L2 * np.linalg.norm(jdu)
    for n in jg:
        assert np.abs(g[n] - jg[n]).max() <= GRAD_TOL * gmax, n


# ------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def labelled_tree(tmp_path_factory):
    """One ring-ordered drive of 6 frames of 1024 points with label
    files."""
    root = tmp_path_factory.mktemp("kitti_labels")
    make_tree(str(root), [27], n_frames=6, max_points=N, rings=H,
              world_points=4000)
    write_labels(str(root), str(root / "labels"), [27])
    return root


def labelled_dict(root, **datasets):
    return slice_dict(**{
        "kitti": {"root-path": str(root), "train": {DATE: [27]}},
        "labels-path": str(root / "labels"),
        "label-map": {40: 1, 50: 2}, "labels-num-classes": 3, **datasets})


def test_pretrain_end_to_end_and_graft(labelled_tree, tmp_path):
    cfg = port_config(labelled_dict(labelled_tree))
    out = tpre.pretrain_pointseg(cfg, str(tmp_path / "pre"), steps=2,
                                 batch_size=2, seed=0, device="cpu")
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 2
    assert out["loss"] == out["losses"][-1] and 0.0 <= out["acc"] <= 1.0
    saved = torch.load(tmp_path / "pre" / "params.pt", weights_only=True)
    assert saved and all(k.startswith("encoder.") for k in saved)

    model = build_model(cfg, device="cpu", seed=7)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pointseg_backbone(model, str(tmp_path / "pre"))
    after = model.state_dict()
    enc = "lidar_feat.pointseg.encoder."
    for k, v in saved.items():
        assert torch.equal(after[enc + k[len("encoder."):]], v)
    changed = [k for k in after if not torch.equal(after[k], before[k])]
    assert changed and all(k.startswith(enc) for k in changed)
    assert torch.equal(after["heads.q_out.bias"], before["heads.q_out.bias"])


def test_labels_path_without_files_raises(labelled_tree, tmp_path):
    cfg = port_config(labelled_dict(labelled_tree, **{
        "labels-path": str(tmp_path / "none")}))
    with pytest.raises(FileNotFoundError, match="no label file"):
        tpre.pretrain_pointseg(cfg, str(tmp_path / "pre"), steps=1,
                               batch_size=2, device="cpu")


def test_packed_false_without_labels_raises_naming_item_5(tmp_path,
                                                         monkeypatch):
    """``packed: false`` without ``labels-path`` now pretrains: the
    geometric labels read the winner's exact float32 z from
    ``project_batch(packed=False)`` (the scatter selection with index
    payloads), equal to JAX's bit for bit; with ``packed: true`` they
    read its float16 z, which moves points just above ``GROUND_Z`` to the
    ground (JAX's too). Then one step of ``pretrain_pointseg`` with
    exact-z labels, one selection with index payloads a step."""
    pts, valid, _ = _centred_cloud(3)
    # z just above GROUND_Z rounds below it in float16
    near = np.arange(0, N, 7)
    pts[:, near, 2] = np.float32(-1.19995)
    planes = [torch.from_numpy(np.ascontiguousarray(pts[..., c]))
              for c in range(4)]
    for packed in (False, True):
        got = tpre.label_image(planes, torch.from_numpy(valid), None, H, W,
                               FU, FD, packed=packed).numpy()
        want = np.asarray(jpre.geometric_labels(*jproj.project_batch(
            jnp.asarray(pts), jnp.asarray(valid), H, W, FU, FD,
            packed=packed)))
        np.testing.assert_array_equal(got, want)
        if packed:
            assert (got != exact).sum() >= 20
        else:
            exact = got
            assert set(np.unique(got)) == {0, 1, 2}

    calls = []
    select = tsc.scatter_select

    def spy(key, xy, zr, n_pix, rq_bits):
        calls.append(bool((xy == torch.arange(key.shape[1],
                                              dtype=torch.int32)).all()))
        return select(key, xy, zr, n_pix, rq_bits)

    monkeypatch.setattr(tsc, "scatter_select", spy)
    cfg = port_config(slice_dict(packed=False, synthetic=True,
                                 **{"synthetic-frames": 4}))
    out = tpre.pretrain_pointseg(cfg, str(tmp_path / "pre"), steps=1,
                                 batch_size=2, device="cpu")
    assert calls == [True] and np.isfinite(out["loss"])
    # with labels, packed does not matter: no refusal before the drives
    cfg = port_config(slice_dict(**{"packed": False, "synthetic": True,
                                    "labels-path": "/labels"}))
    with pytest.raises(FileNotFoundError):
        tpre.pretrain_pointseg(cfg, "/nowhere", steps=1, device="cpu")


def test_kitti_tree_label_files(labelled_tree, tmp_path):
    """``bench/kitti_tree.py``'s label writer: one uint32 a point of each
    ``.bin``; the semantic id follows z (40 below -1.2, 50 above) but on
    a few points (0, 3000, 0xFFFF); the tree's scans are the same bytes as
    a tree written without labels."""
    make_tree(str(tmp_path), [27], n_frames=6, max_points=N, rings=H,
              world_points=4000)
    base = "2011_10_03/2011_10_03_drive_0027_sync/velodyne_points/data"
    seen = set()
    for i in range(6):
        name = f"{i:010d}"
        raw = (labelled_tree / base / f"{name}.bin").read_bytes()
        assert raw == (tmp_path / base / f"{name}.bin").read_bytes()
        z = np.frombuffer(raw, np.float32).reshape(-1, 4)[:, 2]
        lab = np.fromfile(labelled_tree / "labels" / "2011_10_03_drive_0027"
                          / f"{name}.label", np.uint32)
        sem = lab & 0xFFFF
        assert lab.shape == z.shape and (lab >> 16).any()
        geo = np.isin(sem, (40, 50))
        assert geo.mean() > 0.9
        np.testing.assert_array_equal(sem[geo] == 40, z[geo] < -1.2)
        seen |= set(np.unique(sem).tolist())
    assert seen <= {0, 40, 50, 3000, 0xFFFF} and {0, 40, 50} <= seen
