"""The port's projection cache against the JAX package's
(``tests/unit/test_proj_cache.py``, its single-process cases), on the CPU.

The tree: ``deeplio_tpu_torch/bench/kitti_tree.py``, two drives of 11
ring-ordered frames (16 rings, 2048 points), read at 16x128 with
``backend: pallas-ring``. JAX's prefill projects on the CPU through its
XLA ring twin (``make_projector`` picks it off the TPU), as
``tests/test_torch_projection.py::test_projector_matches_jax`` runs it, and
is held as that test holds it: pixels that differ are at most 0.1% of
pixels (atan2/asin ulps move a boundary point by one pixel), every other
pixel equal by value (the twin leaves -0.0 under empty pixels).

A training step on cached images against one on raw points, float32 on
the CPU, the same weights and windows: the loss and ``loss_x`` within
1e-4 of their magnitude and ``grad_norm`` within 1e-3 (the one-step
tolerances of ``tests/test_torch_train.py``); ``loss_q`` within 1e-2: the
cache stores f16, which rounds every image value by up to 2^-11 of it, and
``loss_q``, the squared quaternion residual (4e-4 of ``loss_x`` here),
magnifies the prediction's relative error (measured 1.1e-3).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data.dataset import build_drives as jax_build_drives  # noqa: E402
from deeplio_tpu.data.proj_cache import ProjectionCache as JaxCache  # noqa: E402
from deeplio_tpu.data.proj_cache import fingerprint as jax_fingerprint  # noqa: E402
from deeplio_tpu_torch.bench.kitti_tree import DATE, make_tree  # noqa: E402
from deeplio_tpu_torch.config import ConfigError  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data.dataset import WindowDataset, build_drives  # noqa: E402
from deeplio_tpu_torch.data.proj_cache import ProjectionCache, fingerprint  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402
from deeplio_tpu_torch.ops import projection as tproj  # noqa: E402
from deeplio_tpu_torch.train.state import create_train_state  # noqa: E402
from deeplio_tpu_torch.train.step import batch_to_device, build_train_step  # noqa: E402

from .test_torch_kitti import ROOT, kitti_dict  # noqa: E402

MAX_FLIP_FRACTION = 1e-3
FRAMES = 11


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_rings")
    make_tree(str(root), [27, 42], n_frames=FRAMES, max_points=2048,
              rings=16, world_points=6000)
    return str(root)


def cache_dict(root, **datasets):
    d = kitti_dict(root, {DATE: [27, 42]}, **datasets)
    d["compute-dtype"] = "float32"
    d["deeplio"]["dropout"] = 0.0
    return d


@pytest.fixture(scope="module")
def filled(tree, tmp_path_factory):
    """The port's and JAX's caches of both drives, chunks of 4 frames (the
    last of each drive padded)."""
    d = cache_dict(tree)
    cfg, ref = port_config(d), jax_config(d)
    drives = build_drives(cfg, "train")
    cache = ProjectionCache(str(tmp_path_factory.mktemp("port_cache")),
                            cfg.datasets, "cpu")
    cache.ensure(drives, batch=4)
    jdrives = jax_build_drives(ref, "train")
    jcache = JaxCache(str(tmp_path_factory.mktemp("jax_cache")),
                      ref.datasets)
    jcache.ensure(jdrives, batch=4)
    return cfg, drives, cache, jdrives, jcache


def test_fingerprint_matches_jax_and_follows_the_geometry(tree):
    with open(ROOT / "configs" / "deeplio_kitti_tpu.yaml") as f:
        shipped = yaml.safe_load(f)
    for d in (cache_dict(tree), shipped):
        cfg, ref = port_config(d), jax_config(d)
        assert fingerprint(cfg.datasets) == jax_fingerprint(ref.datasets)
    cfg = port_config(cache_dict(tree)).datasets
    wider = dataclasses.replace(
        cfg, projection=dataclasses.replace(cfg.projection, width=256))
    assert fingerprint(cfg) != fingerprint(wider)
    assert fingerprint(cfg) != fingerprint(dataclasses.replace(
        cfg, channels=cfg.channels[:3], mean=cfg.mean[:3], std=cfg.std[:3]))


def test_prefill_images_match_jax(filled):
    cfg, drives, cache, jdrives, jcache = filled
    p = cfg.datasets.projection
    for d, j in zip(drives, jdrives):
        assert os.path.basename(cache._path(d)) == \
            os.path.basename(jcache._path(j))
        got = np.asarray(cache.images(d, 0, len(d)))
        want = np.asarray(jcache.images(j, 0, len(j)))
        assert got.dtype == want.dtype == np.float16
        assert got.shape == want.shape == (FRAMES, p.height, p.width, 5)
        flip = (got != want).any(-1)
        assert flip.sum() <= MAX_FLIP_FRACTION * flip.size
        np.testing.assert_array_equal(got[~flip], want[~flip])
        assert (got != 0).any(-1).mean() > 0.2     # the images hold points


def test_prefill_equals_the_projector_cast_to_f16(filled):
    """Every cached frame, padded chunk tails included, is the projector's
    float32 image cast to f16, bit for bit."""
    cfg, drives, cache, _, _ = filled
    ds = cfg.datasets
    proj = tproj.make_projector(ds.projection, ds.channels, ds.mean, ds.std)
    for d in drives:
        pts, vld = zip(*[d.points(i) for i in range(len(d))])
        img, _ = proj(torch.from_numpy(np.stack(pts)),
                      torch.from_numpy(np.stack(vld)))
        want = img.to(torch.float16).numpy()
        got = np.asarray(cache.images(d, 0, len(d)))
        assert got.view(np.uint16).tobytes() == \
            want.view(np.uint16).tobytes()


def test_dataset_serves_images_not_points(filled):
    cfg, drives, cache, _, _ = filled
    ds = WindowDataset(cfg.datasets, drives, image_cache=cache)
    assert not ds.with_points
    item = ds.get(5)
    S, p = cfg.datasets.sequence_size, cfg.datasets.projection
    assert "points_x" not in item and "points_valid" not in item
    assert item["images"].shape == (S, p.height, p.width, 5)
    assert item["images"].dtype == np.float16
    di, s = ds.index[5]
    np.testing.assert_array_equal(item["images"],
                                  cache.images(drives[di], s, s + S))
    raw = WindowDataset(cfg.datasets, drives)
    for b, r in zip(ds.iter_batches(4, shuffle=True, seed=2),
                    raw.iter_batches(4, shuffle=True, seed=2)):
        assert set(b) == set(r) - {"points_x", "points_y", "points_z",
                                   "points_rem", "points_valid"} | {
                                       "images"}
        assert b["images"].shape == (4, S, p.height, p.width, 5)
        for k in ("imu", "imu_mask", "x_gt", "q_gt", "valid", "meta"):
            np.testing.assert_array_equal(b[k], r[k])


def test_subrange_drives_get_distinct_files(tree, tmp_path):
    d = cache_dict(tree)
    d["datasets"]["kitti"]["train"] = {DATE: [42, {"drive": 42, "start": 2,
                                                   "end": 8}]}
    cfg = port_config(d)
    cache = ProjectionCache(str(tmp_path), cfg.datasets, "cpu")

    class Stub:
        name = "d"

        def __init__(self, start, n):
            self.start, self._n = start, n

        def __len__(self):
            return self._n

    assert cache._path(Stub(0, 5)) != cache._path(Stub(5, 5))
    full, sub = build_drives(cfg, "train")
    cache.ensure([full, sub])
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(cache._path(x)) for x in (full, sub))
    np.testing.assert_array_equal(cache.images(sub, 0, 7),
                                  cache.images(full, 2, 9))


def test_a_drive_listed_twice_is_projected_once(tree, tmp_path,
                                                monkeypatch):
    cfg = port_config(cache_dict(tree))
    calls = []
    make = tproj.make_projector

    def counting(*a, **k):
        proj = make(*a, **k)

        def project(pts, vld):
            calls.append(pts.shape[0])
            return proj(pts, vld)
        return project

    monkeypatch.setattr(tproj, "make_projector", counting)
    d27 = build_drives(cfg, "train")[0]
    cache = ProjectionCache(str(tmp_path), cfg.datasets, "cpu")
    cache.ensure([d27, d27])
    assert calls == [16]             # 11 frames padded to one chunk of 16
    cache.ensure([d27])              # present: nothing to project
    assert calls == [16] and cache.fill_ms > 0
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def test_cached_step_matches_uncached(filled):
    cfg, drives, cache, _, _ = filled
    model = build_model(cfg, device="cpu", seed=0)
    out = {}
    for name, ds in (("raw", WindowDataset(cfg.datasets, drives)),
                     ("cached", WindowDataset(cfg.datasets, drives,
                                              image_cache=cache))):
        batch = next(ds.iter_batches(2, shuffle=True, seed=1))
        train_step, _ = build_train_step(cfg)
        state = create_train_state(cfg, copy.deepcopy(model))
        _, m = train_step(state, batch_to_device(batch, "cpu"))
        out[name] = {k: float(v) for k, v in m.items()}
    raw, got = out["raw"], out["cached"]
    for k, tol in (("loss", 1e-4), ("loss_x", 1e-4), ("grad_norm", 1e-3),
                   ("loss_q", 1e-2)):
        assert abs(got[k] - raw[k]) <= tol * abs(raw[k]), (k, got[k], raw[k])


def test_cache_with_augment_yaw_is_a_config_error(tree):
    d = cache_dict(tree, **{"augment-yaw": True})
    d["train"]["cache-projections"] = True
    with pytest.raises(ConfigError, match="cache-projections"):
        port_config(d)
    with pytest.raises(ValueError, match="cache-projections"):
        jax_config(d)
    del d["datasets"]["augment-yaw"]
    assert port_config(d).train.cache_projections

