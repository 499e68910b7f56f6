"""The port's KITTI raw reader, its splits and its batches against the JAX
package, on devkit trees written to disk, float64/float32 on the CPU.

Trees: ``tests/_kitti_tree.py`` (the JAX tests' writer: random points,
5000 to 8000 a scan, 100 Hz OXTS) for the reader, the splits and the
batches; ``deeplio_tpu_torch/bench/kitti_tree.py`` (the port's writer,
from a ``SyntheticDrive``) read back against the drive it was written
from. Everything here is held bit for bit: both packages parse the same
text with the same float64 arithmetic.
"""

import copy
import os
import pathlib

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

from deeplio_tpu.config import load_config as jax_load  # noqa: E402
from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.config.schema import ODOMETRY_SEQUENCES as JAX_SEQUENCES  # noqa: E402
from deeplio_tpu.data.dataset import build_dataset as jax_build_dataset  # noqa: E402
from deeplio_tpu.data.dataset import build_drives as jax_build_drives  # noqa: E402
from deeplio_tpu.data.dataset import collate as jax_collate  # noqa: E402
from deeplio_tpu.data.drives import KittiRawDrive as JaxKittiRawDrive  # noqa: E402
from deeplio_tpu_torch.bench.kitti_tree import make_tree  # noqa: E402
from deeplio_tpu_torch.config import ConfigError, load_config  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.config.schema import ODOMETRY_SEQUENCES  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_dataset, build_drives, collate  # noqa: E402
from deeplio_tpu_torch.data.drives import KittiRawDrive  # noqa: E402

from ._kitti_tree import DATE, make_kitti_tree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_FRAMES = 12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Drives 27 (12 frames) and 42 (9 frames) of 2011_10_03."""
    root = tmp_path_factory.mktemp("kitti_raw")
    make_kitti_tree(root, n_frames=N_FRAMES, drive=27, seed=0)
    make_kitti_tree(root, n_frames=9, drive=42, seed=1)
    return str(root)


def _same(a, b):
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("span", [(0, -1), (2, 4), (5, 99)])
@pytest.mark.parametrize("max_points", [8192, 1024])
def test_reader_matches_jax(tree, max_points, span):
    """Points and planes (padded at 8192, truncated at 1024), masks, frame
    times, poses and the IMU between consecutive frames, over whole drives
    and sub-ranges (``end`` inclusive, clamped to the drive)."""
    start, end = span
    d = KittiRawDrive(tree, DATE, 27, max_points=max_points, start=start,
                      end=end)
    j = JaxKittiRawDrive(tree, DATE, 27, max_points=max_points, start=start,
                         end=end)
    assert (len(d), d.start, d.end, d.name) == (len(j), j.start, j.end,
                                                 j.name)
    assert len(d) == (N_FRAMES - start if end < 0
                      else min(end + 1, N_FRAMES) - start)
    for i in range(len(d)):
        for got, want in zip(d.points(i) + d.points_planes(i),
                             j.points(i) + j.points_planes(i)):
            assert _same(got, want), i
        n_raw = os.path.getsize(os.path.join(
            d.velo_dir, f"{start + i:010d}.bin")) // 16
        assert d.points(i)[1].sum() == min(max_points, n_raw)
        assert d.frame_time(i) == j.frame_time(i)
        assert _same(d.pose(i), j.pose(i)), i
    for i in range(len(d) - 1):
        t0, t1 = d.frame_time(i), d.frame_time(i + 1)
        got, want = d.imu_between(t0, t1), j.imu_between(t0, t1)
        assert _same(got, want) and 8 <= len(got) <= 12, i
    assert _same(d.oxts, j.oxts) and d.oxts.shape[1] == 30


def test_truncation_and_drive_local_origin(tree):
    d = KittiRawDrive(tree, DATE, 27, max_points=1024)
    pts, valid = d.points(1)
    assert valid.all() and pts.shape == (1024, 4)
    np.testing.assert_array_equal(d.pose(0), np.eye(4))
    sub = KittiRawDrive(tree, DATE, 27, max_points=1024, start=3, end=5)
    assert _same(sub.points(0)[0], d.points(3)[0])
    assert _same(sub.pose(0), d.pose(3))     # one origin for the drive


def test_labels_and_slot_grid_raise_naming_their_items(tree):
    """Labels, ported with pretraining: a frame with no label file gives
    None, as in the JAX package. Slot binning, ported with the flagship
    slice: a slot-gridded drive's scans equal JAX's bit for bit in both
    layouts, its labels raise, and a capacity that is no multiple of H*W
    raises before any read, as in JAX."""
    d = KittiRawDrive(tree, DATE, 27, max_points=1024)
    assert d.labels(0, str(tree)) is None
    grid = (8, 64, 3.0, -25.0)
    for layout in ("slots", "halves"):
        got = KittiRawDrive(tree, DATE, 27, max_points=1024,
                            slot_grid=grid, slot_layout=layout)
        want = JaxKittiRawDrive(tree, DATE, 27, max_points=1024,
                              slot_grid=grid, slot_layout=layout)
        for i in (0, 3):
            (gp, gv), (wp, wv) = got.points(i), want.points(i)
            assert _same(gp, wp) and np.array_equal(gv, wv)
        with pytest.raises(ValueError, match="slot-bin"):
            got.labels(0, str(tree))
    with pytest.raises(ValueError, match="multiple"):
        KittiRawDrive("/nonexistent", DATE, 27, max_points=1023,
                      slot_grid=grid)


@pytest.mark.parametrize("span", [(0, -1), (2, 4)])
@pytest.mark.parametrize("max_points", [8192, 1024])
def test_labels_match_jax(tree, tmp_path, max_points, span):
    """SemanticKITTI label files (uint32, instance ids in the high 16
    bits): the low 16 bits, zero-padded to (or truncated at) max_points,
    frames offset by the span's start; a missing file gives None."""
    d0 = KittiRawDrive(tree, DATE, 27)
    labdir = tmp_path / d0.name
    labdir.mkdir()
    rng = np.random.default_rng(max_points)
    for i in range(len(d0)):
        if i == 3:
            continue                       # frame 3 has no label file
        n = int(d0.points(i)[1].sum())
        raw = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        raw[:4] = [0, 0xFFFF, 0x1234FFFF, 40 | (7 << 16)]
        raw.tofile(labdir / f"{i:010d}.label")
    start, end = span
    d = KittiRawDrive(tree, DATE, 27, max_points=max_points, start=start,
                      end=end)
    j = JaxKittiRawDrive(tree, DATE, 27, max_points=max_points, start=start,
                         end=end)
    for i in range(len(d)):
        got, want = d.labels(i, str(tmp_path)), j.labels(i, str(tmp_path))
        if start + i == 3:
            assert got is None and want is None
            continue
        assert _same(got, want) and got.shape == (max_points,), i
        assert got.max() <= 0xFFFF
        if max_points == 8192:
            assert not got[int(d.points(i)[1].sum()):].any()


def kitti_dict(root, train, validation=None, **datasets):
    """``configs/deeplio_kitti_tpu.yaml`` cut to 16x128 images, 2048-point
    scans, windows of 3 frames at stride 2, on the tree at ``root``."""
    with open(ROOT / "configs" / "deeplio_kitti_tpu.yaml") as f:
        d = yaml.safe_load(f)
    d["datasets"]["kitti"] = {"root-path": str(root), "train": train,
                              "validation": validation or {DATE: [42]},
                              "test": {DATE: [42]}}
    d["datasets"].update({"image-height": 16, "image-width": 128,
                          "max-points": 2048, "sequence-size": 3,
                          "window-stride": 2, **datasets})
    return d


SPLITS = {
    "ids": {DATE: [27, 42]},
    "ranges": {DATE: [{"drive": 27, "start": 1, "end": 8}, 42,
                      {"drive": 42, "start": 4, "end": 100}]},
    "sequences": {"sequences": ["00", 1]},
}


@pytest.mark.parametrize("form", list(SPLITS))
def test_build_drives_matches_jax(tree, form):
    """The ``{date: [ids]}``, ``{drive, start, end}`` and ``{sequences:
    [...]}`` forms give JAX's drives: names, spans and lengths."""
    d = kitti_dict(tree, SPLITS[form])
    cfg, ref = port_config(d), jax_config(d)
    assert cfg.datasets.train == ref.datasets.train
    got, want = build_drives(cfg, "train"), jax_build_drives(ref, "train")
    assert [(x.name, x.start, x.end, len(x)) for x in got] == \
        [(x.name, x.start, x.end, len(x)) for x in want]
    assert all(isinstance(x, KittiRawDrive) for x in got)
    if form == "sequences":      # 00 and 01 map to drives 27 and 42
        assert [x.name for x in got] == [f"{DATE}_drive_0027",
                                         f"{DATE}_drive_0042"]


@pytest.mark.parametrize("shuffle", [True, False])
def test_iter_batches_match_jax(tree, shuffle):
    """Every key of every batch, in order, for the same seed."""
    d = kitti_dict(tree, SPLITS["ranges"])
    ds, ref = build_dataset(port_config(d), "train"), \
        jax_build_dataset(jax_config(d), "train")
    assert ds.index == ref.index and len(ds) == 9
    got = list(ds.iter_batches(3, shuffle=shuffle, seed=5))
    want = list(ref.iter_batches(3, shuffle=shuffle, seed=5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert _same(g[k], w[k]), k


def test_get_and_collate_match_jax(tree):
    d = kitti_dict(tree, SPLITS["ids"])
    ds, ref = build_dataset(port_config(d), "train"), \
        jax_build_dataset(jax_config(d), "train")
    items, want = [ds.get(i) for i in (4, 0, 7)], [ref.get(i)
                                                  for i in (4, 0, 7)]
    for g, w in zip(items, want):
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in w)
    g, w = collate(items), jax_collate(want)
    assert all(_same(g[k], w[k]) for k in w)


def test_kitti_tree_reads_back_the_synthetic_drive(tmp_path):
    """``bench/kitti_tree.py``: read back by the port's reader (and the
    JAX package's), the scans equal the synthetic drive's bit for bit.
    The poses and IMU samples too (tolerance 0): ``%.17g`` gives back each
    float64 exactly, and the frame and record stamps of one instant are
    the same text in both timestamp files, so every nearest-record and
    window lookup picks the drive's own record."""
    srcs = make_tree(str(tmp_path), [27, 42], n_frames=11, max_points=2048,
                     rings=16, world_points=6000)
    for num, src in zip((27, 42), srcs):
        d = KittiRawDrive(str(tmp_path), DATE, num, max_points=2048)
        j = JaxKittiRawDrive(str(tmp_path), DATE, num, max_points=2048)
        assert len(d) == len(src) == 11
        for i in range(len(d)):
            for got, want, other in zip(d.points(i), src.points(i),
                                        j.points(i)):
                assert _same(got, want) and _same(got, other), (num, i)
            assert _same(d.pose(i), src.pose(i)), (num, i)
            assert abs(d.frame_time(i) - src.frame_time(i)) < 1e-6
        for i in range(len(d) - 1):
            got = d.imu_between(d.frame_time(i), d.frame_time(i + 1))
            want = src.imu_between(src.frame_time(i), src.frame_time(i + 1))
            assert _same(got, want) and len(got) == 10, (num, i)


# ------------------------------------------------------------------ config

def test_kitti_tpu_config_loads_with_its_splits():
    """The repo's KITTI throughput config loads unchanged; its root and
    splits are JAX's."""
    path = ROOT / "configs" / "deeplio_kitti_tpu.yaml"
    cfg, ref = load_config(path), jax_load(str(path))
    for f in ("root_path", "train", "validation", "test"):
        assert getattr(cfg.datasets, f) == getattr(ref.datasets, f), f
    assert cfg.datasets.projection.backend == "pallas-ring"
    assert cfg.datasets.train["2011_10_03"] == [27, 42, 34]


def test_sequences_form_matches_jax():
    assert ODOMETRY_SEQUENCES == JAX_SEQUENCES
    d = kitti_dict("/r", {"sequences": ["00", 8, "10"]},
                   validation={"sequences": [9]})
    cfg, ref = port_config(d), jax_config(d)
    for f in ("train", "validation", "test", "root_path"):
        assert getattr(cfg.datasets, f) == getattr(ref.datasets, f), f
    assert cfg.datasets.train["2011_09_30"][0] == {"drive": 28,
                                                   "start": 1100,
                                                   "end": 5170}
    bad = copy.deepcopy(d)
    bad["datasets"]["kitti"]["train"] = {"sequences": ["11"]}
    with pytest.raises(ConfigError, match="sequence '11'"):
        port_config(bad)


def test_root_path_at_the_top_level():
    d = kitti_dict("/ignored", {DATE: [27]})
    del d["datasets"]["kitti"]["root-path"]
    d["datasets"]["root-path"] = "/top"
    assert port_config(d).datasets.root_path == \
        jax_config(d).datasets.root_path == "/top"
