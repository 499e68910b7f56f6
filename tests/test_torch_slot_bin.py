"""Host slot binning and the drives that use it, against the JAX package,
on the CPU, bit for bit.

- ``slot_bin_scan_np`` (the numpy oracle) against JAX's, in both layouts,
  with far points clipped to the key ceiling;
- the port's native op (``deeplio_tpu_torch/native``, built with ``g++``
  on first use) against its own oracle: per scan, from injected keys
  (the selection logic alone), and through the batch entry;
- ``SyntheticDrive`` and ``KittiRawDrive`` with a slot grid,
  ``PermutedDrive``, and ``build_drives`` under ``slot-bin``, ``trust``
  and ``halves``: scan for scan against JAX's drives; labels raise under
  a slot grid.
"""

import ctypes
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data import synthetic as jsyn  # noqa: E402
from deeplio_tpu.data.dataset import build_drives as jax_build_drives  # noqa: E402
from deeplio_tpu.data.drives import PermutedDrive as JPermutedDrive  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive  # noqa: E402
from deeplio_tpu_torch import native  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import synthetic as syn  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_drives  # noqa: E402
from deeplio_tpu_torch.data.drives import PermutedDrive, SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.ops.projection import (  # noqa: E402
    halves_permutation,
    idx_key_layout,
)

from ._kitti_tree import DATE, make_kitti_tree  # noqa: E402

H, W = 8, 64
N_PIX = H * W
GRID = (H, W, 3.0, -25.0)

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ to build the native op")


def _cloud(seed, n, invalid=0.1, far=0.0):
    rng = np.random.default_rng(seed)
    world = syn.synthetic_world(20000, seed=seed)
    Ts, _ = syn.synthetic_trajectory(2, seed=seed)
    pts, valid = syn.synthetic_scan(world, Ts[0], n, seed=seed)
    pts = np.array(pts)
    pts[rng.uniform(size=n) < far, :3] *= 60.0
    return pts, valid & (rng.uniform(size=n) >= invalid)


def _same(a, b):
    """Arrays equal bit for bit (float32 words compared as int32)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("far", [0.0, 0.4])
@pytest.mark.parametrize("spp", [1, 2, 3])
@pytest.mark.parametrize("layout", ["slots", "halves"])
def test_oracle_matches_jax(layout, spp, far):
    pts, valid = _cloud(spp, 3 * N_PIX, far=far)
    got = syn.slot_bin_scan_np(pts, valid, H, W, spp, layout=layout)
    want = jsyn.slot_bin_scan_np(pts, valid, H, W, spp, layout=layout)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@needs_gxx
def test_native_library_builds():
    assert native.lib() is not None, native.build_error()
    assert native.library_path().exists()


@needs_gxx
@pytest.mark.parametrize("far", [0.0, 0.4])
@pytest.mark.parametrize("spp", [1, 2, 3])
@pytest.mark.parametrize("layout", ["slots", "halves"])
def test_native_matches_oracle(layout, spp, far):
    pts, valid = _cloud(10 + spp, 3 * N_PIX, far=far)
    got = syn.slot_bin_scan(pts, valid, H, W, spp, layout=layout)
    want = syn.slot_bin_scan_np(pts, valid, H, W, spp, layout=layout)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # every kept point is a valid input point
    assert got[1].sum() <= valid.sum()


@needs_gxx
def test_native_all_invalid():
    pts, _ = _cloud(7, 2 * N_PIX)
    out, ov = syn.slot_bin_scan(pts, np.zeros(2 * N_PIX, bool), H, W, 2)
    assert not ov.any() and not out.any()


@needs_gxx
@pytest.mark.parametrize("layout_id,layout", [(0, "slots"), (1, "halves")])
def test_native_selection_from_keys(layout_id, layout):
    """Injected (pixel, range key, ok): the native selection keeps each
    pixel's ``spp`` best by (key, index) under heavy key ties, placed as
    the layout says."""
    rng = np.random.default_rng(0)
    n, n_pix, spp = 5000, 64, 3
    pix = rng.integers(0, n_pix, n).astype(np.int32)
    rq = rng.integers(0, 5, n).astype(np.int32)
    ok = (rng.uniform(size=n) > 0.2).astype(np.uint8)
    out = np.empty(n_pix * spp, np.int32)
    i32p, u8p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)
    native.lib().dlt_slot_bin_from_keys(
        pix.ctypes.data_as(i32p), rq.ctypes.data_as(i32p),
        ok.ctypes.data_as(u8p), n, n_pix, spp, layout_id,
        out.ctypes.data_as(i32p))
    sel = np.flatnonzero(ok)
    order = sel[np.lexsort((rq[sel], pix[sel]))]
    want = np.full(n_pix * spp, -1, np.int32)
    counts = np.zeros(n_pix, np.int64)
    for i in order:
        p, k = pix[i], counts[pix[i]]
        if k < spp:
            want[k * n_pix + p if layout == "halves" else p * spp + k] = i
            counts[p] += 1
    np.testing.assert_array_equal(out, want)


@needs_gxx
@pytest.mark.parametrize("layout_id,layout", [(0, "slots"), (1, "halves")])
def test_native_batch_entry_matches_scan_entry(layout_id, layout):
    spp, n = 2, 2 * N_PIX
    scans = [_cloud(s, n) for s in range(3)]
    pts = np.ascontiguousarray(np.stack([p for p, _ in scans]))
    valid = np.ascontiguousarray(np.stack([v for _, v in scans]), np.uint8)
    _, rq_bits, rq_scale = idx_key_layout(n, N_PIX)
    out = np.empty((3, n, 4), np.float32)
    out_valid = np.empty((3, n), np.uint8)
    f32p, u8p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)
    native.lib().dlt_slot_bin_batch(
        pts.ctypes.data_as(f32p), valid.ctypes.data_as(u8p), 3, n, H, W,
        spp, 3.0, -25.0, float(rq_scale), (1 << rq_bits) - 2, layout_id,
        out.ctypes.data_as(f32p), out_valid.ctypes.data_as(u8p))
    for s, (p, v) in enumerate(scans):
        a, av = syn.slot_bin_scan_np(p, v, H, W, spp, layout=layout)
        assert _same(out[s], a) and np.array_equal(out_valid[s].view(bool),
                                                   av)


@pytest.mark.parametrize("layout", ["slots", "halves"])
def test_synthetic_drive_slot_grid_matches_jax(layout):
    got = SyntheticDrive(n_frames=3, max_points=2 * N_PIX, seed=1,
                         slot_grid=GRID, slot_layout=layout)
    want = JSyntheticDrive(n_frames=3, max_points=2 * N_PIX, seed=1,
                           slot_grid=GRID, slot_layout=layout)
    for i in range(3):
        for a, b in zip(got.points(i), want.points(i)):
            assert _same(a, b)
        for a, b in zip(got.points_planes(i), want.points_planes(i)):
            assert _same(a, b)
    with pytest.raises(ValueError, match="slot-bin"):
        got.labels(0, "/nonexistent")
    assert SyntheticDrive(n_frames=2, max_points=2 * N_PIX).labels(0, "") \
        is None
    with pytest.raises(ValueError, match="multiple"):
        SyntheticDrive(n_frames=2, max_points=2 * N_PIX - 1, slot_grid=GRID)


def test_permuted_drive_matches_jax():
    perm = halves_permutation(2 * N_PIX, H, W)
    got = PermutedDrive(SyntheticDrive(n_frames=3, max_points=2 * N_PIX),
                        perm)
    want = JPermutedDrive(JSyntheticDrive(n_frames=3, max_points=2 * N_PIX),
                          perm)
    assert got.name == want.name and len(got) == len(want)
    for i in range(3):
        for a, b in zip(got.points(i), want.points(i)):
            assert _same(a, b)
        for a, b in zip(got.points_planes(i), want.points_planes(i)):
            assert _same(a, b)
        assert _same(got.pose(i), want.pose(i))
    assert _same(got.imu_between(0.0, 0.2), want.imu_between(0.0, 0.2))
    with pytest.raises(ValueError, match="halves"):
        got.labels(0, "/nonexistent")


def _synthetic_cfg(**ds):
    return {"arch": "deeplo",
            "datasets": {"synthetic": True, "backend": "pallas-ring",
                         "image-height": H, "image-width": W,
                         "max-points": 2 * N_PIX, "synthetic-frames": 3,
                         "synthetic-train-drives": 2, **ds},
            "deeplo": {"lidar-feat-net": {"name": "lidar-feat-simple-0"}}}


@pytest.mark.parametrize("ds", [{"kernel-aligned": "halves"},
                                {"kernel-aligned": "trust"},
                                {"slot-bin": True},
                                {"kernel-aligned": "auto"}])
def test_build_drives_synthetic_matches_jax(ds):
    d = _synthetic_cfg(**ds)
    got = build_drives(port_config(d), "train")
    want = jax_build_drives(jax_config(d), "train")
    assert [type(g).__name__ for g in got] == [type(w).__name__
                                               for w in want]
    for g, w in zip(got, want):
        assert getattr(g, "slot_grid", None) == getattr(w, "slot_grid", None)
        assert getattr(g, "slot_layout", None) == getattr(w, "slot_layout",
                                                          None)
        for a, b in zip(g.points(1), w.points(1)):
            assert _same(a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_slot")
    make_kitti_tree(root, n_frames=3, drive=27, seed=0)
    return str(root)


@pytest.mark.parametrize("aligned", ["halves", "trust", "auto"])
def test_build_drives_kitti_slot_bin_matches_jax(tree, aligned):
    d = {"arch": "deeplo",
         "datasets": {"backend": "pallas-ring", "image-height": H,
                      "image-width": W, "max-points": 2 * N_PIX,
                      "slot-bin": True, "kernel-aligned": aligned,
                      "kitti": {"root-path": tree, "train": {DATE: [27]}}},
         "deeplo": {"lidar-feat-net": {"name": "lidar-feat-simple-0"}}}
    (got,) = build_drives(port_config(d), "train")
    (want,) = jax_build_drives(jax_config(d), "train")
    assert got.slot_grid == want.slot_grid == GRID
    assert got.slot_layout == want.slot_layout
    for i in range(3):
        for a, b in zip(got.points(i), want.points(i)):
            assert _same(a, b)
    with pytest.raises(ValueError, match="slot-bin"):
        got.labels(0, tree)
