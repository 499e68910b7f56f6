"""The whole slice on the CPU: the port's StreamingOdometry against the JAX
package's on the same tiny drive (8 frames, 2048 points, 16x128, the
kitti-tpu model knobs, float32) and the same weights.

Tolerances: per-frame motion within 1e-4 of its largest magnitude and
integrated poses within 1e-5 (float32 model, ulp-level summation-order
differences; a pixel flipped by trig ulps would also stay inside them at
this size). Chunking must not change the port's results at all.
"""

import pathlib

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data import synthetic as jsyn  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JaxDrive  # noqa: E402
from deeplio_tpu.eval.streaming import StreamingOdometry as JaxStreaming  # noqa: E402
from deeplio_tpu.models import init_model  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models.from_flax import load_flax_variables  # noqa: E402
from deeplio_tpu_torch.models.zoo import build_model  # noqa: E402

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
H, W, NPTS, FRAMES = 16, 128, 2048, 8
DX_TOL = 1e-4
POSE_ATOL = 1e-5


@pytest.fixture(scope="module")
def slice_pair():
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS})
    jcfg = jax_config(d)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tcfg = port_config(d)
    port = build_model(tcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    return jcfg, model, variables, tcfg, port


def _compare(jax_out, port_out):
    for want, got in zip(jax_out[1:], port_out[1:]):        # dx, dq
        err = np.abs(got - want).max()
        assert err <= DX_TOL * np.abs(want).max(), err
    np.testing.assert_allclose(port_out[0], jax_out[0], rtol=0,
                               atol=POSE_ATOL)


@pytest.mark.parametrize("rings", [0, H], ids=["unordered", "ring-ordered"])
def test_streaming_matches_jax(slice_pair, rings):
    """Same drive, same weights: poses, dx and dq agree. ``rings=H`` feeds
    ring-ordered scans (the order the ring projection is built for); the
    JAX streamer takes the port's numpy drive as is."""
    jcfg, model, variables, tcfg, port = slice_pair
    drive = SyntheticDrive(n_frames=FRAMES, max_points=NPTS, seed=5,
                           rings=rings)
    want = JaxStreaming(jcfg, model, variables, chunk=FRAMES).run(drive)
    got = StreamingOdometry(tcfg, port, chunk=FRAMES, device="cpu").run(drive)
    assert got[0].shape == (FRAMES, 4, 4) and got[0].dtype == np.float32
    _compare(want, got)


def test_streaming_chunk_invariance(slice_pair):
    """chunk groups host-to-device copies only: results are identical."""
    *_, tcfg, port = slice_pair
    drive = SyntheticDrive(n_frames=FRAMES - 1, max_points=NPTS, seed=6,
                           rings=H)
    a = StreamingOdometry(tcfg, port, chunk=3, device="cpu").run(drive)
    b = StreamingOdometry(tcfg, port, chunk=16, device="cpu").run(drive)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_streaming_first_tick_and_chaining(slice_pair):
    """The first tick is the identity, and each pose is the previous pose
    composed with the emitted relative motion."""
    *_, tcfg, port = slice_pair
    drive = SyntheticDrive(n_frames=5, max_points=NPTS, seed=7, rings=H)
    poses, dx, dq = StreamingOdometry(tcfg, port, chunk=2,
                                      device="cpu").run(drive)
    np.testing.assert_array_equal(poses[0], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(dx[0], 0.0)
    np.testing.assert_array_equal(dq[0], [1.0, 0.0, 0.0, 0.0])
    assert np.isfinite(poses).all()
    for k in range(1, len(poses)):
        w, x, y, z = dq[k] / np.linalg.norm(dq[k])
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]])
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R, dx[k]
        np.testing.assert_allclose(poses[k], poses[k - 1] @ step, atol=1e-6)


def test_synthetic_drive_bit_exact():
    """The port's SyntheticDrive gives the JAX fixture's points, validity,
    IMU, times and poses, bit for bit."""
    jd = JaxDrive(n_frames=6, max_points=NPTS, seed=3)
    td = SyntheticDrive(n_frames=6, max_points=NPTS, seed=3)
    assert len(jd) == len(td) == 6
    for k in range(6):
        for a, b in zip(jd.points(k), td.points(k)):
            np.testing.assert_array_equal(a, b)
        assert jd.frame_time(k) == td.frame_time(k)
        np.testing.assert_array_equal(jd.pose(k), td.pose(k))
        if k:
            t0, t1 = td.frame_time(k - 1), td.frame_time(k)
            np.testing.assert_array_equal(jd.imu_between(t0, t1),
                                          td.imu_between(t0, t1))


def test_ring_ordered_scan_matches_jax_fixture():
    """``rings > 0`` is the JAX fixture's own ``synthetic_scan(rings=...)``."""
    td = SyntheticDrive(n_frames=3, max_points=NPTS, seed=4, rings=H)
    jd = JaxDrive(n_frames=3, max_points=NPTS, seed=4)
    want = jsyn.synthetic_scan(jd._world, jd._Ts[2], NPTS, seed=4 * 1000 + 2,
                               rings=H)
    for a, b in zip(want, td.points(2)):
        np.testing.assert_array_equal(a, b)


def test_ring_batch_bit_exact():
    a = jsyn.synthetic_ring_batch(np.random.default_rng(1), 2, 4096, rings=H)
    b = tsyn.synthetic_ring_batch(np.random.default_rng(1), 2, 4096, rings=H)
    np.testing.assert_array_equal(a, b)


def _deeplo_dict():
    """``configs/deeplo_synth.yaml`` cut to the slice's size: DeepLO with
    ``lidar-feat-simple-0`` and the ``sort`` backend, float32."""
    with open(KITTI_TPU.parent / "deeplo_synth.yaml") as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS})
    d["lidar-feat-simple-0"].update({"feature-size": 16, "base-channels": 8})
    d["odom-feat-rnn"]["hidden-size"] = 16
    return d


def test_deeplo_streams_without_imu_matches_jax():
    """DeepLO streams with no IMU input (its chunks carry none), against
    JAX's ``StreamingOdometry`` on the same weights and drive."""
    d = _deeplo_dict()
    jcfg, tcfg = jax_config(d), port_config(d)
    model, variables = init_model(jcfg, jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_model(tcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    drive = SyntheticDrive(n_frames=6, max_points=NPTS, seed=8)
    so = StreamingOdometry(tcfg, port, chunk=4, device="cpu")
    assert so.keys == ("points", "valid")
    assert all(c.keys() == {"points", "valid"}
               for _, c in so.host_chunks(drive))
    want = JaxStreaming(jcfg, model, variables, chunk=4).run(drive)
    got = so.run(drive)
    assert got[0].shape == (6, 4, 4)
    _compare(want, got)


def test_deepio_does_not_stream():
    with open(KITTI_TPU.parent / "deepio_synth.yaml") as f:
        cfg = port_config(yaml.safe_load(f))
    with pytest.raises(ValueError, match="lidar arch"):
        StreamingOdometry(cfg, build_model(cfg, device="cpu"), device="cpu")
