"""The ``corridor`` synthetic world (``synthetic-world: corridor``) against
the JAX package's numpy fixture: the world, a corridor ``SyntheticDrive``'s
scans, poses and IMU, and ``build_drives``' corridor drives, all bit for
bit (both sides are the same float64 numpy draws)."""

import copy
import pathlib

import numpy as np
import pytest
import yaml

pytest.importorskip("torch")

from deeplio_tpu.config import load_config_dict as jax_config  # noqa: E402
from deeplio_tpu.data import synthetic as jsyn  # noqa: E402
from deeplio_tpu.data.dataset import build_drives as jax_build_drives  # noqa: E402
from deeplio_tpu.data.drives import SyntheticDrive as JSyntheticDrive  # noqa: E402
from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from deeplio_tpu_torch.data.dataset import build_drives  # noqa: E402
from deeplio_tpu_torch.data.drives import SyntheticDrive  # noqa: E402

GEN2 = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_synth_gen2.yaml"


@pytest.mark.parametrize("frames,seed", [(40, 0), (150, 101)])
def test_corridor_world_bit_equal(frames, seed):
    Ts, _ = tsyn.synthetic_trajectory(frames, seed=seed)
    got = tsyn.synthetic_world_corridor(Ts, seed=seed)
    want = jsyn.synthetic_world_corridor(Ts, seed=seed)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_corridor_drive_bit_equal():
    """Scans late in a long drive stay populated, unlike the origin world's,
    and every array equals JAX's."""
    kw = dict(n_frames=260, max_points=2048, seed=3)
    got = SyntheticDrive(world_mode="corridor", **kw)
    want = JSyntheticDrive(world_mode="corridor", **kw)
    for i in (0, 130, 250):
        for g, w in zip(got.points(i), want.points(i)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got.pose(i), want.pose(i))
    np.testing.assert_array_equal(
        got.imu_between(got.frame_time(10), got.frame_time(11)),
        want.imu_between(want.frame_time(10), want.frame_time(11)))
    assert got.points(250)[1].all()                 # every point valid
    assert SyntheticDrive(**kw).points(250)[1].sum() == 0   # origin: none
    with pytest.raises(ValueError, match="world mode"):
        SyntheticDrive(world_mode="maze", **kw)


def test_build_drives_corridor():
    with open(GEN2) as f:
        d = yaml.safe_load(f)
    d = copy.deepcopy(d)
    d["datasets"].update({"synthetic-frames": 12, "synthetic-eval-frames": 20,
                          "synthetic-train-drives": 2, "max-points": 1024})
    got = build_drives(port_config(d), "test")
    want = jax_build_drives(jax_config(d), "test")
    assert [len(g) for g in got] == [len(w) for w in want] == [20] * 3
    for g, w in zip(got, want):
        assert g.name == w.name
        for a, b in zip(g.points(19), w.points(19)):
            np.testing.assert_array_equal(a, b)
