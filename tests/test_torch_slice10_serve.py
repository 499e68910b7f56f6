"""The slice's two configurations (``deeplio_tpu_torch/bench/slice10.py``)
streamed, float32 on the CPU, cut to 16x128 images, 2048 points and
narrow nets: the port's ``StreamingOdometry`` against JAX's on one drive
with the same weights (``A``: 3 frames, the tick's two frames with the
pair ``(0, 1)`` into the factorized stem; ``B``: 2 frames, their
space-to-depth pair, the Pallas kernel in interpret mode), at
``tests/test_torch_streaming.py``'s tolerances. Their export:
``tests/test_torch_slice10_export.py``.
"""

import pathlib

import jax
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from deeplio_tpu.config import load_config_dict as jax_config
from deeplio_tpu.eval.streaming import StreamingOdometry as JaxStreaming
from deeplio_tpu.models import init_model
from deeplio_tpu.ops import projection_pallas as jpal
from deeplio_tpu_torch.bench.slice10 import slice10_dict
from deeplio_tpu_torch.config import load_config_dict as port_config
from deeplio_tpu_torch.data.drives import SyntheticDrive
from deeplio_tpu_torch.eval.streaming import StreamingOdometry
from deeplio_tpu_torch.models.from_flax import load_flax_variables
from deeplio_tpu_torch.models.zoo import build_model
from tests.test_torch_streaming import _compare

KITTI_TPU = pathlib.Path(__file__).resolve().parents[1] / "configs" / \
    "deeplio_kitti_tpu.yaml"
H, W, NPTS = 16, 128, 2048
# frames streamed against JAX: B's Pallas kernel runs interpreted
FRAMES = {"A": 3, "B": 2}


def cut_dict(which, **datasets):
    """Configuration ``which`` on the shipped file at 16x128, 2048 points,
    narrow nets, float32."""
    with open(KITTI_TPU) as f:
        d = yaml.safe_load(f)
    d["compute-dtype"] = "float32"
    d["datasets"].update({"image-height": H, "image-width": W,
                          "max-points": NPTS, **datasets})
    d["lidar-feat-pointseg"].update({"feature-size": 16, "el-squeeze": 16})
    d["imu-feat-rnn"]["hidden-size"] = 12
    d["odom-feat-rnn"]["hidden-size"] = 16
    return slice10_dict(d, which)


@pytest.fixture(scope="module", params=["A", "B"])
def pair(request):
    d = cut_dict(request.param)
    jcfg, tcfg = jax_config(d), port_config(d)
    model, variables = init_model(jcfg, jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_model(tcfg, device="cpu", seed=None)
    load_flax_variables(port, variables)
    return request.param, jcfg, model, variables, tcfg, port


def test_streaming_matches_jax(pair, monkeypatch):
    which, jcfg, model, variables, tcfg, port = pair
    assert port.stem == {"A": "factorized", "B": "s2d-pre"}[which]
    n = FRAMES[which]
    drive = SyntheticDrive(n_frames=n, max_points=NPTS, seed=5, rings=H)
    monkeypatch.setattr(jpal, "CHUNK", 512)   # as test_torch_train.py
    with pltpu.force_tpu_interpret_mode():
        want = JaxStreaming(jcfg, model, variables, chunk=n).run(drive)
    got = StreamingOdometry(tcfg, port, chunk=n, device="cpu").run(drive)
    assert got[0].shape == (n, 4, 4)
    _compare(want, got)
