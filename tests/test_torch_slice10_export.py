"""The serving artifact under the slice's two configurations
(``deeplio_tpu_torch/bench/slice10.py``: the factorized stem and the
s2d-pre stem), float32 on the CPU at 16x128, 2048 points and narrow
nets: ``torch.export`` of the streaming step (one tick a chunk) equal to
``StreamingOdometry.run`` bit for bit over 2 frames, as
``tests/test_torch_export.py`` holds it (the same ATen operators on the
same float32 inputs)."""

import numpy as np
import pytest
import torch

from deeplio_tpu_torch.config import load_config_dict
from deeplio_tpu_torch.data.drives import SyntheticDrive
from deeplio_tpu_torch.eval.export import (
    export_streaming,
    load_streaming_artifact,
)
from deeplio_tpu_torch.eval.streaming import StreamingOdometry
from deeplio_tpu_torch.models.zoo import build_model
from tests.test_torch_slice10_serve import H, NPTS, cut_dict


@pytest.mark.parametrize("which", ["A", "B"])
def test_artifact_reproduces_streaming_run(which, tmp_path):
    cfg = load_config_dict(cut_dict(which))
    port = build_model(cfg, device="cpu", seed=0)
    export_streaming(cfg, port, str(tmp_path), chunk=1, device="cpu")
    so = StreamingOdometry(cfg, port, chunk=1, device="cpu")
    drive = SyntheticDrive(n_frames=2, max_points=NPTS, seed=7, rings=H)
    want = so.run(drive)
    step, init_carry, _ = load_streaming_artifact(str(tmp_path))
    carry, outs = init_carry(), []
    for n_real, host in so.host_chunks(drive, pad=True):
        carry, res = step(carry, {k: torch.from_numpy(v)
                                  for k, v in host.items()})
        outs.append([r[:n_real].numpy() for r in res])
    for g, w in zip((np.concatenate(o) for o in zip(*outs)), want):
        np.testing.assert_array_equal(g, w)
