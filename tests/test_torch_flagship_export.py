"""The reduced flagship's serving export under ``kernel-aligned: auto``,
on the CPU.

``auto``'s check becomes a ``torch.cond`` in the exported streaming step
(``ops/projection.py::project_batch_ring_aligned_planes``); the artifact
must give the eager step's poses bit for bit on a grid chunk (the direct
branch) and on a shifted one (the ring branch). The configuration is
``tests/test_torch_flagship.py::small_dict``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplio_tpu_torch.config import load_config_dict as port_config  # noqa: E402
from deeplio_tpu_torch.data import synthetic as syn  # noqa: E402
from deeplio_tpu_torch.eval.export import (  # noqa: E402
    export_streaming,
    load_streaming_artifact,
)
from deeplio_tpu_torch.eval.streaming import StreamingOdometry  # noqa: E402
from deeplio_tpu_torch.models import zoo  # noqa: E402
from tests.test_torch_flagship import H, N, small_dict  # noqa: E402


def test_auto_export_serves_both_branches(tmp_path):
    cfg = port_config(small_dict(**{"kernel-aligned": "auto"}))
    model = zoo.build_model(cfg, device="cpu", seed=0)
    export_streaming(cfg, model, str(tmp_path), chunk=1, device="cpu")
    step, init_carry, _ = load_streaming_artifact(str(tmp_path))
    so = StreamingOdometry(cfg, model, chunk=1, device="cpu")
    grid = syn.synthetic_ring_batch(np.random.default_rng(0), 1, N, rings=H)
    for pts in (grid, np.roll(grid, 1, axis=1)):
        chunk = {"points": torch.from_numpy(pts),
                 "valid": torch.ones(pts.shape[:2], dtype=torch.bool),
                 "imu": torch.zeros(1, 16, 6), "imu_mask": torch.ones(1, 16)}
        _, got = step(init_carry(), chunk)
        with torch.no_grad():
            *_, poses, dx, dq = so.step(*so.init_carry(),
                                        *(chunk[k] for k in so.keys))
        for a, b in zip(got, (poses, dx, dq)):
            assert torch.equal(a, b)
