"""The yardstick's arithmetic: the chip's peaks, the model's operations
and the projection's bytes, all from shapes and never from what the
system under test runs.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.loss import pose_loss
from portbench.reference.model import DeepLIO

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# bytes a point of the raw scan: x, y, z, remission float32 and valid
POINT_BYTES = 17


def model_flops(spec: Dict, windows: int, pairs: int, H: int, W: int,
                imu_len: int, train: bool) -> int:
    """Floating-point operations of one forward (``train``: forward, loss
    and backward) of the reference model on ``windows`` x ``pairs`` pair
    images, counted by ``FlopCounterMode`` on meta tensors (two a
    multiply-add: convolutions and matrix products)."""
    with torch.device("meta"):
        model = DeepLIO(spec)
        c = 2 * spec["image_channels"]
        imgs = torch.empty(windows, pairs, H, W, c)
        imu = torch.empty(windows, pairs, imu_len, 6)
        mask = torch.empty(windows, pairs, imu_len)
    model.train(train)
    counter = FlopCounterMode(display=False)
    with counter:
        x, q = model(imgs, imu, mask)
        if train:
            sx = torch.zeros((), device="meta", requires_grad=True)
            total = pose_loss(x, q, torch.empty_like(x), torch.empty_like(q),
                              sx, sx)[0]
            total.backward()
    return int(counter.get_total_flops())


def projection_bytes(scans: int, points: int, model_batch_elems: int,
                     elem_bytes: int) -> int:
    """The least bytes a projection moves: each input plane read once
    (``POINT_BYTES`` a point) and the model batch written once."""
    return scans * points * POINT_BYTES + model_batch_elems * elem_bytes


def roofline_s(nbytes: int) -> float:
    """The least time ``nbytes`` take at the HBM peak."""
    return nbytes / PEAK_HBM_BYTES
