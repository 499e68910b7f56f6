"""The JAX package's benchmark configuration, for the port: a copy of
``__graft_entry__._FLAGSHIP`` and of its ``_raw_batch`` (whose module
imports the JAX package, which the port never does).

The flagship: DeepLIO in bfloat16 on 16 windows of 9 synthetic frames
(128 pairs a step), 131072-point scans projected by the ``pallas-ring``
backend through the dual-half slot route (``kernel-aligned: halves``)
into 64x1024 images, PointSeg at h-stride 2, w-stride 4, el-squeeze 128
with the ``stride-fold`` pool and the ``pair-split`` stem, LSTMs of 128x2
(IMU) and 256x2 (odometry), soft fusion and the LWS loss.
``tests/test_torch_flagship.py`` holds :data:`FLAGSHIP_YAML` equal to the
JAX package's after ``yaml.safe_load``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import yaml

from deeplio_tpu_torch.config.schema import Config
from deeplio_tpu_torch.data.synthetic import synthetic_ring_batch
from deeplio_tpu_torch.ops.projection import halves_permutation

FLAGSHIP_YAML = """
arch: deeplio
compute-dtype: bfloat16
datasets:
  synthetic: true
  sequence-size: 9
  window-stride: 8
  channels: [x, y, z, remission, depth]
  image-height: 64
  image-width: 1024
  max-points: 131072
  packed: true
  backend: pallas-ring
  kernel-packed: "on"
  kernel-aligned: "halves"
  mean: [0.0, 0.0, -1.0, 0.25, 12.0]
  std: [12.0, 12.0, 1.5, 0.16, 12.0]
  max-imu-per-pair: 16
deeplio:
  dropout: 0.25
  lidar-feat-net: {name: lidar-feat-pointseg}
  imu-feat-net: {name: imu-feat-rnn}
  fusion-net: {type: soft}
  odom-feat-net: {name: odom-feat-rnn}
lidar-feat-pointseg: {part: encoder, feature-size: 512, h-stride: 2, w-stride: 4,
                      el-squeeze: 128, pool: stride-fold, stem: pair-split}
imu-feat-rnn: {type: lstm, hidden-size: 128, num-layers: 2}
odom-feat-rnn: {type: lstm, hidden-size: 256, num-layers: 2}
losses: {active: lws, lws: {sx: 0.0, sq: -2.5}}
optimizer: {name: adam, lr: 0.0005}
train: {batch-size: 16}
"""


def flagship_dict() -> dict:
    """:data:`FLAGSHIP_YAML` as a dict (a fresh one each call)."""
    return yaml.safe_load(FLAGSHIP_YAML)


def raw_batch(cfg: Config, batch_size: int, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    """A host training batch of ``batch_size`` windows, as the JAX
    package's ``_raw_batch`` makes it: ``synthetic_ring_batch`` scans
    (ring-major, on the slot grid when N is a multiple of H*W) as flat
    channel planes [B*S, N], permuted by ``halves_permutation`` under
    ``kernel-aligned: halves``, every point valid; random IMU and
    translations, identity rotations, all pairs valid."""
    rng = np.random.default_rng(seed)
    ds = cfg.datasets
    S, P, N, T = (ds.sequence_size, ds.num_pairs, ds.projection.max_points,
                  ds.max_imu_per_pair)
    pts = synthetic_ring_batch(
        rng, batch_size * S, N, rings=ds.projection.height,
        fov_up_deg=ds.projection.fov_up_deg,
        fov_down_deg=ds.projection.fov_down_deg,
    ).reshape(batch_size, S, N, 4)
    soa = np.ascontiguousarray(
        pts.transpose(3, 0, 1, 2).reshape(4, batch_size * S, N))
    if ds.projection.kernel_aligned == "halves":
        soa = np.ascontiguousarray(
            soa[:, :, halves_permutation(N, ds.projection.height,
                                         ds.projection.width)])
    q = np.tile([1.0, 0, 0, 0], (batch_size, P, 1)).astype(np.float32)
    return {
        "points_x": soa[0],
        "points_y": soa[1],
        "points_z": soa[2],
        "points_rem": soa[3],
        "points_valid": np.ones((batch_size * S, N), bool),
        "imu": rng.normal(size=(batch_size, P, T, 6)).astype(np.float32),
        "imu_mask": np.ones((batch_size, P, T), np.float32),
        "x_gt": rng.normal(size=(batch_size, P, 3)).astype(np.float32),
        "q_gt": q,
        "valid": np.ones((batch_size, P), np.float32),
    }
