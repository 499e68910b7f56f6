"""The two configurations of the optimizer, stem and Fire slice: the
shipped ``configs/deeplio_kitti_tpu.yaml`` with settings changed in code,
so no file is added under ``configs/``.

- ``A``, through the ring kernel: ``backend: pallas-ring`` as shipped,
  the ``factorized`` stem and ``mixed`` Fires, SGD (lr 0.01, momentum
  0.9, weight-decay 1e-4).
- ``B``, through the scatter kernel: ``backend: pallas``, the ``s2d-pre``
  stem and ``fused`` Fires, AdamW (weight-decay 0.01, the shipped lr),
  ``param-dtype: bfloat16`` (parsed and never read, as in the JAX
  package).

Both keep the file's 16 windows of 9 frames, its 64x1024 images, bf16,
h-stride 2, w-stride 4 and ``pool: stride``, its schedule and its clip.
The tests build them from here.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

SETTINGS: Dict[str, Dict[str, Dict[str, Any]]] = {
    "A": {"lidar-feat-pointseg": {"stem": "factorized", "fire": "mixed"},
          "optimizer": {"name": "sgd", "lr": 0.01, "momentum": 0.9,
                        "weight-decay": 1.0e-4}},
    "B": {"datasets": {"backend": "pallas"},
          "lidar-feat-pointseg": {"stem": "s2d-pre", "fire": "fused"},
          "optimizer": {"name": "adam", "weight-decay": 0.01}},
}
PARAM_DTYPE = {"B": "bfloat16"}


def slice10_dict(base: Dict[str, Any], which: str) -> Dict[str, Any]:
    """``base`` (the shipped file as a dict, maybe cut to size) with
    configuration ``which`` ("A" or "B") set, as a new dict."""
    d = copy.deepcopy(base)
    for block, keys in SETTINGS[which].items():
        d.setdefault(block, {}).update(keys)
    if which in PARAM_DTYPE:
        d["param-dtype"] = PARAM_DTYPE[which]
    return d
