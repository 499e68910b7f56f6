"""Evaluation: metrics, trajectories, the drive evaluator, streaming
odometry and the serving export.

The names below (the JAX package's ``eval/__init__.py`` exports) are
imported on first use, so that importing ``eval.export`` to load a serving
artifact pulls in neither the config, the data pipeline nor the models.
"""

import importlib

_EXPORTS = {
    "ate": "metrics",
    "kitti_odometry_errors": "metrics",
    "rpe": "metrics",
    "StreamingOdometry": "streaming",
    "evaluate_drive": "runner",
    "predict_drive": "runner",
    "chain_relative": "trajectory",
    "chain_relative_np": "trajectory",
    "gt_trajectory": "trajectory",
    "read_kitti_poses": "trajectory",
    "write_kitti_poses": "trajectory",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
