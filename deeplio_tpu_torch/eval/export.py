"""Serving export (counterpart of ``deeplio_tpu/eval/export.py``): the
streaming chunk step as a self-contained artifact.

``export_streaming`` exports ``eval/streaming.py::StreamingStep`` (the
projection through its selection operator, the model forward under its
autocast regions and the pose composition, ``chunk`` ticks unrolled) with
``torch.export`` on the device it will serve on, the trained weights
inside:

    artifact/
      streaming_step.pt2   torch.export.save of the step (weights inside)
      carry_init.pt        the initial carry (a zero image, pose I, 0)
      manifest.json        shapes, dtypes, device, config provenance

The selections are the ``torch.library`` operators
``deeplio::ring_select`` and ``deeplio::scatter_select``, and on the
packed routes the projection's prologue and epilogue are
``deeplio::proj_prologue`` and ``deeplio::proj_epilogue``, one node each
per tick in the exported graph: on the card they launch the CUDA kernels,
on the CPU their plain versions. A serving process needs only
``load_streaming_artifact``, which imports ``torch`` and the modules that
register those operators: no model zoo, no config parsing, no checkpoint
plumbing.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Tuple

import torch

# registers deeplio::ring_select and deeplio::scatter_select, and through
# them deeplio::proj_prologue and deeplio::proj_epilogue
from deeplio_tpu_torch.ops import projection_ring, projection_scatter  # noqa: F401

KIND = "deeplio_tpu_torch.streaming_step"
_PROGRAM = "streaming_step.pt2"
_CARRY = "carry_init.pt"
_MANIFEST = "manifest.json"


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def export_streaming(cfg, model, out_dir: str, chunk: int = 16,
                     device=None) -> str:
    """Export the streaming chunk step of ``model`` (a DeepLIO or a
    DeepLO) on ``device`` (CUDA unless ``"cpu"``); returns the artifact
    dir.

    The exported call is ``(*carry, points, valid, imu, imu_mask) ->
    (*carry, poses [c,4,4], dx [c,3], dq [c,4])`` with ``carry =
    (prev_img, pose, started)``, DeepLO's without ``imu`` and
    ``imu_mask``: exactly ``StreamingStep``, weights inside.
    """
    from deeplio_tpu_torch.eval.streaming import StreamingOdometry

    so = StreamingOdometry(cfg, model, chunk=chunk, device=device)
    carry = so.init_carry()
    ds = cfg.datasets
    n, t = ds.projection.max_points, ds.max_imu_per_pair
    ex = {"points": torch.zeros((chunk, n, 4), dtype=torch.float32),
          "valid": torch.zeros((chunk, n), dtype=torch.bool),
          "imu": torch.zeros((chunk, t, 6), dtype=torch.float32),
          "imu_mask": torch.zeros((chunk, t), dtype=torch.float32)}
    ex = {k: v.to(so.device) for k, v in ex.items()}
    with torch.no_grad():
        program = torch.export.export(
            so.step, (*carry, *(ex[k] for k in so.keys)), strict=False)

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM))
    torch.save(tuple(c.cpu() for c in carry), os.path.join(out_dir, _CARRY))
    manifest = {
        "kind": KIND,
        "version": 1,
        "device": so.device.type,
        "chunk": chunk,
        "arch": cfg.model.arch,
        "inputs": {k: [list(ex[k].shape), _dtype(ex[k])] for k in so.keys},
        "carry": [[list(c.shape), _dtype(c)] for c in carry],
        "image": {"height": ds.projection.height,
                  "width": ds.projection.width,
                  "channels": list(ds.channels)},
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


def load_streaming_artifact(art_dir: str) -> Tuple[Callable, Callable, dict]:
    """Load an artifact; returns (step, init_carry, manifest).

    ``step(carry, chunk_inputs)`` runs the exported program on the
    manifest's device: ``carry`` a tuple of three tensors, ``chunk_inputs``
    a dict of the manifest's inputs (``points``, ``valid``, and for
    DeepLIO ``imu`` and ``imu_mask``) as tensors there with its shapes;
    it returns ``(carry, (poses, dx, dq))``.
    ``init_carry()`` gives the artifact's initial carry on that device."""
    with open(os.path.join(art_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("kind") != KIND:
        raise ValueError(f"not a streaming artifact: {art_dir}")
    module = torch.export.load(os.path.join(art_dir, _PROGRAM)).module()
    keys = list(manifest["inputs"])
    device = torch.device(manifest["device"])

    def step(carry, chunk_inputs):
        with torch.no_grad():
            *carry, poses, dx, dq = module(
                *carry, *(chunk_inputs[k] for k in keys))
        return tuple(carry), (poses, dx, dq)

    def init_carry():
        saved = torch.load(os.path.join(art_dir, _CARRY), weights_only=True)
        return tuple(c.to(device) for c in saved)

    return step, init_carry, manifest
