"""The data-parallel layout (counterpart of
``deeplio_tpu/parallel/mesh.py``).

JAX lays a ``(data, model)`` mesh over the devices of one program. Here
each process owns one device, and the mesh is this process's view of the
data axis: its size (the number of processes), this process's rank, the
process group that carries the collectives and the device the rank runs
on. A single process with no process group is a mesh of 1, whose steps
are the one-device steps (``train/step.py``). The model axis is 1, as in
the JAX package, and is not represented.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from deeplio_tpu_torch.device import DeviceLike, resolve_device
from deeplio_tpu_torch.parallel.multihost import (
    local_rank,
    process_count,
    process_index,
)


@dataclass(frozen=True)
class Mesh:
    data: int                     # processes on the data axis
    rank: int                     # this process's place on it
    group: Optional[Any]          # the process group; None in one process
    device: torch.device          # this rank's device


def _rank_device(device: DeviceLike) -> torch.device:
    if not dist.is_initialized():
        return resolve_device(device)
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    local = local_rank()
    have = torch.cuda.device_count()
    if local >= have:
        raise ValueError(f"process {process_index()} (local rank {local}) "
                         f"has no GPU to take: {have} visible")
    return torch.device("cuda", local)


def make_mesh(data: int = -1, device: DeviceLike = None) -> Mesh:
    """This process's mesh. ``data=-1`` spans every process; a larger
    ``data`` than there are processes raises, as JAX's ``make_mesh`` does
    when there are too few devices. ``device`` defaults to
    ``cuda:<local rank>`` (``cuda`` in one process); ``"cpu"`` runs the
    ranks on the CPU (gloo)."""
    world = process_count()
    if data == -1:
        data = world
    if data > world:
        raise ValueError(f"mesh {data}x1 needs {data} devices, have {world}")
    if data < world:
        raise ValueError(f"data-parallel {data} leaves {world - data} of "
                         f"{world} processes without rows (one process per "
                         f"device: data-parallel is the world size)")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(data=data, rank=process_index(), group=group,
                device=_rank_device(device))


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors): the
    rank's contiguous block of each key's leading dimension, so window
    keys [B, ...] and the flat scan planes [B * S, N] split alike."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % mesh.data:
            raise ValueError(f"batch key {k!r}: leading dim {n} is not "
                             f"divisible by the {mesh.data} ranks")
        m = n // mesh.data
        out[k] = v[mesh.rank * m:(mesh.rank + 1) * m]
    return out


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (one broadcast per dtype). Returns ``module``."""
    if mesh.group is None or mesh.data == 1:
        return module
    by_dtype: Dict[torch.dtype, list] = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t.detach())
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))
    return module
