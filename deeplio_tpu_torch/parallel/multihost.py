"""Multi-process data parallelism plumbing (counterpart of
``deeplio_tpu/parallel/multihost.py``).

PyTorch's idiom is one process per GPU joined by ``torch.distributed``:
NCCL between GPUs, gloo on the CPU. Each process holds the whole model and
feeds its own contiguous block of rows of every global batch
(:func:`process_slice`); the gradients are averaged by
``DistributedDataParallel`` (``train/step.py``). JAX's one process
driving a mesh of devices has no counterpart here.

The topology comes from the command line (``cli/train.py``) or from the
environment, with the JAX package's names::

    DEEPLIO_COORDINATOR=host:port  DEEPLIO_NUM_PROCESSES=2  DEEPLIO_PROCESS_ID=0

or from torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
``WORLD_SIZE`` (the counterpart of JAX's ``JAX_COORDINATOR_ADDRESS``
autodetect). A process whose GPU is not ``cuda:<rank>`` sets
``LOCAL_RANK`` (torchrun does). A plain single process is no cluster:
every helper then answers for a world of one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from deeplio_tpu_torch.utils import get_app_logger

_AUTODETECT = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def maybe_initialize(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join this process to the ``torch.distributed`` cluster if one is
    configured, before any use of the device.

    ``backend`` defaults to NCCL where a GPU is visible and gloo
    elsewhere. Returns True when running multi-process (always after
    initialising here), False for a plain single process. Safe to call more
    than once.
    """
    coordinator = coordinator or os.environ.get("DEEPLIO_COORDINATOR")
    if num_processes is None and "DEEPLIO_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DEEPLIO_NUM_PROCESSES"])
    if process_id is None and "DEEPLIO_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DEEPLIO_PROCESS_ID"])

    autodetect = all(k in os.environ for k in _AUTODETECT)
    if (not coordinator and not autodetect) or dist.is_initialized():
        return process_count() > 1
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError(
                "DEEPLIO_COORDINATOR requires DEEPLIO_NUM_PROCESSES and "
                "DEEPLIO_PROCESS_ID (or pass num_processes/process_id)")
        kwargs = dict(init_method=f"tcp://{coordinator}",
                      world_size=num_processes, rank=process_id)
        rank = process_id
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, **kwargs)
    get_app_logger().info(
        "torch.distributed initialised (%s): process %d/%d", backend,
        process_index(), process_count())
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank(rank: Optional[int] = None) -> int:
    """This process's GPU on its host: ``LOCAL_RANK`` where the launcher
    set it, else the rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_index() if rank is None else rank


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint side
    effects."""
    return process_index() == 0


def process_slice(global_batch_size: int) -> slice:
    """This process's contiguous row block of a global batch: process p of
    n takes rows [p * B / n, (p + 1) * B / n)."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {n} processes")
    local = global_batch_size // n
    lo = process_index() * local
    return slice(lo, lo + local)


def barrier() -> None:
    """Wait for every process (nothing to wait for in a world of one)."""
    if process_count() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
