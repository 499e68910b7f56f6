"""Data parallelism (counterpart of ``deeplio_tpu/parallel``): one process
per device joined by ``torch.distributed`` (``multihost``) and each
process's view of the data axis (``mesh``)."""

from deeplio_tpu_torch.parallel import multihost
from deeplio_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from deeplio_tpu_torch.parallel.multihost import (
    is_primary,
    maybe_initialize,
    process_count,
    process_index,
    process_slice,
)

__all__ = ["Mesh", "is_primary", "make_mesh", "maybe_initialize",
           "multihost", "process_count", "process_index", "process_slice",
           "replicate", "shard_batch"]
