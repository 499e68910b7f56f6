"""Device ops: spherical projection through the ring and point-scatter
selections and the prologue and epilogue around them (each a CUDA kernel
and its plain version), surface normals, yaw augmentation, masked
LSTM/GRU. The projection API is the JAX package's
``deeplio_tpu/ops/__init__.py``'s."""

from deeplio_tpu_torch.ops.projection import (
    assemble_channels,
    check_ring_order,
    compute_normals,
    make_projector,
    normalize_channels,
    project_scan_np,
    spherical_uv,
)
from deeplio_tpu_torch.ops.projection_io import (
    proj_epilogue,
    proj_epilogue_reference,
    proj_prologue,
    proj_prologue_reference,
)
from deeplio_tpu_torch.ops.projection_scatter import (
    project_batch,
    project_scan,
)
