"""Seeded weights, made on the device in a few large draws.

The benchmark makes one state dict from the run's seed for the reference
model's parameter names and shapes (``reference/model.py::init_kinds``):
lecun-normal kernels truncated at two sigma, LSTM tensors uniform in +-1 /
sqrt(hidden), zero biases, unit BatchNorm scales and variances, the
``q_out`` bias at the identity quaternion. The same tensors load into the
system under test and into the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from portbench.reference.model import init_kinds

# the standard normal's CDF at -2 and +2 sigma
_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def make_state(model: nn.Module, gen: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """``model``'s state dict (shapes only: a model on the meta device
    will do) filled from ``gen``, float32 on ``device``."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    dtypes = {k: v.dtype for k, v in model.state_dict().items()}
    kinds = init_kinds(model)
    sizes = {k: math.prod(shapes[k]) for k, _, _ in kinds}
    n_normal = sum(sizes[k] for k, kind, _ in kinds if kind == "normal")
    n_uniform = sum(sizes[k] for k, kind, _ in kinds if kind == "uniform")
    # one draw for every truncated normal, one for every uniform
    u = torch.rand(n_normal, generator=gen, device=device,
                   dtype=torch.float64) * (_HI - _LO) + _LO
    normal = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    out, i_n, i_u = {}, 0, 0
    for k, kind, scale in kinds:
        n, shape = sizes[k], shapes[k]
        if kind == "normal":
            t = normal[i_n:i_n + n].view(shape) * scale
            i_n += n
        elif kind == "uniform":
            t = uniform[i_u:i_u + n].view(shape) * scale
            i_u += n
        elif kind == "one":
            t = torch.ones(shape, device=device)
        elif kind == "quat":
            t = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device)
        else:
            t = torch.zeros(shape, device=device, dtype=dtypes[k])
        out[k] = t
    return out
