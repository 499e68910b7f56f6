"""Weight bridge between the JAX package's flax variables and the port's
modules, both ways.

``load_flax_variables(model, variables)`` takes a ``{"params",
"batch_stats"}`` tree (arrays convertible with ``numpy.asarray``) and
loads it into a module whose submodules carry the flax names (every
module of ``deeplio_tpu_torch.models`` does). The layouts:

    conv ``kernel`` [kh, kw, I, O]      -> ``weight`` [O, I, kh, kw]
    ConvTranspose ``kernel`` [kh, kw, I, O]
                                        -> ``weight`` [I, O, kh, kw],
                                           flipped in kh and kw
    Dense ``kernel`` [I, O]             -> ``weight`` [O, I]
    BN ``scale`` / ``bias``             -> ``weight`` / ``bias``
    BN stats ``mean`` / ``var``         -> ``running_mean`` / ``running_var``
    LSTM ``w_ih`` / ``w_hh`` / ``b``    -> kept as they are
    GRU ``w_ih`` / ``w_hh`` / ``b_ih`` / ``b_hh``
                                        -> kept as they are

(an RNN's directions are its modules ``l{k}_fwd`` and ``l{k}_bwd``, the
FC nets' layers Dense ``Dense_{k}``, the decoder-bearing tower's decoder
``pointseg/decoder``, the factorized stem ``FactorizedStem_0`` with its
``Conv_0`` [kh, kw, C, 2F] and ``BatchNorm_0``, a fused Fire's lone
``ConvBN_0``, the s2d stems' 2x2 ``ConvBN_0`` on h * w * 2C channels:
each is its own module on both sides, so the layouts above carry them).

The bridge is strict on both sides, as ``deeplio_tpu/models/
import_torch.py`` is: a flax entry with no matching module or tensor, a
shape mismatch, or a port tensor left unset is an error, and nothing is
written unless everything matches.

``to_flax_variables(model)`` is the inverse: the module's parameters and
statistics as a ``{"params", "batch_stats"}`` tree of numpy arrays in the
flax layouts, so a trained port model and a trained flax model compare in
one layout.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from deeplio_tpu_torch.ops.rnn import GruCellScan, LstmCellScan

# the masked RNN cells' leaves, the same in both layouts
RNN_LEAVES = {LstmCellScan: ("w_ih", "w_hh", "b"),
              GruCellScan: ("w_ih", "w_hh", "b_ih", "b_hh")}


def _leaves(tree: Mapping[str, Any],
            prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                            Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _target(mod: nn.Module, collection: str, leaf: str,
            value: np.ndarray) -> Tuple[str, np.ndarray]:
    """(tensor name on ``mod``, value in the port's layout)."""
    if collection == "params":
        if isinstance(mod, nn.Conv2d):
            if leaf == "kernel" and value.ndim == 4:
                return "weight", value.transpose(3, 2, 0, 1)
            if leaf == "bias":
                return "bias", value
        elif isinstance(mod, nn.ConvTranspose2d):
            # flax correlates with the kernel as it stands, PyTorch's
            # transposed conv with its weight flipped (blocks.py::
            # SameConvTranspose2d)
            if leaf == "kernel" and value.ndim == 4:
                return "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
            if leaf == "bias":
                return "bias", value
        elif isinstance(mod, nn.Linear):
            if leaf == "kernel" and value.ndim == 2:
                return "weight", value.T
            if leaf == "bias":
                return "bias", value
        elif isinstance(mod, nn.BatchNorm2d):
            if leaf in ("scale", "bias"):
                return {"scale": "weight", "bias": "bias"}[leaf], value
        elif leaf in RNN_LEAVES.get(type(mod), ()):
            return leaf, value
    elif isinstance(mod, nn.BatchNorm2d) and leaf in ("mean", "var"):
        return {"mean": "running_mean", "var": "running_var"}[leaf], value
    raise KeyError(f"no {type(mod).__name__} tensor for flax "
                   f"{collection} leaf {leaf!r}")


def load_flax_variables(model: nn.Module,
                        variables: Mapping[str, Any]) -> None:
    """Load a flax ``{"params", "batch_stats"}`` tree into ``model``."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected flax collections {sorted(unknown)}")
    own: Dict[str, torch.Tensor] = {
        k: v for k, v in model.state_dict(keep_vars=True).items()
        if not k.endswith("num_batches_tracked")}
    staged: Dict[str, np.ndarray] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            where = "/".join(path)
            try:
                mod = model.get_submodule(".".join(path[:-1]))
                name, value = _target(mod, collection, path[-1],
                                      np.asarray(leaf, np.float32))
            except (AttributeError, KeyError) as e:
                raise KeyError(f"flax {collection} {where}: {e}") from None
            key = ".".join(path[:-1] + (name,))
            if key not in own:
                raise KeyError(f"flax {collection} {where}: the port has no "
                               f"tensor {key}")
            if key in staged:
                raise KeyError(f"flax {collection} {where}: {key} set twice")
            if tuple(own[key].shape) != value.shape:
                raise ValueError(
                    f"flax {collection} {where}: shape {value.shape} does "
                    f"not match {key} {tuple(own[key].shape)}")
            staged[key] = value
    missing = sorted(set(own) - set(staged))
    if missing:
        raise KeyError(f"flax variables leave {len(missing)} port tensors "
                       f"unset, e.g. {missing[:5]}")
    with torch.no_grad():
        for key, value in staged.items():
            own[key].copy_(torch.from_numpy(np.array(value, np.float32)))


def _source(mod: nn.Module, name: str, value: np.ndarray
            ) -> Tuple[str, str, np.ndarray]:
    """(flax collection, flax leaf, value in the flax layout) of the port
    tensor ``name`` of ``mod``: the inverse of :func:`_target`."""
    if isinstance(mod, nn.Conv2d):
        if name == "weight":
            return "params", "kernel", value.transpose(2, 3, 1, 0)
        if name == "bias":
            return "params", "bias", value
    elif isinstance(mod, nn.ConvTranspose2d):
        if name == "weight":
            return "params", "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        if name == "bias":
            return "params", "bias", value
    elif isinstance(mod, nn.Linear):
        if name == "weight":
            return "params", "kernel", value.T
        if name == "bias":
            return "params", "bias", value
    elif isinstance(mod, nn.BatchNorm2d):
        flax = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}
        if name in flax:
            return flax[name] + (value,)
    elif name in RNN_LEAVES.get(type(mod), ()):
        return "params", name, value
    raise KeyError(f"no flax leaf for {type(mod).__name__} tensor {name!r}")


def to_flax_variables(model: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The module's tensors as a flax ``{"params", "batch_stats"}`` tree of
    float32 numpy arrays (copies, on the host)."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        *path, name = key.split(".")
        mod = model.get_submodule(".".join(path))
        collection, leaf, value = _source(
            mod, name, t.detach().cpu().float().numpy())
        node = out[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.array(value, order="C")   # a copy, also on the CPU
    return {k: v for k, v in out.items() if v}
