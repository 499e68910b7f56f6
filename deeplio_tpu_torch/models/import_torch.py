"""Reference PyTorch ``state_dict`` -> the port's models (counterpart of
``deeplio_tpu/models/import_torch.py``).

A reference checkpoint (a bare ``state_dict``, or one wrapped under
``state_dict``, ``model`` or ``model_state_dict``) is converted into the
flax-layout ``{"params", "batch_stats"}`` numpy trees the JAX package's
``import_state_dict`` produces from it, then loaded into a port model with
``models/from_flax.py::load_flax_variables``. The template the importer
walks is the port model's own tree (``to_flax_variables(model)``), so the
JAX package and the port import one state dict into the same trees.

Layout conversions (torch -> flax), the JAX package's:

    Conv2d.weight          [O, I, kh, kw]  -> kernel [kh, kw, I, O]
    ConvTranspose2d.weight [I, O, kh, kw]  -> kernel [kh, kw, I, O],
                                              flipped in kh and kw
    Linear.weight          [O, I]          -> kernel [I, O]
    BatchNorm2d            weight / bias   -> scale / bias (params)
                           running stats   -> mean / var (batch_stats)
    LSTM weight_ih_l{k}    [4H, D]         -> l{k}_fwd/w_ih [D, 4H]
         bias_ih + bias_hh (summed)        -> l{k}_fwd/b    [4H]
    GRU  weight_ih_l{k}    [3H, D]         -> l{k}_fwd/w_ih [D, 3H]
         bias_ih / bias_hh (kept apart: the reset gate scales the hidden
         side's n bias)                    -> b_ih / b_hh
    *_l{k}_reverse (bidirectional)         -> l{k}_bwd/...

A template RNN's layers, cell and directions are read from the template,
as the JAX package reads them: the layer count from its ``l{k}_fwd``
modules, a reverse direction from its ``l{k}_bwd``, the cell from the gate
ratio of ``w_ih`` to ``w_hh`` (4 an LSTM, 3 a GRU). The matcher is always
strict, as the JAX package's is by default: a torch key left over, a
template module with no torch tensors or a shape mismatch is an error, and
nothing is loaded.

The reference's own layer names are not known (no reference checkpoint is
in the repository), so ``name_map`` (template path -> torch module prefix)
is the caller's; the default is the identity, the port's module names.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplio_tpu_torch.models.from_flax import (
    load_flax_variables,
    to_flax_variables,
)

__all__ = [
    "convert_conv",
    "convert_conv_transpose",
    "convert_dense",
    "convert_batchnorm",
    "convert_rnn",
    "import_state_dict",
    "import_into",
    "import_reference_checkpoint",
    "load_reference_checkpoint",
]

Tree = Dict[str, Any]
NameMap = Callable[[Tuple[str, ...]], Optional[str]]
CHECKPOINT_KEYS = ("state_dict", "model", "model_state_dict")


def _np(t) -> np.ndarray:
    """torch.Tensor | ndarray -> float32 ndarray (detached, on the host)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


# ------------------------------------------------ per-layer converters

def convert_conv(weight, bias=None) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(_np(weight), (2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def convert_conv_transpose(weight, bias=None) -> Dict[str, np.ndarray]:
    # PyTorch's transposed conv correlates with its weight flipped, flax's
    # ConvTranspose with its kernel as it stands
    w = np.transpose(_np(weight), (2, 3, 0, 1))[::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w)}
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def convert_dense(weight, bias=None) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(weight).T}
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def convert_batchnorm(weight, bias, running_mean, running_var
                      ) -> Tuple[Dict[str, np.ndarray],
                                 Dict[str, np.ndarray]]:
    return ({"scale": _np(weight), "bias": _np(bias)},
            {"mean": _np(running_mean), "var": _np(running_var)})


def _directions(bidirectional: bool):
    return (("fwd", ""), ("bwd", "_reverse")) if bidirectional else \
        (("fwd", ""),)


def _rnn_keys(prefix: str, num_layers: int, bidirectional: bool = False):
    return [f"{prefix}{t}_l{k}{suffix}" for k in range(num_layers)
            for _, suffix in _directions(bidirectional)
            for t in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]


def convert_rnn(sd: Mapping[str, Any], prefix: str, num_layers: int,
                cell: str = "lstm", bidirectional: bool = False
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """An ``nn.LSTM``'s or ``nn.GRU``'s tensors under ``prefix`` ->
    ``{"l{k}_fwd": {...}, ["l{k}_bwd": {...}]}``
    (``ops/rnn.py::MaskedRNN``). The port's LSTM cell adds one bias,
    torch's two: ``b = bias_ih + bias_hh``; the GRU keeps both."""
    if cell not in ("lstm", "gru"):
        raise ValueError(f"unknown rnn cell {cell!r}")
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k in range(num_layers):
        for side, suffix in _directions(bidirectional):
            def t(name):
                return _np(sd[f"{prefix}{name}_l{k}{suffix}"])
            p = {"w_ih": t("weight_ih").T, "w_hh": t("weight_hh").T}
            if cell == "lstm":
                p["b"] = t("bias_ih") + t("bias_hh")
            else:
                p.update(b_ih=t("bias_ih"), b_hh=t("bias_hh"))
            out[f"l{k}_{side}"] = p
    return out


# ------------------------------------------------ structural matcher

def _classify(params: Mapping[str, Any]) -> Optional[str]:
    """A template module's kind from its leaf names."""
    keys = set(params)
    if keys in ({"kernel"}, {"kernel", "bias"}):
        return "conv" if np.ndim(params["kernel"]) == 4 else "dense"
    if keys == {"scale", "bias"}:
        return "batchnorm"
    if keys and all(k.startswith("l") and ("_fwd" in k or "_bwd" in k)
                    for k in keys):
        inner = next(iter(params.values()))
        if isinstance(inner, Mapping) and "w_ih" in inner:
            return "rnn"
    return None


def _walk(tree: Mapping[str, Any], path: Tuple[str, ...] = ()):
    """(path, module, kind) for every classified module of the tree."""
    kind = _classify(tree)
    if kind is not None:
        yield path, tree, kind
        return
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _walk(sub, path + (name,))


def _put(tree: Tree, path: Tuple[str, ...], value: Any) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _rnn_meta(module: Mapping[str, Any]) -> Tuple[int, str, bool]:
    """(layers, cell, bidirectional) of the template RNN ``module``: its
    ``l{k}_fwd`` count, the gate ratio of its first layer's ``w_ih`` [D,
    gates * H] to ``w_hh`` [H, gates * H], and whether it has an
    ``l{k}_bwd``."""
    fwd = sorted(k for k in module if k.endswith("_fwd"))
    first = module[fwd[0]]
    gates = np.shape(first["w_ih"])[1] // np.shape(first["w_hh"])[0]
    return (len(fwd), {4: "lstm", 3: "gru"}[gates],
            any(k.endswith("_bwd") for k in module))


def import_state_dict(state_dict: Mapping[str, Any],
                      params: Mapping[str, Any],
                      batch_stats: Optional[Mapping[str, Any]] = None,
                      name_map: Optional[NameMap] = None
                      ) -> Tuple[Tree, Tree]:
    """Fill the template trees ``params`` / ``batch_stats`` from a torch
    ``state_dict``: new ``(params, batch_stats)`` numpy trees.

    ``name_map``: template module path -> torch module prefix (None keeps
    the template's values for that module). Every torch key consumed,
    every template module filled, every shape equal, or ``ValueError``."""
    name_map = name_map or (lambda path: ".".join(path))
    sd = dict(state_dict)
    consumed = set()

    def take(key):
        consumed.add(key)
        return sd[key]

    new_params: Tree = {}
    new_stats: Tree = {}
    unmatched = []
    for path, module, kind in _walk(params):
        prefix = name_map(path)
        if prefix is None:
            _put(new_params, path, module if kind == "rnn" else
                 {k: np.asarray(v) for k, v in module.items()})
            continue
        dot = prefix + "." if prefix else ""
        try:
            if kind == "conv":
                w = take(dot + "weight")
                b = take(dot + "bias") if dot + "bias" in sd else None
                # a transposed conv's [I, O] is shape-identical to a
                # conv's [O, I] when I == O: the flax name decides first
                deconv = any("ConvTranspose" in p for p in path)
                named_conv = not deconv and any(
                    p.startswith("Conv_") or p == "Conv" for p in path)
                if not (deconv or named_conv):
                    tw = _np(w)
                    deconv = not (tw.ndim == 4 and tuple(
                        np.transpose(tw, (2, 3, 1, 0)).shape)
                        == tuple(np.shape(module["kernel"])))
                _put(new_params, path, convert_conv_transpose(w, b)
                     if deconv else convert_conv(w, b))
            elif kind == "dense":
                b = take(dot + "bias") if dot + "bias" in sd else None
                _put(new_params, path, convert_dense(take(dot + "weight"), b))
            elif kind == "batchnorm":
                p, s = convert_batchnorm(
                    take(dot + "weight"), take(dot + "bias"),
                    take(dot + "running_mean"), take(dot + "running_var"))
                if dot + "num_batches_tracked" in sd:
                    take(dot + "num_batches_tracked")
                _put(new_params, path, p)
                _put(new_stats, path, s)
            else:
                layers, cell, bidi = _rnn_meta(module)
                sub = convert_rnn(sd, dot, layers, cell, bidi)
                # exactly the keys read: extra layers or directions stay
                # leftovers
                consumed.update(_rnn_keys(dot, layers, bidi))
                _put(new_params, path, sub)
        except KeyError as e:
            unmatched.append(f"{'/'.join(path)} <- {dot}* (missing {e})")

    def check(ref, new, path=()):
        for k in new:
            if k not in ref:
                unmatched.append(f"imported leaf has no template home: "
                                 f"{'/'.join(path + (k,))}")
        for k, v in ref.items():
            if k not in new:
                unmatched.append(f"template module not imported: "
                                 f"{'/'.join(path + (k,))}")
            elif isinstance(v, Mapping):
                check(v, new[k], path + (k,))
            elif tuple(np.shape(v)) != tuple(np.shape(new[k])):
                unmatched.append(
                    f"shape mismatch at {'/'.join(path + (k,))}: template "
                    f"{np.shape(v)} vs imported {np.shape(new[k])}")

    check(params, new_params)
    if batch_stats:
        check(batch_stats, new_stats)
    leftovers = sorted(set(sd) - consumed)
    if unmatched or leftovers:
        raise ValueError("torch import mismatch:\n  " + "\n  ".join(
            unmatched + [f"unconsumed torch key: {k}" for k in leftovers]))
    return new_params, new_stats


def _read_checkpoint(path: str) -> Mapping[str, Any]:
    """A torch checkpoint file's ``state_dict``, unwrapped from
    ``state_dict`` / ``model`` / ``model_state_dict`` when wrapped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    for key in CHECKPOINT_KEYS:
        if isinstance(blob, dict) and isinstance(blob.get(key), dict):
            return blob[key]
    return blob


def import_reference_checkpoint(path: str, params: Mapping[str, Any],
                                batch_stats: Optional[Mapping[str, Any]] = None,
                                name_map: Optional[NameMap] = None
                                ) -> Tuple[Tree, Tree]:
    """:func:`import_state_dict` of a checkpoint file (read with
    ``weights_only=True``; a bare ``state_dict`` or one wrapped under
    ``state_dict``, ``model`` or ``model_state_dict``): ``(params,
    batch_stats)`` numpy trees, as the JAX package's function returns.
    For a ``factorized`` config, import onto the classic tree and pass the
    result through ``models/zoo.py::factorize_stem_variables``, as the JAX
    package does. A ``fire: fused`` template raises: the fused Fire's
    parameters are not the reference Fire's."""
    return import_state_dict(_read_checkpoint(path), params, batch_stats,
                             name_map=name_map)


def import_into(model: nn.Module, state_dict: Mapping[str, Any],
                name_map: Optional[NameMap] = None) -> nn.Module:
    """Load a reference ``state_dict`` into ``model``, its own tree as the
    template; returns ``model``."""
    template = to_flax_variables(model)
    params, stats = import_state_dict(
        state_dict, template["params"], template.get("batch_stats"),
        name_map=name_map)
    load_flax_variables(model, {"params": params, "batch_stats": stats}
                        if stats else {"params": params})
    return model


def load_reference_checkpoint(path: str, model: nn.Module,
                              name_map: Optional[NameMap] = None
                              ) -> nn.Module:
    """:func:`import_into` from a checkpoint file."""
    return import_into(model, _read_checkpoint(path), name_map)
