"""Masked multi-layer LSTM and GRU (counterpart of
``deeplio_tpu/ops/rnn.py``: ``LstmCellScan``, ``GruCellScan`` and
``MaskedRNN``, one or two directions).

Sequences arrive padded with a validity mask. A masked step keeps the
state and emits the carried ``h``, so the final state is the state after
the last valid step. ``nn.LSTM``/``nn.GRU`` and cuDNN cannot express that,
hence the explicit loop over time; the input projection for all steps is
hoisted into one matmul. The weights keep the JAX layout (``w_ih [D,
gates * H]``, ``w_hh [H, gates * H]``). LSTM gates are ordered i, f, g, o
with one fused bias ``b``; GRU gates r, z, n, torch's, with ``n = tanh(xn
+ r * (h @ w_hh + b_hh)_n)``, so its two biases ``b_ih`` and ``b_hh``
cannot be fused.

A reverse direction flips the inputs and the mask along time, runs, and
flips its outputs back; its final state is the state after the first
valid step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LstmCellScan(nn.Module):
    """One LSTM layer run over time with mask pass-through."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_ih = nn.Parameter(torch.empty(input_size, 4 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 4 * hidden_size))
        self.b = nn.Parameter(torch.empty(4 * hidden_size))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D], mask [B, T] (1 = valid) -> (outputs [B, T, H],
        final hidden [B, H]); ``reverse`` runs backward in time."""
        b, t, _ = x.shape
        xp = F.linear(x, self.w_ih.t(), self.b)        # hoisted [B, T, 4H]
        h = xp.new_zeros(b, self.hidden_size)
        c = xp.new_zeros(b, self.hidden_size)
        ys = []
        for step in (reversed(range(t)) if reverse else range(t)):
            gates = xp[:, step] + torch.matmul(h, self.w_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            m = mask[:, step, None].to(h_new.dtype)
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            ys.append(h)
        if reverse:
            ys.reverse()
        return torch.stack(ys, dim=1), h


class GruCellScan(nn.Module):
    """One GRU layer run over time with mask pass-through."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.w_ih = nn.Parameter(torch.empty(input_size, 3 * hidden_size))
        self.w_hh = nn.Parameter(torch.empty(hidden_size, 3 * hidden_size))
        self.b_ih = nn.Parameter(torch.empty(3 * hidden_size))
        self.b_hh = nn.Parameter(torch.empty(3 * hidden_size))

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D], mask [B, T] (1 = valid) -> (outputs [B, T, H],
        final hidden [B, H]); ``reverse`` runs backward in time."""
        b, t, _ = x.shape
        xp = F.linear(x, self.w_ih.t(), self.b_ih)     # hoisted [B, T, 3H]
        h = xp.new_zeros(b, self.hidden_size)
        ys = []
        for step in (reversed(range(t)) if reverse else range(t)):
            hp = F.linear(h, self.w_hh.t(), self.b_hh)
            xr, xz, xn = xp[:, step].chunk(3, dim=-1)
            hr, hz, hn = hp.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            m = mask[:, step, None].to(h_new.dtype)
            h = m * h_new + (1 - m) * h
            ys.append(h)
        if reverse:
            ys.reverse()
        return torch.stack(ys, dim=1), h


CELLS = {"lstm": LstmCellScan, "gru": GruCellScan}


class MaskedRNN(nn.Module):
    """Stack of masked LSTM or GRU layers, one or two directions
    (``l{k}_fwd``, and ``l{k}_bwd`` when bidirectional).

    Returns (outputs of the last layer [B, T, H * dirs], final [B, H *
    dirs]): ``final`` concatenates the last layer's forward state after
    the last valid step and its backward state after the first. A layer
    above the first reads both directions' outputs, concatenated.
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 cell: str = "lstm", bidirectional: bool = False):
        super().__init__()
        if cell not in CELLS:
            raise ValueError(f"cell must be {'|'.join(CELLS)}, got {cell!r}")
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        dirs = 2 if bidirectional else 1
        for k in range(num_layers):
            d = input_size if k == 0 else dirs * hidden_size
            setattr(self, f"l{k}_fwd", CELLS[cell](d, hidden_size))
            if bidirectional:
                setattr(self, f"l{k}_bwd", CELLS[cell](d, hidden_size))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = x.new_ones(x.shape[:2], dtype=torch.float32)
        y, final = x, None
        for k in range(self.num_layers):
            ys, final = getattr(self, f"l{k}_fwd")(y, mask)
            if self.bidirectional:
                ys_b, h_b = getattr(self, f"l{k}_bwd")(y, mask, reverse=True)
                ys = torch.cat([ys, ys_b], dim=-1)
                final = torch.cat([final, h_b], dim=-1)
            y = ys
        return y, final
