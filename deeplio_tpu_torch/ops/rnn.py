"""Masked multi-layer LSTM (counterpart of ``deeplio_tpu/ops/rnn.py``:
``LstmCellScan`` and ``MaskedRNN``, LSTM and unidirectional only).

Sequences arrive padded with a validity mask. A masked step keeps ``h, c``
and emits the carried ``h``, so the final state is the state after the last
valid step. ``nn.LSTM`` and cuDNN cannot express that, hence the explicit
loop over time; the input projection for all steps is hoisted into one
matmul. Gates are ordered i, f, g, o with one fused bias ``b``; the
weights keep the JAX layout (``w_ih [D, 4H]``, ``w_hh [H, 4H]``).
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

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D], mask [B, T] (1 = valid) -> (outputs [B, T, H],
        final hidden [B, H])."""
        b, t, _ = x.shape
        xp = F.linear(x, self.w_ih.t(), self.b)        # hoisted [B, T, 4H]
        h = xp.new_zeros(b, self.hidden_size)
        c = xp.new_zeros(b, self.hidden_size)
        ys = []
        for step in range(t):
            gates = xp[:, step] + torch.matmul(h, self.w_hh)
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            m = mask[:, step, None].to(h_new.dtype)
            h = m * h_new + (1 - m) * h
            c = m * c_new + (1 - m) * c
            ys.append(h)
        return torch.stack(ys, dim=1), h


class MaskedRNN(nn.Module):
    """Stack of unidirectional masked LSTM layers (``l{k}_fwd``).

    Returns (outputs of the last layer [B, T, H], its final hidden [B, H]).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            setattr(self, f"l{k}_fwd", LstmCellScan(
                input_size if k == 0 else hidden_size, hidden_size))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = x.new_ones(x.shape[:2], dtype=torch.float32)
        y, final = x, None
        for k in range(self.num_layers):
            y, final = getattr(self, f"l{k}_fwd")(y, mask)
        return y, final
