"""Transformer feed-forward: Linear -> gelu(tanh) -> Linear.

Counterpart of `videopainter_tpu/ops/feed_forward.py`. The submodule names
follow diffusers' FeedForward (`net.0.proj`, `net.2`), so the reference
state dict loads directly; `net.1` is the dropout slot, identity at
inference.
"""

from __future__ import annotations

import torch
from torch import nn

from .basic import Linear, gelu_tanh


class GELUProj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.proj = Linear(dim_in, dim_out, bias=bias, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_tanh(self.proj(x))


class FeedForward(nn.Module):
    def __init__(self, dim: int, *, mult: int = 4, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([
            GELUProj(dim, inner, bias=bias, device=device, dtype=dtype),
            nn.Identity(),
            Linear(inner, dim, bias=bias, device=device, dtype=dtype),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.net:
            x = m(x)
        return x
