"""AdaLN-style conditioning norms (CogVideoXLayerNormZero, AdaLayerNorm).

Counterpart of `videopainter_tpu/ops/norms.py`. The modulation (linear of
silu(temb)) and its application run in float32; outputs return to the
activation dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import annotate
from .basic import LayerNorm, Linear, silu


class LayerNormZero(nn.Module):
    """CogVideoXLayerNormZero: 6-way chunk (shift, scale, gate) for video,
    then text."""

    def __init__(self, cond_dim: int, embed_dim: int, *, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None, dtype=None):
        super().__init__()
        self.linear = Linear(cond_dim, 6 * embed_dim, device=device, dtype=dtype)
        self.norm = LayerNorm(embed_dim, eps=eps, elementwise_affine=elementwise_affine,
                              device=device, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor], temb: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor,
                           Optional[torch.Tensor]]:
        """Returns (h, enc_h, gate, enc_gate); enc_* None when
        encoder_hidden_states is None. Runs under the `dit.adaln` span."""
        with annotate("dit.adaln"):
            mod = self.linear(silu(temb.float()))
            shift, scale, gate, enc_shift, enc_scale, enc_gate = mod.chunk(6, dim=-1)
            dt = hidden_states.dtype
            h = self.norm(hidden_states)
            h = (h.float() * (1 + scale[:, None, :]) + shift[:, None, :]).to(dt)
            if encoder_hidden_states is None:
                return h, None, gate[:, None, :].to(dt), None
            e = self.norm(encoder_hidden_states)
            e = (e.float() * (1 + enc_scale[:, None, :]) + enc_shift[:, None, :]).to(
                encoder_hidden_states.dtype)
            return h, e, gate[:, None, :].to(dt), enc_gate[:, None, :].to(dt)


class AdaLayerNorm(nn.Module):
    """Final-output AdaLN with chunk_dim=1: (shift, scale) chunk order."""

    def __init__(self, embedding_dim: int, output_dim: int, *, eps: float = 1e-5,
                 elementwise_affine: bool = True, device=None, dtype=None):
        super().__init__()
        self.linear = Linear(embedding_dim, output_dim, device=device, dtype=dtype)
        self.norm = LayerNorm(output_dim // 2, eps=eps,
                              elementwise_affine=elementwise_affine,
                              device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        mod = self.linear(silu(temb.float()))
        shift, scale = mod.chunk(2, dim=-1)
        y = self.norm(x)
        y = y.float() * (1 + scale[:, None, :]) + shift[:, None, :]
        return y.to(x.dtype)
