"""AdaLN-style conditioning norms (CogVideoXLayerNormZero, AdaLayerNorm).

Counterpart of `videopainter_tpu/ops/norms.py`. The modulation (linear of
silu(temb)) runs in float32; the norm and its modulation are `ops/adaln.py`
`adaln` (one CUDA pass on the card, the eager chain on the CPU): outputs
return to the activation dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..utils.profiling import annotate
from .adaln import adaln
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
            h, e = adaln(hidden_states, shift, scale, *self.norm.affine(), eps=self.norm.eps,
                         enc=encoder_hidden_states, enc_shift=enc_shift, enc_scale=enc_scale)
            return (h, e, gate[:, None, :].to(dt),
                    None if e is None else enc_gate[:, None, :].to(dt))


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
        return adaln(x, shift, scale, *self.norm.affine(), eps=self.norm.eps)[0]
