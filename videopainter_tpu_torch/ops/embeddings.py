"""Timestep embeddings: sinusoidal features and the TimestepEmbedding MLP.

Counterpart of `videopainter_tpu/ops/embeddings.py`. CogVideoX uses
flip_sin_to_cos=True, freq_shift=0 and a silu MLP.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .basic import Linear, silu


def timestep_embedding(timesteps: torch.Tensor, embedding_dim: int, *,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       scale: float = 1.0,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [N] -> [N, embedding_dim] float32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32,
                                                    device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, in_dim: int, time_embed_dim: int, *, device=None, dtype=None):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim, device=device, dtype=dtype)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, device=device, dtype=dtype)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(silu(self.linear_1(t_emb)))
