"""Joint [text ‖ video] patch embedding (CogVideoXPatchEmbed).

Counterpart of `videopainter_tpu/ops/patch_embed.py`. The reference's
Conv2d(p, stride=p) per frame is a reshape plus one matmul; the weight keeps
the reference's conv layout [O, I, p, p] (`proj.weight`), so the state dict
loads as is, and is flattened to [O, (p p I)] at use. Video layout is
channels-last [B, T, H, W, C].

CogVideoX 1.5 (`patch_size_t` = q) patches q latent frames at once: a token
(t', h', w') holds the q x p x p cells of its window, its features ordered
channel-major (c, dt, dh, dw), and the projection is a Linear
[O, C q p p] (bias-free in the published model), the diffusers layout.

Masks are avg-pooled to the patch grid (over q frames too for 1.5) and
binarized with > 0 (any masked pixel in a patch marks the whole patch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .basic import Linear, linear


def patchify(video: torch.Tensor, patch_size: int,
             patch_size_t: Optional[int] = None) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T*(H/p)*(W/p), p*p*C] with (ph, pw, c) minor
    order; with patch_size_t = q, [B, (T/q)*(H/p)*(W/p), C*q*p*p] with
    (c, dt, dh, dw) minor order."""
    b, t, h, w, c = video.shape
    p, q = patch_size, patch_size_t
    if q is not None:
        x = video.reshape(b, t // q, q, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)
        return x.reshape(b, (t // q) * (h // p) * (w // p), c * q * p * p)
    x = video.reshape(b, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, num_frames: int, height: int, width: int,
               patch_size: int, patch_size_t: Optional[int] = None) -> torch.Tensor:
    """[B, (T/q)*h*w, C*q*p*p] (channel-major (c, dt, dh, dw) per token) ->
    [B, T, H, W, C]; q = patch_size_t, 1 for per-frame patches."""
    b, s, d = tokens.shape
    p, q = patch_size, patch_size_t or 1
    h, w = height // p, width // p
    c = d // (q * p * p)
    x = tokens.reshape(b, num_frames // q, h, w, c, q, p, p)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, num_frames, height, width, c)


def pool_patch_mask(masks: torch.Tensor, patch_size: int,
                    patch_size_t: Optional[int] = None) -> torch.Tensor:
    """[B, T, H, W] (float 0/1) -> bool [B, (T/q)*(H/p)*(W/p)]: averaged over
    (q, p, p) windows, q = patch_size_t or 1, and binarized with > 0."""
    b, t, h, w = masks.shape
    p, q = patch_size, patch_size_t or 1
    m = masks.reshape(b, t // q, q, h // p, p, w // p, p).mean(dim=(2, 4, 6))
    return (m > 0.0).reshape(b, -1)


class PatchEmbed(nn.Module):
    def __init__(self, *, patch_size: int, in_channels: int, embed_dim: int,
                 text_embed_dim: int, patch_size_t: Optional[int] = None, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.patch_size_t = patch_size_t
        if patch_size_t is None:
            self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size,
                                  device=device, dtype=dtype)
        else:
            self.proj = Linear(in_channels * patch_size_t * patch_size * patch_size, embed_dim,
                               bias=bias, device=device, dtype=dtype)
        self.text_proj = Linear(text_embed_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, text_embeds: torch.Tensor, video: torch.Tensor, *,
                masks: Optional[torch.Tensor] = None,
                pos_embedding: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (joint embeds [B, S_text+S_vid, D], patch mask bool [B, S_vid] | None)."""
        text = self.text_proj(text_embeds)
        if self.patch_size_t is None:
            w = self.proj.weight.permute(0, 2, 3, 1).flatten(1)  # [O, (p p I)]
            vid = linear(patchify(video, self.patch_size), w, self.proj.bias)
        else:
            vid = self.proj(patchify(video, self.patch_size, self.patch_size_t))
        embeds = torch.cat([text, vid.to(text.dtype)], dim=1)
        if pos_embedding is not None:
            embeds = embeds + pos_embedding.to(embeds.dtype)
        patch_mask = (None if masks is None else
                      pool_patch_mask(masks, self.patch_size, self.patch_size_t))
        return embeds, patch_mask
