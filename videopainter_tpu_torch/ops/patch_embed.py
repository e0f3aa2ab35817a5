"""Joint [text ‖ video] patch embedding (CogVideoXPatchEmbed).

Counterpart of `videopainter_tpu/ops/patch_embed.py`. The reference's
Conv2d(p, stride=p) per frame is a reshape plus one matmul; the weight keeps
the reference's conv layout [O, I, p, p] (`proj.weight`), so the state dict
loads as is, and is flattened to [O, (p p I)] at use. Video layout is
channels-last [B, T, H, W, C].

Masks are avg-pooled to the patch grid and binarized with > 0 (any masked
pixel in a patch marks the whole patch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .basic import Linear, linear


def patchify(video: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, T*(H/p)*(W/p), p*p*C] with (ph, pw, c) minor order."""
    b, t, h, w, c = video.shape
    p = patch_size
    x = video.reshape(b, t, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t * (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, num_frames: int, height: int, width: int,
               patch_size: int) -> torch.Tensor:
    """[B, T*h*w, p*p*C] (channel-major (c, ph, pw) per token) -> [B, T, H, W, C]."""
    b, s, d = tokens.shape
    p = patch_size
    h, w = height // p, width // p
    c = d // (p * p)
    x = tokens.reshape(b, num_frames, h, w, c, p, p)
    x = x.permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, num_frames, height, width, c)


def pool_patch_mask(masks: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, T, H, W] (float 0/1) -> bool [B, T*(H/p)*(W/p)] via avgpool + (>0)."""
    b, t, h, w = masks.shape
    p = patch_size
    m = masks.reshape(b, t, h // p, p, w // p, p).mean(dim=(3, 5))
    return (m > 0.0).reshape(b, t * (h // p) * (w // p))


class PatchEmbed(nn.Module):
    def __init__(self, *, patch_size: int, in_channels: int, embed_dim: int,
                 text_embed_dim: int, device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size,
                              device=device, dtype=dtype)
        self.text_proj = Linear(text_embed_dim, embed_dim, device=device, dtype=dtype)

    def forward(self, text_embeds: torch.Tensor, video: torch.Tensor, *,
                masks: Optional[torch.Tensor] = None,
                pos_embedding: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (joint embeds [B, S_text+S_vid, D], patch mask bool [B, S_vid] | None)."""
        text = self.text_proj(text_embeds)
        w = self.proj.weight.permute(0, 2, 3, 1).flatten(1)  # [O, (p p I)]
        vid = linear(patchify(video, self.patch_size), w, self.proj.bias)
        embeds = torch.cat([text, vid.to(text.dtype)], dim=1)
        if pos_embedding is not None:
            embeds = embeds + pos_embedding.to(embeds.dtype)
        patch_mask = pool_patch_mask(masks, self.patch_size) if masks is not None else None
        return embeds, patch_mask
