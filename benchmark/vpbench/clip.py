"""A traffic mix's inputs, drawn from the seed on the device: the video, its
hole, the prompt embeddings and every noise the loop consumes. The negative
prompt is the empty one, the same for every clip: zeros.

Every seed gets the same sizes: the hole is a rectangle of a fixed fraction
of each side at a position drawn from the seed, so the masked-token count
(which sizes the any-length capture) is the same in every run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Clip:
    video: torch.Tensor        # [1, T, H, W, 3] float32 in [-1, 1]
    masks: torch.Tensor        # [1, T, H, W] float32, 1 = hole
    image: torch.Tensor        # [1, H, W, 3] the first frame with its hole blanked
    prompt: torch.Tensor       # [1, S_text, text_dim] float32
    negative: torch.Tensor     # [1, S_text, text_dim] zeros: the empty negative prompt
    noise0: torch.Tensor       # [1, T_lat, h, w, C] the initial noise, float32
    sde: torch.Tensor          # [steps, 1, T_lat, h, w, C] the DPM SDE noise, float32
    noise_w1: torch.Tensor     # [1, T_lat, h, w, C] window 1's noise (any length), float32


def latent_shape(frames: int, height: int, width: int, vae: dict):
    down = 2 ** (len(vae["block_out_channels"]) - 1)
    return ((frames - 1) // vae["temporal_compression_ratio"] + 1, height // down,
            width // down, vae["latent_channels"])


def make(gen: torch.Generator, *, frames: int, height: int, width: int, steps: int,
         hole: float, text_len: int, text_dim: int, vae: dict, device,
         latent_frames: Optional[int] = None) -> Clip:
    video = torch.rand((1, frames, height, width, 3), generator=gen, device=device) * 2 - 1
    hh, hw = int(round(height * hole)), int(round(width * hole))
    top = int(torch.randint(0, height - hh + 1, (1,), generator=gen, device=device))
    left = int(torch.randint(0, width - hw + 1, (1,), generator=gen, device=device))
    masks = torch.zeros((1, frames, height, width), device=device)
    masks[:, :, top:top + hh, left:left + hw] = 1.0
    image = video[:, 0] * (1 - masks[:, 0, ..., None])
    prompt = torch.randn((1, text_len, text_dim), generator=gen, device=device)
    negative = torch.zeros((1, text_len, text_dim), device=device)
    lat = latent_shape(latent_frames or frames, height, width, vae)
    noise0 = torch.randn((1, *lat), generator=gen, device=device)
    sde = torch.randn((steps, 1, *lat), generator=gen, device=device)
    noise_w1 = torch.randn((1, *lat), generator=gen, device=device)
    return Clip(video, masks, image, prompt, negative, noise0, sde, noise_w1)
