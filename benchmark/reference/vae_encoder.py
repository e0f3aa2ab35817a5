"""Plain float32 reference of CogVideoX's causal 3D VAE encoder
(diffusers' AutoencoderKLCogVideoX.encode, as the published VAE config sets
it up: frame batches of 8 with causal conv caches carried between them, the
first batch taking the remainder), over a state dict with the diffusers
names. Returns the posterior's mean times the scaling factor, the latents a
pipeline uses in its deterministic ("mode") encode.

Imports nothing of the program under test. Run with cuDNN's TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


class Encoder:
    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, *, device):
        self.sd, self.cfg, self.dev = sd, cfg, device
        self.groups = cfg.get("norm_num_groups", 32)
        self.eps = cfg.get("norm_eps", 1e-6)

    def w(self, name):
        return self.sd["encoder." + name].to(self.dev, torch.float32)

    def causal_conv(self, x, name, cache: Optional[torch.Tensor]):
        w, b = self.w(name + ".conv.weight"), self.w(name + ".conv.bias")
        kt, kh, kw = w.shape[2:]
        if kt > 1:
            lead = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if cache is None else cache
            x = torch.cat([lead, x], dim=2)
            cache = x[:, :, -(kt - 1):].clone()
        return F.conv3d(x, w, b, padding=(0, kh // 2, kw // 2)), cache

    def norm(self, x, name):
        return F.group_norm(x, self.groups, self.w(name + ".weight"), self.w(name + ".bias"),
                            self.eps)

    def resnet(self, x, name, cache):
        cache = cache or {}
        h = F.silu(self.norm(x, name + ".norm1"))
        h, c1 = self.causal_conv(h, name + ".conv1", cache.get("c1"))
        h = F.silu(self.norm(h, name + ".norm2"))
        h, c2 = self.causal_conv(h, name + ".conv2", cache.get("c2"))
        if "encoder." + name + ".conv_shortcut.weight" in self.sd:
            x = F.conv3d(x, self.w(name + ".conv_shortcut.weight"),
                         self.w(name + ".conv_shortcut.bias"))
        return h + x, {"c1": c1, "c2": c2}

    def downsample(self, x, name, compress_time: bool):
        if compress_time:
            first, rest = (x[:, :, :1], x[:, :, 1:]) if x.shape[2] % 2 else (x[:, :, :0], x)
            if rest.shape[2]:
                rest = (rest[:, :, 0::2] + rest[:, :, 1::2]) * 0.5
            x = torch.cat([first, rest], dim=2)
        b, c, t, h, w = x.shape
        frames = F.pad(x, (0, 1, 0, 1)).permute(0, 2, 1, 3, 4).reshape(b * t, c, h + 1, w + 1)
        y = F.conv2d(frames, self.w(name + ".conv.weight"), self.w(name + ".conv.bias"), stride=2)
        return y.reshape(b, t, c, *y.shape[2:]).permute(0, 2, 1, 3, 4)

    def chunk(self, x, cache):
        """One frame batch through the encoder; returns (moments, cache)."""
        new = {}
        levels = int(math.log2(self.cfg.get("temporal_compression_ratio", 4)))
        n_blocks = len(self.cfg["block_out_channels"])
        h, new["in"] = self.causal_conv(x, "conv_in", cache.get("in"))
        for i in range(n_blocks):
            for j in range(self.cfg["layers_per_block"]):
                key = f"down_blocks.{i}.resnets.{j}"
                h, new[key] = self.resnet(h, key, cache.get(key))
            if i < n_blocks - 1:
                h = self.downsample(h, f"down_blocks.{i}.downsamplers.0", i < levels)
        for j in range(2):
            key = f"mid_block.resnets.{j}"
            h, new[key] = self.resnet(h, key, cache.get(key))
        h = F.silu(self.norm(h, "norm_out"))
        h, new["out"] = self.causal_conv(h, "conv_out", cache.get("out"))
        return h, new

    @torch.no_grad()
    def latents(self, video: torch.Tensor) -> torch.Tensor:
        """video [B, T, H, W, 3] in [-1, 1] -> scaled posterior mean
        [B, T', H/8, W/8, latent_channels], float32."""
        return self.moments(video)[0] * self.cfg["scaling_factor"]

    @torch.no_grad()
    def moments(self, video: torch.Tensor):
        """video [B, T, H, W, 3] -> the posterior's (mean, logvar), each
        [B, T', H/8, W/8, latent_channels], float32, unscaled."""
        x = video.to(self.dev, torch.float32).permute(0, 4, 1, 2, 3)
        t, fbs = x.shape[2], 8
        n = max(t // fbs if t > 1 else 1, 1)
        rem = t % fbs
        outs, cache = [], {}
        for i in range(n):
            s, e = fbs * i + (0 if i == 0 else rem), fbs * (i + 1) + rem
            y, cache = self.chunk(x[:, :, s:e], cache)
            outs.append(y)
        moments = torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)
        c = self.cfg["latent_channels"]
        return moments[..., :c], moments[..., c:2 * c]
