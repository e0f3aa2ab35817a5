"""Hiera trunk + FPN neck (SAM2 image encoder).

Counterpart of `videopainter_tpu/segmentation/hiera.py` (reference
app/sam2/modeling/backbones/hieradet.py: MultiScaleAttention :60-107,
MultiScaleBlock :110-190, Hiera :193-317; image_encoder.py: FpnNeck
:44-140, ImageEncoder :14-41), with the torch SAM2's module names
(`trunk.blocks.{i}.attn.qkv`, `neck.convs.{j}.conv`, ...).

 - 7x7 stride-4 patch embed; position embedding = the bicubic-resized
   background embedding + the tiled window embedding (:284-296);
 - windowed attention per block, global at `global_att_blocks`, 2x2 max-pool
   of the queries at the first block of a stage (q-pooling);
 - the FPN neck: a 1x1 conv per level, top-down x2 fusion at
   `fpn_top_down_levels`, sine position encodings.

Every Hiera attention is the plain product (head dim 72 at every stage of
`large`; the JAX package runs none of it through a kernel either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .modules import (MLP, bicubic_resize_torch, gelu_exact, sdpa, sine_pos_embed,
                      window_partition, window_unpartition)


@dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 96
    num_heads: int = 1
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    d_model: int = 256
    scalp: int = 1
    fpn_top_down_levels: Optional[Tuple[int, ...]] = None  # None = all levels
    fpn_interp: str = "bilinear"

    @property
    def depth(self):
        return sum(self.stages)

    @property
    def stage_ends(self):
        return [sum(self.stages[:i]) - 1 for i in range(1, len(self.stages) + 1)]

    @property
    def q_pool_blocks(self):
        return [x + 1 for x in self.stage_ends[:-1]][: self.q_pool]

    def block_dims(self):
        """Per-block (dim_in, dim_out, heads, window_size, has_pool)."""
        out = []
        dim, heads, cur_stage = self.embed_dim, self.num_heads, 1
        for i in range(self.depth):
            dim_out = dim
            window = self.window_spec[cur_stage - 1]
            if self.global_att_blocks and i in self.global_att_blocks:
                window = 0
            if i - 1 in self.stage_ends:
                dim_out = int(dim * self.dim_mul)
                heads = int(heads * self.head_mul)
                cur_stage += 1
            out.append((dim, dim_out, heads, window, i in self.q_pool_blocks))
            dim = dim_out
        return out

    @property
    def channel_list(self):
        dims = [d_out for (_, d_out, _, _, _) in self.block_dims()]
        return [dims[i] for i in self.stage_ends[::-1]]


def _maxpool2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max-pool of [B, H, W, C] (floor at odd sizes)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, pool: bool):
        super().__init__()
        self.num_heads, self.pool = num_heads, pool
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)
        if self.pool:
            q = _maxpool2x(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, -1)
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.proj(out.transpose(1, 2).reshape(b, h, w, -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, num_heads: int, window: int, has_pool: bool):
        super().__init__()
        self.dim, self.dim_out, self.window, self.has_pool = dim, dim_out, window, has_pool
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, has_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * 4), dim_out, 2, act=gelu_exact)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        xn = self.norm1(x)
        if self.dim != self.dim_out:
            # q-pooling only happens where the width changes (reference :162-166)
            shortcut = self.proj(xn)
            if self.has_pool:
                shortcut = _maxpool2x(shortcut)
        window = self.window
        h, w = xn.shape[1:3]
        if window > 0:
            xw, pad_hw = window_partition(xn, window)
        else:
            xw, pad_hw = xn, (h, w)
        xw = self.attn(xw)
        if self.has_pool:
            window_out = window // 2 if window > 0 else 0
            oh, ow = shortcut.shape[1:3]
            if window > 0:
                pad_hw = (oh + (window_out - oh % window_out) % window_out,
                          ow + (window_out - ow % window_out) % window_out)
            h, w = oh, ow
            window = window_out
        if window > 0:
            xw = window_unpartition(xw, window, pad_hw, (h, w))
        x = shortcut + xw
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=4, padding=3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)   # BHWC


class Hiera(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim,
                                                  *cfg.window_pos_embed_bkg_spatial_size))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, cfg.window_spec[0],
                                                         cfg.window_spec[0]))
        self.blocks = nn.ModuleList(MultiScaleBlock(*spec) for spec in cfg.block_dims())

    def _pos_embed(self, h: int, w: int) -> torch.Tensor:
        pe = bicubic_resize_torch(self.pos_embed.float(), h, w)
        win = self.pos_embed_window
        pe = pe + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        return pe.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[B, 3, H, W] -> the stage ends, BHWC."""
        x = self.patch_embed(x)
        x = x + self._pos_embed(x.shape[1], x.shape[2])
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.stage_ends:
                feats.append(x)
        return feats


class FpnNeck(nn.Module):
    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList()
        for ch in cfg.channel_list:
            seq = nn.Sequential()
            seq.add_module("conv", nn.Conv2d(ch, cfg.d_model, 1))
            self.convs.append(seq)

    def forward(self, feats: List[torch.Tensor]):
        """BHWC stage ends -> (NCHW levels from stride 4 down, their sine
        encodings); convs[j] takes the level n - j (reference :101-140)."""
        cfg = self.cfg
        n = len(feats) - 1
        out: list = [None] * len(feats)
        pos: list = [None] * len(feats)
        top_down = (cfg.fpn_top_down_levels if cfg.fpn_top_down_levels is not None
                    else tuple(range(len(feats))))
        prev = None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i](feats[i].permute(0, 3, 1, 2))
            if prev is not None and i in top_down:
                if cfg.fpn_interp == "nearest":
                    up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
                else:
                    up = F.interpolate(prev.float(), scale_factor=2.0, mode=cfg.fpn_interp,
                                       align_corners=False)
                prev = lateral + up.to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
            pos[i] = sine_pos_embed(prev.shape[2], prev.shape[3], cfg.d_model,
                                    prev.device).expand(prev.shape[0], -1, -1, -1)
        return out, pos


class ImageEncoder(nn.Module):
    """Hiera trunk + FpnNeck. forward([B, 3, H, W]) returns {"backbone_fpn":
    [stride 4, 8, 16(, 32)] NCHW, "vision_pos_enc": [...], "vision_features":
    the last level} with the `scalp` lowest-resolution levels dropped."""

    def __init__(self, cfg: HieraConfig):
        super().__init__()
        self.cfg = cfg
        self.trunk = Hiera(cfg)
        self.neck = FpnNeck(cfg)

    def forward(self, image: torch.Tensor) -> dict:
        out, pos = self.neck(self.trunk(image))
        if self.cfg.scalp > 0:
            out, pos = out[: -self.cfg.scalp], pos[: -self.cfg.scalp]
        return {"backbone_fpn": out, "vision_pos_enc": pos, "vision_features": out[-1]}


def hiera_config(variant: str) -> HieraConfig:
    """Hiera trunk + neck of the published SAM2 checkpoints
    (app/sam2_configs/sam2_hiera_{t,s,b+,l}.yaml)."""
    common = dict(d_model=256, scalp=1, fpn_top_down_levels=(2, 3), fpn_interp="nearest",
                  window_pos_embed_bkg_spatial_size=(7, 7))
    presets = {
        "tiny": dict(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                     global_att_blocks=(5, 7, 9), window_spec=(8, 4, 14, 7)),
        "small": dict(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                      global_att_blocks=(7, 10, 13), window_spec=(8, 4, 14, 7)),
        "base_plus": dict(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                          global_att_blocks=(12, 16, 20), window_spec=(8, 4, 14, 7),
                          window_pos_embed_bkg_spatial_size=(14, 14)),
        "large": dict(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                      global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8)),
    }
    if variant not in presets:
        raise ValueError(f"unknown variant {variant}; choose {list(presets)}")
    return HieraConfig(**{**common, **presets[variant]})
