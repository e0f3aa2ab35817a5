"""Causal 3D VAE (AutoencoderKLCogVideoX).

Counterpart of `videopainter_tpu/models/vae.py`. The public functions keep
the JAX layout (video [B, T, H, W, 3], latents [B, T, h, w, C]); inside, the
modules run PyTorch's channel-first NCDHW layout, so the convolutions go to
cuDNN without transposes. Parameter names are the diffusers names.

 - Causal conv3d with explicit caches: each call takes (x, cache) and returns
   (y, new_cache), the cache being the trailing k_t-1 input frames; a fresh
   call replicates the first frame instead.
 - Frame-batched encode (8 pixel frames) and decode (2 latent frames), the
   caches carried across batches as in the reference.
 - Tiled encode/decode with linear blending that keeps the reference's
   in-place quirk: each tile blends against its already-blended neighbours.
The streaming decoder (the any-length pipeline's `stream_decode`) belongs to
a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig
from ..ops.basic import GroupNorm, init_random_, silu

Cache = Optional[Dict[str, Any]]


def _to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def nearest_resize3d(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """F.interpolate(mode='nearest') over (T, H, W) of [B, C, T, H, W] with
    integer index math: output index i reads floor(i * in / out)."""
    dev = x.device
    for dim, out in zip((2, 3, 4), size):
        n = x.shape[dim]
        if n != out:
            idx = torch.arange(out, device=dev) * n // out
            x = x.index_select(dim, idx)
    return x


def nearest_resize3d_ndhwc(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """nearest_resize3d over (T, H, W) of channels-last [B, T, H, W, C]."""
    return _to_ndhwc(nearest_resize3d(_to_ncdhw(x), size))


class CausalConv3d(nn.Module):
    """CogVideoXCausalConv3d: temporal causal padding from the cache (or
    replicas of the first frame), symmetric zero padding in space."""

    def __init__(self, cin: int, cout: int, k: int, *, device=None, dtype=None):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, k, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        kt, kh, kw = self.conv.kernel_size
        new_cache = None
        if kt > 1:
            lead = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if cache is None \
                else cache.to(x.dtype)
            x = torch.cat([lead, x], dim=2)
            new_cache = x[:, :, -(kt - 1):].clone()  # not a view pinning all of x
        w = self.conv.weight.to(x.dtype)
        b = self.conv.bias.to(x.dtype)
        return F.conv3d(x, w, b, padding=(0, kh // 2, kw // 2)), new_cache


class SpatialNorm3D(nn.Module):
    """CogVideoXSpatialNorm3D: GroupNorm(f) modulated by 1x1x1 convs of the
    nearest-resized zq; the first frame is resized separately when T is odd > 1."""

    def __init__(self, f_ch: int, zq_ch: int, groups: int, *, device=None, dtype=None):
        super().__init__()
        self.norm_layer = GroupNorm(groups, f_ch, eps=1e-6, device=device, dtype=dtype)
        self.conv_y = CausalConv3d(zq_ch, f_ch, 1, device=device, dtype=dtype)
        self.conv_b = CausalConv3d(zq_ch, f_ch, 1, device=device, dtype=dtype)

    def forward(self, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
        ft, fh, fw = f.shape[2:]
        if ft > 1 and ft % 2 == 1:
            z_first = nearest_resize3d(zq[:, :, :1], (1, fh, fw))
            z_rest = nearest_resize3d(zq[:, :, 1:], (ft - 1, fh, fw))
            zq = torch.cat([z_first, z_rest], dim=2)
        else:
            zq = nearest_resize3d(zq, (ft, fh, fw))
        return self.norm_layer(f) * self.conv_y(zq)[0] + self.conv_b(zq)[0]


class ResnetBlock3D(nn.Module):
    """CogVideoXResnetBlock3D, temb_channels=0 path; a plain 1x1x1
    `conv_shortcut` when the channel count changes."""

    def __init__(self, cin: int, cout: int, groups: int, zq_ch: Optional[int] = None, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if zq_ch is None:
            self.norm1 = GroupNorm(groups, cin, eps=1e-6, **kw)
            self.norm2 = GroupNorm(groups, cout, eps=1e-6, **kw)
        else:
            self.norm1 = SpatialNorm3D(cin, zq_ch, groups, **kw)
            self.norm2 = SpatialNorm3D(cout, zq_ch, groups, **kw)
        self.conv1 = CausalConv3d(cin, cout, 3, **kw)
        self.conv2 = CausalConv3d(cout, cout, 3, **kw)
        self.conv_shortcut = nn.Conv3d(cin, cout, 1, **kw) if cin != cout else None

    def _norm(self, norm, h, zq):
        return norm(h, zq) if zq is not None else norm(h)

    def forward(self, x: torch.Tensor, zq: Optional[torch.Tensor], cache: Cache
                ) -> Tuple[torch.Tensor, dict]:
        cache = cache or {}
        h = silu(self._norm(self.norm1, x, zq))
        h, c1 = self.conv1(h, cache.get("conv1"))
        h = silu(self._norm(self.norm2, h, zq))
        h, c2 = self.conv2(h, cache.get("conv2"))
        if self.conv_shortcut is not None:
            x = F.conv3d(x, self.conv_shortcut.weight.to(x.dtype),
                         self.conv_shortcut.bias.to(x.dtype))
        return h + x, {"conv1": c1, "conv2": c2}


def _per_frame_conv2d(conv: nn.Conv2d, x: torch.Tensor, *, stride: int,
                      padding: int) -> torch.Tensor:
    b, c, t, h, w = x.shape
    x2 = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    y = F.conv2d(x2, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=stride,
                 padding=padding)
    return y.reshape(b, t, *y.shape[1:]).permute(0, 2, 1, 3, 4)


class Downsample3D(nn.Module):
    """CogVideoXDownsample3D: optional causal time avg-pool (first frame kept
    when odd), then right/bottom pad + stride-2 conv."""

    def __init__(self, ch: int, *, compress_time: bool, device=None, dtype=None):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(ch, ch, 3, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compress_time:
            t = x.shape[2]
            if t % 2 == 1:
                x_first, x_rest = x[:, :, :1], x[:, :, 1:]
                if x_rest.shape[2] > 0:
                    x_rest = (x_rest[:, :, 0::2] + x_rest[:, :, 1::2]) * 0.5
                x = torch.cat([x_first, x_rest], dim=2)
            else:
                x = (x[:, :, 0::2] + x[:, :, 1::2]) * 0.5
        x = F.pad(x, (0, 1, 0, 1))
        return _per_frame_conv2d(self.conv, x, stride=2, padding=0)


class Upsample3D(nn.Module):
    """CogVideoXUpsample3D: nearest x2 (time doubled for all but a kept first
    frame when odd, on the first chunk of a causal stream), then 3x3 conv."""

    def __init__(self, ch: int, *, compress_time: bool, device=None, dtype=None):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(ch, ch, 3, padding=1, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, first_chunk: bool = True) -> torch.Tensor:
        up2 = lambda y: y.repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)
        t = x.shape[2]
        if self.compress_time and (not first_chunk or t > 1):
            if first_chunk and t % 2 == 1:
                x = torch.cat([up2(x[:, :, :1]),
                               up2(x[:, :, 1:]).repeat_interleave(2, dim=2)], dim=2)
            else:
                x = up2(x).repeat_interleave(2, dim=2)
        else:
            x = up2(x)
        return _per_frame_conv2d(self.conv, x, stride=1, padding=1)


class _Block(nn.Module):
    def __init__(self):
        super().__init__()


class Encoder3D(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g = cfg.norm_num_groups
        boc = cfg.block_out_channels
        levels = int(math.log2(cfg.temporal_compression_ratio))
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], 3, **kw)
        self.down_blocks = nn.ModuleList()
        ch = boc[0]
        for i, out_ch in enumerate(boc):
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock3D(ch if j == 0 else out_ch, out_ch, g, **kw)
                 for j in range(cfg.layers_per_block)])
            if i < len(boc) - 1:
                blk.downsamplers = nn.ModuleList(
                    [Downsample3D(out_ch, compress_time=i < levels, **kw)])
            self.down_blocks.append(blk)
            ch = out_ch
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock3D(boc[-1], boc[-1], g, **kw) for _ in range(2)])
        self.norm_out = GroupNorm(g, boc[-1], eps=1e-6, **kw)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, 3, **kw)

    def forward(self, x: torch.Tensor, cache: Cache = None) -> Tuple[torch.Tensor, dict]:
        cache = cache or {}
        new: Dict[str, Any] = {}
        h, new["conv_in"] = self.conv_in(x, cache.get("conv_in"))
        for i, blk in enumerate(self.down_blocks):
            bc, nb = cache.get(f"down_{i}", {}), {}
            for j, rn in enumerate(blk.resnets):
                h, nb[f"res_{j}"] = rn(h, None, bc.get(f"res_{j}"))
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
            new[f"down_{i}"] = nb
        mc, nm = cache.get("mid", {}), {}
        for j, rn in enumerate(self.mid_block.resnets):
            h, nm[f"res_{j}"] = rn(h, None, mc.get(f"res_{j}"))
        new["mid"] = nm
        h = silu(self.norm_out(h))
        h, new["conv_out"] = self.conv_out(h, cache.get("conv_out"))
        return h, new


class Decoder3D(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        zc = cfg.latent_channels
        levels = int(math.log2(cfg.temporal_compression_ratio))
        self.conv_in = CausalConv3d(zc, rev[0], 3, **kw)
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock3D(rev[0], rev[0], g, zq_ch=zc, **kw) for _ in range(2)])
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList(
                [ResnetBlock3D(ch if j == 0 else out_ch, out_ch, g, zq_ch=zc, **kw)
                 for j in range(cfg.layers_per_block + 1)])
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList(
                    [Upsample3D(out_ch, compress_time=i < levels, **kw)])
            self.up_blocks.append(blk)
            ch = out_ch
        self.norm_out = SpatialNorm3D(rev[-1], zc, g, **kw)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, 3, **kw)

    def forward(self, z: torch.Tensor, cache: Cache = None) -> Tuple[torch.Tensor, dict]:
        first_chunk = cache is None
        cache = cache or {}
        new: Dict[str, Any] = {}
        h, new["conv_in"] = self.conv_in(z, cache.get("conv_in"))
        mc, nm = cache.get("mid", {}), {}
        for j, rn in enumerate(self.mid_block.resnets):
            h, nm[f"res_{j}"] = rn(h, z, mc.get(f"res_{j}"))
        new["mid"] = nm
        for i, blk in enumerate(self.up_blocks):
            bc, nb = cache.get(f"up_{i}", {}), {}
            for j, rn in enumerate(blk.resnets):
                h, nb[f"res_{j}"] = rn(h, z, bc.get(f"res_{j}"))
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, first_chunk=first_chunk)
            new[f"up_{i}"] = nb
        h = silu(self.norm_out(h, z))
        h, new["conv_out"] = self.conv_out(h, cache.get("conv_out"))
        return h, new


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        std = torch.exp(0.5 * torch.clamp(self.logvar, -30.0, 20.0))
        eps = torch.randn(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                          device=self.mean.device)
        return self.mean + std * eps

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKLCogVideoX(nn.Module):
    """VAE with the reference's frame batching and optional spatial tiling."""

    def __init__(self, cfg: VAEConfig, *, device=None, dtype=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder3D(cfg, device=device, dtype=dtype)
        self.decoder = Decoder3D(cfg, device=device, dtype=dtype)
        self.num_latent_frames_batch_size = 2
        self.num_sample_frames_batch_size = 8
        sc = cfg.spatial_compression_ratio
        self.tile_sample_min_height = cfg.sample_height // 2
        self.tile_sample_min_width = cfg.sample_width // 2
        self.tile_latent_min_height = self.tile_sample_min_height // sc
        self.tile_latent_min_width = self.tile_sample_min_width // sc
        self.tile_overlap_factor_height = 1 / 6
        self.tile_overlap_factor_width = 1 / 5
        self.use_tiling = False

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> "AutoencoderKLCogVideoX":
        return init_random_(self, generator)

    def enable_tiling(self, tile_sample_min_height=None, tile_sample_min_width=None,
                      tile_overlap_factor_height=None, tile_overlap_factor_width=None):
        self.use_tiling = True
        if tile_sample_min_height:
            self.tile_sample_min_height = tile_sample_min_height
        if tile_sample_min_width:
            self.tile_sample_min_width = tile_sample_min_width
        sc = self.cfg.spatial_compression_ratio
        self.tile_latent_min_height = int(self.tile_sample_min_height / sc)
        self.tile_latent_min_width = int(self.tile_sample_min_width / sc)
        if tile_overlap_factor_height:
            self.tile_overlap_factor_height = tile_overlap_factor_height
        if tile_overlap_factor_width:
            self.tile_overlap_factor_width = tile_overlap_factor_width

    def disable_tiling(self):
        self.use_tiling = False

    # -- frame batching (NCDHW inside) ----------------------------------------
    @staticmethod
    def _batches(t: int, fbs: int, num_batches: int) -> List[Tuple[int, int]]:
        rem = t % fbs
        return [(fbs * i + (0 if i == 0 else rem), fbs * (i + 1) + rem)
                for i in range(num_batches)]

    def _frame_batched_encode(self, x: torch.Tensor) -> torch.Tensor:
        fbs = self.num_sample_frames_batch_size
        t = x.shape[2]
        outs, cache = [], None
        for s, e in self._batches(t, fbs, max(t // fbs if t > 1 else 1, 1)):
            y, cache = self.encoder(x[:, :, s:e], cache)
            outs.append(y)
        return torch.cat(outs, dim=2)

    def _frame_batched_decode(self, z: torch.Tensor) -> torch.Tensor:
        fbs = self.num_latent_frames_batch_size
        t = z.shape[2]
        outs, cache = [], None
        for s, e in self._batches(t, fbs, max(t // fbs, 1)):
            y, cache = self.decoder(z[:, :, s:e], cache)
            outs.append(y)
        return torch.cat(outs, dim=2)

    # -- tiling ---------------------------------------------------------------
    @staticmethod
    def _blend(a: torch.Tensor, b: torch.Tensor, extent: int, dim: int) -> torch.Tensor:
        extent = min(a.shape[dim], b.shape[dim], extent)
        if extent <= 0:
            return b
        shape = [1] * b.ndim
        shape[dim] = extent
        w = (torch.arange(extent, device=b.device, dtype=b.dtype) / extent).view(shape)
        head = a.narrow(dim, a.shape[dim] - extent, extent) * (1 - w) \
            + b.narrow(dim, 0, extent) * w
        return torch.cat([head, b.narrow(dim, extent, b.shape[dim] - extent)], dim=dim)

    def _tiled(self, x: torch.Tensor, fn, tile_in: Tuple[int, int],
               tile_out: Tuple[int, int], overlap_factor: Tuple[float, float]) -> torch.Tensor:
        """Tiles of `tile_in` on x's (H, W), each through fn, blended over
        `overlap_factor` of `tile_out` and cropped. The blend reads neighbours
        that were already blended, as the reference's in-place blend does."""
        height, width = x.shape[3], x.shape[4]
        step_h = int(tile_in[0] * (1 - overlap_factor[0]))
        step_w = int(tile_in[1] * (1 - overlap_factor[1]))
        blend_h = int(tile_out[0] * overlap_factor[0])
        blend_w = int(tile_out[1] * overlap_factor[1])
        limit_h, limit_w = tile_out[0] - blend_h, tile_out[1] - blend_w
        rows = [[fn(x[:, :, :, i:i + tile_in[0], j:j + tile_in[1]])
                 for j in range(0, width, step_w)] for i in range(0, height, step_h)]
        result_rows = []
        for i, row in enumerate(rows):
            result_row = []
            for j, tile in enumerate(row):
                if i > 0:
                    tile = self._blend(rows[i - 1][j], tile, blend_h, 3)
                if j > 0:
                    tile = self._blend(row[j - 1], tile, blend_w, 4)
                rows[i][j] = tile
                result_row.append(tile[:, :, :, :limit_h, :limit_w])
            result_rows.append(torch.cat(result_row, dim=4))
        return torch.cat(result_rows, dim=3)

    def _encode_single(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[3], x.shape[4]
        if self.use_tiling and (w > self.tile_sample_min_width or h > self.tile_sample_min_height):
            return self._tiled(
                x, self._frame_batched_encode,
                (self.tile_sample_min_height, self.tile_sample_min_width),
                (self.tile_latent_min_height, self.tile_latent_min_width),
                (self.tile_overlap_factor_height, self.tile_overlap_factor_width))
        return self._frame_batched_encode(x)

    def _decode_single(self, z: torch.Tensor) -> torch.Tensor:
        h, w = z.shape[3], z.shape[4]
        if self.use_tiling and (w > self.tile_latent_min_width or h > self.tile_latent_min_height):
            return self._tiled(
                z, self._frame_batched_decode,
                (self.tile_latent_min_height, self.tile_latent_min_width),
                (self.tile_sample_min_height, self.tile_sample_min_width),
                (self.tile_overlap_factor_height, self.tile_overlap_factor_width))
        return self._frame_batched_decode(z)

    # -- public API (channels-last, as the JAX package) -------------------------
    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """x: [B, T, H, W, 3] -> DiagonalGaussian over [B, T', H/8, W/8, C_lat]."""
        h = self._encode_single(_to_ncdhw(x))
        mean, logvar = _to_ndhwc(h).chunk(2, dim=-1)
        return DiagonalGaussian(mean, logvar)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: [B, T, h, w, C_lat] -> [B, T_out, H, W, 3]."""
        if z.shape[1] == 1:
            z = torch.cat([z, z], dim=1)  # single-frame decode duplicates the frame
        return _to_ndhwc(self._decode_single(_to_ncdhw(z)))
