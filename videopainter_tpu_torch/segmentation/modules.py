"""Shared SAM2 primitives.

Counterpart of `videopainter_tpu/segmentation/modules.py` (reference
app/sam2/modeling/sam2_utils.py MLP :108-132, LayerNorm2d :137-149;
backbones/utils.py window partition :16-63; position_encoding.py sine
:16-113, random :115-158, axial RoPE :167-216).

Layouts follow the torch SAM2: convolutions and `LayerNorm2d` take NCHW,
the Hiera trunk and the window helpers BHWC, attention [B, H, S, D]. The
modules keep the torch SAM2's parameter names, so its state dicts load with
`load_state_dict`. Everything runs in float32.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import sdpa  # noqa: F401  (the plain fp32-softmax product)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """torch nn.GELU's default (erf), not the tanh approximation of the DiT."""
    return F.gelu(x)


class MLP(nn.Module):
    """`layers.{i}` linears with `act` between them (reference MLP)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 act=F.relu):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = self.act(x)
        return x


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of NCHW input (statistics over C only)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__(num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        s = (x - u).square().mean(1, keepdim=True)
        y = (x - u) * torch.rsqrt(s + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


# -- windowing (BHWC) ------------------------------------------------------------------

def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> ([B*nw, win, win, C], (Hp, Wp)), zero-padded to whole windows."""
    b, h, w, c = x.shape
    ph = (window - h % window) % window
    pw = (window - w % window) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


# -- positional encodings ------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _sine_pos_embed_np(h: int, w: int, num_pos_feats: int, temperature: float,
                       scale: float) -> np.ndarray:
    half = num_pos_feats // 2
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    eps = 1e-6
    y = y / (y[-1:, :] + eps) * scale
    x = x / (x[:, -1:] + eps) * scale
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    px = x[..., None] / dim_t
    py = y[..., None] / dim_t
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], -1).reshape(h, w, -1)
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], -1).reshape(h, w, -1)
    out = np.concatenate([py, px], axis=-1).astype(np.float32)
    out.setflags(write=False)
    return out


_SINE_CACHE: dict = {}


def sine_pos_embed(h: int, w: int, num_pos_feats: int, device=None,
                   temperature: float = 10000.0, scale: float = 2 * math.pi) -> torch.Tensor:
    """PositionEmbeddingSine (normalized) -> [1, C, H, W] float32 on `device`,
    computed on the host in numpy as the JAX package does, and cached: every
    frame's features share one tensor."""
    dev = torch.device(device or "cpu")
    key = (h, w, num_pos_feats, temperature, scale, dev)
    if key not in _SINE_CACHE:
        pe = _sine_pos_embed_np(h, w, num_pos_feats, temperature, scale)
        _SINE_CACHE[key] = torch.from_numpy(pe.copy()).permute(2, 0, 1)[None].contiguous().to(dev)
    return _SINE_CACHE[key]


class PositionEmbeddingRandom(nn.Module):
    """Random Fourier features of [0, 1] coordinates (reference :115-158); the
    Gaussian matrix is a buffer named as in the reference."""

    def __init__(self, num_pos_feats: int = 64, scale: float = 1.0):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             scale * torch.randn((2, num_pos_feats)))

    def encode(self, coords01: torch.Tensor) -> torch.Tensor:
        c = (2 * coords01 - 1) @ self.positional_encoding_gaussian_matrix.to(coords01.dtype)
        c = 2 * np.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """Dense grid PE -> [1, C, H, W]."""
        dev = self.positional_encoding_gaussian_matrix.device
        ye = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xe = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        yy, xx = torch.meshgrid(ye, xe, indexing="ij")
        return self.encode(torch.stack([xx, yy], dim=-1)).permute(2, 0, 1)[None]


def compute_axial_cis(dim: int, end_x: int, end_y: int, theta: float = 10000.0):
    """Axial 2D RoPE angles as (cos, sin) float32 numpy [end_x*end_y, dim//2]
    (reference :167-183 builds a complex table; real cos / sin here, as in
    the JAX package)."""
    n = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4, dtype=np.float32)[:n] / dim))
    t = np.arange(end_x * end_y, dtype=np.float32)
    tx, ty = t % end_x, np.floor(t / end_x)
    ang = np.concatenate([np.outer(tx, freqs), np.outer(ty, freqs)], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rotary_enc(xq: torch.Tensor, xk: Optional[torch.Tensor], freqs_cis,
                     repeat_freqs_k: bool = False):
    """[B, H, S, D] rotary with (cos, sin) tables [S, D/2] (reference
    :194-216); with `repeat_freqs_k` the key table repeats over the memory
    frames when the keys are a multiple of the queries."""
    cos, sin = (torch.as_tensor(t, device=xq.device) for t in freqs_cis)

    def rot(x, cos, sin):
        xr = x.float().reshape(*x.shape[:-1], -1, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    xq_out = rot(xq, cos, sin)
    if xk is None or xk.shape[-2] == 0:
        return xq_out, xk
    if repeat_freqs_k and xk.shape[-2] != xq.shape[-2]:
        r = xk.shape[-2] // xq.shape[-2]
        cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
    return xq_out, rot(xk, cos, sin)


def bicubic_resize_torch(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch's bicubic resize (Keys a = -0.75, half-pixel centres, edge
    clamp), the JAX package's gather version of which this is the original.
    x: [B, C, H, W]."""
    return F.interpolate(x, size=(out_h, out_w), mode="bicubic", align_corners=False)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear")` on [B, C, H, W]: half-pixel
    centres, and an antialiasing triangle filter along an axis that shrinks
    (where plain bilinear would skip pixels)."""
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=shrink)
