"""3D rotary position embeddings for CogVideoX video tokens.

Counterpart of `videopainter_tpu/ops/rope.py`: head_dim split t:h:w =
1/4 : 3/8 : 3/8, per-axis 1D RoPE with frequencies repeated in pairs, applied
with the rotate-pairs convention (x0, x1) -> (x0 c - x1 s, x1 c + x0 s) in
float32. Tables are computed on the host in numpy float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _rope_1d(dim: int, pos: np.ndarray, theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin [S, dim] with each frequency repeated twice (interleaved)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2] / dim))
    ang = np.outer(pos.astype(np.float32), freqs)
    cos = np.repeat(np.cos(ang), 2, axis=1)
    sin = np.repeat(np.sin(ang), 2, axis=1)
    return cos.astype(np.float32), sin.astype(np.float32)


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords: Tuple[Tuple[int, int], Tuple[int, int]],
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin), each [T*H*W, embed_dim] float32 numpy."""
    start, stop = crops_coords
    gh, gw = grid_size
    grid_h = np.linspace(start[0], stop[0], gh, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(start[1], stop[1], gw, endpoint=False, dtype=np.float32)
    grid_t = np.linspace(0, temporal_size, temporal_size, endpoint=False, dtype=np.float32)

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3

    t_cos, t_sin = _rope_1d(dim_t, grid_t, theta)
    h_cos, h_sin = _rope_1d(dim_h, grid_h, theta)
    w_cos, w_sin = _rope_1d(dim_w, grid_w, theta)

    def combine(ft, fh, fw):
        ft = np.broadcast_to(ft[:, None, None, :], (temporal_size, gh, gw, dim_t))
        fh = np.broadcast_to(fh[None, :, None, :], (temporal_size, gh, gw, dim_h))
        fw = np.broadcast_to(fw[None, None, :, :], (temporal_size, gh, gw, dim_w))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(temporal_size * gh * gw, -1)

    return combine(t_cos, h_cos, w_cos), combine(t_sin, h_sin, w_sin)


def get_resize_crop_region_for_grid(src: Tuple[int, int], tgt_width: int, tgt_height: int):
    """Aspect-ratio crop region used to rescale RoPE for off-default resolutions."""
    h, w = src
    r = h / w
    if r > (tgt_height / tgt_width):
        resize_height = tgt_height
        resize_width = int(round(tgt_height / h * w))
    else:
        resize_width = tgt_width
        resize_height = int(round(tgt_width / w * h))
    crop_top = int(round((tgt_height - resize_height) / 2.0))
    crop_left = int(round((tgt_width - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair RoPE in float32, returned in x's dtype.

    x: [..., D]; cos/sin broadcast against x (e.g. [S, 1, D] for
    [B, S, H, D] activations). out = x*cos + rotate_pairs(x)*sin with
    rotate_pairs((x0, x1)) = (-x1, x0).
    """
    x32 = x.float()
    xr = x32.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).flatten(-2)
    return (x32 * cos + x_rot * sin).to(x.dtype)
