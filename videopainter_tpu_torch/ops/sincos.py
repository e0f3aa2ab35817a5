"""3D sincos positional embeddings (host-side numpy, float64).

Counterpart of `videopainter_tpu/ops/sincos.py`; the table is a constant
held in the patch embed's `pos_embedding` buffer.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _sincos_2d_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    spatial_size: Union[int, Tuple[int, int]],
    temporal_size: int,
    spatial_interpolation_scale: float = 1.0,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """[T, H*W, D] float64 numpy. spatial_size is (W, H) per the reference."""
    if embed_dim % 4 != 0:
        raise ValueError("`embed_dim` must be divisible by 4")
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)

    embed_dim_spatial = 3 * embed_dim // 4
    embed_dim_temporal = embed_dim // 4

    grid_h = np.arange(spatial_size[1], dtype=np.float32) / spatial_interpolation_scale
    grid_w = np.arange(spatial_size[0], dtype=np.float32) / spatial_interpolation_scale
    grid = np.meshgrid(grid_w, grid_h)  # w first
    grid = np.stack(grid, axis=0).reshape([2, 1, spatial_size[1], spatial_size[0]])
    pos_embed_spatial = _sincos_2d_from_grid(embed_dim_spatial, grid)

    grid_t = np.arange(temporal_size, dtype=np.float32) / temporal_interpolation_scale
    pos_embed_temporal = _sincos_1d(embed_dim_temporal, grid_t)

    pos_embed_spatial = np.repeat(pos_embed_spatial[np.newaxis], temporal_size, axis=0)
    pos_embed_temporal = np.repeat(
        pos_embed_temporal[:, np.newaxis], spatial_size[0] * spatial_size[1], axis=1)

    return np.concatenate([pos_embed_temporal, pos_embed_spatial], axis=-1)
