"""Connected-components labelling: the CUDA kernel and its plain version.

Counterpart of `videopainter_tpu/native/__init__.py`. The reference's one
native kernel is SAM2's CUDA connected components (app/sam2/csrc/
connected_components.cu); the JAX package has a host C++ union-find and a
lax.while_loop version instead. Here:

 - `connected_components_cuda`: `csrc/connected_components.cu` (union-find
   with atomicMin, then a per-image scan that numbers the roots), built at
   first use like the port's other kernels;
 - `connected_components_reference`: the JAX package's algorithm in torch (a
   3x3 min-pool of pixel indices iterated over the foreground until nothing
   changes, then `torch.unique` per image), O(diameter) passes.

`get_connected_components(mask)` runs the kernel on a CUDA tensor and the
plain version on a CPU tensor (numpy goes to the CPU); a failed build or
launch raises, with no fallback. Both number components from 1 in the raster
order of their first pixel, as both JAX versions do, so labels compare equal.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
_SOURCE = "connected_components.cu"
_SIGNATURES = {"vp_connected_components": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}
SOURCES = ((_SOURCE, _SIGNATURES),)
_TILE = 1024             # pixels of one image per block (csrc's TILE)
_REF_CHECK_EVERY = 16    # min-pool passes between the plain version's convergence checks


def _check_mask(mask: torch.Tensor) -> Tuple[int, int, int]:
    if mask.ndim != 4 or mask.shape[1] != 1:
        raise ValueError(f"mask must be [B, 1, H, W], got {tuple(mask.shape)}")
    b, _, h, w = mask.shape
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{b * h * w} pixels exceed the int32 indices of the labelling")
    return b, h, w


def connected_components_cuda(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/connected_components.cu on the current stream: uint8 (or
    bool) [B, 1, H, W] on the card -> (labels, areas) int32 [B, 1, H, W]."""
    b, h, w = _check_mask(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA tensor, got {mask.device}")
    m = mask.to(torch.uint8).contiguous()
    labels = torch.empty(m.shape, dtype=torch.int32, device=m.device)
    areas = torch.empty_like(labels)
    parent = torch.empty_like(labels)
    tile_roots = torch.empty((b, -(-h * w // _TILE)), dtype=torch.int32, device=m.device)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    with torch.cuda.device(m.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vp_connected_components(m.data_ptr(), labels.data_ptr(), areas.data_ptr(),
                                         parent.data_ptr(), tile_roots.data_ptr(), b, h, w,
                                         stream)
    _kernels.check(rc, "connected_components")
    _kernels.LAUNCHES["connected_components"] += 1
    return labels, areas


def connected_components_reference(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version (the JAX package's `connected_components_jax`): each
    foreground pixel takes the smallest raster index over its 3x3
    neighbourhood until nothing changes, so each component ends up holding
    its first pixel's index; `torch.unique` over those numbers the components
    and counts their pixels. Float32 carries the indices exactly below 2^24
    pixels an image."""
    b, h, w = _check_mask(mask)
    if h * w >= 2 ** 24:
        raise ValueError(f"{h * w} pixels an image exceed float32's exact integers")
    fg = mask.reshape(b, 1, h, w) != 0
    big = float(h * w)
    idx = torch.arange(h * w, dtype=torch.float32, device=mask.device).reshape(1, 1, h, w)
    x = torch.where(fg, idx, big)
    while True:
        prev = x
        for _ in range(_REF_CHECK_EVERY):
            x = torch.where(fg, torch.minimum(x, -F.max_pool2d(-x, 3, 1, 1)), big)
        if torch.equal(x, prev):
            break
    labels = torch.zeros((b, 1, h, w), dtype=torch.int32, device=mask.device)
    areas = torch.zeros_like(labels)
    for i in range(b):
        sel = fg[i, 0]
        _, inverse, counts = torch.unique(x[i, 0][sel], return_inverse=True,
                                          return_counts=True)
        labels[i, 0][sel] = (inverse + 1).to(torch.int32)
        areas[i, 0][sel] = counts[inverse].to(torch.int32)
    return labels, areas


def get_connected_components(mask: Union[torch.Tensor, np.ndarray]):
    """uint8 [B, 1, H, W] (nonzero = foreground) -> (labels, areas) int32,
    the contract of the reference's `get_connected_componnets`. A CUDA
    tensor runs the kernel, a CPU tensor the plain version; numpy input runs
    on the CPU and gets numpy back."""
    if isinstance(mask, np.ndarray):
        labels, areas = connected_components_reference(torch.from_numpy(np.asarray(mask)))
        return labels.numpy(), areas.numpy()
    if mask.device.type == "cuda":
        return connected_components_cuda(mask)
    return connected_components_reference(mask)


def fill_holes_in_mask_scores(mask: Union[torch.Tensor, np.ndarray], max_area: int):
    """Remove small holes and specks (sam2/utils/misc.py:268) on the mask's
    device: background components of area <= max_area become foreground,
    foreground components that small become background. [H, W] or
    [B, 1, H, W]; returns uint8 of the same shape (numpy for numpy)."""
    if max_area <= 0:
        return mask
    as_numpy = isinstance(mask, np.ndarray)
    t = torch.from_numpy(np.asarray(mask)) if as_numpy else mask
    binary = (t > 0).to(torch.uint8)
    squeeze = binary.ndim == 2
    if squeeze:
        binary = binary[None, None]
    _, hole_areas = get_connected_components(1 - binary)
    _, speck_areas = get_connected_components(binary)
    out = binary.clone()
    out[(binary == 0) & (hole_areas > 0) & (hole_areas <= max_area)] = 1
    out[(binary == 1) & (speck_areas > 0) & (speck_areas <= max_area)] = 0
    out = out[0, 0] if squeeze else out
    return out.numpy() if as_numpy else out
