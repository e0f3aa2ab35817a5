"""The VAE's GroupNorm, with the SiLU after it where there is one, as two
hand-written CUDA passes, with its plain version.

The JAX package leaves `group_norm` (`videopainter_tpu/ops/basic.py:209`) and
`silu` to XLA's fusion; it has no Pallas kernel. Here:

 - `group_norm_silu_reference`: the plain version, what the port ran before
   the kernels: `F.group_norm` over an fp32 copy, rounded back to x's dtype,
   then `F.silu` in that dtype. CPU tensors take it (autograd runs through it).
 - `csrc/group_norm_silu.cu`: the fp32 statistics split over many blocks a
   group (launch counter `group_norm_stats`), then the apply with the SiLU
   fused (`group_norm_apply`); see the source's note for its design and bound.

`group_norm_silu(x, num_groups, weight, bias, eps=..., silu=...)` takes x
[B, C, T, H, W] in bf16 or fp32 with any batch, channel and frame strides as
long as each H x W plane is contiguous, such as the channel / frame swapped
view `models/vae.py` `_per_frame_conv2d` returns, and gives a contiguous
result in x's dtype. A CUDA tensor launches both kernels or raises. The kernels have no
backward: the port runs its VAE frozen under `torch.no_grad()`
(`AutoencoderKLCogVideoX.encode` / `decode`, `VAEStreamDecoder.feed`), and a
CUDA call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _kernels

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SOURCE = "group_norm_silu.cu"
_SIGNATURES = {
    "vp_group_norm_silu": [*([_P] * 7), _I, _I, _I, *([_L] * 6), _I, *([_L] * 4), _F,
                           _I, _I, _I, _I, _P],
}
SOURCES = ((_SOURCE, _SIGNATURES),)
_DTYPES = (torch.bfloat16, torch.float32)
_BLOCKS_PER_SM = 16      # the grid the split aims for: a few waves of resident blocks
_MIN_CHUNK = 16384       # elements: no block gets less of a group than this
_MAX_GROUP = 2 ** 31     # elements a group: the kernels index it in 32 bits


def group_norm_silu_reference(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                              bias: torch.Tensor, *, eps: float = 1e-6,
                              silu: bool = False) -> torch.Tensor:
    """The plain version, on any device: fp32 statistics and affine, rounded
    to x's dtype, then the SiLU in that dtype."""
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps).to(x.dtype)
    return F.silu(y) if silu else y


# -- the kernels ----------------------------------------------------------------------

class Plan(NamedTuple):
    """x seen as [batch, C, frames, H * W], and the split of each group."""
    batch: int
    groups: int
    cg: int                         # channels a group
    frames: int
    plane: int
    strides: Tuple[int, int, int]   # batch, channel, frame (elements; 0 for a dim of 1)
    vec: int                        # values a load: 16 bytes' worth, or 1
    chunk: int                      # elements of a group a block
    nchunk: int                     # blocks a group

    @property
    def group_elems(self) -> int:
        return self.cg * self.frames * self.plane


def plan(x: torch.Tensor, num_groups: int, sms: int) -> Plan:
    """The launch geometry of x [B, C, T, H, W], or ValueError for a layout the
    kernels do not take. The chunks a group is cut into follow from its size:
    enough that the grid holds `_BLOCKS_PER_SM` blocks an SM whatever the group
    count, none shorter than `_MIN_CHUNK` elements (a whole small group is one
    block)."""
    if x.dim() != 5:
        raise ValueError(f"the kernels take [B, C, T, H, W], got {tuple(x.shape)}")
    b, c, t, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if (w > 1 and x.stride(4) != 1) or (h > 1 and x.stride(3) != w):
        raise ValueError(f"the kernels need each H x W plane contiguous; got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    strides = tuple(x.stride(d) if x.shape[d] > 1 else 0 for d in range(3))
    cg = c // num_groups
    group_elems = cg * t * h * w
    if group_elems >= _MAX_GROUP:
        raise ValueError(f"a group of {group_elems} elements is beyond the kernels' 32-bit "
                         f"indexing ({_MAX_GROUP})")
    width = 16 // x.element_size()
    vec = width if (h * w % width == 0 and not any(s % width for s in strides)
                    and x.data_ptr() % 16 == 0) else 1
    nchunk = max(1, min(-(-_BLOCKS_PER_SM * sms // max(1, b * num_groups)),
                        group_elems // _MIN_CHUNK))
    chunk = -(-max(1, group_elems) // nchunk)
    chunk = -(-chunk // vec) * vec
    nchunk = max(1, -(-group_elems // chunk))
    return Plan(b, num_groups, cg, t, h * w, strides, vec, chunk, nchunk)


def divider(d: int) -> Tuple[int, int]:
    """(mul, shift) with n // d == ((n * mul) >> 32) >> shift for 0 <= n < 2**31,
    the kernels' `divide` (d == 1 reads n itself)."""
    if d == 1:
        return 0, 0
    p = 31 + (d - 1).bit_length()    # 31 + ceil(log2 d)
    return -(-(1 << p) // d), p - 32


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _params(weight: torch.Tensor, bias: torch.Tensor, c: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The affine rows as the kernel reads them: bf16 where both are bf16,
    else fp32; contiguous, on x's device; and the bf16 flag."""
    for t in (weight, bias):
        if t.shape != (c,):
            raise ValueError(f"the affine weight and bias must be [{c}], got {tuple(t.shape)}")
    bf16 = weight.dtype == bias.dtype == torch.bfloat16
    dtype = torch.bfloat16 if bf16 else torch.float32
    w, b = (t.to(device=device, dtype=dtype).contiguous() for t in (weight, bias))
    return w, b, int(bf16)


def group_norm_silu_cuda(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                         bias: torch.Tensor, *, eps: float, silu: bool, stats: bool = False):
    """Launch both kernels on the current stream. Returns y, or (y, mean,
    rstd) with each (batch, group)'s fp32 mean and rstd [B, G] when `stats`."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the kernels take bfloat16 or float32 input, got {x.dtype}")
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    dev = x.device
    pl = plan(x, num_groups, torch.cuda.get_device_properties(dev).multi_processor_count)
    w, b, params_bf16 = _params(weight, bias, x.shape[1], dev)
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty((pl.batch, pl.groups), dtype=torch.float32, device=dev)
                      for _ in range(2))
    part = torch.empty((pl.batch * pl.groups * pl.nchunk, 4), dtype=torch.float32, device=dev)
    (plane_mul, plane_shift), (frames_mul, frames_shift) = divider(pl.plane), divider(pl.frames)
    with torch.cuda.device(dev):
        rc = lib.vp_group_norm_silu(
            _ptr(x), _ptr(y), _ptr(w), _ptr(b), _ptr(part), _ptr(mean), _ptr(rstd),
            pl.batch, pl.groups, pl.cg, pl.frames, pl.plane, *pl.strides, pl.chunk, pl.nchunk,
            plane_mul, plane_shift, frames_mul, frames_shift, float(eps), int(silu),
            int(x.dtype == torch.float32), params_bf16, pl.vec,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "group_norm_silu")
    _kernels.LAUNCHES["group_norm_stats"] += 1
    _kernels.LAUNCHES["group_norm_apply"] += 1
    return (y, mean, rstd) if stats else y


def _device_kind(x: torch.Tensor) -> str:
    return x.device.type


def group_norm_silu(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                    bias: torch.Tensor, *, eps: float = 1e-6,
                    silu: bool = False) -> torch.Tensor:
    """GroupNorm over [B, C, *spatial] with fp32 statistics (per batch and
    group, across all spatial dims), then the SiLU where `silu`; x's dtype.
    On the card x is [B, C, T, H, W], as every VAE norm's input is."""
    kind = _device_kind(x)
    if kind == "cpu":
        return group_norm_silu_reference(x, num_groups, weight, bias, eps=eps, silu=silu)
    if kind != "cuda":
        raise ValueError(f"group_norm_silu runs on cpu or cuda tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        raise RuntimeError("group_norm_silu: the CUDA kernels have no backward, and this call "
                           "needs a gradient. The port runs its VAE frozen: call it under "
                           "torch.no_grad(), or freeze the weights and the input")
    return group_norm_silu_cuda(x, num_groups, weight, bias, eps=eps, silu=silu)
