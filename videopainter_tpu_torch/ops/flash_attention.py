"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of `videopainter_tpu/ops/flash_attention.py`. The TPU forward
kernel `_flash_kernel` becomes `csrc/flash_fwd.cu` (see the note there for
its design and what bounds it); `flash_attention_reference` is the same
function in plain PyTorch: an online softmax over key chunks in float32 with
the same key masks and logsumexp.

`flash_attention(q, k, v, scale, *, kv_len, kv_page_len)` keeps the JAX
contract. Inputs are [B, H, S, D]; any strides work as long as the last dim
is contiguous, so heads split from a [B, S, H*D] projection by a view need no
copy. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no padding contract: the kernel masks the ragged
tails of S_q and S_k itself (the TPU's block padding existed for Mosaic).
The backward kernels belong to a later slice.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _kernels

NEG_INF = -1e30
_REF_CHUNK = 512   # keys per step of the plain version; bounds its [S_q, chunk] scores
_SOURCE = "flash_fwd.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"vp_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                *([_L] * 12), ctypes.c_float, _I, _I, _P]}
HEAD_DIMS = (64,)


def _kv_valid(col: torch.Tensor, kv_len: int, kv_page_len: Optional[int],
              kv_total: int) -> torch.Tensor:
    """Key validity: plain `col < kv_len`; paged
    `(col < kv_total) & (col % kv_page_len < kv_len)`."""
    if kv_page_len is None:
        return col < kv_len
    return (col < kv_total) & (torch.remainder(col, kv_page_len) < kv_len)


def _check_args(q, k, v, kv_len, kv_page_len) -> int:
    if kv_page_len is not None and kv_len is None:
        raise ValueError("kv_page_len requires kv_len")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [B, H, S, D]")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    s_k = k.shape[2]
    kv_len = s_k if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= (s_k if kv_page_len is None else kv_page_len):
        raise ValueError(f"kv_len {kv_len} out of range for S_k {s_k} / page {kv_page_len}")
    return kv_len


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: Optional[float] = None, *,
                              kv_len: Optional[int] = None,
                              kv_page_len: Optional[int] = None,
                              with_lse: bool = False):
    """The plain PyTorch version: online softmax over 512-key chunks, float32
    running max / denominator / accumulator, masked scores -1e30 as in the
    kernel. Returns out (q's dtype) or (out, lse fp32 [B, H, S_q])."""
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    qs = q.float()
    m = torch.full((b, h, s_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_q, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, s_k, _REF_CHUNK):
        kc = k[:, :, c0:c0 + _REF_CHUNK].float()
        vc = v[:, :, c0:c0 + _REF_CHUNK].float()
        s = torch.matmul(qs, kc.transpose(-1, -2)) * scale
        col = torch.arange(c0, c0 + kc.shape[2], device=q.device)
        s = s.masked_fill(~_kv_valid(col, kv_len, kv_page_len, s_k), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vc)
        m = m_new
    out = (acc / l).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l))[..., 0]
    return out


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   kv_len: int, kv_page_len: Optional[int], with_lse: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch csrc/flash_fwd.cu on the current stream. Returns (out, lse|None);
    out is a [B, H, S_q, D] view of a [B, S_q, H, D] buffer."""
    if not torch.cuda.is_available():
        raise RuntimeError("flash_fwd_cuda needs a CUDA device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dim, strides that are "
                             f"multiples of 8 and a 16-byte aligned start; got "
                             f"strides {x.stride()}")
    b, h, s_q, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    s_k = k.shape[2]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vp_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              lse.data_ptr() if lse is not None else None,
                              b, h, s_q, s_k, *q.stride()[:3], *k.stride()[:3],
                              *v.stride()[:3], *out.stride()[:3], float(scale),
                              kv_len, kv_page_len or 0, stream)
    _kernels.check(rc, "flash_fwd")
    _kernels.LAUNCHES["flash_fwd"] += 1
    return out, lse


def _flash(q, k, v, scale, kv_len, kv_page_len, with_lse):
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, kv_len=kv_len,
                                         kv_page_len=kv_page_len, with_lse=True)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, float(scale), kv_len, kv_page_len, with_lse)
    raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, *, kv_len: Optional[int] = None,
                    kv_page_len: Optional[int] = None) -> torch.Tensor:
    """Bidirectional attention. q, k, v: [B, H, S, D]; returns [B, H, S_q, D].

    kv_len: number of valid keys (default all of S_k); keys from kv_len on
    are masked. kv_page_len: K is a concatenation of pages of kv_page_len
    rows, each valid up to kv_len: valid(i) = (i < S_k) & (i % kv_page_len <
    kv_len). Requires kv_len.
    """
    return _flash(q, k, v, scale, kv_len, kv_page_len, with_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None, *,
                             kv_len: Optional[int] = None,
                             kv_page_len: Optional[int] = None):
    """(out, lse) with lse = logsumexp of the scaled, masked scores per query
    row, fp32 [B, H, S_q]: the merge state for ring attention."""
    return _flash(q, k, v, scale, kv_len, kv_page_len, with_lse=True)
