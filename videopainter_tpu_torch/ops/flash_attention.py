"""Flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of `videopainter_tpu/ops/flash_attention.py`. The TPU forward
kernel `_flash_kernel` becomes `csrc/flash_fwd.cu`, the backward kernels
`_flash_dq_kernel` and `_flash_dkv_kernel` become `csrc/flash_bwd.cu` (see
the notes there for their design and what bounds them).
`flash_attention_reference` is the forward in plain PyTorch: an online
softmax over key chunks in float32 with the same key masks and logsumexp;
`flash_attention_backward_reference` is the backward: the same formulas over
key chunks, never an [S_q, S_k] matrix.

`flash_attention(q, k, v, scale, *, kv_len, kv_page_len)` keeps the JAX
contract. Inputs are [B, H, S, D]; any strides work as long as the last dim
is contiguous, so heads split from a [B, S, H*D] projection by a view need no
copy. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no padding contract: the kernel masks the ragged
tails of S_q and S_k itself (the TPU's block padding existed for Mosaic).

`flash_attention` is differentiable (the counterpart of the JAX
`custom_vjp`): when an input requires grad it goes through `FlashAttention`,
a `torch.autograd.Function` whose forward launches the forward kernel with
the logsumexp and whose backward launches the dQ and the dK/dV kernel (on a
CPU tensor: the plain versions). `flash_attention_with_lse` stays forward
only, as in the JAX package.
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
_BWD_SOURCE = "flash_bwd.cu"
_BWD_SIGNATURES = {
    "vp_flash_dq": [*([_P] * 7), _I, _I, _I, _I, *([_L] * 15), ctypes.c_float, _I, _I, _P],
    "vp_flash_dkv": [*([_P] * 8), _I, _I, _I, _I, *([_L] * 18), ctypes.c_float, _I, _I, _P]}
HEAD_DIMS = (64,)


def _kv_valid(col: torch.Tensor, kv_len: int, kv_page_len: Optional[int],
              kv_total: int) -> torch.Tensor:
    """Key validity: plain `col < kv_len`; paged
    `(col < kv_total) & (col % kv_page_len < kv_len)`."""
    if kv_page_len is None:
        return col < kv_len
    return (col < kv_total) & (torch.remainder(col, kv_page_len) < kv_len)


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    """The plain versions accumulate in float32 (float64 inputs stay float64,
    for numerical gradient checks)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


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
    running max / denominator / accumulator (float64 for float64 inputs),
    masked scores -1e30 as in the kernel. Returns out (q's dtype) or
    (out, lse fp32 [B, H, S_q])."""
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    acc_t = _acc_dtype(q)
    qs = q.to(acc_t)
    m = torch.full((b, h, s_q, 1), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((b, h, s_q, 1), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=acc_t, device=q.device)
    for c0 in range(0, s_k, _REF_CHUNK):
        kc = k[:, :, c0:c0 + _REF_CHUNK].to(acc_t)
        vc = v[:, :, c0:c0 + _REF_CHUNK].to(acc_t)
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


def _kernel_layout_ok(x: torch.Tensor) -> bool:
    """What the kernels' 16-byte loads need: a contiguous last dim, strides
    that are multiples of 8 elements and a 16-byte aligned start."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0)


def _check_cuda_operands(q, k, v) -> Tuple[int, int, int, int]:
    if not torch.cuda.is_available():
        raise RuntimeError("the flash kernels need a CUDA device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on q's device, got {x.device}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {x.dtype}")
        if not _kernel_layout_ok(x):
            raise ValueError(f"{name} needs a contiguous last dim, strides that are "
                             f"multiples of 8 and a 16-byte aligned start; got "
                             f"strides {x.stride()}")
    b, h, s_q, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    return b, h, s_q, d


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   kv_len: int, kv_page_len: Optional[int], with_lse: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch csrc/flash_fwd.cu on the current stream. Returns (out, lse|None);
    out is a [B, H, S_q, D] view of a [B, S_q, H, D] buffer."""
    b, h, s_q, d = _check_cuda_operands(q, k, v)
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


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, scale: Optional[float] = None, *,
        kv_len: Optional[int] = None, kv_page_len: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the two backward kernels, over 512-key
    chunks in float32: P = exp(s * scale - lse) under the key mask (masked
    keys exactly 0), dP = dO V^T, dS = P (dP - delta) scale with delta =
    rowsum(dO O); dV = P^T dO with P rounded to dO's dtype, dK = dS^T Q and
    dQ = dS K with dS rounded to k's / q's dtype. Returns (dq, dk, dv) in the
    dtypes of q, k, v."""
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s_k = k.shape[2]
    acc_t = _acc_dtype(q)
    qs, dos = q.to(acc_t), dout.to(acc_t)
    delta = (dos * out.to(acc_t)).sum(dim=-1, keepdim=True)
    lse = lse.to(acc_t)[..., None]
    dq = torch.zeros(q.shape, dtype=acc_t, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, s_k, _REF_CHUNK):
        kc = k[:, :, c0:c0 + _REF_CHUNK].to(acc_t)
        vc = v[:, :, c0:c0 + _REF_CHUNK].to(acc_t)
        s = torch.matmul(qs, kc.transpose(-1, -2)) * scale
        col = torch.arange(c0, c0 + kc.shape[2], device=q.device)
        valid = _kv_valid(col, kv_len, kv_page_len, s_k)
        p = torch.where(valid, torch.exp(s - lse), torch.zeros((), dtype=acc_t, device=q.device))
        dp = torch.matmul(dos, vc.transpose(-1, -2))
        ds = p * (dp - delta) * scale
        dvs.append(torch.matmul(p.to(dout.dtype).to(acc_t).transpose(-1, -2), dos))
        dks.append(torch.matmul(ds.to(q.dtype).to(acc_t).transpose(-1, -2), qs))
        dq += torch.matmul(ds.to(k.dtype).to(acc_t), kc)
    return dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype), torch.cat(dvs, dim=2).to(v.dtype)


def _bwd_operands(q, k, v, dout, lse, delta):
    """Checked operands of a backward launch: (b, h, s_q, s_k, d, pointers,
    strides). `dout` must already be addressable by the kernels."""
    b, h, s_q, d = _check_cuda_operands(q, k, v)
    if dout.dtype != torch.bfloat16 or dout.shape != q.shape or dout.device != q.device:
        raise ValueError(f"dout must be bfloat16 {tuple(q.shape)} on {q.device}, got "
                         f"{dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if not _kernel_layout_ok(dout):
        raise ValueError(f"dout needs a contiguous last dim, strides that are multiples "
                         f"of 8 and a 16-byte aligned start; got strides {dout.stride()}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b, h, s_q) or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 [B, H, S_q], got "
                             f"{x.dtype} {tuple(x.shape)} strides {x.stride()}")
    ptrs = tuple(x.data_ptr() for x in (q, k, v, dout, lse, delta))
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3])
    return b, h, s_q, k.shape[2], d, ptrs, strides


def _new_bshd(b, s, h, d, like):
    """An empty [B, H, S, D] view of a [B, S, H, D] buffer: the layout of the
    head-split projections, so the view's backward is a view too."""
    return torch.empty((b, s, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def flash_dq_cuda(q, k, v, dout, lse, delta, scale: float, kv_len: int,
                  kv_page_len: Optional[int]) -> torch.Tensor:
    """Launch the dQ kernel of csrc/flash_bwd.cu on the current stream."""
    b, h, s_q, s_k, d, ptrs, strides = _bwd_operands(q, k, v, dout, lse, delta)
    dq = _new_bshd(b, s_q, h, d, q)
    lib = _kernels.load(_BWD_SOURCE, _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.vp_flash_dq(*ptrs, dq.data_ptr(), b, h, s_q, s_k, *strides,
                             *dq.stride()[:3], float(scale), kv_len, kv_page_len or 0,
                             torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "flash_dq")
    _kernels.LAUNCHES["flash_dq"] += 1
    return dq


def flash_dkv_cuda(q, k, v, dout, lse, delta, scale: float, kv_len: int,
                   kv_page_len: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of csrc/flash_bwd.cu on the current stream."""
    b, h, s_q, s_k, d, ptrs, strides = _bwd_operands(q, k, v, dout, lse, delta)
    dk, dv = _new_bshd(b, s_k, h, d, k), _new_bshd(b, s_k, h, d, v)
    lib = _kernels.load(_BWD_SOURCE, _BWD_SIGNATURES)
    with torch.cuda.device(q.device):
        rc = lib.vp_flash_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), b, h, s_q, s_k, *strides,
                              *dk.stride()[:3], *dv.stride()[:3], float(scale), kv_len,
                              kv_page_len or 0, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "flash_dkv")
    _kernels.LAUNCHES["flash_dkv"] += 1
    return dk, dv


def flash_bwd_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, S_q] contiguous: formed outside
    the kernels, as the JAX package does."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   lse: torch.Tensor, dout: torch.Tensor, scale: float, kv_len: int,
                   kv_page_len: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: delta, then the dQ and the dK/dV kernel.
    Returns (dq, dk, dv), each a [B, H, S, D] view of a [B, S, H, D] buffer.
    `dout` comes with whatever strides its consumer produced; a copy is made
    only when the kernels cannot address it."""
    if not _kernel_layout_ok(dout):
        dout = dout.contiguous()
    lse = lse.contiguous()
    delta = flash_bwd_delta(out, dout)
    dq = flash_dq_cuda(q, k, v, dout, lse, delta, scale, kv_len, kv_page_len)
    dk, dv = flash_dkv_cuda(q, k, v, dout, lse, delta, scale, kv_len, kv_page_len)
    return dq, dk, dv


def _flash(q, k, v, scale, kv_len, kv_page_len, with_lse):
    """The forward on checked arguments: the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, kv_len=kv_len,
                                         kv_page_len=kv_page_len, with_lse=True)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, float(scale), kv_len, kv_page_len, with_lse)
    raise ValueError(f"flash_attention runs on cpu or cuda tensors, got {q.device}")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward keeps (q, k, v, out, lse),
    the backward recomputes P from them in the dQ and the dK/dV kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len, kv_page_len):
        out, lse = _flash(q, k, v, scale, kv_len, kv_page_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (scale, kv_len, kv_page_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, kv_len, kv_page_len = ctx.mask
        if q.device.type == "cpu":
            grads = flash_attention_backward_reference(
                q, k, v, out, lse, dout, scale, kv_len=kv_len, kv_page_len=kv_page_len)
        else:
            grads = flash_bwd_cuda(q, k, v, out, lse, dout, float(scale), kv_len, kv_page_len)
        return (*grads, None, None, None)


def _prepare(q, k, v, scale, kv_len, kv_page_len):
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    return (q.shape[-1] ** -0.5 if scale is None else scale), kv_len


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None, *, kv_len: Optional[int] = None,
                    kv_page_len: Optional[int] = None) -> torch.Tensor:
    """Bidirectional attention. q, k, v: [B, H, S, D]; returns [B, H, S_q, D].
    Differentiable in q, k and v.

    kv_len: number of valid keys (default all of S_k); keys from kv_len on
    are masked. kv_page_len: K is a concatenation of pages of kv_page_len
    rows, each valid up to kv_len: valid(i) = (i < S_k) & (i % kv_page_len <
    kv_len). Requires kv_len.
    """
    scale, kv_len = _prepare(q, k, v, scale, kv_len, kv_page_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, kv_len, kv_page_len)
    return _flash(q, k, v, scale, kv_len, kv_page_len, with_lse=False)[0]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: Optional[float] = None, *,
                             kv_len: Optional[int] = None,
                             kv_page_len: Optional[int] = None):
    """(out, lse) with lse = logsumexp of the scaled, masked scores per query
    row, fp32 [B, H, S_q]: the merge state for ring attention. Forward only."""
    scale, kv_len = _prepare(q, k, v, scale, kv_len, kv_page_len)
    return _flash(q.detach(), k.detach(), v.detach(), scale, kv_len, kv_page_len,
                  with_lse=True)
