"""int8 (SageAttention-style) flash attention: the hand-written Hopper kernel,
its quantization prologue and its plain version.

Counterpart of `videopainter_tpu/ops/flash_attention_int8.py`. The TPU kernel
`_int8_flash_kernel` becomes `csrc/flash_int8_wgmma.cu`, a warp-specialised
Hopper kernel (TMA producer warp, mbarrier ring, s8 and bf16 wgmma; see the
note there for its design and what bounds it). What the JAX package does
around its kernel stays plain PyTorch here (`quantize_qkv`): K is
mean-centred per (batch, head) over all S_k rows, which shifts every score of
a query row by the same constant and so leaves the softmax unchanged; Q and
the centred K (and V in the int8 P.V mode) are quantized per block of
`blk_q` / `blk_k` rows with symmetric scales `max|x| / 127` floored at 1e-8
and round-half-to-even. The last block is ragged: its scale is the max over
the rows that exist. The scale tables are `[B, H, n_blocks]`.

`flash_attention_int8_reference` is the same function step by step in plain
PyTorch: the exact int32 product of the int8 operands, dequantized once by
`scale * sq * sk`, an fp32 online softmax over key blocks of `blk_k`, and
P.V in v's dtype or, with `int8_pv`, `round(P * 127)` times int8 V scaled by
`sv / 127`. A CPU tensor takes it; a CUDA tensor launches the kernel or
raises. Inference only: the wrapper raises under autograd instead of letting
the rounding return a zero gradient.

`int8_flash_uniform` is the kernel's precursor (the JAX package's
`tools/bench_int8_attn.py::_int8_kernel`), `csrc/flash_int8_uniform_wgmma.cu`:
already quantized operands, one scalar dequantization scale, the plain
`kv_len` mask and `/ 127` on the int8 P.V product; the same Hopper design,
with the int32 -> fp32 conversion folded into the softmax.

In the int8 P.V mode the kernels read V transposed, `[B, H, D, S_k]` padded
with zeros to their key tile (`kernel_vt`, written in the pass that
transposes it). The kernels' s8 A fragment holds 4 consecutive k per
thread where its score accumulator holds 2 consecutive keys per 8-key chunk,
so their V^T has the key columns permuted within each 16-key group
(`PERM16`): position 4t + i holds key 2t + i for i < 2 and key 8 + 2t + i - 2
for i >= 2. The bytes are those of the plain transpose.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from .. import _kernels
from .flash_attention import HEAD_DIMS, NEG_INF, _check_args, _kv_valid

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_FWD_SIGNATURE = [_P] * 7 + [_I] * 4 + [_L] * 12 + [_F, _I, _I, _I, _I, _I, _P]
_SOURCE = "flash_int8_wgmma.cu"
_SIGNATURES = {"vp_flash_int8_fwd": _FWD_SIGNATURE}
_UNIFORM_SIGNATURE = [_P] * 4 + [_I] * 4 + [_L] * 12 + [_F, _F, _I, _I, _P]
_UNIFORM_SOURCE = "flash_int8_uniform_wgmma.cu"
_UNIFORM_SIGNATURES = {"vp_flash_int8_uniform_fwd": _UNIFORM_SIGNATURE}
# every (source, signatures) the port builds, as chip_smoke.py builds them
SOURCES = ((_SOURCE, _SIGNATURES), (_UNIFORM_SOURCE, _UNIFORM_SIGNATURES))
# the kernels' tiles (query rows, keys); quantization blocks are multiples of them
_KERNEL_BLK_Q, _KERNEL_BLK_K = 128, 128
# position 4t + i of a 16-key group of the kernels' V^T holds key PERM16[4t + i]
PERM16 = tuple(2 * (p // 4) + p % 4 if p % 4 < 2 else 8 + 2 * (p // 4) + p % 4 - 2
               for p in range(16))
_POS16 = tuple(PERM16.index(k) for k in range(16))   # the position of each key
_REF_SCORE_ELEMS = 1 << 28               # plain version: score elements held at once


class QuantizedQKV(NamedTuple):
    q_i8: torch.Tensor           # int8 [B, H, S_q, D]
    k_i8: torch.Tensor           # int8 [B, H, S_k, D], mean-centred before quantization
    v: torch.Tensor              # v as given, or int8 [B, H, S_k, D] with int8_pv
    sq: torch.Tensor             # fp32 [B, H, ceil(S_q / blk_q)]
    sk: torch.Tensor             # fp32 [B, H, ceil(S_k / blk_k)]
    sv: Optional[torch.Tensor]   # fp32 [B, H, ceil(S_k / blk_k)] with int8_pv


def _block_quantize(x32: torch.Tensor, blk: int):
    """x32 [B, H, S, D] fp32 -> (int8 in x32's layout, scales [B, H, ceil(S / blk)]),
    per-(b, h, block) symmetric scales max|x| / 127 floored at 1e-8."""
    b, h, s, _ = x32.shape
    n = -(-s // blk)
    row_max = x32.abs().amax(dim=-1)
    row_max = torch.nn.functional.pad(row_max, (0, n * blk - s))
    sc = (row_max.reshape(b, h, n, blk).amax(dim=-1) / 127.0).clamp_min(1e-8)
    per_row = sc.repeat_interleave(blk, dim=-1)[..., :s, None]
    return torch.round(x32 / per_row).to(torch.int8), sc


def quantize_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, blk_q: int,
                 blk_k: int, int8_pv: bool) -> QuantizedQKV:
    """The prologue of both the kernel and the plain version. The K mean is
    summed in float64, where the sum of 2^15 bf16 or fp32 keys of any
    realistic spread of magnitudes is exact, so independent of the order a
    reduction picks: a head's mean, its int8 keys and scales are then the
    same whichever other heads share the tensor (tensor parallelism splits
    them)."""
    mean = k.sum(dim=2, keepdim=True, dtype=torch.float64) / k.shape[2]
    k32 = k.float() - mean.float()
    q_i8, sq = _block_quantize(q.float(), blk_q)
    k_i8, sk = _block_quantize(k32, blk_k)
    if int8_pv:
        v_i8, sv = _block_quantize(v.float(), blk_k)
        return QuantizedQKV(q_i8, k_i8, v_i8, sq, sk, sv)
    return QuantizedQKV(q_i8, k_i8, v, sq, sk, None)


def _int_product(a: torch.Tensor, b_t: torch.Tensor, exact_f32: bool) -> torch.Tensor:
    """The exact integer product a @ b_t^T of int8 operands, as fp32. Sums of
    at most 2^24 are exact in an fp32 product; longer ones go through fp64
    (the int32 -> fp32 conversion of the sum then rounds, as on the TPU)."""
    if exact_f32:
        return torch.matmul(a.float(), b_t.float().transpose(-1, -2))
    return torch.matmul(a.double(), b_t.double().transpose(-1, -2)).float()


def _online_softmax_int8(q_i8, k_i8, v, deq, dpv, *, blk_k: int, int8_pv: bool,
                         kv_len: int, kv_page_len: Optional[int], out_dtype) -> torch.Tensor:
    """Shared body of the two plain versions, on [N, S, D] operands.
    deq(rows, j): fp32 score scale of key block j for the given rows, [n, S_q, 1]
    or a scalar; dpv(rows, j): the scale of the int8 P.V product."""
    n, s_q, d = q_i8.shape
    s_k = k_i8.shape[1]
    out = torch.empty((n, s_q, d), dtype=out_dtype, device=q_i8.device)
    step = max(1, _REF_SCORE_ELEMS // (s_q * min(blk_k, s_k)))
    exact_qk = d * 127 * 127 < (1 << 24)
    for r0 in range(0, n, step):
        rows = slice(r0, min(r0 + step, n))
        qr = q_i8[rows]
        m = torch.full((qr.shape[0], s_q, 1), NEG_INF, dtype=torch.float32, device=qr.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((qr.shape[0], s_q, d), dtype=torch.float32, device=qr.device)
        for j, c0 in enumerate(range(0, s_k, blk_k)):
            kc = k_i8[rows, c0:c0 + blk_k]
            vc = v[rows, c0:c0 + blk_k]
            s = _int_product(qr, kc, exact_qk) * deq(rows, j)
            col = torch.arange(c0, c0 + kc.shape[1], device=qr.device)
            s = s.masked_fill(~_kv_valid(col, kv_len, kv_page_len, s_k), NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            if int8_pv:
                p_i8 = torch.round(p * 127.0).to(torch.int8)
                pv = _int_product(p_i8, vc.transpose(-1, -2), False)
                acc = acc * alpha + pv * dpv(rows, j)
            else:
                acc = acc * alpha + torch.matmul(p.to(vc.dtype).float(), vc.float())
            m = m_new
        out[rows] = (acc / l).to(out_dtype)
    return out


def flash_attention_int8_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   scale: Optional[float] = None, *, blk_q: int = 512,
                                   blk_k: int = 2048, int8_pv: bool = False,
                                   kv_len: Optional[int] = None,
                                   kv_page_len: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of `flash_attention_int8` (any device)."""
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    qq = quantize_qkv(q, k, v, blk_q=blk_q, blk_k=blk_k, int8_pv=int8_pv)
    flat = lambda x: x.reshape(b * h, *x.shape[2:])
    sq_row = flat(qq.sq).repeat_interleave(blk_q, dim=-1)[:, :s_q, None]   # [BH, S_q, 1]
    sk, sv = flat(qq.sk), (flat(qq.sv) if int8_pv else None)
    out = _online_softmax_int8(
        flat(qq.q_i8), flat(qq.k_i8), flat(qq.v),
        lambda rows, j: float(scale) * (sq_row[rows] * sk[rows, j, None, None]),
        lambda rows, j: sv[rows, j, None, None] * (1.0 / 127.0),
        blk_k=blk_k, int8_pv=int8_pv, kv_len=kv_len, kv_page_len=kv_page_len,
        out_dtype=q.dtype)
    return out.reshape(b, h, s_q, d)


def _check_cuda_operand(name: str, x: torch.Tensor, dtype, device, align: int) -> None:
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on q's device, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if x.stride(-1) != 1 or any(s % align for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dim, strides that are multiples "
                         f"of {align} and a 16-byte aligned start; got strides {x.stride()}")


def kernel_vt(v: torch.Tensor, tile: int) -> torch.Tensor:
    """[B, H, S_k, D] -> V^T [B, H, D, S_k padded with zeros to a multiple of
    `tile`], the layout the kernels' int8 P.V product reads, in one pass: each
    16-key group's columns in the order `PERM16`. Any dtype."""
    b, h, s_k, d = v.shape
    pad = -(-s_k // tile) * tile
    vt = torch.zeros((b, h, d, pad), dtype=v.dtype, device=v.device)
    key = torch.arange(s_k, device=v.device)
    pos16 = torch.tensor(_POS16, device=v.device)
    vt[..., key - key % 16 + pos16[key % 16]] = v.transpose(-1, -2)
    return vt


def _launch_args(q_i8, k_i8, v_in, int8_pv: bool):
    """Checks shared by the entries; returns (out, the kernel's v operand)."""
    dev = q_i8.device
    b, h, s_q, d = q_i8.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel (takes {HEAD_DIMS})")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's y limit")
    _check_cuda_operand("q (int8)", q_i8, torch.int8, dev, 16)
    _check_cuda_operand("k (int8)", k_i8, torch.int8, dev, 16)
    if int8_pv:
        v_in = kernel_vt(v_in, _KERNEL_BLK_K)
        _check_cuda_operand("v (int8, transposed)", v_in, torch.int8, dev, 16)
    else:
        _check_cuda_operand("v", v_in, torch.bfloat16, dev, 8)
    out = torch.empty((b, s_q, h, d), dtype=torch.bfloat16, device=dev).transpose(1, 2)
    return out, v_in


def flash_int8_fwd_cuda(qq: QuantizedQKV, scale: float, kv_len: int,
                        kv_page_len: Optional[int], blk_q: int, blk_k: int,
                        int8_pv: bool) -> torch.Tensor:
    """Launch csrc/flash_int8_wgmma.cu on the current stream with operands from
    `quantize_qkv`; its tiles (128 rows, 128 keys) must divide blk_q and
    blk_k. Returns bf16 [B, H, S_q, D], a view of a [B, S_q, H, D] buffer."""
    if blk_q % _KERNEL_BLK_Q or blk_k % _KERNEL_BLK_K:
        raise ValueError(f"the kernel's tiles ({_KERNEL_BLK_Q} rows, {_KERNEL_BLK_K} keys) "
                         f"must divide blk_q {blk_q} and blk_k {blk_k}")
    if not torch.cuda.is_available():
        raise RuntimeError("flash_int8_fwd needs a CUDA device")
    b, h, s_q, _ = qq.q_i8.shape
    s_k = qq.k_i8.shape[2]
    out, v_in = _launch_args(qq.q_i8, qq.k_i8, qq.v, int8_pv)
    sq, sk = qq.sq.contiguous(), qq.sk.contiguous()
    sv = qq.sv.contiguous() if int8_pv else None
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vp_flash_int8_fwd(
            qq.q_i8.data_ptr(), qq.k_i8.data_ptr(), v_in.data_ptr(), out.data_ptr(),
            sq.data_ptr(), sk.data_ptr(), sv.data_ptr() if sv is not None else None,
            b, h, s_q, s_k, *qq.q_i8.stride()[:3], *qq.k_i8.stride()[:3],
            *v_in.stride()[:3], *out.stride()[:3], float(scale), kv_len,
            kv_page_len or 0, blk_q, blk_k, int(int8_pv), stream)
    _kernels.check(rc, "flash_int8_fwd")
    _kernels.LAUNCHES["flash_int8_fwd"] += 1
    return out


def _raise_under_autograd(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash_attention_int8 is inference-only (no useful gradient through int8 "
            "rounding); use use_flash=True for training")


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None, *, blk_q: int = 512,
                         blk_k: int = 2048, int8_pv: bool = False,
                         kv_len: Optional[int] = None,
                         kv_page_len: Optional[int] = None) -> torch.Tensor:
    """int8-QK^T flash attention. q, k, v: [B, H, S, D]; returns [B, H, S_q, D]
    in q's dtype. On CUDA the inputs are bf16.

    kv_len: number of valid keys when k / v arrive pre-padded; the K mean and
    the last block's scale then include the padded tail rows (still exact for
    the softmax). kv_page_len: paged validity for concatenated pre-padded
    pages, valid(i) = (i < S_k) & (i % kv_page_len < kv_len).
    """
    _raise_under_autograd(q, k, v)
    kv_len = _check_args(q, k, v, kv_len, kv_page_len)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, scale, blk_q=blk_q, blk_k=blk_k,
                                              int8_pv=int8_pv, kv_len=kv_len,
                                              kv_page_len=kv_page_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8 runs on cpu or cuda tensors, got {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16 on CUDA, got {x.dtype}")
    qq = quantize_qkv(q, k, v, blk_q=blk_q, blk_k=blk_k, int8_pv=int8_pv)
    return flash_int8_fwd_cuda(qq, float(scale), kv_len, kv_page_len, blk_q, blk_k, int8_pv)


# -- the precursor: one uniform dequantization scale -------------------------------

def int8_flash_uniform_reference(q_i8: torch.Tensor, k_i8: torch.Tensor, v: torch.Tensor,
                                 sm_scale: float, deq_scale: float, kv_len: int, *,
                                 int8_pv: bool = False, blk_k: int = 2048) -> torch.Tensor:
    """Plain version of `int8_flash_uniform`: [N, S, D] int8 q and k, v bf16
    (or int8 with int8_pv); bf16 out."""
    f = float(sm_scale) * float(deq_scale)
    return _online_softmax_int8(q_i8, k_i8, v, lambda rows, j: f, lambda rows, j: 1.0 / 127.0,
                                blk_k=blk_k, int8_pv=int8_pv, kv_len=kv_len,
                                kv_page_len=None, out_dtype=torch.bfloat16)


def int8_flash_uniform(q_i8: torch.Tensor, k_i8: torch.Tensor, v: torch.Tensor,
                       sm_scale: float, deq_scale: float, kv_len: int, *,
                       int8_pv: bool = False) -> torch.Tensor:
    """int8 Q.K^T flash attention on already quantized operands with one
    global dequantization scale: softmax(sm_scale * deq_scale * q_i8 k_i8^T,
    keys < kv_len) v, and with int8_pv round(P * 127) v_i8 / 127 (the caller
    applies v's own scale). q_i8, k_i8: int8 [N, S, D]; v: bf16, or int8 with
    int8_pv; returns bf16 [N, S_q, D]. On CUDA tensors it launches
    csrc/flash_int8_uniform_wgmma.cu."""
    if q_i8.ndim != 3 or k_i8.shape != v.shape or q_i8.shape[0] != k_i8.shape[0]:
        raise ValueError("q_i8, k_i8, v must be [N, S, D] with matching N and key shapes")
    if not 1 <= kv_len <= k_i8.shape[1]:
        raise ValueError(f"kv_len {kv_len} out of range for S_k {k_i8.shape[1]}")
    if q_i8.device.type == "cpu":
        return int8_flash_uniform_reference(q_i8, k_i8, v, sm_scale, deq_scale, kv_len,
                                            int8_pv=int8_pv)
    if q_i8.device.type != "cuda":
        raise ValueError(f"int8_flash_uniform runs on cpu or cuda tensors, got {q_i8.device}")
    n, s_q, _ = q_i8.shape
    s_k = k_i8.shape[1]
    q4, k4 = q_i8[None], k_i8[None]
    out, v_in = _launch_args(q4, k4, v[None], int8_pv)
    lib = _kernels.load(_UNIFORM_SOURCE, _UNIFORM_SIGNATURES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.vp_flash_int8_uniform_fwd(
            q4.data_ptr(), k4.data_ptr(), v_in.data_ptr(), out.data_ptr(), 1, n, s_q, s_k,
            *q4.stride()[:3], *k4.stride()[:3], *v_in.stride()[:3], *out.stride()[:3],
            float(sm_scale), float(deq_scale), kv_len, int(int8_pv), stream)
    _kernels.check(rc, "flash_int8_uniform_fwd")
    _kernels.LAUNCHES["flash_int8_uniform_fwd"] += 1
    return out[0]
