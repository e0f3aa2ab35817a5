"""Attention's prep: the per-head QK LayerNorm and RoPE on the video rows,
as one hand-written CUDA pass, forward and backward, with its plain version.

The JAX package leaves this prep to XLA's fusion (`videopainter_tpu/ops/
attention.py`: `layer_norm` on the split q and k, then `_rope_video_slice`);
it has no Pallas kernel. Here:

 - `qk_norm_rope_reference`: the plain version, the eager composition
   `joint_attention` ran before the kernel, unchanged: split the heads,
   `ops/basic.layer_norm` (fp32 statistics and affine, rounded back), then
   `_rope_video_slice` (`ops/rope.apply_rotary_emb` on rows from `text_len`
   on). CPU tensors take it; its backward is autograd through it.
 - `csrc/qk_norm_rope.cu`: one launch for q and k together (forward), and one
   for their backward; see the source's note for its design and its bound.

`qk_norm_rope(q, k, heads=..., norm_q=..., norm_k=..., rope=..., text_len=...)`
takes the projections [B, S, H * 64] as they come from the linears (any batch
and token strides, such as a `to_qkv(x).chunk(3)` view) and returns
[B, S, H, 64] tensors in their dtype. A norm is `(weight, bias, eps)`
(`weight` / `bias` may be None) or None for no norm; `rope` is the fp32
(cos, sin) [S - text_len, 64] or None. `q` may be None (the keys of a
variant's extra pages). The route follows what the call shows: an input or a
weight that needs grad goes through `QKNormRope`, an autograd Function whose
forward keeps the input, each row's mean and rstd and whose backward is the
second kernel; otherwise (the served loop under `no_grad`) the forward alone
runs and keeps nothing. A CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _kernels
from .basic import layer_norm
from .rope import apply_rotary_emb

Norm = Tuple[Optional[torch.Tensor], Optional[torch.Tensor], float]
Rope = Tuple[torch.Tensor, torch.Tensor]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SOURCE = "qk_norm_rope.cu"
_SIGNATURES = {
    "vp_qk_norm_rope_fwd": [*([_P] * 14), *([_I] * 5), *([_L] * 4), _I, _F, _F, _I, _I, _I, _P],
    "vp_qk_norm_rope_bwd": [*([_P] * 18), *([_I] * 5), *([_L] * 10), _I, _I, _I, _I, _P],
}
SOURCES = ((_SOURCE, _SIGNATURES),)
HEAD_DIM = 64          # the kernels' row width
_WARPS = 8             # items a block of the kernels (csrc's WARPS)
_BWD_BLOCKS_PER_SM = 2   # resident blocks of the backward (its launch bounds)
_DTYPES = (torch.bfloat16, torch.float32)


def _rope_video_slice(x: torch.Tensor, rope: Optional[Rope], text_len: int) -> torch.Tensor:
    """RoPE on positions [text_len:] of [B, S, H, D]; cos/sin are [S_vid, D]."""
    if rope is None:
        return x
    cos, sin = rope
    out = torch.empty_like(x)
    out[:, :text_len] = x[:, :text_len]
    out[:, text_len:] = apply_rotary_emb(x[:, text_len:], cos[:, None, :], sin[:, None, :])
    return out


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    return x.view(x.shape[0], x.shape[1], heads, x.shape[2] // heads)


def _prep_reference(x: torch.Tensor, heads: int, norm: Optional[Norm], rope: Optional[Rope],
                    text_len: int) -> torch.Tensor:
    y = _split(x, heads)
    if norm is not None:
        y = layer_norm(y, norm[0], norm[1], eps=norm[2])
    return _rope_video_slice(y, rope, text_len)


def qk_norm_rope_reference(q: Optional[torch.Tensor], k: torch.Tensor, *, heads: int,
                           norm_q: Optional[Norm] = None, norm_k: Optional[Norm] = None,
                           rope: Optional[Rope] = None, text_len: int = 0
                           ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The plain version, on any device: the eager composition (differentiable
    by autograd). Returns (q', k'), q' None without q."""
    qo = None if q is None else _prep_reference(q, heads, norm_q, rope, text_len)
    return qo, _prep_reference(k, heads, norm_k, rope, text_len)


# -- the kernels ----------------------------------------------------------------------

def _addressable(x: torch.Tensor, dims: int) -> bool:
    """What the kernels' 16-byte accesses need of a tensor: a contiguous last
    dim, the `dims` strides before it multiples of 8 elements, a 16-byte
    aligned start."""
    return (x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[-1 - dims:-1])
            and x.data_ptr() % 16 == 0)


def _check_cuda(xs: Sequence[torch.Tensor], heads: int, rope: Optional[Rope], text_len: int):
    """Checked (batch, seq, dtype, cos, sin) of a launch."""
    x0 = xs[0]
    b, s, width = x0.shape
    if x0.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes bfloat16 or float32 projections, got {x0.dtype}")
    if width != heads * HEAD_DIM:
        raise ValueError(f"head dim {width // heads} not supported by the kernel "
                         f"(takes {HEAD_DIM})")
    for x in xs:
        if x.device != x0.device or x.dtype != x0.dtype or x.shape != x0.shape:
            raise ValueError(f"q and k must match: {x.dtype} {tuple(x.shape)} on {x.device} "
                             f"against {x0.dtype} {tuple(x0.shape)} on {x0.device}")
        if not _addressable(x, 2):
            raise ValueError(f"the kernel needs a contiguous last dim, strides that are "
                             f"multiples of 8 and a 16-byte aligned start; got strides "
                             f"{x.stride()}")
    cos = sin = None
    if rope is not None:
        cos, sin = (t.to(device=x0.device, dtype=torch.float32).contiguous() for t in rope)
        if cos.shape != (s - text_len, HEAD_DIM) or sin.shape != cos.shape:
            raise ValueError(f"rope tables must be [S - text_len, {HEAD_DIM}] = "
                             f"[{s - text_len}, {HEAD_DIM}], got {tuple(cos.shape)}")
    return b, s, x0.dtype, cos, sin


def _params(norms: Sequence[Optional[Norm]], device) -> Tuple[list, int]:
    """The affine rows as the kernel reads them (fp32, or bf16 where every one
    is bf16), contiguous, one pair a tensor; and the bf16 flag."""
    ts = [t for n in norms if n is not None for t in n[:2] if t is not None]
    bf16 = bool(ts) and all(t.dtype == torch.bfloat16 for t in ts)
    dtype = torch.bfloat16 if bf16 else torch.float32
    out = []
    for n in norms:
        pair = (None, None) if n is None else n[:2]
        out.append([None if t is None else t.detach().to(device=device, dtype=dtype).contiguous()
                    for t in pair])
    for w, bias in out:
        for t in (w, bias):
            if t is not None and t.shape != (HEAD_DIM,):
                raise ValueError(f"norm weights must be [{HEAD_DIM}], got {tuple(t.shape)}")
    return out, int(bf16)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pad2(seq, fill=None):
    return list(seq) + [fill] * (2 - len(seq))


def qk_norm_rope_fwd_cuda(xs: Sequence[torch.Tensor], norms: Sequence[Optional[Norm]], *,
                          heads: int, rope: Optional[Rope], text_len: int,
                          save_stats: bool):
    """Launch the forward kernel on the current stream for 1 or 2 tensors.
    Returns (outputs [B, S, H, 64], stats): stats are each tensor's (mean,
    rstd) fp32 [B, S, H] when `save_stats` (None for a tensor without norm)."""
    b, s, dtype, cos, sin = _check_cuda(xs, heads, rope, text_len)
    dev = xs[0].device
    params, params_bf16 = _params(norms, dev)
    ys = [torch.empty((b, s, heads, HEAD_DIM), dtype=dtype, device=dev) for _ in xs]
    stats = [(torch.empty((b, s, heads), dtype=torch.float32, device=dev),
              torch.empty((b, s, heads), dtype=torch.float32, device=dev))
             if save_stats and n is not None else (None, None) for n in norms]
    x0, x1 = _pad2(xs)
    (w0, b0), (w1, b1) = _pad2(params, (None, None))
    (m0, r0), (m1, r1) = _pad2(stats, (None, None))
    eps = [0.0 if n is None else float(n[2]) for n in _pad2(norms)]
    norm_mask = sum(1 << i for i, n in enumerate(norms) if n is not None)
    grid = -(-s * len(xs) * b // _WARPS)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.vp_qk_norm_rope_fwd(
            _ptr(x0), _ptr(x1), _ptr(ys[0]), _ptr(_pad2(ys)[1]), _ptr(w0), _ptr(b0), _ptr(w1),
            _ptr(b1), _ptr(cos), _ptr(sin), _ptr(m0), _ptr(r0), _ptr(m1), _ptr(r1),
            len(xs), b, s, heads, text_len, *x0.stride()[:2],
            *(x1.stride()[:2] if x1 is not None else (0, 0)), norm_mask, eps[0], eps[1],
            int(dtype == torch.float32), params_bf16, grid,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "qk_norm_rope")
    _kernels.LAUNCHES["qk_norm_rope"] += 1
    return ys, stats


def qk_norm_rope_bwd_cuda(xs: Sequence[torch.Tensor], dys: Sequence[torch.Tensor],
                          norms: Sequence[Optional[Norm]], stats, *, heads: int,
                          rope: Optional[Rope], text_len: int,
                          want_params: Sequence[bool]):
    """Launch the backward kernel on the current stream. Returns (dxs
    [B, S, H * 64] contiguous, dparams): dparams are each tensor's fp32
    (dweight, dbias) [64], summed over the blocks' partials, or (None, None)
    where `want_params` is False."""
    b, s, dtype, cos, sin = _check_cuda(xs, heads, rope, text_len)
    dev = xs[0].device
    params, params_bf16 = _params(norms, dev)
    dys = [dy.to(dtype) for dy in dys]
    dys = [dy if _addressable(dy, 3) else dy.contiguous() for dy in dys]
    for dy in dys:
        if dy.shape != (b, s, heads, HEAD_DIM) or dy.device != dev:
            raise ValueError(f"the output gradient must be [{b}, {s}, {heads}, {HEAD_DIM}] on "
                             f"{dev}, got {tuple(dy.shape)} on {dy.device}")
    dxs = [torch.empty((b, s, heads * HEAD_DIM), dtype=dtype, device=dev) for _ in xs]
    items = s * len(xs) * b
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(-(-items // _WARPS), _BWD_BLOCKS_PER_SM * sms)
    parts = [(torch.empty((grid, HEAD_DIM), dtype=torch.float32, device=dev),
              torch.empty((grid, HEAD_DIM), dtype=torch.float32, device=dev))
             if want and n is not None else (None, None) for want, n in zip(want_params, norms)]
    x0, x1 = _pad2(xs)
    dy0, dy1 = _pad2(dys)
    dx0, dx1 = _pad2(dxs)
    (w0, _), (w1, _) = _pad2(params, (None, None))
    (m0, r0), (m1, r1) = _pad2(stats, (None, None))
    (dw0, db0), (dw1, db1) = _pad2(parts, (None, None))
    norm_mask = sum(1 << i for i, n in enumerate(norms) if n is not None)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    with torch.cuda.device(dev):
        rc = lib.vp_qk_norm_rope_bwd(
            _ptr(x0), _ptr(x1), _ptr(dy0), _ptr(dy1), _ptr(dx0), _ptr(dx1), _ptr(w0), _ptr(w1),
            _ptr(cos), _ptr(sin), _ptr(m0), _ptr(r0), _ptr(m1), _ptr(r1), _ptr(dw0), _ptr(db0),
            _ptr(dw1), _ptr(db1), len(xs), b, s, heads, text_len, *x0.stride()[:2],
            *(x1.stride()[:2] if x1 is not None else (0, 0)), *dy0.stride()[:3],
            *(dy1.stride()[:3] if dy1 is not None else (0, 0, 0)), norm_mask,
            int(dtype == torch.float32), params_bf16, grid,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "qk_norm_rope_bwd")
    _kernels.LAUNCHES["qk_norm_rope_bwd"] += 1
    dparams = [tuple(None if t is None else t.sum(dim=0) for t in pair) for pair in parts]
    return dxs, dparams


# -- the differentiable call ------------------------------------------------------------

class QKNormRope(torch.autograd.Function):
    """Differentiable prep of one or two tensors. Arguments after `spec`
    (heads, rope, text_len, eps of each norm or None): x, weight, bias of each
    tensor, None where absent. CUDA: the forward kernel, keeping x, the
    weights and each row's mean and rstd, then the backward kernel. CPU: the
    plain version, and autograd through it again in the backward."""

    @staticmethod
    def forward(ctx, spec, *flat):
        heads, rope, text_len, eps = spec
        xs, norms = _unflatten(flat, eps)
        ctx.spec = spec
        if xs[0].device.type == "cuda":
            ys, stats = qk_norm_rope_fwd_cuda(xs, norms, heads=heads, rope=rope,
                                              text_len=text_len, save_stats=True)
            ctx.save_for_backward(*flat, *(t for st in stats for t in st))
        else:
            ys = [_prep_reference(x, heads, n, rope, text_len) for x, n in zip(xs, norms)]
            ctx.save_for_backward(*flat)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        heads, rope, text_len, eps = ctx.spec
        saved = ctx.saved_tensors
        n = 3 * len(eps)
        flat, rest = saved[:n], saved[n:]
        xs, norms = _unflatten(flat, eps)
        need = ctx.needs_input_grad[1:]
        if xs[0].device.type == "cuda":
            stats = [tuple(rest[2 * i:2 * i + 2]) for i in range(len(xs))]
            want = [need[3 * i + 1] or need[3 * i + 2] for i in range(len(xs))]
            dxs, dparams = qk_norm_rope_bwd_cuda(xs, dys, norms, stats, heads=heads, rope=rope,
                                                 text_len=text_len, want_params=want)
            grads = []
            for i, (dx, (dw, db)) in enumerate(zip(dxs, dparams)):
                w, bias = flat[3 * i + 1], flat[3 * i + 2]
                grads += [dx, None if dw is None or w is None else dw.to(w.dtype),
                          None if db is None or bias is None else db.to(bias.dtype)]
        else:
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(need[i])
                          for i, t in enumerate(flat)]
                lxs, lnorms = _unflatten(leaves, eps)
                ys = [_prep_reference(x, heads, nn, rope, text_len) for x, nn in zip(lxs, lnorms)]
                wrt = [t for t in leaves if t is not None and t.requires_grad]
                got = iter(torch.autograd.grad(ys, wrt, dys, allow_unused=True))
                grads = [next(got) if t is not None and t.requires_grad else None for t in leaves]
        return (None, *(g if need[i] else None for i, g in enumerate(grads)))


def _unflatten(flat, eps):
    """[x, w, b] * n and the eps of each norm -> (xs, norms)."""
    xs = [flat[3 * i] for i in range(len(eps))]
    norms = [None if e is None else (flat[3 * i + 1], flat[3 * i + 2], e)
             for i, e in enumerate(eps)]
    return xs, norms


def qk_norm_rope(q: Optional[torch.Tensor], k: torch.Tensor, *, heads: int,
                 norm_q: Optional[Norm] = None, norm_k: Optional[Norm] = None,
                 rope: Optional[Rope] = None, text_len: int = 0
                 ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Per-head LayerNorm of q and k, then RoPE on rows [text_len:]; one
    launch for both on the card. q, k: [B, S, H * 64]; returns (q', k')
    [B, S, H, 64], q' None without q."""
    pairs = [(x, n) for x, n in ((q, norm_q), (k, norm_k)) if x is not None]
    if rope is None and all(n is None for _, n in pairs):
        return (None if q is None else _split(q, heads)), _split(k, heads)
    xs = [x for x, _ in pairs]
    norms = [n for _, n in pairs]
    flat = [t for x, n in pairs for t in (x, *((None, None) if n is None else n[:2]))]
    spec = (heads, rope, text_len, tuple(None if n is None else float(n[2]) for n in norms))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in flat):
        ys = QKNormRope.apply(spec, *flat)
    elif xs[0].device.type == "cpu":
        ys = [_prep_reference(x, heads, n, rope, text_len) for x, n in pairs]
    elif xs[0].device.type == "cuda":
        ys = qk_norm_rope_fwd_cuda(xs, norms, heads=heads, rope=rope, text_len=text_len,
                                   save_stats=False)[0]
    else:
        raise ValueError(f"qk_norm_rope runs on cpu or cuda tensors, got {xs[0].device}")
    return (None if q is None else ys[0]), ys[-1]
