"""AdaLN's norm and modulation (`LayerNormZero`, `AdaLayerNorm`) as one
hand-written CUDA pass, forward and backward, with its plain version.

The JAX package leaves `layer_norm_zero` and `ada_layer_norm`
(`videopainter_tpu/ops/norms.py`) to XLA's fusion; it has no Pallas kernel.
Here:

 - `adaln_reference`: the plain version, the eager chain `ops/norms.py` ran
   before the kernel, unchanged: `ops/basic.layer_norm` (fp32 statistics and
   affine, rounded back to x's dtype), then `* (1 + scale) + shift` in fp32
   (float64 for float64 input), rounded once to x's dtype. CPU tensors take it.
 - `adaln_backward_reference`: the backward kernel's formula in plain PyTorch
   (fp32 from dy to dx, one rounding), which the autograd Function runs on the
   CPU and the tests hold to float64 `gradcheck`.
 - `csrc/adaln.cu`: one launch for the video and the text rows together
   (forward), and one for their backward; see the source's note for its
   design and its bound.

`adaln(x, shift, scale, weight, bias, eps=..., enc=..., enc_shift=...,
enc_scale=...)` takes the video rows x [B, S, D] and, where there are any, the
text rows `enc` [B, S_text, D] (bf16 or fp32, any batch and token strides as
long as each row is contiguous, such as the any-length path's
`prev_hidden_states[:, text_len:]`), each stream's fp32 modulation [B, D]
(the chunks of the modulation linear's output) and the norm's weight and bias
[D] (or None), and returns (y, enc_y) contiguous in x's dtype (enc_y None
without `enc`). The route follows what the call shows: a tensor that needs
grad goes through `AdaLNFunction`, whose forward keeps its inputs and each
row's fp32 mean and rstd (8 B a row) and whose backward is the second kernel;
otherwise (the served loop under `no_grad`) the forward alone runs and keeps
nothing. A CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from .. import _kernels
from .basic import layer_norm

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SOURCE = "adaln.cu"
_SIGNATURES = {
    "vp_adaln_fwd": [*([_P] * 14), *([_I] * 5), *([_L] * 8), _F, _I, _I, _P],
    "vp_adaln_bwd": [*([_P] * 17), *([_I] * 7), *([_L] * 12), _I, _I, _P],
}
SOURCES = ((_SOURCE, _SIGNATURES),)
MAX_DIM = 4096            # the kernels' widest row (csrc's MAX_DIM)
_BWD_BLOCKS_PER_SM = 1    # the backward's grid (its registers allow one block of 384)
_DTYPES = (torch.bfloat16, torch.float32)

Stream = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # x, shift, scale


# -- the plain version ------------------------------------------------------------------

def _modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
              weight: Optional[torch.Tensor], bias: Optional[torch.Tensor],
              eps: float) -> torch.Tensor:
    acc = torch.promote_types(x.dtype, torch.float32)
    n = layer_norm(x, weight, bias, eps=eps)
    return (n.to(acc) * (1 + scale[:, None, :]) + shift[:, None, :]).to(x.dtype)


def adaln_reference(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                    weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], *,
                    eps: float, enc: Optional[torch.Tensor] = None,
                    enc_shift: Optional[torch.Tensor] = None,
                    enc_scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version, on any device (differentiable by autograd): each
    stream's LayerNorm rounded to its dtype, then `n * (1 + scale) + shift`
    in fp32, rounded once."""
    y = _modulate(x, shift, scale, weight, bias, eps)
    e = None if enc is None else _modulate(enc, enc_shift, enc_scale, weight, bias, eps)
    return y, e


def _stats(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's mean and rstd [B, S] in x's accumulation dtype."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    if not x.numel():
        return x.sum(-1), x.sum(-1)
    var, mean = torch.var_mean(x, dim=-1, unbiased=False)
    return mean, torch.rsqrt(var + eps)


def adaln_backward_reference(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor,
                             rstd: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                             weight: Optional[torch.Tensor], bias: Optional[torch.Tensor]):
    """The backward kernel's formula for one stream, in plain PyTorch: fp32
    (float64 for float64 input) from dy to dx, which is rounded once to x's
    dtype. Returns (dx, d_shift [B, D], d_scale [B, D], dweight [D], dbias
    [D]); the last four in the accumulation dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    d = x.shape[-1]
    w = torch.ones(d, dtype=acc, device=x.device) if weight is None else weight.to(acc)
    b = torch.zeros(d, dtype=acc, device=x.device) if bias is None else bias.to(acc)
    dy = dy.to(acc)
    xhat = (x.to(acc) - mean[..., None]) * rstd[..., None]
    n = (xhat * w + b).to(x.dtype).to(acc)          # as the forward rounded it
    g = dy * (1 + scale.to(acc)[:, None, :])
    gw = g * w
    dx = rstd[..., None] * (gw - gw.mean(-1, keepdim=True)
                            - xhat * (gw * xhat).mean(-1, keepdim=True))
    return (dx.to(x.dtype), dy.sum(1), (dy * n).sum(1), (g * xhat).sum((0, 1)),
            g.sum((0, 1)))


# -- the kernels ------------------------------------------------------------------------

def _addressable(t: torch.Tensor) -> bool:
    """What the kernels' 16-byte accesses need of a tensor: a contiguous last
    dim, the strides before it (of dims longer than 1) multiples of 16 bytes,
    a 16-byte aligned start."""
    width = 16 // t.element_size()
    outer = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    return t.stride(-1) == 1 and not any(s % width for s in outer) and t.data_ptr() % 16 == 0


def _check_cuda(xs: Sequence[torch.Tensor]) -> Tuple[int, int, torch.dtype]:
    """Checked (batch, dim, dtype) of a launch over the streams `xs`."""
    x0 = xs[0]
    if x0.dtype not in _DTYPES:
        raise ValueError(f"the AdaLN kernels take bfloat16 or float32 activations, got "
                         f"{x0.dtype}")
    if x0.dim() != 3:
        raise ValueError(f"the AdaLN kernels take [B, S, D], got {tuple(x0.shape)}")
    b, _, d = x0.shape
    if d % 8 or d > MAX_DIM:
        raise ValueError(f"the AdaLN kernels take a width that is a multiple of 8 up to "
                         f"{MAX_DIM}, got {d}")
    for x in xs:
        if (x.device != x0.device or x.dtype != x0.dtype or x.dim() != 3
                or x.shape[0] != b or x.shape[2] != d):
            raise ValueError(f"the streams must match: {x.dtype} {tuple(x.shape)} on "
                             f"{x.device} against {x0.dtype} {tuple(x0.shape)} on {x0.device}")
        if x.numel() and not _addressable(x):
            raise ValueError(f"the AdaLN kernels need each row contiguous, strides that are "
                             f"multiples of 16 bytes and a 16-byte aligned start; got strides "
                             f"{x.stride()} for shape {tuple(x.shape)}")
    return b, d, x0.dtype


def _mod(t: torch.Tensor, b: int, d: int, device) -> torch.Tensor:
    """A modulation vector as the kernels read it: fp32 [B, D] rows."""
    if t.shape != (b, d):
        raise ValueError(f"the modulation must be [{b}, {d}], got {tuple(t.shape)}")
    t = t.detach().to(device=device, dtype=torch.float32)
    return t if _addressable(t) else t.contiguous()


def _affine(weight, bias, d: int, device):
    """The norm's weight and bias as the kernels read them (bf16 where both are
    bf16, else fp32; None stays None), and the bf16 flag."""
    ts = [t for t in (weight, bias) if t is not None]
    bf16 = bool(ts) and all(t.dtype == torch.bfloat16 for t in ts)
    dtype = torch.bfloat16 if bf16 else torch.float32
    out = []
    for t in (weight, bias):
        if t is not None and t.shape != (d,):
            raise ValueError(f"the norm's weight and bias must be [{d}], got {tuple(t.shape)}")
        out.append(None if t is None else t.detach().to(device=device, dtype=dtype).contiguous())
    return out, int(bf16)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _pad2(seq, fill=None):
    return list(seq) + [fill] * (2 - len(seq))


def _strides(t: Optional[torch.Tensor], n: int) -> List[int]:
    return list(t.stride()[:n]) if t is not None else [0] * n


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_args(streams: Sequence[Stream], weight, bias):
    """What both launches check and convert before they load the library:
    (xs, batch, dim, dtype, the modulation of each stream, (weight, bias),
    the bf16 flag)."""
    xs = [s[0] for s in streams]
    b, d, dtype = _check_cuda(xs)
    dev = xs[0].device
    mods = [(_mod(s[1], b, d, dev), _mod(s[2], b, d, dev)) for s in streams]
    affine, params_bf16 = _affine(weight, bias, d, dev)
    return xs, b, d, dtype, mods, affine, params_bf16


def adaln_fwd_cuda(streams: Sequence[Stream], weight, bias, *, eps: float, save_stats: bool):
    """Launch the forward kernel on the current stream for 1 or 2 streams of
    (x, shift, scale). Returns (outputs [B, S, D], stats): stats are each
    stream's fp32 (mean, rstd) [B, S] when `save_stats`, else None."""
    xs, b, d, dtype, mods, (w, bias_), params_bf16 = _launch_args(streams, weight, bias)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    dev = xs[0].device
    ys = [torch.empty(x.shape, dtype=dtype, device=dev) for x in xs]
    stats = None
    if save_stats:
        stats = [tuple(torch.empty(x.shape[:2], dtype=torch.float32, device=dev)
                       for _ in range(2)) for x in xs]
    rows = [x.shape[1] for x in xs]
    x0, x1 = _pad2(xs)
    y0, y1 = _pad2(ys)
    (sh0, sc0), (sh1, sc1) = _pad2(mods, (None, None))
    (m0, r0), (m1, r1) = _pad2(stats or [], (None, None))
    with torch.cuda.device(dev):
        rc = lib.vp_adaln_fwd(
            _ptr(x0), _ptr(x1), _ptr(y0), _ptr(y1), _ptr(w), _ptr(bias_), _ptr(sh0), _ptr(sc0),
            _ptr(sh1), _ptr(sc1), _ptr(m0), _ptr(r0), _ptr(m1), _ptr(r1), len(xs), b, rows[0],
            _pad2(rows, 0)[1], d, *_strides(x0, 2), *_strides(x1, 2), *_strides(sh0, 1),
            *_strides(sc0, 1), *_strides(sh1, 1), *_strides(sc1, 1), float(eps),
            int(dtype == torch.float32), params_bf16, torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "adaln_fwd")
    _kernels.LAUNCHES["adaln_fwd"] += 1
    return ys, stats


def _bwd_blocks(rows: Sequence[int], batch: int, device) -> List[int]:
    """Blocks a batch of each stream in the backward, in proportion to its
    rows, at least one: the grid fills the card once."""
    target = _BWD_BLOCKS_PER_SM * _sms(device)
    total = max(1, batch * sum(rows))
    return [max(1, round(target * r / total)) for r in rows]


def adaln_bwd_cuda(streams: Sequence[Stream], dys: Sequence[torch.Tensor], stats, weight,
                   bias, *, want_params: bool):
    """Launch the backward kernel on the current stream. Returns (dxs [B, S,
    D] contiguous in x's dtype, params): params None unless `want_params`,
    else each stream's fp32 (d_shift, d_scale) [B, D] and the fp32 (dweight,
    dbias) [D] over both streams, each the sum of the blocks' partials in a
    fixed order."""
    xs, b, d, dtype, mods, (w, bias_), params_bf16 = _launch_args(streams, weight, bias)
    lib = _kernels.load(_SOURCE, _SIGNATURES)
    dev = xs[0].device
    dys = [dy.to(dtype) for dy in dys]
    dys = [dy if _addressable(dy) else dy.contiguous() for dy in dys]
    for x, dy in zip(xs, dys):
        if dy.shape != x.shape or dy.device != dev:
            raise ValueError(f"the output gradient must be {tuple(x.shape)} on {dev}, got "
                             f"{tuple(dy.shape)} on {dy.device}")
    dxs = [torch.empty(x.shape, dtype=dtype, device=dev) for x in xs]
    rows = [x.shape[1] for x in xs]
    blocks = _bwd_blocks(rows, b, dev)
    grid = b * sum(blocks)
    part = (torch.empty((grid, 4, d), dtype=torch.float32, device=dev)
            if want_params else None)
    x0, x1 = _pad2(xs)
    dy0, dy1 = _pad2(dys)
    dx0, dx1 = _pad2(dxs)
    (sh0, sc0), (sh1, sc1) = _pad2(mods, (None, None))
    (m0, r0), (m1, r1) = _pad2(stats, (None, None))
    with torch.cuda.device(dev):
        rc = lib.vp_adaln_bwd(
            _ptr(x0), _ptr(x1), _ptr(dy0), _ptr(dy1), _ptr(dx0), _ptr(dx1), _ptr(w),
            _ptr(bias_), _ptr(sh0), _ptr(sc0), _ptr(sh1), _ptr(sc1), _ptr(m0), _ptr(r0),
            _ptr(m1), _ptr(r1), _ptr(part), len(xs), b, rows[0], _pad2(rows, 0)[1], d,
            blocks[0], _pad2(blocks, 0)[1], *_strides(x0, 2), *_strides(x1, 2),
            *_strides(dy0, 2), *_strides(dy1, 2), *_strides(sh0, 1), *_strides(sc0, 1),
            *_strides(sh1, 1), *_strides(sc1, 1), int(dtype == torch.float32), params_bf16,
            torch.cuda.current_stream().cuda_stream)
    _kernels.check(rc, "adaln_bwd")
    _kernels.LAUNCHES["adaln_bwd"] += 1
    if part is None:
        return dxs, None
    sums, o = [], 0
    for nb in blocks:   # each (stream, batch)'s blocks, summed in order: [B, 4, D]
        sums.append(part[o:o + b * nb].view(b, nb, 4, d).sum(1))
        o += b * nb
    mod_grads = [(s[:, 0], s[:, 1]) for s in sums]
    total = torch.cat(sums).sum(0)
    return dxs, (mod_grads, total[2], total[3])


# -- the differentiable call ------------------------------------------------------------

class AdaLNFunction(torch.autograd.Function):
    """Differentiable AdaLN of one or two streams. Arguments after `eps`:
    weight, bias, then x, shift, scale of each stream (weight / bias may be
    None). CUDA: the forward kernel, keeping the inputs and each row's mean
    and rstd, then the backward kernel. CPU: the plain version, then
    `adaln_backward_reference`."""

    @staticmethod
    def forward(ctx, eps, weight, bias, *flat):
        streams = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        if _device_kind(streams[0][0]) == "cuda":
            ys, stats = adaln_fwd_cuda(streams, weight, bias, eps=eps, save_stats=True)
        else:
            ys = [_modulate(x, sh, sc, weight, bias, eps) for x, sh, sc in streams]
            stats = [_stats(x, eps) for x, _, _ in streams]
        ctx.n = len(streams)
        ctx.save_for_backward(weight, bias, *flat, *(t for st in stats for t in st))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *dys):
        saved = ctx.saved_tensors
        weight, bias = saved[:2]
        flat = saved[2:2 + 3 * ctx.n]
        stats = [tuple(saved[2 + 3 * ctx.n + 2 * i:4 + 3 * ctx.n + 2 * i]) for i in range(ctx.n)]
        streams = [tuple(flat[i:i + 3]) for i in range(0, len(flat), 3)]
        need = ctx.needs_input_grad
        want_params = any(need[1:3]) or any(need[3 + 3 * i + j] for i in range(ctx.n)
                                            for j in (1, 2))
        if _device_kind(streams[0][0]) == "cuda":
            dxs, params = adaln_bwd_cuda(streams, dys, stats, weight, bias,
                                         want_params=want_params)
            mod_grads, dw, db = params if params is not None else ([(None, None)] * ctx.n,
                                                                   None, None)
        else:
            outs = [adaln_backward_reference(x, dy, m, r, sh, sc, weight, bias)
                    for (x, sh, sc), dy, (m, r) in zip(streams, dys, stats)]
            dxs = [o[0] for o in outs]
            mod_grads = [o[1:3] for o in outs]
            dw, db = (sum(o[i] for o in outs) for i in (3, 4))
        grads = [None,
                 None if dw is None or weight is None else dw.to(weight.dtype),
                 None if db is None or bias is None else db.to(bias.dtype)]
        for (x, sh, sc), dx, (dsh, dsc) in zip(streams, dxs, mod_grads):
            grads += [dx, None if dsh is None else dsh.to(sh.dtype),
                      None if dsc is None else dsc.to(sc.dtype)]
        return tuple(g if need[i] else None for i, g in enumerate(grads))


def _device_kind(x: torch.Tensor) -> str:
    return x.device.type


def adaln(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
          weight: Optional[torch.Tensor], bias: Optional[torch.Tensor], *, eps: float,
          enc: Optional[torch.Tensor] = None, enc_shift: Optional[torch.Tensor] = None,
          enc_scale: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """LayerNorm of each row (fp32 statistics and affine, rounded to its
    dtype), then `* (1 + scale) + shift` in fp32, rounded once: the video
    rows x with (shift, scale) and, where given, the text rows `enc` with
    (enc_shift, enc_scale); one launch for both on the card. Returns (y,
    enc_y), enc_y None without `enc`."""
    streams = [(x, shift, scale)] + ([] if enc is None else [(enc, enc_shift, enc_scale)])
    flat = [t for s in streams for t in s]
    kind = _device_kind(x)
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"adaln runs on cpu or cuda tensors, got {x.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (weight, bias, *flat)):
        ys = AdaLNFunction.apply(float(eps), weight, bias, *flat)
    elif kind == "cpu":
        return adaln_reference(x, shift, scale, weight, bias, eps=eps, enc=enc,
                               enc_shift=enc_shift, enc_scale=enc_scale)
    else:
        ys = adaln_fwd_cuda(streams, weight, bias, eps=eps, save_stats=False)[0]
    return ys[0], (ys[1] if enc is not None else None)
