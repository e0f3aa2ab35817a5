"""Ring attention: sequence-parallel attention over the `seq` group.

Counterpart of `videopainter_tpu/parallel/ring_attention.py` (standard ring
attention, Liu et al. 2023). Each rank holds its queries and one shard of
the video keys and values; the shards rotate around the ring
(`comm.sendrecv`, the JAX `ppermute`) while each rank folds every shard into
its output. The state is (out, lse), merged in fp32 (`merge_out_lse`, as the
JAX `_merge_out_lse`), so each local block is the flash forward with its
logsumexp: on CUDA tensors with `use_flash` the B1 kernel
(`ops.flash_attention.flash_attention_with_lse`, `csrc/flash_fwd_wgmma.cu`),
otherwise the plain fp32 version. Under the int8 modes the ring runs B1 all
the same, as the JAX call site does (B4 has no lse).

`ring_joint_attention` is the DiT's layout: the replicated text keys and
values are folded in once, first; the text queries ride on every rank and
their output is averaged over the group (the JAX `pmean`), so the
replicated text stream stays identical across ranks.

The backward (`_RingJoint`) is written out, block by block, as the forward
was: with the merged lse and delta = rowsum(dO * O) of the final output, the
gradient of each block is the flash backward of that block alone (B2 for
dQ, B3 for dK / dV on CUDA tensors with `use_flash`; the plain version
`flash_attention_backward_reference` otherwise). dQ sums over the blocks;
dK / dV accumulate on the rotating shard, travel with it, and go home with
one last step. Gradients follow the rule of `comm.py`: each rank returns its
share of the replicated text inputs' gradient (the sum over `seq` is taken
with the parameter gradients), and the text output's gradient is averaged
over the group first, as the `pmean`'s is.

`ring_forward_decomposition` / `ring_backward_decomposition` compute, in
one process and with no communication, what each rank of a ring of n
computes (same blocks, same order, same merges), for checking the ring's
arithmetic against a single flash call on the whole sequence.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ..ops.flash_attention import (flash_attention_backward_reference,
                                   flash_attention_reference, flash_attention_with_lse,
                                   flash_bwd_delta, flash_dkv_cuda, flash_dq_cuda,
                                   _kernel_layout_ok)
from . import comm
from .mesh import AXES


def merge_out_lse(out_a, lse_a, out_b, lse_b):
    """Merge two partial attentions over disjoint key sets, in fp32."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)
    wb = torch.exp(lse_b - m)
    out = (out_a * wa[..., None] + out_b.float() * wb[..., None]) / (wa + wb)[..., None]
    return out, m + torch.log(wa + wb)


def local_out_lse(q, k, v, scale, use_flash) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse fp32) of one block: B1 with lse on CUDA tensors under
    `use_flash` (any mode), the plain fp32 version otherwise (out in fp32)."""
    if use_flash and q.device.type == "cuda":
        return flash_attention_with_lse(q, k, v, scale)
    return flash_attention_reference(q.float(), k.float(), v.float(), scale, with_lse=True)


def _block_grads(q, k, v, out, lse, dout, delta, scale, use_flash):
    """(dq, dk, dv) of one block given the merged lse and delta."""
    if use_flash and q.device.type == "cuda":
        dq = flash_dq_cuda(q, k, v, dout, lse, delta, scale, k.shape[2], None)
        dk, dv = flash_dkv_cuda(q, k, v, dout, lse, delta, scale, k.shape[2], None)
        return dq, dk, dv
    return flash_attention_backward_reference(q, k, v, out, lse, dout, scale)


Rotate = Callable[[int, List[torch.Tensor]], List[torch.Tensor]]


def _ring_forward(q, k_text, v_text, k0, v0, n: int, rotate: Rotate, scale, use_flash):
    """The forward of one rank: the text block (if any), then n video shards
    as `rotate(step, [k, v])` hands them over. Returns (out fp32, lse)."""
    out = lse = None
    if k_text is not None and k_text.shape[2]:
        out, lse = local_out_lse(q, k_text, v_text, scale, use_flash)
        out = out.float()
    k, v = k0, v0
    for step in range(n):
        o, l = local_out_lse(q, k, v, scale, use_flash)
        out, lse = (o.float(), l) if out is None else merge_out_lse(out, lse, o, l)
        if step < n - 1:
            k, v = rotate(step, [k, v])
    return out, lse


def _ring_backward(q, k_text, v_text, k0, v0, out, lse, dout, n: int, rotate: Rotate,
                   scale, use_flash):
    """The backward of one rank. Returns (dq, dk_text, dv_text, dk, dv)
    with dk / dv those of the shard held after n - 1 rotations (the caller
    sends them home) and the rest this rank's share; fp32."""
    if use_flash and q.device.type == "cuda":
        if not _kernel_layout_ok(dout):
            dout = dout.contiguous()
        lse = lse.contiguous()
        delta = flash_bwd_delta(out, dout)
    else:
        delta = None
    grads = lambda k, v: _block_grads(q, k, v, out, lse, dout, delta, scale, use_flash)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_t = dv_t = None
    if k_text is not None and k_text.shape[2]:
        g = grads(k_text, v_text)
        dq += g[0].float()
        dk_t, dv_t = g[1].float(), g[2].float()
    k, v = k0, v0
    dk = torch.zeros(k0.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v0.shape, dtype=torch.float32, device=q.device)
    for step in range(n):
        g = grads(k, v)
        dq += g[0].float()
        dk += g[1].float()
        dv += g[2].float()
        if step < n - 1:
            k, v, dk, dv = rotate(step, [k, v, dk, dv])
    return dq, dk_t, dv_t, dk, dv


class _RingJoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_text, q_vid, k_text, k_vid, v_text, v_vid, group, scale, use_flash):
        n = comm.size(group)
        s_text = q_text.shape[2]
        q = torch.cat([q_text, q_vid], dim=2)
        rotate = lambda step, ts: comm.sendrecv(ts, group)
        out, lse = _ring_forward(q, k_text, v_text, k_vid, v_vid, n, rotate, scale, use_flash)
        out = out.to(q_vid.dtype)
        ctx.save_for_backward(q, k_text, v_text, k_vid, v_vid, out, lse)
        ctx.args = (group, scale, use_flash, s_text)
        out_text = out[:, :, :s_text].contiguous()
        if s_text:
            out_text = comm.all_reduce_(out_text.float(), group).div_(n).to(out.dtype)
        return out_text, out[:, :, s_text:]

    @staticmethod
    def backward(ctx, d_text, d_vid):
        q, k_text, v_text, k_vid, v_vid, out, lse = ctx.saved_tensors
        group, scale, use_flash, s_text = ctx.args
        n = comm.size(group)
        if d_vid is None:
            d_vid = torch.zeros_like(out[:, :, s_text:])
        if s_text:
            d_text = torch.zeros_like(out[:, :, :s_text]) if d_text is None else d_text
            d_text = comm.all_reduce_(d_text.float().contiguous(), group).div_(n)
            dout = torch.cat([d_text.to(out.dtype), d_vid.to(out.dtype)], dim=2)
        else:
            dout = d_vid.to(out.dtype)
        rotate = lambda step, ts: comm.sendrecv(ts, group)
        dq, dk_t, dv_t, dk, dv = _ring_backward(q, k_text, v_text, k_vid, v_vid, out, lse,
                                                dout, n, rotate, scale, use_flash)
        if n > 1:   # the shard held now is rank + 1's: send it home
            dk, dv = comm.sendrecv([dk, dv], group)
        cast = lambda g, like: None if g is None else g.to(like.dtype)
        return (cast(dq[:, :, :s_text], q), cast(dq[:, :, s_text:], q),
                cast(dk_t, k_text), cast(dk, k_vid), cast(dv_t, v_text), cast(dv, v_vid),
                None, None, None)


def _group(mesh, axis):
    return mesh.get_group(axis) if hasattr(mesh, "get_group") else mesh


def ring_joint_attention(q_text, q_vid, k_text, k_vid, v_text, v_vid, mesh, *,
                         axis: str = AXES.seq, scale: Optional[float] = None,
                         use_flash=False):
    """Joint [text ‖ video] ring attention. q/k/v_text: [B, H, S_text, D],
    the same on every rank; q/k/v_vid: this rank's [B, H, S_vid / n, D]
    shard (every rank's the same length). `mesh`: a DeviceMesh (its `axis`
    group) or a process group. Returns (out_text, the same on every rank;
    out_vid, this rank's shard)."""
    group = _group(mesh, axis)
    scale = q_vid.shape[-1] ** -0.5 if scale is None else scale
    return _RingJoint.apply(q_text, q_vid, k_text, k_vid, v_text, v_vid, group, scale,
                            bool(use_flash))


def ring_attention(q, k, v, mesh, *, axis: str = AXES.seq, scale: Optional[float] = None,
                   use_flash=False):
    """q, k, v: this rank's [B, H, S / n, D] shards; returns this rank's
    shard of the output."""
    empty = q[:, :, :0]
    return ring_joint_attention(empty, q, empty, k, empty, v, mesh, axis=axis, scale=scale,
                                use_flash=use_flash)[1]


def _shards(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    if x.shape[2] % n:
        raise ValueError(f"video length {x.shape[2]} is not divisible by the ring size {n}")
    return list(x.chunk(n, dim=2))


def ring_forward_decomposition(q, k, v, text_len: int, n: int, rank: int, *,
                               scale: Optional[float] = None, use_flash=True):
    """What rank `rank` of a ring of n computes for the joint sequence
    q, k, v [B, H, text_len + S_vid, D], in one process: (out fp32, lse) of
    its queries [text ‖ shard rank] before the text average."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    ks, vs = _shards(k[:, :, text_len:], n), _shards(v[:, :, text_len:], n)
    qr = torch.cat([q[:, :, :text_len], _shards(q[:, :, text_len:], n)[rank]], dim=2)
    rotate = lambda step, ts: [ks[(rank - step - 1) % n], vs[(rank - step - 1) % n]]
    return _ring_forward(qr, k[:, :, :text_len], v[:, :, :text_len], ks[rank], vs[rank], n,
                         rotate, scale, use_flash)


def ring_backward_decomposition(q, k, v, dout, text_len: int, n: int, *,
                                scale: Optional[float] = None, use_flash=True):
    """Every rank of a ring of n, in one process: each runs the ring forward
    and the ring backward of its queries (text output gradient `dout`'s text
    rows over n, the share the text average gives each rank), the dK / dV of
    each shard summed over the ranks as the ring does. Returns (dq, dk, dv)
    of the whole joint sequence, fp32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    ks, vs = _shards(k[:, :, text_len:], n), _shards(v[:, :, text_len:], n)
    qs, ds = _shards(q[:, :, text_len:], n), _shards(dout[:, :, text_len:], n)
    kt, vt = k[:, :, :text_len], v[:, :, :text_len]
    d_text = (dout[:, :, :text_len].float() / n).to(dout.dtype)
    dq_t = torch.zeros(q[:, :, :text_len].shape, dtype=torch.float32, device=q.device)
    dk_t, dv_t = torch.zeros_like(dq_t), torch.zeros_like(dq_t)
    dq_v, dk_v = [], [torch.zeros(x.shape, dtype=torch.float32, device=q.device) for x in ks]
    dv_v = [torch.zeros_like(x) for x in dk_v]
    for r in range(n):
        qr = torch.cat([q[:, :, :text_len], qs[r]], dim=2)
        out, lse = ring_forward_decomposition(q, k, v, text_len, n, r, scale=scale,
                                              use_flash=use_flash)
        out = out.to(q.dtype)
        held = [r]

        def rotate(step, ts, r=r, held=held):
            # the shard that leaves keeps its gradient; the next one comes
            # with a fresh accumulator (the ring's traffic, without traffic)
            dk_v[held[-1]] += ts[2]
            dv_v[held[-1]] += ts[3]
            held.append((r - step - 1) % n)
            return [ks[held[-1]], vs[held[-1]], torch.zeros_like(ts[2]), torch.zeros_like(ts[3])]
        dout_r = torch.cat([d_text, ds[r]], dim=2)
        dq, dkt, dvt, dk, dv = _ring_backward(qr, kt, vt, ks[r], vs[r], out, lse, dout_r, n,
                                              rotate, scale, use_flash)
        dk_v[held[-1]] += dk
        dv_v[held[-1]] += dv
        dq_t += dq[:, :, :text_len]
        dq_v.append(dq[:, :, text_len:])
        if dkt is not None:
            dk_t += dkt
            dv_t += dvt
    return (torch.cat([dq_t, *dq_v], dim=2), torch.cat([dk_t, *dk_v], dim=2),
            torch.cat([dv_t, *dv_v], dim=2))
