"""The collectives of the parallel paths, differentiable where a gradient
crosses them.

In the JAX package XLA inserts these from the shardings (GSPMD) or from
`shard_map`'s `psum` / `pmean` / `ppermute`; the port calls them itself:

 - `all_reduce_` (sum or max, in place, no gradient): the gradient average
   over `data`, the ZeRO-2 statistics, the W8A8 activation amax of a
   row-parallel linear;
 - `reduce_from` / `copy_to`: the Megatron pair of a tensor-parallel layer
   (sum in the forward and identity in the backward, and the reverse);
 - `pmean`: the mean over a group both ways (the ring's text outputs);
 - `all_gather(x, dim, group, backward=...)`: concatenation of every rank's
   shard along `dim`, shards of unequal length allowed (each padded to the
   longest, trimmed after). Its backward either sums every rank's gradient
   of the gathered tensor and keeps this rank's slice ("sum": the consumer of
   the gathered tensor is split across ranks, as K / V for local queries) or
   keeps this rank's slice of its own gradient ("slice": the consumer is
   replicated, as the output projection after the last block);
 - `sendrecv(tensors, group, shift)`: each rank sends to rank + shift and
   receives from rank - shift (`batch_isend_irecv`), the ring's rotation.

Gradients follow one rule across ranks: a rank back-propagates the part of
the loss its local tokens carry, and parameter gradients are summed over
`seq` and averaged over `data` once, after the backward
(`training/train_branch.py`). Over `model` the Megatron rule holds: every
rank back-propagates the whole loss.

Routes: NCCL moves CUDA tensors directly. PyTorch's gloo backend accepts
CUDA tensors only in `broadcast` and `all_reduce`, so under gloo a CUDA
tensor's all-gather and send / recv are staged through pinned host buffers
(one copy each way); `all_reduce` stays direct. The route is chosen from
`dist.get_backend(group)`, recorded in `ROUTES` and logged once per
(backend, kind); a failed collective raises. `COUNTS` holds the calls and
payload bytes of each kind, which tests and chip_smoke.py read.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

KINDS = ("all_reduce", "all_gather", "sendrecv")
COUNTS: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0} for k in KINDS}
ROUTES: Dict[str, str] = {}


def reset_counts() -> None:
    for k in KINDS:
        COUNTS[k]["calls"] = COUNTS[k]["bytes"] = 0


def _count(kind: str, tensors: Sequence[torch.Tensor]) -> None:
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def _staged(kind: str, group, x: torch.Tensor) -> bool:
    """True when `x` must travel through host memory: a CUDA tensor under
    gloo for anything but all_reduce."""
    backend = dist.get_backend(group)
    host = x.device.type == "cuda" and backend == "gloo" and kind != "all_reduce"
    key = f"{backend}:{kind}:{x.device.type}"
    if key not in ROUTES:
        ROUTES[key] = "host" if host else "direct"
        log.info("collective %s on %s tensors over %s: %s", kind, x.device.type, backend,
                 ROUTES[key])
    return host


def _to_host(x: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce (sum or max) of `x` over `group`; no gradient."""
    _staged("all_reduce", group, x)
    _count("all_reduce", [x])
    dist.all_reduce(x, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group)
    return x


def _gather_raw(x: torch.Tensor, dim: int, group, sizes: List[int]) -> torch.Tensor:
    """Concatenate every rank's shard of `x` along `dim` (shard r has
    sizes[r] rows there; each travels padded to the longest)."""
    n, longest = len(sizes), max(sizes)
    x = x.movedim(dim, 0)
    if x.shape[0] < longest:
        x = torch.cat([x, x.new_zeros((longest - x.shape[0],) + tuple(x.shape[1:]))])
    x = x.contiguous()
    staged = _staged("all_gather", group, x)
    src = _to_host(x) if staged else x
    parts = [torch.empty_like(src) for _ in range(n)]
    _count("all_gather", [src])
    dist.all_gather(parts, src, group=group)
    if staged:
        parts = [p.to(x.device, non_blocking=True) for p in parts]
    full = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return full.movedim(0, dim)


def _slice(x: torch.Tensor, dim: int, sizes: List[int], r: int) -> torch.Tensor:
    lo = sum(sizes[:r])
    return x.narrow(dim, lo, sizes[r])


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group) / size(group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group) / size(ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, sizes, backward):
        ctx.args = (dim, group, sizes, backward)
        return _gather_raw(x, dim, group, sizes)

    @staticmethod
    def backward(ctx, g):
        dim, group, sizes, backward = ctx.args
        if backward == "sum":
            g = all_reduce_(g.contiguous().clone(), group)
        return _slice(g, dim, sizes, rank(group)).contiguous(), None, None, None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` in the forward, identity in the backward (the output
    of a row-parallel linear)."""
    return _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity in the forward, sum over `group` in the backward (the input of
    a column-parallel linear)."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyTo.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """Mean over `group`, forward and backward."""
    return _PMean.apply(x, group)


def shard_sizes(total: int, n: int) -> List[int]:
    """Rows of each of n shards of `total`: ceil(total / n) each, the last
    ones shorter (GSPMD's split of an uneven axis)."""
    c = -(-total // n)
    return [max(0, min(c, total - r * c)) for r in range(n)]


def shard_range(total: int, n: int, r: int):
    c = -(-total // n)
    return min(r * c, total), min((r + 1) * c, total)


def all_gather(x: torch.Tensor, dim: int, group, *, sizes: Optional[List[int]] = None,
               backward: str = "sum") -> torch.Tensor:
    """Every rank's shard of `x` concatenated along `dim` (see the module
    note for `backward`). `sizes`: each rank's length along `dim` (default:
    all equal to this rank's)."""
    if backward not in ("sum", "slice"):
        raise ValueError(f"backward must be 'sum' or 'slice', got {backward!r}")
    sizes = list(sizes) if sizes is not None else [x.shape[dim]] * size(group)
    if x.shape[dim] != sizes[rank(group)]:
        raise ValueError(f"shard of {x.shape[dim]} rows on rank {rank(group)}, "
                         f"expected {sizes[rank(group)]}")
    return _AllGather.apply(x, dim % x.ndim, group, sizes, backward)


def sendrecv(tensors: Sequence[torch.Tensor], group, shift: int = 1) -> List[torch.Tensor]:
    """Send each tensor to group rank (r + shift) % n and receive the same
    shapes from (r - shift) % n. Returns the received tensors."""
    n, r = size(group), rank(group)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    staged = _staged("sendrecv", group, tensors[0])
    outs, ops, sends = [], [], []
    for t in tensors:
        t = t.contiguous()
        s = _to_host(t) if staged else t
        recv = torch.empty_like(s)
        sends.append(s)
        outs.append(recv)
        ops += [dist.P2POp(dist.isend, s, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    _count("sendrecv", sends)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        outs = [o.to(t.device, non_blocking=True) for o, t in zip(outs, tensors)]
    return outs
