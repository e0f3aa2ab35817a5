"""Placement rules for the models' parameters, and tensor parallelism.

Counterpart of `videopainter_tpu/parallel/sharding.py`, on the port's
diffusers names. Megatron-style tensor parallelism over `model` for the
linears of the DiT blocks (the FLOP-dominant 95% of the parameters):

 | under `transformer_blocks.*`            | placement                          |
 |-----------------------------------------|------------------------------------|
 | `attn1.to_q` / `to_k` / `to_v` / `to_qkv` | column-parallel (weight rows, bias)|
 | `attn1.to_out.0`                        | row-parallel (weight columns)      |
 | `ff.net.0.proj`                         | column-parallel                    |
 | `ff.net.2`                              | row-parallel                       |

`Int8Linear`s follow the same rule (`weight_q` as the weight; `kscale`
with the output rows, replicated on the row-parallel ones; `ascale`
replicated). Everything else is replicated, the VAE entirely.

A spec is a tuple with one mesh axis name (or None) per dim. A block
parameter's spec runs over the parameter stacked across layers, [L, *shape],
as the JAX package's stacked leaves do, so the ZeRO-2 rule reads the same:
moments of a stacked leaf shard their layer axis over `data`
(`optimizer_state_specs`). Non-block parameters have the spec () (replicated).

`shard_params(model, mesh)` applies the rule in place: each rule's linear
keeps this rank's rows or columns and gets a `TPSlot`
(`ops/basic.py`), and each attention's head count becomes the local
`num_heads // model` (the QK norms, shared by all heads, sum their gradient
over the group). The fused `to_qkv` keeps [q_r ‖ k_r ‖ v_r], this rank's
rows of each of q, k and v, so `chunk(3)` sees local q, k and v. A block
whose heads or FFN width `model` does not divide stays replicated (as
`fit_spec` leaves an axis that does not divide).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.basic import Int8Linear, TPSlot
from .mesh import AXES, axis_rank, axis_size

M, D, S = AXES.model, AXES.data, AXES.seq
Spec = Tuple[Optional[str], ...]

COLUMN = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_qkv", "ff.net.0.proj")
ROW = ("attn1.to_out.0", "ff.net.2")
_BLOCK = re.compile(r"^(?:.*\.)?transformer_blocks\.(\d+)\.(.+)$")


def placement(name: str) -> Optional[str]:
    """"col", "row" or None for a parameter or buffer name."""
    m = _BLOCK.match(name)
    if m is None:
        return None
    owner = m.group(2).rsplit(".", 1)[0]
    if owner in COLUMN:
        return "col"
    if owner in ROW:
        return "row"
    return None


def param_spec(name: str) -> Spec:
    kind = placement(name)
    leaf = name.rsplit(".", 1)[1]
    if kind is None or leaf == "ascale":
        return ()
    if kind == "col":
        if leaf in ("weight", "weight_q"):
            return (None, M, None)
        return (None, M)                   # bias, kscale: with the output rows
    if leaf in ("weight", "weight_q"):
        return (None, None, M)
    return ()                              # row-parallel bias and kscale: replicated


def _named_tensors(model: nn.Module):
    yield from model.named_parameters()
    for name, buf in model.named_buffers():
        if buf is not None and not name.endswith(("pos_embedding", "lora_A", "lora_B",
                                                  "lora_scale")):
            yield name, buf


def transformer_param_specs(model: nn.Module) -> Dict[str, Spec]:
    """{name: spec} for every parameter (and int8 buffer) of a DiT or branch."""
    return {name: param_spec(name) for name, _ in _named_tensors(model)}


def branch_param_specs(model: nn.Module) -> Dict[str, Spec]:
    return transformer_param_specs(model)


def vae_param_specs(model: nn.Module) -> Dict[str, Spec]:
    return {name: () for name, _ in _named_tensors(model)}


def activation_spec(batch_axis: bool = True, seq_axis: bool = False) -> Spec:
    """Latent activations [B, ...] / token sequences [B, S, D]."""
    if seq_axis:
        return (D, S)
    return (D,) if batch_axis else ()


def optimizer_state_specs(param_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """ZeRO-2: the moments of a stacked block leaf (spec of rank >= 2 with a
    free leading axis) shard the layer axis over `data`; the rest stay
    replicated."""
    def convert(spec: Spec) -> Spec:
        if len(spec) >= 2 and spec[0] is None:
            return (D,) + tuple(spec[1:])
        return spec
    return {k: convert(v) for k, v in param_specs.items()}


def opt_state_specs(opt_state: dict, params, param_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """{state key: spec} for an optimizer state (`training/optim.py`) made
    from `params` ({name: tensor} in sorted-name order, as
    `init_branch_train_state` makes it, or the names): a per-parameter entry
    "<key>.<name>" (moments, accumulators) takes the ZeRO-2 spec of its
    parameter; everything else (counters, scalars) is replicated."""
    names = sorted(params) if isinstance(params, dict) else list(params)
    zero = optimizer_state_specs(param_specs)
    out: Dict[str, Spec] = {}
    for key, value in opt_state.items():
        if isinstance(value, list) and len(value) == len(names):
            for name in names:
                out[f"{key}.{name}"] = zero.get(name, ())
        else:
            out[key] = ()
    return out


def fit_spec(shape: Sequence[int], spec: Spec, mesh_shape: Dict[str, int]) -> Spec:
    """Drop the spec axes whose mesh size does not divide the dim (a 2-layer
    stacked leaf on a data=4 mesh stays replicated on that dim)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, axis in zip(shape, parts):
        if axis is None:
            out.append(None)
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        size = 1
        for n in names:
            size *= mesh_shape[n]
        out.append(axis if size > 0 and dim % size == 0 else None)
    return tuple(out)


def _rows(full: int, parts: int, r: int, fused: bool) -> torch.Tensor:
    """This rank's output rows: a contiguous 1/parts slice, or for a fused
    [q; k; v] weight the slice of each third."""
    if not fused:
        c = full // parts
        return torch.arange(r * c, (r + 1) * c)
    third = full // 3
    c = third // parts
    return torch.cat([torch.arange(j * third + r * c, j * third + (r + 1) * c)
                      for j in range(3)])


@torch.no_grad()
def _shard_linear(lin: nn.Module, kind: str, group, parts: int, r: int, fused: bool):
    if isinstance(lin, Int8Linear):
        weight, wname = lin.weight_q, "weight_q"
    else:
        weight, wname = lin.weight, "weight"
    out_f, in_f = weight.shape
    if kind == "col":
        index = _rows(out_f, parts, r, fused).to(weight.device)
        new_w = weight.index_select(0, index)
        full = out_f
    else:
        index = torch.arange(r * (in_f // parts), (r + 1) * (in_f // parts),
                             device=weight.device)
        new_w = weight.index_select(1, index)
        full = in_f

    def put(name, value):
        old = getattr(lin, name)
        if isinstance(old, nn.Parameter):
            setattr(lin, name, nn.Parameter(value.contiguous(), requires_grad=old.requires_grad))
        else:
            lin.register_buffer(name, value.contiguous(),
                                persistent=name not in ("lora_A", "lora_B", "lora_scale"))

    put(wname, new_w)
    if kind == "col":
        for name in ("bias", "kscale"):
            if getattr(lin, name, None) is not None:
                put(name, getattr(lin, name).index_select(0, index))
                getattr(lin, name).tp_split = True
        if getattr(lin, "lora_B", None) is not None:
            put("lora_B", lin.lora_B.index_select(1, index))
    elif getattr(lin, "lora_A", None) is not None:
        put("lora_A", lin.lora_A.index_select(0, index))
    getattr(lin, wname).tp_split = True   # this rank's part: statistics sum over `model`
    if isinstance(lin, Int8Linear):
        lin.out_features, lin.in_features = lin.weight_q.shape
    else:
        lin.out_features, lin.in_features = lin.weight.shape
    lin.tp = TPSlot(kind, group, index, full)


def _divides(block: nn.Module, parts: int) -> bool:
    attn = block.attn1
    hidden = block.ff.net[0].proj
    width = (hidden.weight_q if isinstance(hidden, Int8Linear) else hidden.weight).shape[0]
    return attn.num_heads % parts == 0 and width % parts == 0


def shard_params(model: nn.Module, mesh, specs: Optional[Dict[str, Spec]] = None) -> nn.Module:
    """Tensor-parallel placement of a DiT or branch over the mesh's `model`
    axis, in place (see the module note); returns `model`. A mesh whose
    `model` axis has one rank leaves the model as it is. `specs` is accepted
    for the JAX signature; the rule table decides."""
    del specs
    parts = axis_size(mesh, M)
    blocks = getattr(model, "transformer_blocks", None)
    if parts == 1 or blocks is None:
        return model
    group, r = mesh.get_group(M), axis_rank(mesh, M)
    for block in blocks:
        if getattr(block.attn1, "tp_parts", 1) != 1:
            raise ValueError("model is already tensor-parallel")
        if not _divides(block, parts):
            continue
        for name, mod in block.named_modules():
            kind = placement(f"transformer_blocks.0.{name}.weight")
            if kind is not None:
                _shard_linear(mod, kind, group, parts, r, fused=name.endswith("to_qkv"))
        block.attn1.num_heads //= parts
        block.attn1.tp_parts = parts
        for norm in (block.attn1.norm_q, block.attn1.norm_k):
            if norm is not None:   # shared by the heads of every rank
                norm.tp_group = group
    return model


def tp_slot(model: nn.Module, name: str):
    """(TPSlot, dim) of a tensor-parallel parameter `name` of `model` (dim:
    the axis that holds this rank's part), or None for a whole one."""
    path, leaf = name.rsplit(".", 1)
    mod = model.get_submodule(path)
    slot = getattr(mod, "tp", None)
    if slot is None:
        return None
    if slot.kind == "col":
        return slot, 0
    return (slot, 1) if leaf in ("weight", "weight_q") else None


def gather_tp(t: torch.Tensor, slot: TPSlot, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's part (a collective over the
    `model` group; the rank's positions are its slot's index)."""
    from . import comm
    index = comm.all_gather(slot.index.to(t.device), 0, slot.group)
    parts = comm.all_gather(t.detach().contiguous(), dim, slot.group)
    shape = list(t.shape)
    shape[dim] = slot.full
    return torch.empty(shape, dtype=t.dtype, device=t.device).index_copy_(dim, index, parts)


def take_tp(t: torch.Tensor, slot: TPSlot, dim: int) -> torch.Tensor:
    """This rank's part of a whole tensor."""
    return t.index_select(dim, slot.index.to(t.device))
