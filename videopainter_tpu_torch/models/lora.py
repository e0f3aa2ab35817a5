"""LoRA for the DiT attention projections (the VideoPainterID adapter).

Counterpart of `videopainter_tpu/models/lora.py`. The reference trains a
rank-256 (alpha 128) adapter on the backbone's to_q / to_k / to_v / to_out.0
with peft. An adapter here is the JAX package's stacked tree as tensors:
`{target: {"lora_A": [L, d_in, r], "lora_B": [L, r, d_out]}}`. Two ways to
use one:

 - `merge_lora`: fold W + scale * (alpha / r) * A B into the base weights once
   (serving; no runtime cost). Merge before quantizing.
 - `attach_lora`: hang (A, B, scale) on each target linear so that it adds
   scale * (alpha / r) * (x A) B after the base projection. Same arithmetic,
   but no merged weight is made, so it also works on an int8-quantized
   backbone, which has no weight to merge into.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out")
LORA_RANK, LORA_ALPHA = 256, 128.0   # the VideoPainterID adapter's
LoraParams = Dict[str, Dict[str, torch.Tensor]]


def _target(block: nn.Module, tgt: str) -> nn.Module:
    attn = block.attn1
    return attn.to_out[0] if tgt == "to_out" else getattr(attn, tgt)


def init_lora_params(generator: Optional[torch.Generator], model: nn.Module, *,
                     rank: int = 256, dtype=torch.float32) -> LoraParams:
    """A fresh adapter for `model`'s blocks: A uniform in +-1 / sqrt(d_in),
    B zero (the product starts at zero). Works on a quantized model too."""
    blocks = model.transformer_blocks
    out: LoraParams = {}
    for tgt in LORA_TARGETS:
        lin = _target(blocks[0], tgt)
        d_in, d_out = lin.in_features, lin.out_features
        dev = next(lin.buffers(), None)
        dev = dev.device if dev is not None else lin.weight.device
        bound = d_in ** -0.5
        a = torch.rand((len(blocks), d_in, rank), generator=generator, device=dev,
                       dtype=torch.float32) * (2 * bound) - bound
        out[tgt] = {"lora_A": a.to(dtype),
                    "lora_B": torch.zeros((len(blocks), rank, d_out), dtype=dtype, device=dev)}
    return out


@torch.no_grad()
def merge_lora(model: nn.Module, lora_params: LoraParams, *, alpha: float, rank: int,
               scale: float = 1.0) -> nn.Module:
    """Fold W <- W + scale * (alpha / rank) * A B into `model`'s attention
    weights, in place and one layer at a time; returns the model."""
    factor = scale * alpha / rank
    for tgt, ab in lora_params.items():
        for i, block in enumerate(model.transformer_blocks):
            w = _target(block, tgt).weight   # [out, in]
            delta = (ab["lora_A"][i].to(w.device).float()
                     @ ab["lora_B"][i].to(w.device).float()) * factor
            w.add_(delta.t().to(w.dtype))
    return model


def attach_lora(model: nn.Module, lora_params: LoraParams, *, alpha: float, rank: int,
                scale: float = 1.0, trainable: bool = False) -> nn.Module:
    """Hang the adapter on `model`'s target linears (plain or int8), in place;
    returns the model. Attach after `quantize_transformer_int8`, which
    rebuilds the linears. trainable=True attaches per-layer views of the
    stacked tensors that stay in their autograd graph (the LoRA train step:
    gradients reach `lora_params` through the linears' delta); otherwise the
    adapter is detached (serving)."""
    factor = scale * alpha / rank
    for tgt, ab in lora_params.items():
        for i, block in enumerate(model.transformer_blocks):
            lin = _target(block, tgt)
            dev = next(lin.buffers(), None)
            dev = dev.device if dev is not None else lin.weight.device
            for name, value in (("lora_A", ab["lora_A"][i]), ("lora_B", ab["lora_B"][i]),
                                ("lora_scale", torch.tensor(factor, dtype=torch.float32))):
                if name in lin._buffers:
                    delattr(lin, name)
                value = value if trainable and name != "lora_scale" else value.detach()
                lin.register_buffer(name, value.to(dev), persistent=False)
    return model


# -- peft / diffusers checkpoint interop ---------------------------------------------

_PEFT_RE = re.compile(
    r"transformer\.transformer_blocks\.(\d+)\.attn1\.(to_q|to_k|to_v|to_out)(?:\.0)?"
    r"\.lora_([AB])\.weight")


def convert_peft_lora_state_dict(sd: Dict[str, object], num_layers: int, rank: int
                                 ) -> LoraParams:
    """diffusers `save_lora_weights` format -> the stacked adapter.
    lora_A.weight [r, d_in] -> A [d_in, r]; lora_B.weight [d_out, r] -> B [r, d_out]."""
    found = {}
    for k, v in sd.items():
        m = _PEFT_RE.match(k)
        if m:
            found[(m.group(2), m.group(3), int(m.group(1)))] = (
                v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
    out: LoraParams = {}
    for tgt in LORA_TARGETS:
        a_list, b_list = [], []
        for layer in range(num_layers):
            a, b = found.get((tgt, "A", layer)), found.get((tgt, "B", layer))
            if a is None or b is None:
                raise KeyError(f"missing LoRA weights for layer {layer} target {tgt}")
            if a.shape[0] != rank or b.shape[1] != rank:
                raise ValueError(f"layer {layer} target {tgt}: rank {a.shape[0]}, "
                                 f"expected {rank}")
            a_list.append(a.t())
            b_list.append(b.t())
        out[tgt] = {"lora_A": torch.stack(a_list), "lora_B": torch.stack(b_list)}
    return out


def export_peft_lora_state_dict(lora_params: LoraParams) -> Dict[str, np.ndarray]:
    """The stacked adapter -> diffusers `save_lora_weights` names (numpy)."""
    sd = {}
    for tgt, ab in lora_params.items():
        a = ab["lora_A"].detach().float().cpu().numpy()
        b = ab["lora_B"].detach().float().cpu().numpy()
        suffix = ".0" if tgt == "to_out" else ""
        for layer in range(a.shape[0]):
            base = f"transformer.transformer_blocks.{layer}.attn1.{tgt}{suffix}"
            sd[f"{base}.lora_A.weight"] = np.ascontiguousarray(a[layer].T)
            sd[f"{base}.lora_B.weight"] = np.ascontiguousarray(b[layer].T)
    return sd
