"""JAX parameter pytree -> the port's diffusers-named state dicts.

The inverse of `videopainter_tpu/convert/torch_to_flax.py` (read, not
imported): it takes the JAX package's parameter trees as numpy arrays
(`jax.tree.map(np.asarray, params)`) and returns torch state dicts for
`CogVideoXTransformer3D`, `CogVideoXBranch` and `AutoencoderKLCogVideoX`, so
both packages compute with the same weights.

 - Linear:   kernel [in, out]               -> weight [out, in]
 - patchify: kernel [(p p I), O]            -> Conv2d weight [O, I, p, p]
 - Conv3d:   kernel DHWIO [kt, kh, kw, I, O] -> [O, I, kt, kh, kw]
 - Conv2d:   kernel HWIO                    -> [O, I, kh, kw]
 - LayerNorm/GroupNorm: scale -> weight, bias -> bias
 - stacked blocks [L, ...]                  -> transformer_blocks.{i}.*
 - int8 linear: kernel_q [in, out] int8     -> weight_q [out, in]; kscale, ascale kept
   (`load_quantized`: a quantized tree has other modules than a plain one)
 - LoRA tree (lora_A, lora_B [L, ...])      -> tensors (`lora_params`)
 - captured cross-window state (array, compressed, or the int8 dict) -> tensors
   (`captured_state`)

Training state crosses the same way (a branch tree through
`branch_state_dict` into the branch module, a LoRA tree through
`lora_params`); `to_jax_layout` goes back: the port's parameters, gradients
or updated weights, named as in a state dict, into the JAX tree's layout, so
a test can compare them leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _linear(sd: StateDict, prefix: str, p: dict) -> None:
    if "kernel_q" in p:
        sd[f"{prefix}.weight_q"] = _t(np.asarray(p["kernel_q"]).T)
        sd[f"{prefix}.kscale"] = _t(p["kscale"])
        if p.get("ascale") is not None:
            sd[f"{prefix}.ascale"] = _t(np.asarray(p["ascale"], np.float32))
    else:
        sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Optional[dict]) -> None:
    if p is None:
        return
    sd[f"{prefix}.weight"] = _t(p["scale"])
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _block(sd: StateDict, prefix: str, bp: dict) -> None:
    for n in ("norm1", "norm2"):
        _linear(sd, f"{prefix}.{n}.linear", bp[n]["linear"])
        _norm(sd, f"{prefix}.{n}.norm", bp[n].get("norm"))
    a = bp["attn1"]
    for n in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.attn1.{n}", a[n])
    _linear(sd, f"{prefix}.attn1.to_out.0", a["to_out"])
    for n in ("norm_q", "norm_k"):
        _norm(sd, f"{prefix}.attn1.{n}", a.get(n))
    _linear(sd, f"{prefix}.ff.net.0.proj", bp["ff"]["proj_in"])
    _linear(sd, f"{prefix}.ff.net.2", bp["ff"]["proj_out"])


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)[i]


def transformer_state_dict(params: dict, *, patch_size: int = 2) -> StateDict:
    """JAX CogVideoXTransformer3D params -> CogVideoXTransformer3D state dict."""
    sd: StateDict = {}
    pe = params["patch_embed"]
    k = np.asarray(pe["proj"]["kernel"])  # [(p p I), O]
    out_dim = k.shape[1]
    c_in = k.shape[0] // (patch_size * patch_size)
    sd["patch_embed.proj.weight"] = _t(
        k.reshape(patch_size, patch_size, c_in, out_dim).transpose(3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = _t(pe["proj"]["bias"])
    _linear(sd, "patch_embed.text_proj", pe["text_proj"])
    if pe.get("pos_embedding") is not None:
        sd["patch_embed.pos_embedding"] = _t(pe["pos_embedding"])
    _linear(sd, "time_embedding.linear_1", params["time_embedding"]["linear_1"])
    _linear(sd, "time_embedding.linear_2", params["time_embedding"]["linear_2"])
    to_q = params["blocks"]["attn1"]["to_q"]
    n = np.asarray(to_q["kernel_q"] if "kernel_q" in to_q else to_q["kernel"]).shape[0]
    for i in range(n):
        _block(sd, f"transformer_blocks.{i}", _layer(params["blocks"], i))
    _norm(sd, "norm_final", params.get("norm_final"))
    _linear(sd, "norm_out.linear", params["norm_out"]["linear"])
    _norm(sd, "norm_out.norm", params["norm_out"].get("norm"))
    _linear(sd, "proj_out", params["proj_out"])
    return sd


def branch_state_dict(params: dict, *, patch_size: int = 2) -> StateDict:
    """JAX CogVideoXBranch params -> CogVideoXBranch state dict."""
    sd = transformer_state_dict(params, patch_size=patch_size)
    bb = params["branch_blocks"]
    for i in range(np.asarray(bb["kernel"]).shape[0]):
        sd[f"branch_blocks.{i}.weight"] = _t(np.asarray(bb["kernel"])[i].T)
        sd[f"branch_blocks.{i}.bias"] = _t(np.asarray(bb["bias"])[i])
    if params.get("branch_x_embedder") is not None:
        _linear(sd, "branch_x_embedder", params["branch_x_embedder"])
    return sd


def load_quantized(model, sd: StateDict):
    """Load a state dict converted from an int8-quantized JAX tree into a
    plain `model` (in place; returns it): every linear that the state dict
    holds as `weight_q` / `kscale` (/ `ascale`) becomes an `Int8Linear` with
    exactly those values, so both packages compute with the same quantized
    weights; the rest loads as usual."""
    from ..ops.basic import Int8Linear

    sd = dict(sd)
    int8_keys = []
    for key in [k for k in sd if k.endswith(".weight_q")]:
        path = key[:-len(".weight_q")]
        parent, _, name = path.rpartition(".")
        lin = Int8Linear(sd.pop(key), sd.pop(f"{path}.kscale"), sd.pop(f"{path}.bias", None),
                         sd.pop(f"{path}.ascale", None))
        setattr(model.get_submodule(parent), name, lin)
        int8_keys += [f"{path}.{k}" for k in lin.state_dict()]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = sorted(set(missing) - set(int8_keys))
    if missing or unexpected:
        raise KeyError(f"load_quantized: missing {missing}, unexpected {list(unexpected)}")
    return model


def lora_params(tree: dict) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX LoRA tree {target: {"lora_A": [L, d_in, r], "lora_B": [L, r, d_out]}}
    -> the same tree as tensors (the port keeps the stacked layout)."""
    return {tgt: {k: _t(v) for k, v in ab.items() if k in ("lora_A", "lora_B")}
            for tgt, ab in tree.items()}


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def to_jax_layout(named: Dict[str, torch.Tensor], like: dict) -> dict:
    """The inverse of `branch_state_dict` on values:
    `named` holds tensors under the port's state-dict names (parameters,
    gradients, updated weights); the result is a numpy tree with the layout of
    the JAX tree `like`. The conversions only permute elements, so the inverse
    is read off by converting a tree of element indices."""
    offset = 0

    def index(x):
        nonlocal offset
        x = np.asarray(x)
        idx = np.arange(offset, offset + x.size, dtype=np.int64).reshape(x.shape)
        offset += x.size
        return idx

    index_tree = _map_leaves(like, index)
    flat = np.zeros(offset, dtype=np.float64)
    seen = np.zeros(offset, dtype=bool)
    for name, idx in branch_state_dict(index_tree).items():
        if name not in named:
            raise KeyError(f"to_jax_layout: no tensor named {name!r}")
        pos = idx.numpy().ravel()
        flat[pos] = named[name].detach().to(torch.float64).cpu().numpy().ravel()
        seen[pos] = True
    if not seen.all():
        raise ValueError(f"to_jax_layout: {int((~seen).sum())} elements of the tree have no "
                         "counterpart in the state dict")
    return _map_leaves(index_tree, lambda idx: flat[idx].astype(np.float32))


def captured_state(hs):
    """Captured per-layer states of the JAX DiT -> tensors: the full or the
    compressed array, or the int8 dict {"values", "scales"}."""
    if isinstance(hs, dict):
        return {k: _t(v) for k, v in hs.items()}
    return _t(hs)


def _conv3d(sd: StateDict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv2d(sd: StateDict, prefix: str, p: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _spatial_norm(sd: StateDict, prefix: str, p: dict) -> None:
    _norm(sd, f"{prefix}.norm_layer", p["norm_layer"])
    _conv3d(sd, f"{prefix}.conv_y.conv", p["conv_y"]["conv"])
    _conv3d(sd, f"{prefix}.conv_b.conv", p["conv_b"]["conv"])


def _resnet(sd: StateDict, prefix: str, p: dict) -> None:
    for n in ("norm1", "norm2"):
        if "norm_layer" in p[n]:
            _spatial_norm(sd, f"{prefix}.{n}", p[n])
        else:
            _norm(sd, f"{prefix}.{n}", p[n])
    _conv3d(sd, f"{prefix}.conv1.conv", p["conv1"]["conv"])
    _conv3d(sd, f"{prefix}.conv2.conv", p["conv2"]["conv"])
    if "conv_shortcut" in p:
        sc = p["conv_shortcut"]
        if "conv" in sc:
            raise NotImplementedError("causal 3x3x3 conv_shortcut is not used by CogVideoX")
        _conv3d(sd, f"{prefix}.conv_shortcut", sc)


def vae_state_dict(params: dict) -> StateDict:
    """JAX AutoencoderKLCogVideoX params -> AutoencoderKLCogVideoX state dict."""
    sd: StateDict = {}
    enc, dec = params["encoder"], params["decoder"]
    _conv3d(sd, "encoder.conv_in.conv", enc["conv_in"]["conv"])
    for i, blk in enumerate(enc["down_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", rp)
        if "downsampler" in blk:
            _conv2d(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", blk["downsampler"]["conv"])
    for j, rp in enumerate(enc["mid_block"]["resnets"]):
        _resnet(sd, f"encoder.mid_block.resnets.{j}", rp)
    _norm(sd, "encoder.norm_out", enc["norm_out"])
    _conv3d(sd, "encoder.conv_out.conv", enc["conv_out"]["conv"])

    _conv3d(sd, "decoder.conv_in.conv", dec["conv_in"]["conv"])
    for j, rp in enumerate(dec["mid_block"]["resnets"]):
        _resnet(sd, f"decoder.mid_block.resnets.{j}", rp)
    for i, blk in enumerate(dec["up_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", rp)
        if "upsampler" in blk:
            _conv2d(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", blk["upsampler"]["conv"])
    _spatial_norm(sd, "decoder.norm_out", dec["norm_out"])
    _conv3d(sd, "decoder.conv_out.conv", dec["conv_out"]["conv"])
    return sd
