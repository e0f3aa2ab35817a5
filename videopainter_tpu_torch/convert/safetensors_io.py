"""diffusers checkpoint directories: their safetensors files, read and written.

The port's modules carry the diffusers parameter names, so a checkpoint
directory (`transformer/`, `vae/`, a branch, a LoRA) loads with
`load_state_dict(load_safetensors_dir(path))`: no converter in between. A
directory holds one `<prefix>.safetensors`, or shards
`<prefix>-0000i-of-0000n.safetensors` listed by
`<prefix>.safetensors.index.json` (how CogVideoX-5b-I2V's transformer
ships). `safetensors` is imported only inside the functions that use it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

StateDict = Dict[str, torch.Tensor]


def save_safetensors_dir(tensors: StateDict, out_dir: str, *,
                         prefix: str = "diffusion_pytorch_model",
                         max_shard_bytes: Optional[int] = None,
                         config: Optional[dict] = None) -> int:
    """A diffusers checkpoint directory: `tensors` (any device and dtype) in
    one file, or in shards of at most `max_shard_bytes` (a larger tensor gets
    a shard of its own) with their index; `config` as config.json. Returns
    the bytes of the weight files."""
    from safetensors.torch import save_file

    os.makedirs(out_dir, exist_ok=True)
    shards, size = [{}], 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if max_shard_bytes and shards[-1] and size + nbytes > max_shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t.detach().contiguous().cpu()
        size += nbytes
    names = ([f"{prefix}.safetensors"] if len(shards) == 1 else
             [f"{prefix}-{i + 1:05d}-of-{len(shards):05d}.safetensors"
              for i in range(len(shards))])
    for fname, shard in zip(names, shards):
        save_file(shard, os.path.join(out_dir, fname))
    if len(shards) > 1:
        with open(os.path.join(out_dir, f"{prefix}.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": sum(t.numel() * t.element_size()
                                                      for t in tensors.values())},
                       "weight_map": {k: fname for fname, shard in zip(names, shards)
                                      for k in shard}}, f, indent=2)
    if config is not None:
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=2)
    return sum(os.path.getsize(os.path.join(out_dir, fname)) for fname in names)


def load_safetensors_dir(path: str) -> StateDict:
    """One state dict (CPU tensors) from a checkpoint directory: the shards
    its `*.safetensors.index.json` lists, or else every `*.safetensors` in it."""
    from safetensors.torch import load_file

    names = os.listdir(path)
    index = sorted(f for f in names if f.endswith(".safetensors.index.json"))
    if index:
        with open(os.path.join(path, index[0])) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(f for f in names if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    state: StateDict = {}
    for fname in files:
        part = load_file(os.path.join(path, fname))
        dup = state.keys() & part.keys()
        if dup:
            raise ValueError(f"{path}: tensors in more than one file: {sorted(dup)[:5]}")
        state.update(part)
    return state
