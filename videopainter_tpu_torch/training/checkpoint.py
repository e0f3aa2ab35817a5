"""Checkpoint save / rotate / resume + HF-format export.

Counterpart of `videopainter_tpu/training/checkpoint.py`. Reference
behaviours: save every `checkpointing_steps` with `checkpoints_total_limit`
rotation; `--resume_from_checkpoint latest` scans checkpoint-* dirs; the
branch is exported as an HF save_pretrained-style dir, the adapter as
pytorch_lora_weights.safetensors.

The train state (trainable tensors, optimizer state, step) is one
`torch.save` file per checkpoint directory. The exports write the same
diffusers / peft names as the JAX package: the port's modules already carry
those names, so an export is a state-dict dump through
`convert.save_safetensors_dir`, which also reads them back
(`convert.load_safetensors_dir`).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from ..convert.safetensors_io import save_safetensors_dir

STATE_FILE = "train_state.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(output_dir: str, step: int, state, *,
                    total_limit: Optional[int] = None) -> str:
    """Write `state` ({"step", "trainable", "opt_state"}: nested dicts / lists
    of tensors and numbers) to <output_dir>/checkpoint-<step>/."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if total_limit is not None:
        rotate_checkpoints(output_dir, total_limit)
    return path


def _checkpoints(output_dir: str):
    return sorted((d for d in os.listdir(output_dir) if re.fullmatch(r"checkpoint-\d+", d)),
                  key=lambda d: int(d.split("-")[1]))


def rotate_checkpoints(output_dir: str, total_limit: int) -> None:
    """Delete the oldest checkpoint-* dirs beyond the limit."""
    ckpts = _checkpoints(output_dir)
    for d in ckpts[: max(0, len(ckpts) - total_limit)]:
        shutil.rmtree(os.path.join(output_dir, d))


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest checkpoint-* dir, or None."""
    if not os.path.isdir(output_dir):
        return None
    ckpts = _checkpoints(output_dir)
    return os.path.join(output_dir, ckpts[-1]) if ckpts else None


def restore_checkpoint(path: str, target=None):
    """Read a checkpoint. With `target` (a state of the same structure) the
    restored tensors are copied into the target's tensors in place (the
    optimizer and the modules keep their objects) and the target is returned
    with the restored numbers."""
    restored = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                          map_location="cpu", weights_only=True)
    return restored if target is None else _copy_into(target, restored)


def _copy_into(target, source):
    if isinstance(target, dict):
        if set(target) != set(source):
            raise KeyError(f"checkpoint keys {sorted(source)} do not match {sorted(target)}")
        return {k: _copy_into(target[k], source[k]) for k in target}
    if isinstance(target, (list, tuple)):
        if len(target) != len(source):
            raise ValueError(f"checkpoint holds {len(source)} tensors, expected {len(target)}")
        return [_copy_into(t, s) for t, s in zip(target, source)]
    if torch.is_tensor(target):
        with torch.no_grad():
            target.copy_(source)
        return target
    return source


# -- HF-format interop (safetensors; the loader lives in convert/) --------------------

def _export(model_or_sd, config_dict: dict, out_dir: str, class_name: str, *,
            dtype: torch.dtype = torch.float32, max_shard_bytes: Optional[int] = None) -> int:
    """config.json + diffusion_pytorch_model.safetensors (sharded past
    `max_shard_bytes`) in `dtype`; returns the bytes of the weight files."""
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else model_or_sd
    return save_safetensors_dir({k: v.to(dtype) for k, v in sd.items()}, out_dir,
                                max_shard_bytes=max_shard_bytes,
                                config=dict(config_dict, _class_name=class_name))


def export_branch_pretrained(branch, config_dict: dict, out_dir: str, **kw) -> int:
    """HF save_pretrained-style export of the branch (module or state dict),
    in float32 unless `dtype=` says otherwise."""
    return _export(branch, config_dict, out_dir, "CogvideoXBranchModel", **kw)


def export_transformer_pretrained(transformer, config_dict: dict, out_dir: str, **kw) -> int:
    return _export(transformer, config_dict, out_dir, "CogVideoXTransformer3DModel", **kw)


def export_vae_pretrained(vae, config_dict: dict, out_dir: str, **kw) -> int:
    return _export(vae, config_dict, out_dir, "AutoencoderKLCogVideoX", **kw)


def export_lora_weights(lora_params: dict, out_dir: str) -> int:
    """diffusers-compatible pytorch_lora_weights.safetensors (float32)."""
    from ..models.lora import export_peft_lora_state_dict

    sd = export_peft_lora_state_dict(lora_params)
    return save_safetensors_dir({k: torch.from_numpy(v) for k, v in sd.items()}, out_dir,
                                prefix="pytorch_lora_weights")
