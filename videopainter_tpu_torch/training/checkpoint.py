"""Checkpoint save / rotate / resume + HF-format export.

Counterpart of `videopainter_tpu/training/checkpoint.py`. Reference
behaviours: save every `checkpointing_steps` with `checkpoints_total_limit`
rotation; `--resume_from_checkpoint latest` scans checkpoint-* dirs; the
branch is exported as an HF save_pretrained-style dir, the adapter as
pytorch_lora_weights.safetensors.

The train state (trainable tensors, optimizer state, step) is one
`torch.save` file per checkpoint directory. The exports write the same
diffusers / peft names as the JAX package: the port's modules already carry
those names, so an export is a state-dict dump. `safetensors` is imported
only inside the functions that read or write it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

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


# -- HF-format interop (safetensors) -------------------------------------------------

def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """All *.safetensors of an HF model dir as one state dict."""
    from safetensors import safe_open

    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    state = {}
    for fname in files:
        with safe_open(os.path.join(path, fname), framework="pt") as f:
            for k in f.keys():
                state[k] = f.get_tensor(k)
    return state


def _export(sd: Dict[str, torch.Tensor], config_dict: dict, out_dir: str,
            class_name: str) -> None:
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    save_file({k: np.ascontiguousarray(v.detach().float().cpu().numpy()) for k, v in sd.items()},
              os.path.join(out_dir, "diffusion_pytorch_model.safetensors"))
    cfg = dict(config_dict)
    cfg["_class_name"] = class_name
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def _state_dict(model_or_sd) -> Dict[str, torch.Tensor]:
    return model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") else dict(model_or_sd)


def export_branch_pretrained(branch, config_dict: dict, out_dir: str) -> None:
    """HF save_pretrained-style export of the branch (module or state dict):
    config.json + diffusion_pytorch_model.safetensors in float32."""
    _export(_state_dict(branch), config_dict, out_dir, "CogvideoXBranchModel")


def export_transformer_pretrained(transformer, config_dict: dict, out_dir: str) -> None:
    _export(_state_dict(transformer), config_dict, out_dir, "CogVideoXTransformer3DModel")


def export_vae_pretrained(vae, config_dict: dict, out_dir: str) -> None:
    _export(_state_dict(vae), config_dict, out_dir, "AutoencoderKLCogVideoX")


def export_lora_weights(lora_params: dict, out_dir: str) -> None:
    """diffusers-compatible pytorch_lora_weights.safetensors."""
    from safetensors.numpy import save_file

    from ..models.lora import export_peft_lora_state_dict

    os.makedirs(out_dir, exist_ok=True)
    sd = export_peft_lora_state_dict(lora_params)
    save_file({k: np.asarray(v, dtype=np.float32) for k, v in sd.items()},
              os.path.join(out_dir, "pytorch_lora_weights.safetensors"))
