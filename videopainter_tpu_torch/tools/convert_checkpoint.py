"""Validate and copy the reference's checkpoints into the layout the port loads.

Counterpart of the JAX package's `tools/convert_checkpoint.py`:

    python -m videopainter_tpu_torch.tools.convert_checkpoint \\
        --src /path/to/CogVideoX-5b-I2V --dst ckpts/cogvideox-5b-i2v \\
        [--branch /path/to/VideoPainter/checkpoints/branch --branch_dst ckpts/branch] \\
        [--sam2 sam2_hiera_large.pt --sam2_dst ckpts/sam2.pt] \\
        [--device cpu]

The port's modules carry the diffusers and torch SAM2 parameter names, so
nothing is converted: the model directories keep the HF layout (config.json
and safetensors, sharded or not) that `infer.inpaint.build_pipeline` reads
through `convert/safetensors_io.py`. Each directory's files (.safetensors,
.json, .model, .txt) are copied, then `transformer/`, `vae/` and the branch
are validated as `build_pipeline` loads them: their config.json parsed into
the port's config, the module built from it on the meta device and moved to
`--device` (the card unless `--device cpu`), the safetensors loaded into it
strictly (every name present, every shape right, nothing left over).
`text_encoder/` is checked to load as safetensors; the tokenizer and
scheduler files are copied as they are.

A SAM2 `.pt` becomes a `.pt` of its bare state dict (the `"model"` entry
unwrapped), which `segmentation.build_sam2_video_predictor(variant,
checkpoint_path)` loads with `load_state_dict` (`segmentation/convert.py`).
It is first loaded strictly into the predictor of its variant (tiny, small,
base_plus or large, told apart by the trunk's block count) on `--device`. The JAX tool writes an .npz of JAX parameter trees instead;
the port reads that too (`segmentation.convert.load_sam2_npz`). Without a
card and without `--device cpu` the tool raises.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
from typing import Dict, Optional

import torch

from .. import resolve_device

MODEL_SUBDIRS = ("transformer", "vae", "text_encoder", "tokenizer", "scheduler")
COPIED = (".safetensors", ".json", ".model", ".txt")


def _copy_files(src: str, dst: str, suffixes=COPIED) -> int:
    os.makedirs(dst, exist_ok=True)
    n = 0
    for f in sorted(os.listdir(src)):
        if f.endswith(suffixes):
            shutil.copy2(os.path.join(src, f), os.path.join(dst, f))
            n += 1
    return n


def _load_strict(model: torch.nn.Module, sd, device) -> None:
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    del model


def validate_model_dir(path: str, kind: str, device) -> int:
    """Load `path` strictly into the module `build_pipeline` builds for
    `kind` (transformer, vae, branch), on `device`; returns the tensor
    count. Raises on a missing, unexpected or misshapen tensor."""
    from ..config import BranchConfig, TransformerConfig, VAEConfig, load_config
    from ..convert import load_safetensors_dir
    from ..models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D

    sd = load_safetensors_dir(path)
    cfg_path = os.path.join(path, "config.json")
    with torch.device("meta"):
        if kind == "transformer":
            model = CogVideoXTransformer3D(load_config(cfg_path, TransformerConfig),
                                           patch_in_channels=sd["patch_embed.proj.weight"]
                                           .shape[1])
        elif kind == "vae":
            model = AutoencoderKLCogVideoX(load_config(cfg_path, VAEConfig))
        elif kind == "branch":
            model = CogVideoXBranch(load_config(cfg_path, BranchConfig))
        else:
            raise ValueError(f"no module for {kind!r}")
    _load_strict(model, sd, device)
    return len(sd)


def convert_model_dir(src: str, dst: str, sub: str, device) -> Optional[int]:
    """Copy src/sub to dst/sub and validate it; None when src/sub is absent."""
    s, d = os.path.join(src, sub), os.path.join(dst, sub)
    if not os.path.isdir(s):
        print(f"[skip] {s} missing")
        return None
    _copy_files(s, d)
    if sub in ("transformer", "vae"):
        n = validate_model_dir(d, sub, device)
    elif sub == "text_encoder":
        from ..convert import load_safetensors_dir
        n = len(load_safetensors_dir(d))
    else:
        n = len(os.listdir(d))
        print(f"[ok] {sub}: {n} files")
        return n
    print(f"[ok] {sub}: {n} tensors")
    return n


def convert_branch(src: str, dst: str, device) -> int:
    _copy_files(src, dst, (".safetensors", ".json"))
    n = validate_model_dir(dst, "branch", device)
    print(f"[ok] branch: {n} tensors -> {dst}")
    return n


SAM2_VARIANTS = ("tiny", "small", "base_plus", "large")


def sam2_variant(sd) -> str:
    """The published variant whose Hiera trunk has `sd`'s block count."""
    from ..segmentation.hiera import hiera_config

    blocks = {int(m.group(1)) for k in sd
              for m in [re.match(r"image_encoder\.trunk\.blocks\.(\d+)\.", k)] if m}
    for v in SAM2_VARIANTS:
        if hiera_config(v).depth == len(blocks):
            return v
    raise ValueError(f"no SAM2 variant has a {len(blocks)}-block trunk")


def convert_sam2(src: str, dst: str, device) -> Dict[str, object]:
    """A SAM2 .pt (or the JAX package's .npz) -> `dst`, a .pt of the bare
    state dict, after a strict load into its variant's predictor on `device`."""
    from ..segmentation import SAM2Config, SAM2VideoPredictor
    from ..segmentation.convert import load_sam2_checkpoint
    from ..segmentation.hiera import hiera_config

    sd = load_sam2_checkpoint(src)
    variant = sam2_variant(sd)
    with torch.device("meta"):
        model = SAM2VideoPredictor(SAM2Config(hiera=hiera_config(variant)))
    _load_strict(model, sd, device)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    torch.save(sd, dst)
    print(f"[ok] sam2 ({variant}): {len(sd)} tensors -> {dst}")
    return {"tensors": len(sd), "variant": variant}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", help="CogVideoX / VideoPainter HF model directory")
    ap.add_argument("--dst", help="output directory")
    ap.add_argument("--branch", help="branch checkpoint directory")
    ap.add_argument("--branch_dst")
    ap.add_argument("--sam2", help="SAM2 .pt checkpoint")
    ap.add_argument("--sam2_dst", default="ckpts/sam2.pt")
    ap.add_argument("--device", default="cuda",
                    help="where the checkpoints are loaded to be validated")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.src:
        if not args.dst:
            ap.error("--src needs --dst")
        for sub in MODEL_SUBDIRS:
            convert_model_dir(args.src, args.dst, sub, device)
    if args.branch:
        if not args.branch_dst:
            ap.error("--branch needs --branch_dst")
        convert_branch(args.branch, args.branch_dst, device)
    if args.sam2:
        convert_sam2(args.sam2, args.sam2_dst, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
