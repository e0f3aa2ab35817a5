"""Inference CLI: CSV-row-driven any-length video inpainting.

Counterpart of `videopainter_tpu/infer/inpaint.py` (the reference's
infer/inpaint.py generate_video): reads a CSV metadata row and its
all_masks.npz, builds the any-length pipeline from diffusers checkpoints
(with the ID-resample LoRA merged when one is given), runs it with
stride = num_frames - overlap, and writes a side-by-side comparison video.

    python -m videopainter_tpu_torch.infer.inpaint \\
        --model_path /path/to/cogvideox-5b-i2v \\
        --inpainting_branch /path/to/branch \\
        [--id_adapter /path/to/lora] \\
        --meta_file_path meta.csv --video_id 0 --output_path out/ [--device cpu]

A model directory holds diffusers checkpoints: `transformer/` and `vae/`
(config.json and safetensors, sharded or not), and optionally
`text_encoder/` with its tokenizer (else pass --prompt_embeds). It runs on
the card unless `--device cpu` is given.

The file I/O stays apart from the compute: `read_video_with_mask` (cv2 and
the csv module) -> `run_inpaint` (arrays in, frames out) ->
`export_side_by_side` (cv2). The reference's FluxFill first-frame step and
its GPT-4o captioning are external models; `first_frame_inpaint_fn` and
`caption_fn` are their hooks, and `--first_frame_inpaint self` pre-inpaints
frame 0 with the port's own pipeline at T=1 (`infer/first_frame.py`).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _load(model, sd):
    """A module made on the meta device and moved to its device with
    `to_empty`, filled from the state dict `sd` (cast to the module's dtype)."""
    if hasattr(model, "init_pos_embedding_"):
        model.init_pos_embedding_()   # a table no state dict holds unless learned
    model.load_state_dict(sd)
    return model.eval()


def build_pipeline(model_path: str, inpainting_branch: Optional[str],
                   id_adapter: Optional[str] = None, dtype_str: str = "bfloat16",
                   long_video: bool = False, device=None):
    """The any-length pipeline from diffusers checkpoints, in `dtype_str` on
    `device` (CUDA unless given). With no branch, the backbone-only SFT
    any-length pipeline (the reference's eval_inpainting_wo_branch.py:147)."""
    from ..config import (BranchConfig, SchedulerConfig, TransformerConfig, VAEConfig,
                          load_config, refuse_3d_patches)
    from ..convert import load_safetensors_dir as load_dir
    from ..models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D
    from ..models.lora import LORA_ALPHA, LORA_RANK, convert_peft_lora_state_dict, merge_lora
    from ..models.text_encoder import T5TextEncoder
    from ..pipelines import CogVideoXI2VDualInpaintAnyLPipeline, CogVideoXI2VInpaintAnyLPipeline
    from ..schedulers import CogVideoXDPMScheduler

    dev = resolve_device(device)
    dtype = DTYPES[dtype_str]
    tcfg = load_config(os.path.join(model_path, "transformer", "config.json"), TransformerConfig)
    # the CLI runs the any-length pipeline: refuse a 1.5 model before any weight loads
    refuse_3d_patches(tcfg, "the inference CLI (the any-length pipeline)")
    if id_adapter:
        tcfg = TransformerConfig.from_dict({**tcfg.to_dict(), "id_pool_resample_learnable": True})
    vcfg = load_config(os.path.join(model_path, "vae", "config.json"), VAEConfig)

    def meta(ctor):
        return ctor(device="meta", dtype=dtype).to_empty(device=dev)

    t_sd = load_dir(os.path.join(model_path, "transformer"))
    # the patch-in width comes from the checkpoint: an SFT inpainting backbone
    # carries a widened patch embed (2 C + 1 channels)
    patch_in = t_sd["patch_embed.proj.weight"].shape[1]
    transformer = _load(meta(lambda **kw: CogVideoXTransformer3D(
        tcfg, patch_in_channels=patch_in, **kw)), t_sd)
    del t_sd
    vae = _load(meta(lambda **kw: AutoencoderKLCogVideoX(vcfg, **kw)),
                load_dir(os.path.join(model_path, "vae")))
    branch = None
    if inpainting_branch:
        bcfg = load_config(os.path.join(inpainting_branch, "config.json"), BranchConfig)
        branch = _load(meta(lambda **kw: CogVideoXBranch(bcfg, **kw)),
                       load_dir(inpainting_branch))
    if id_adapter:
        lora = convert_peft_lora_state_dict(load_dir(id_adapter), tcfg.num_layers,
                                            rank=LORA_RANK)
        lora = {t: {k: v.to(dtype) for k, v in ab.items()} for t, ab in lora.items()}
        merge_lora(transformer, lora, alpha=LORA_ALPHA, rank=LORA_RANK)
    if long_video:
        vae.enable_slicing()
        vae.enable_tiling()
    sched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())

    text_encoder = None
    te_path = os.path.join(model_path, "text_encoder")
    if os.path.isdir(te_path):
        try:
            text_encoder = T5TextEncoder.from_local(te_path, device=dev)
        except (ImportError, OSError, ValueError) as e:   # the CLI still runs from --prompt_embeds
            print(f"[warn] text encoder unavailable ({e}); pass --prompt_embeds")
    if branch is not None:
        return CogVideoXI2VDualInpaintAnyLPipeline(transformer, branch, vae, sched,
                                                   text_encoder, device=dev)
    return CogVideoXI2VInpaintAnyLPipeline(transformer, vae, sched, text_encoder, device=dev)


def load_pipeline(args):
    """`build_pipeline` from the CLI's arguments, then its serving options:
    W8A8 block projections (`--int8`, with static activation scales from
    `--int8_scales`) and the VAE's frames per decode batch."""
    pipe = build_pipeline(args.model_path, args.inpainting_branch, args.id_adapter, args.dtype,
                          args.long_video, device=args.device)
    if args.vae_frame_batch:
        pipe.vae.num_latent_frames_batch_size = args.vae_frame_batch
    if args.int8:
        from ..quantize import attach_static_ascale, load_ascales, quantize_transformer_int8

        models = {"transformer": pipe.transformer, "branch": pipe.branch}
        for model in models.values():
            if model is not None:
                quantize_transformer_int8(model, free_source=True)
        if args.int8_scales:
            for name, sites in load_ascales(args.int8_scales).items():
                if models.get(name) is not None:
                    attach_static_ascale(models[name], sites)
    return pipe


def _read_row(meta_file_path: str, video_id: int) -> dict:
    with open(meta_file_path, newline="") as f:
        return list(csv.DictReader(f))[video_id]


def read_video_with_mask(meta_file_path: str, video_id: int, data_root: str,
                         height: int, width: int, fps: int):
    """CSV row -> (video uint8 [T, H, W, 3], masks uint8 [T, H, W], caption);
    the columns of the JAX reader: path, fps, start_frame, end_frame,
    mask_path, mask_id, caption."""
    import cv2

    from ..training.data import read_video_frames, resize_video

    row = _read_row(meta_file_path, video_id)
    path = os.path.join(data_root, str(row["path"])) if data_root else str(row["path"])
    src_fps = float(row.get("fps") or fps)
    stride = max(1, int(round(src_fps / fps)))
    video = read_video_frames(path, int(float(row.get("start_frame") or 0)),
                              int(float(row.get("end_frame") or 0)) or None, stride)
    video = resize_video(video, height, width)
    mask_path = row.get("mask_path") or os.path.join(os.path.dirname(path), "all_masks.npz")
    with np.load(mask_path) as npz:
        key = str(row.get("mask_id") or 0)
        masks = npz[key if key in npz.files else npz.files[0]]
    if masks.ndim == 4:
        masks = masks[..., 0]
    masks = masks[::stride][: len(video)]
    masks = np.stack([cv2.resize((m > 0).astype(np.uint8), (width, height),
                                 interpolation=cv2.INTER_NEAREST) for m in masks])
    return video, masks, str(row.get("caption") or "")


def export_side_by_side(original01, masked01, output01, path, fps=8):
    """Comparison video [original | masked | output] as an mp4."""
    import cv2

    h, w = original01.shape[1:3]
    frames = np.concatenate([original01, masked01, output01], axis=2)
    frames = (frames * 255).clip(0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w * 3, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def clip_windows(args, n_frames: int):
    """(frames per window, stride, usable frames) of a clip of n_frames."""
    num_frames = min(args.num_frames, (n_frames - 1) // 4 * 4 + 1)
    stride = num_frames - args.overlap_frames
    return num_frames, stride, num_frames + max(0, (n_frames - num_frames) // stride) * stride


def run_inpaint(pipe, args, video_u8: np.ndarray, masks: np.ndarray, caption: str,
                first_frame_inpaint_fn: Optional[Callable] = None,
                caption_fn: Optional[Callable] = None):
    """The CLI's compute on arrays: video uint8 [T, H, W, 3], masks [T, H, W]
    (nonzero = hole), the caption. Returns (output frames [T', H, W, 3] in
    [0, 1], the input frames in [0, 1] and the masks it used), T' the frames
    the windows cover."""
    from ..models.text_encoder import load_prompt_embeds
    from ..pipelines import parse_skip_steps
    from ..utils.profiling import maybe_profile

    dev = pipe.device
    dtype = DTYPES[args.dtype]
    num_frames, stride, usable = clip_windows(args, len(video_u8))
    video_u8, masks = video_u8[:usable], masks[:usable]
    if caption_fn is not None:
        caption = caption_fn(video_u8, masks, caption)
    prompt = args.prompt or caption

    video01 = video_u8.astype(np.float32) / 255.0
    masks_f = masks.astype(np.float32)
    if args.first_frame_gt:
        masks_f[0] = 0.0
    first = video01[0] * (1 - masks_f[0][..., None])
    embeds = load_prompt_embeds(args.prompt_embeds) if args.prompt_embeds else None
    if first_frame_inpaint_fn is None and args.first_frame_inpaint == "self":
        # the port's own image-mode inpaint at T=1 stands in for FluxFill
        from .first_frame import make_self_first_frame_inpaint

        first_frame_inpaint_fn = make_self_first_frame_inpaint(
            pipe, guidance_scale=args.guidance_scale, seed=args.seed,
            sequential_cfg=args.sequential_cfg,
            use_flash="int8" if args.int8_attn else args.use_flash, dtype=dtype,
            prompt_embeds=embeds)
    if first_frame_inpaint_fn is not None:
        first = first_frame_inpaint_fn(first, masks_f[0], prompt)

    video = torch.from_numpy(video01).to(dev) * 2 - 1
    image = torch.from_numpy(np.ascontiguousarray(first, np.float32)).to(dev) * 2 - 1
    if embeds is not None:
        emb_kw = dict(prompt_embeds=embeds, negative_prompt_embeds=torch.zeros_like(embeds))
    else:
        emb_kw = dict(prompt=prompt, negative_prompt=args.negative_prompt)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    with maybe_profile(args.profile, "inpaint_denoise", args.profile_dir):
        out = pipe(image=image[None], video=video[None],
                   masks=torch.from_numpy(masks_f).to(dev)[None],
                   num_frames=num_frames, stride=stride,
                   num_inference_steps=args.num_inference_steps,
                   guidance_scale=args.guidance_scale, use_dynamic_cfg=True,
                   replace_gt=args.replace_gt, mask_add=args.mask_add,
                   prev_clip_weight=args.prev_clip_weight,
                   id_pool_resample=bool(args.id_adapter),
                   use_flash=("int8pv" if args.int8_pv else "int8" if args.int8_attn
                              else args.use_flash),
                   sequential_cfg=args.sequential_cfg,
                   skip_steps=(parse_skip_steps(args.skip_steps, args.num_inference_steps)
                               if args.skip_steps else None),
                   # int8 capture by default in the int8 ID-resample mode
                   capture_int8=(not args.no_capture_int8
                                 and (args.capture_int8 or (args.int8 and bool(args.id_adapter)))),
                   generator=generator, dtype=dtype, **emb_kw)
    out01 = (np.asarray(out)[0] / 2 + 0.5).clip(0, 1)
    return out01, video01[: len(out01)], masks_f[: len(out01)]


def generate_video(args, first_frame_inpaint_fn: Optional[Callable] = None,
                   caption_fn: Optional[Callable] = None):
    """Read the clip, inpaint it, write video_<id>.mp4; returns the frames."""
    pipe = load_pipeline(args)
    video_u8, masks, caption = read_video_with_mask(
        args.meta_file_path, args.video_id, args.data_root, args.height, args.width, args.fps)
    out01, video01, masks_f = run_inpaint(pipe, args, video_u8, masks, caption,
                                          first_frame_inpaint_fn, caption_fn)
    dst = os.path.join(args.output_path, f"video_{args.video_id}.mp4")
    export_side_by_side(video01, video01 * (1 - masks_f[..., None]), out01, dst, args.fps)
    print(f"wrote {dst}")
    return out01


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--inpainting_branch", required=True)
    p.add_argument("--id_adapter", default=None)
    p.add_argument("--meta_file_path", required=True)
    p.add_argument("--data_root", default="")
    p.add_argument("--video_id", type=int, default=0)
    p.add_argument("--output_path", default="out")
    p.add_argument("--prompt", default=None)
    p.add_argument("--prompt_embeds", default=None,
                   help="npz/npy with precomputed T5 embeds (deployments without T5)")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--overlap_frames", type=int, default=0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--prev_clip_weight", type=float, default=0.0)
    p.add_argument("--replace_gt", action="store_true")
    p.add_argument("--mask_add", action="store_true")
    p.add_argument("--first_frame_gt", action="store_true")
    p.add_argument("--first_frame_inpaint", choices=["none", "self"], default="none",
                   help="'self' pre-inpaints frame 0 with the port's own image-mode (T=1) "
                        "inpaint before propagating (the offline stand-in for the "
                        "reference's FluxFill step); a first_frame_inpaint_fn hook takes "
                        "precedence")
    p.add_argument("--long_video", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--use_flash", action="store_true",
                   help="the hand-written bf16 flash-attention kernel")
    p.add_argument("--int8_attn", action="store_true",
                   help="the int8 Q.K^T flash-attention kernel (SageAttention-style)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 block projections (approximate serving mode)")
    p.add_argument("--int8_pv", action="store_true",
                   help="int8 Q.K^T and int8 P.V flash attention (lossier than --int8_attn)")
    p.add_argument("--int8_scales", default=None,
                   help="npz of calibrated static activation scales (quantize.save_ascales) "
                        "for the int8 linears")
    p.add_argument("--capture_int8", action="store_true",
                   help="store the compressed cross-window ID state as per-token int8 "
                        "(on by default with --int8 and --id_adapter)")
    p.add_argument("--no_capture_int8", action="store_true",
                   help="keep the compressed cross-window state in the model's dtype")
    p.add_argument("--skip_steps", default=None,
                   help='step-skip schedule "start:end:stride" or a comma list: skipped '
                        "steps reuse the cached pre-CFG prediction")
    p.add_argument("--sequential_cfg", action="store_true",
                   help="uncond and cond as two passes per step (half the activations)")
    p.add_argument("--vae_frame_batch", type=int, default=0,
                   help="latent frames per VAE decoder batch (0: the model's default, 2)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; no silent fallback to the CPU")
    p.add_argument("--profile", action="store_true",
                   help="torch.profiler trace around the denoise")
    p.add_argument("--profile_dir", default=os.path.join("build", "torch_trace"))
    return p.parse_args(argv)


def main(argv=None):
    return generate_video(get_args(argv))


if __name__ == "__main__":
    main()
