"""Training CLI: branch SFT / ID-LoRA from HF-format checkpoints.

Counterpart of `videopainter_tpu/training/cli.py`, with the same flags.
Reference entry points: train/VideoPainter.sh -> train_cogvideox_inpainting_
i2v_video.py (branch) and train/VideoPainterID.sh -> ..._resample.py (LoRA);
the ~95 argparse flags map onto the dataclass configs here. Runs on one card
(`--device cpu` for the CPU); the mesh flags accept only 1 until multi-chip
training is ported.

Usage (branch SFT):
    python -m videopainter_tpu_torch.training.cli \
        --pretrained_model_name_or_path ckpts/cogvideox-5b-i2v \
        --meta_file_path data/meta.csv --instance_data_root data/ \
        --output_dir runs/branch --mask_add --first_frame_gt \
        --max_train_steps 10000 --learning_rate 1e-5

ID-LoRA adds:  --mode lora --cogvideox_branch_name_or_path runs/branch/export
Text embeds: supply --prompt_embeds_file (precomputed); the T5 encoder is not
ported yet, so running without the file raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def get_args(argv=None):
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--pretrained_model_name_or_path", required=True)
    p.add_argument("--cogvideox_branch_name_or_path", default=None,
                   help="pretrained branch (required for --mode lora)")
    p.add_argument("--mode", choices=["branch", "lora"], default="branch")
    p.add_argument("--branch_layer_num", type=int, default=2)
    p.add_argument("--rank", type=int, default=256)
    p.add_argument("--lora_alpha", type=float, default=128.0)
    # data
    p.add_argument("--meta_file_path", required=True)
    p.add_argument("--val_meta_file_path", default=None,
                   help="validation CSV: its first clip drives the periodic "
                        "pipeline validation (reference log_validation)")
    p.add_argument("--instance_data_root", default="")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--resolution", type=int, nargs=2, default=None,
                   metavar=("H", "W"), help="alias for --height/--width")
    p.add_argument("--max_num_frames", type=int, default=49)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--skip_frames_start", type=int, default=0)
    p.add_argument("--skip_frames_end", type=int, default=0)
    p.add_argument("--random_flip", action="store_true",
                   help="random horizontal flip (video + masks together)")
    p.add_argument("--video_reshape_mode", default="resize",
                   choices=["resize", "center", "random"])
    p.add_argument("--video_column", default="path")
    p.add_argument("--caption_column", default="caption")
    p.add_argument("--id_token", default=None,
                   help="identifier token prepended to every prompt")
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--mask_transform_prob", type=float, default=0.3)
    p.add_argument("--p_brush", type=float, default=0.25)
    p.add_argument("--p_rect", type=float, default=0.25)
    p.add_argument("--p_ellipse", type=float, default=0.2)
    p.add_argument("--p_circle", type=float, default=0.2)
    p.add_argument("--p_random_brush", type=float, default=0.1)
    p.add_argument("--margin_ratio", type=float, default=0.1)
    p.add_argument("--shape_scale_min", type=float, default=1.1)
    p.add_argument("--shape_scale_max", type=float, default=1.5)
    p.add_argument("--mix_train_ratio", type=float, default=0.0)
    p.add_argument("--min_caption_len", type=int, default=50)
    p.add_argument("--first_frame_gt", action="store_true")
    p.add_argument("--mask_background", action="store_true")
    p.add_argument("--proportion_empty_prompts", type=float, default=0.0)
    p.add_argument("--prompt_embeds_file", default=None)
    p.add_argument("--cache_latents", action="store_true",
                   help="cache VAE posterior MOMENTS per batch on disk and "
                        "skip the per-step 49-frame encodes (the per-step "
                        "posterior sample is still drawn). "
                        "Auto-degrades: full (video+cond) caching needs all "
                        "augmentations off; mask-transform-only keeps the "
                        "GT-video cache; mix_train_ratio/random_flip/random-"
                        "crop disable it (pixels change every step)")
    # objective / conditioning
    p.add_argument("--inpainting_loss_weight", type=float, default=1.0)
    p.add_argument("--mask_add", action="store_true")
    p.add_argument("--add_first", action="store_true")
    p.add_argument("--wo_text", action="store_true")
    p.add_argument("--noised_image_dropout", type=float, default=0.05)
    p.add_argument("--use_flash", action="store_true",
                   help="the hand-written flash-attention kernels in the train "
                        "step (bf16: use with --mixed_precision bf16)")
    # optimization
    p.add_argument("--max_train_steps", type=int, default=None,
                   help="optimizer steps; default: derived from "
                        "--num_train_epochs x dataset size")
    p.add_argument("--num_train_epochs", type=int, default=1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   default=True, help="rematerialize DiT blocks (default ON "
                                      "— required at flagship dims)")
    p.add_argument("--no_gradient_checkpointing", action="store_false",
                   dest="gradient_checkpointing")
    p.add_argument("--remat_chunk", type=int, default=0,
                   help="two-level checkpointing group size for the backbone "
                        "(e.g. 7 at 42 layers): resident block inputs drop "
                        "from L to ~L/chunk+chunk for one extra in-group "
                        "forward (no reference analog)")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--scale_lr", action="store_true",
                   help="lr *= grad_accum x batch x data-parallel size")
    p.add_argument("--optimizer", default="adamw",
                   choices=["adam", "adamw", "prodigy", "adafactor"],
                   help="reference get_optimizer surface "
                        "+ adafactor")
    p.add_argument("--use_8bit_adam", action="store_true",
                   help="the JAX package's analog of bitsandbytes 8-bit Adam: "
                        "switches to adafactor (a factored second moment in "
                        "place of two full moments)")
    p.add_argument("--lr_scheduler", default="cosine_with_restarts",
                   choices=["linear", "cosine", "cosine_with_restarts",
                            "polynomial", "constant", "constant_with_warmup"])
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.95)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--prodigy_beta3", type=float, default=None)
    p.add_argument("--prodigy_decouple", action="store_true", default=True)
    p.add_argument("--prodigy_use_bias_correction", action="store_true")
    p.add_argument("--prodigy_safeguard_warmup", action="store_true")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--enable_slicing", action="store_true",
                   help="VAE batch slicing (reference enables it)")
    p.add_argument("--enable_tiling", action="store_true",
                   help="VAE spatial tiling (reference enables it)")
    p.add_argument("--mixed_precision", default=None,
                   choices=["no", "fp16", "bf16"],
                   help="bf16 casts the FROZEN models and the batch to "
                        "bfloat16, the trainable weights stay float32 "
                        "masters (fp16 is treated as bf16 with a warning)")
    # validation (reference log_validation knobs)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--use_dynamic_cfg", action="store_true", default=True)
    p.add_argument("--num_validation_videos", type=int, default=1)
    # wandb logging identity (reference --tracker_name/--runs_name)
    p.add_argument("--tracker_name", default="videopainter-tpu")
    p.add_argument("--runs_name", default=None)
    p.add_argument("--max_text_seq_length", type=int, default=None,
                   help="override the text token budget (default: model "
                        "config)")
    # accepted-for-parity no-ops so reference shell scripts run unmodified
    # (no meaning here, no egress, or dead in the reference itself: the
    # flag-by-flag account is docs/MIGRATION.md)
    for noop, kw in [
            ("--revision", {}), ("--variant", {}), ("--cache_dir", {}),
            ("--dataset_name", {}), ("--dataset_config_name", {}),
            ("--validation_prompt", {}),
            ("--validation_prompt_separator", {"default": ":::"}),
            ("--validation_epochs", {"type": int}),
            ("--hub_model_id", {}), ("--hub_token", {}),
            ("--logging_dir", {"default": "logs"}), ("--report_to", {}),
            ("--corrupt_file_path", {}),
            ("--dataloader_num_workers", {"type": int, "default": 0}),
            ("--pin_memory", {"action": "store_true"}),
            ("--random_mask", {"action": "store_true"}),
            ("--allow_tf32", {"action": "store_true"}),
            ("--enable_xformers_memory_efficient_attention",
             {"action": "store_true"}),
            ("--push_to_hub", {"action": "store_true"})]:
        p.add_argument(noop, help="accepted for reference script parity "
                                  "(see docs/MIGRATION.md)", **kw)
    # infra
    p.add_argument("--output_dir", default="runs/branch")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=5)
    p.add_argument("--validating_steps", type=int, default=256)
    p.add_argument("--resume_from_checkpoint", default="latest")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back on its own")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel size (only 1: multi-chip training is "
                        "not ported yet)")
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="sequence-parallel size (only 1)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel size (only 1)")
    p.add_argument("--dcn_data", type=int, default=1,
                   help="multi-slice data-parallel factor (only 1)")
    return p.parse_args(argv)


def _load(module, path, device, dtype=None):
    """An HF-format directory's weights into `module` (float32 on `device`,
    or `dtype`)."""
    from .checkpoint import load_safetensors_dir

    module.load_state_dict(load_safetensors_dir(path))
    return module.to(device=device, dtype=dtype)


def main(argv=None):
    args = get_args(argv)
    import dataclasses

    import numpy as np
    import torch

    from .. import resolve_device
    from ..config import (BranchConfig, SchedulerConfig, TransformerConfig, VAEConfig,
                          load_config)
    from ..models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D
    from ..models.lora import init_lora_params
    from ..schedulers import CogVideoXDDIMScheduler
    from .data import DataConfig, InpaintingCollator, VideoInpaintingDataset, data_loader
    from .masks import MaskTransformConfig
    from .train_branch import BranchTrainConfig
    from .trainer import TrainerConfig, train

    if args.resolution:
        args.height, args.width = args.resolution
    for flag in ("mesh_data", "mesh_seq", "mesh_model", "dcn_data"):
        if getattr(args, flag) != 1:
            raise NotImplementedError(f"--{flag} {getattr(args, flag)}: multi-chip "
                                      "training is not ported yet (only 1)")
    device = resolve_device(args.device)
    frozen_dtype = None
    if args.mixed_precision in ("fp16", "bf16"):
        if args.mixed_precision == "fp16":
            print("[warn] --mixed_precision fp16 -> bf16")
        frozen_dtype = torch.bfloat16
    batch_dtype = frozen_dtype or torch.float32

    root = args.pretrained_model_name_or_path
    tcfg_m = load_config(os.path.join(root, "transformer", "config.json"), TransformerConfig)
    overrides = {}
    if args.mode == "lora":
        overrides["id_pool_resample_learnable"] = True
    if args.max_text_seq_length:
        overrides["max_text_seq_length"] = args.max_text_seq_length
    if overrides:
        tcfg_m = TransformerConfig.from_dict({**tcfg_m.to_dict(), **overrides})
    vcfg = load_config(os.path.join(root, "vae", "config.json"), VAEConfig)
    transformer = _load(CogVideoXTransformer3D(tcfg_m), os.path.join(root, "transformer"),
                        device, frozen_dtype)
    vae = _load(AutoencoderKLCogVideoX(vcfg), os.path.join(root, "vae"), device, frozen_dtype)
    if args.enable_slicing:
        raise NotImplementedError("--enable_slicing: VAE batch slicing is not ported")
    if args.enable_tiling:
        vae.enable_tiling()

    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.mode == "branch":
        bcfg = BranchConfig.from_transformer(tcfg_m, num_layers=args.branch_layer_num,
                                             wo_text=args.wo_text)
        branch = CogVideoXBranch(bcfg).to(device).init_from_transformer(transformer)
        trainable = branch   # float32 master weights
    else:
        if not args.cogvideox_branch_name_or_path:
            raise SystemExit("--cogvideox_branch_name_or_path required for lora")
        bcfg = load_config(os.path.join(args.cogvideox_branch_name_or_path, "config.json"),
                           BranchConfig)
        branch = _load(CogVideoXBranch(bcfg), args.cogvideox_branch_name_or_path, device,
                       frozen_dtype)
        trainable = init_lora_params(gen, transformer, rank=args.rank)

    sched = CogVideoXDDIMScheduler(SchedulerConfig(prediction_type="v_prediction"))

    dcfg = DataConfig(
        meta_file_path=args.meta_file_path,
        instance_data_root=args.instance_data_root,
        height=args.height, width=args.width,
        max_num_frames=args.max_num_frames, fps=args.fps,
        skip_frames_start=args.skip_frames_start,
        skip_frames_end=args.skip_frames_end,
        random_flip=args.random_flip,
        video_reshape_mode=args.video_reshape_mode,
        video_column=args.video_column, caption_column=args.caption_column,
        id_token=args.id_token,
        mask_transform_prob=args.mask_transform_prob,
        mask_cfg=MaskTransformConfig(
            p_brush=args.p_brush, p_rect=args.p_rect, p_ellipse=args.p_ellipse,
            p_circle=args.p_circle, p_random_brush=args.p_random_brush,
            margin_ratio=args.margin_ratio,
            shape_scale_min=args.shape_scale_min,
            shape_scale_max=args.shape_scale_max),
        mix_train_ratio=args.mix_train_ratio,
        min_caption_len=args.min_caption_len,
        first_frame_gt=args.first_frame_gt,
        mask_background=args.mask_background,
        proportion_empty_prompts=args.proportion_empty_prompts,
        seed=args.seed)
    dataset = VideoInpaintingDataset(dcfg)
    collator = InpaintingCollator(dcfg)
    print(f"dataset: {len(dataset)} clips after filtering")

    if args.max_train_steps is None:
        # reference semantics: steps derived from epochs when unset
        steps_per_epoch = max(
            len(dataset) // (args.train_batch_size * args.gradient_accumulation_steps), 1)
        args.max_train_steps = args.num_train_epochs * steps_per_epoch
        print(f"max_train_steps = {args.max_train_steps} ({args.num_train_epochs} epochs)")
    if args.scale_lr:
        args.learning_rate *= args.gradient_accumulation_steps * args.train_batch_size

    # prompt embedding: precomputed (the T5 encoder is not ported yet)
    if not args.prompt_embeds_file:
        raise NotImplementedError("the T5 text encoder is not ported yet: pass "
                                  "--prompt_embeds_file")
    arr = np.load(args.prompt_embeds_file)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    fixed = torch.as_tensor(arr[None] if arr.ndim == 2 else arr).to(device, batch_dtype)
    embed_fn = lambda prompts: fixed.repeat(len(prompts), 1, 1)
    to_dev = lambda x: torch.as_tensor(np.asarray(x)).to(device, batch_dtype)

    cache_mode = None
    if args.cache_latents:
        det_video = (dcfg.mix_train_ratio == 0 and not dcfg.random_flip
                     and dcfg.video_reshape_mode != "random")
        det_cond = det_video and dcfg.mask_transform_prob == 0
        cache_mode = "full" if det_cond else ("video" if det_video else None)
        if cache_mode is None:
            print("[warn] --cache_latents disabled: mix_train_ratio/"
                  "random_flip/random-crop re-randomize pixels every step")
        elif cache_mode == "full":
            print("latent cache: video+cond moments")
        else:
            print("latent cache: GT-video moments only (mask transforms "
                  "re-randomize the masked video)")
    cache_dir = os.path.join(args.output_dir, "latent_cache")

    def batches():
        for batch, idx in data_loader(dataset, collator, args.train_batch_size,
                                      seed=args.seed, yield_indices=True):
            tb = {
                "pixel_values": to_dev(batch["pixel_values"]),
                "conditioning_pixel_values": to_dev(batch["conditioning_pixel_values"]),
                "masks": to_dev(batch["masks"]),
                "prompt_embeds": embed_fn(batch["prompts"]),
            }
            if cache_mode:
                os.makedirs(cache_dir, exist_ok=True)
                path = os.path.join(cache_dir, "rows_" + "_".join(map(str, idx)) + ".npz")
                if os.path.exists(path):
                    with np.load(path) as z:
                        tb["video_latent_mean"] = to_dev(z["vm"])
                        tb["video_latent_logvar"] = to_dev(z["vl"])
                        if cache_mode == "full" and "cm" in z:
                            tb["cond_latent_mean"] = to_dev(z["cm"])
                            tb["cond_latent_logvar"] = to_dev(z["cl"])
                else:
                    host = lambda t: t.float().cpu().numpy()
                    d = vae.encode(tb["pixel_values"])
                    tb["video_latent_mean"], tb["video_latent_logvar"] = d.mean, d.logvar
                    arrays = {"vm": host(d.mean), "vl": host(d.logvar)}
                    if cache_mode == "full":
                        d2 = vae.encode(tb["conditioning_pixel_values"])
                        tb["cond_latent_mean"], tb["cond_latent_logvar"] = d2.mean, d2.logvar
                        arrays.update(cm=host(d2.mean), cl=host(d2.logvar))
                    np.savez(path, **arrays)
            yield tb

    btcfg = BranchTrainConfig(
        height=args.height, width=args.width,
        inpainting_loss_weight=args.inpainting_loss_weight,
        mask_add=args.mask_add, add_first=args.add_first, wo_text=args.wo_text,
        noised_image_dropout=args.noised_image_dropout,
        use_flash=args.use_flash, remat=args.gradient_checkpointing,
        remat_chunk=args.remat_chunk or None,
        max_grad_norm=args.max_grad_norm,
        lora_rank=args.rank, lora_alpha=args.lora_alpha)
    trcfg = TrainerConfig(
        output_dir=args.output_dir, max_train_steps=args.max_train_steps,
        learning_rate=args.learning_rate,
        optimizer=("adafactor" if args.use_8bit_adam else args.optimizer),
        lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_num_cycles=args.lr_num_cycles, lr_power=args.lr_power,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon,
        prodigy_beta3=args.prodigy_beta3,
        prodigy_decouple=args.prodigy_decouple,
        prodigy_use_bias_correction=args.prodigy_use_bias_correction,
        prodigy_safeguard_warmup=args.prodigy_safeguard_warmup,
        batch_size=args.train_batch_size,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        validating_steps=args.validating_steps,
        resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed, mode=args.mode,
        tracker_name=args.tracker_name, runs_name=args.runs_name)

    # periodic pipeline validation: the first clip of --val_meta_file_path,
    # run through the full inpaint pipeline every --validating_steps and
    # logged as a side-by-side video
    validation_fn = None
    if args.val_meta_file_path:
        from .validation import make_validation_fn

        val_cfg = dataclasses.replace(dcfg, mask_transform_prob=0.0, mix_train_ratio=0.0,
                                      proportion_empty_prompts=0.0)
        val_ds = VideoInpaintingDataset(
            dataclasses.replace(val_cfg, meta_file_path=args.val_meta_file_path))
        vb = InpaintingCollator(val_cfg)([val_ds[0]])
        val_batch = {
            "pixel_values": to_dev(vb["pixel_values"]),
            "conditioning_pixel_values": to_dev(vb["conditioning_pixel_values"]),
            "masks": to_dev(vb["masks"]),
            "prompt_embeds": embed_fn(vb["prompts"]),
        }
        validation_fn = make_validation_fn(
            transformer, branch, vae, sched, val_batch,
            guidance_scale=args.guidance_scale, mode=args.mode,
            lora_alpha=args.lora_alpha, lora_rank=args.rank,
            use_flash=args.use_flash, dtype=batch_dtype)

    state = train(transformer, branch, vae, sched, batches(), trcfg, btcfg,
                  validation_fn=validation_fn, initial_trainable=trainable)

    # final export in reference-compatible format
    from .checkpoint import export_branch_pretrained, export_lora_weights

    if args.mode == "branch":
        export_branch_pretrained(branch, bcfg.to_dict(), os.path.join(args.output_dir, "export"))
    else:
        export_lora_weights(state.trainable, os.path.join(args.output_dir, "export"))
    print(f"exported final weights to {args.output_dir}/export")
    return state


if __name__ == "__main__":
    main()
