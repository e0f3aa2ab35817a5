"""Evaluation CLI: DAVIS / VPBench inpainting sweep.

Counterpart of `videopainter_tpu/evaluate/cli.py` (the reference's
evaluate/eval_inpainting.py get_args :650-705, main_worker :81-520, driven by
evaluate/eval_inpainting.sh sweeps over dataset x dilate x replace_gt): the
same flags mapped onto `run_inpainting_eval`, plus `--device`.

Usage:
    python -m videopainter_tpu_torch.evaluate.cli \\
        --model_path ckpts/cogvideox-5b-i2v --inpainting_branch ckpts/branch \\
        --dataset davis --video_root data/DAVIS \\
        --dilate_size 16 --replace_gt --mask_add --save_addr eval_out [--device cpu]

VPBench: --dataset vpbench --meta_file_path bench.csv [--data_root ...].
Text embeds: --prompt_embeds_file (precomputed) or a local T5 under
<model_path>/text_encoder. It runs on the card unless `--device cpu` is
given, with the activations in `--dtype`. Attention is the exact path, as the
JAX CLI has it: at 480x720 its fp32 score matrix (2 x 48 heads x 17,776^2) does
not fit one card; the harness takes any callable, so a caller binds
`use_flash=True` into the pipeline for that size.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Optional


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--inpainting_branch", default=None,
                   help="branch dir; omit with --wo_branch")
    p.add_argument("--wo_branch", action="store_true",
                   help="backbone-only SFT eval (eval_inpainting_wo_branch.py)")
    p.add_argument("--id_adapter_resample_learnable_path", default=None)
    p.add_argument("--dataset", choices=["davis", "vpbench"], default="davis")
    p.add_argument("--video_root", default="")
    p.add_argument("--meta_file_path", default="")
    p.add_argument("--data_root", default="")
    p.add_argument("--save_addr", default="eval_out")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--overlap_frames", type=int, default=0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--dilate_size", type=int, default=0,
                   help="mask dilation iterations (reference sweeps 0/16/32)")
    p.add_argument("--replace_gt", action="store_true")
    p.add_argument("--mask_add", action="store_true")
    p.add_argument("--prev_clip_weight", type=float, default=0.0)
    p.add_argument("--max_video_length", type=int, default=None,
                   help="max videos to evaluate")
    p.add_argument("--prompt_embeds_file", default=None)
    p.add_argument("--lpips_weights", default=None,
                   help="local LPIPS-squeeze checkpoint (.pt/.npz) -> lpips/masked_lpips")
    p.add_argument("--i3d_weights", default=None,
                   help="local pytorch-i3d checkpoint -> FVID")
    p.add_argument("--clip_path", default=None,
                   help="local CLIP dir -> clip_score + temporal consistency")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; no silent fallback to the CPU")
    return p.parse_args(argv)


def build_metrics(lpips_weights: Optional[str] = None, i3d_weights: Optional[str] = None,
                  clip_path: Optional[str] = None, device=None):
    """The MetricsCalculator of the extractors given (each on `device`), or
    None when none is given (the harness then computes the closed-form
    metrics only)."""
    if not (lpips_weights or i3d_weights or clip_path):
        return None
    from .extractors import ClipExtractor, I3DExtractor, make_lpips_fn
    from .metrics import MetricsCalculator

    image_embed_fn = text_image_score_fn = None
    if clip_path:
        clip = ClipExtractor(clip_path, device=device)
        image_embed_fn, text_image_score_fn = clip.image_embed, clip.clip_score
    return MetricsCalculator(
        image_embed_fn=image_embed_fn, text_image_score_fn=text_image_score_fn,
        lpips_fn=make_lpips_fn(weights_path=lpips_weights, device=device)
        if lpips_weights else None,
        video_feature_fn=I3DExtractor(i3d_weights, device=device) if i3d_weights else None)


def main(argv=None):
    args = get_args(argv)
    import torch

    from .. import resolve_device
    from ..infer.inpaint import DTYPES, build_pipeline
    from .datasets import DavisTestDataset, VPBenchDataset
    from .harness import EvalConfig, run_inpainting_eval

    if not args.wo_branch and not args.inpainting_branch:
        raise SystemExit("--inpainting_branch required unless --wo_branch")
    dev = resolve_device(args.device)
    pipeline = build_pipeline(
        args.model_path, None if args.wo_branch else args.inpainting_branch,
        id_adapter=args.id_adapter_resample_learnable_path, dtype_str=args.dtype, device=dev)
    pipe = functools.partial(pipeline, dtype=DTYPES[args.dtype])

    if args.dataset == "davis":
        if not args.video_root:
            raise SystemExit("--video_root required for davis")
        dataset = DavisTestDataset(root=args.video_root, height=args.height,
                                   width=args.width, dilate_iterations=args.dilate_size)
    else:
        if not args.meta_file_path:
            raise SystemExit("--meta_file_path required for vpbench")
        dataset = VPBenchDataset(meta_file_path=args.meta_file_path,
                                 data_root=args.data_root, height=args.height,
                                 width=args.width, dilate_iterations=args.dilate_size,
                                 max_videos=args.max_video_length)

    if args.prompt_embeds_file:
        from ..models.text_encoder import load_prompt_embeds

        fixed = load_prompt_embeds(args.prompt_embeds_file).to(dev)

        def encode_prompt_fn(_caption):
            return fixed, torch.zeros_like(fixed)
    else:
        from ..models.text_encoder import T5TextEncoder

        te = pipeline.text_encoder or T5TextEncoder.from_local(
            os.path.join(args.model_path, "text_encoder"), device=dev)

        def encode_prompt_fn(caption):
            return te.encode_with_negative(caption)

    cfg = EvalConfig(
        output_dir=args.save_addr,
        num_inference_steps=args.num_inference_steps,
        num_frames=args.num_frames,
        stride=(args.num_frames - args.overlap_frames) if args.overlap_frames else None,
        guidance_scale=args.guidance_scale,
        replace_gt=args.replace_gt, mask_add=args.mask_add,
        prev_clip_weight=args.prev_clip_weight,
        resume=not args.no_resume, seed=args.seed,
        max_videos=args.max_video_length)
    averages = run_inpainting_eval(
        pipe, dataset, cfg, encode_prompt_fn=encode_prompt_fn, device=dev,
        metrics=build_metrics(args.lpips_weights, args.i3d_weights, args.clip_path, dev))
    print("corpus averages:", {k: round(v, 4) for k, v in averages.items()})
    return averages


if __name__ == "__main__":
    main()
