"""Full evaluation-matrix sweep — one command reproduces the reference's
eval grid (evaluate/eval_inpainting.sh:12-78): for each dataset config
(standard / anyl / davis), every (dilate_size x replace_gt) combination runs
as its own evaluation into its own output directory, and the corpus averages
aggregate into <save_addr>/sweep_summary.csv.

Counterpart of `videopainter_tpu/evaluate/sweep.py`, on the port's
`evaluate.cli.main`; `--device` is forwarded to every evaluation.

Layout (mirrors the reference's per-config save_addr convention):
    <save_addr>/<config>/dilate<D>_rg<0|1>/results.csv   per-video rows
    <save_addr>/sweep_summary.csv                        one row per combo

Resume: each inner evaluation resumes by artifact (the harness skips videos
already in its results.csv), and completed combos are re-aggregated, so an
interrupted sweep re-run continues where it stopped.

Usage:
    python -m videopainter_tpu_torch.evaluate.sweep \
        --model_path ckpts/cogvideox-5b-i2v --inpainting_branch ckpts/branch \
        --standard_meta data/our_video_inpaint.csv \
        --anyl_meta data/our_video_inpaint_long.csv \
        --davis_root data/davis --data_root data/videovo/raw_video \
        --save_addr eval_sweep --mask_add [--device cpu]

Note a flag-semantics difference vs the reference: its --max_video_length
caps FRAMES per clip (49 standard / 9999 anyl); here clip length is governed
by --num_frames (single-clip) and the anyl config's --anyl_overlap_frames
window stride, while --max_video_length bounds the NUMBER of videos (useful
for smoke sweeps).
"""

from __future__ import annotations

import argparse
import csv
import os


CONFIG_NAMES = ("standard", "anyl", "davis")


def get_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", required=True)
    p.add_argument("--inpainting_branch", default=None)
    p.add_argument("--wo_branch", action="store_true")
    p.add_argument("--id_adapter_resample_learnable_path", default=None,
                   help="LoRA for the anyl (ID-resample) config")
    p.add_argument("--save_addr", default="eval_sweep")
    p.add_argument("--configs", nargs="+", default=list(CONFIG_NAMES),
                   choices=CONFIG_NAMES)
    p.add_argument("--dilate_sizes", nargs="+", type=int, default=[32, 16, 0],
                   help="reference sweeps 32 16 0")
    p.add_argument("--replace_gt_values", nargs="+", default=["true", "false"],
                   choices=["true", "false"])
    # per-config data sources (the sh script's declare -A configs block)
    p.add_argument("--standard_meta", default=None,
                   help="VPBench CSV (our_video_inpaint.csv)")
    p.add_argument("--anyl_meta", default=None,
                   help="VPBench long CSV (our_video_inpaint_long.csv)")
    p.add_argument("--davis_root", default=None)
    p.add_argument("--data_root", default="",
                   help="video root for the VPBench configs")
    p.add_argument("--anyl_overlap_frames", type=int, default=8,
                   help=">0 selects the any-length window pipeline for the "
                        "anyl config (reference --long_video)")
    # shared knobs forwarded to every evaluation
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--num_frames", type=int, default=49)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--mask_add", action="store_true")
    p.add_argument("--prev_clip_weight", type=float, default=0.0)
    p.add_argument("--max_video_length", type=int, default=None,
                   help="bound the number of videos per combo (smoke sweeps)")
    p.add_argument("--prompt_embeds_file", default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--i3d_weights", default=None)
    p.add_argument("--clip_path", default=None)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu; forwarded to every evaluation")
    return p.parse_args(argv)


def _combo_args(args, config: str, dilate: int, replace_gt: bool, out_dir: str):
    """argv for evaluate.cli.main for one grid cell."""
    argv = ["--model_path", args.model_path,
            "--save_addr", out_dir,
            "--height", str(args.height), "--width", str(args.width),
            "--num_frames", str(args.num_frames),
            "--num_inference_steps", str(args.num_inference_steps),
            "--guidance_scale", str(args.guidance_scale),
            "--dilate_size", str(dilate),
            "--dtype", args.dtype, "--seed", str(args.seed)]
    if args.wo_branch:
        argv += ["--wo_branch"]
    else:
        argv += ["--inpainting_branch", args.inpainting_branch]
    if replace_gt:
        argv += ["--replace_gt"]
    if args.mask_add:
        argv += ["--mask_add"]
    if args.max_video_length is not None:
        argv += ["--max_video_length", str(args.max_video_length)]
    for flag in ["prompt_embeds_file", "lpips_weights", "i3d_weights",
                 "clip_path", "device"]:
        v = getattr(args, flag)
        if v:
            argv += [f"--{flag}", v]
    if config == "davis":
        argv += ["--dataset", "davis", "--video_root", args.davis_root]
    else:
        meta = args.standard_meta if config == "standard" else args.anyl_meta
        argv += ["--dataset", "vpbench", "--meta_file_path", meta,
                 "--data_root", args.data_root]
    if config == "anyl":
        argv += ["--overlap_frames", str(args.anyl_overlap_frames),
                 "--prev_clip_weight", str(args.prev_clip_weight or 0.3)]
        if args.id_adapter_resample_learnable_path:
            argv += ["--id_adapter_resample_learnable_path",
                     args.id_adapter_resample_learnable_path]
    elif args.prev_clip_weight:
        argv += ["--prev_clip_weight", str(args.prev_clip_weight)]
    return argv


def main(argv=None):
    args = get_args(argv)
    from .cli import main as eval_main

    sources = {"standard": args.standard_meta, "anyl": args.anyl_meta,
               "davis": args.davis_root}
    configs = [c for c in args.configs if sources[c]]
    skipped = [c for c in args.configs if not sources[c]]
    if skipped:
        print(f"[sweep] skipping configs without a data source: {skipped} "
              "(--standard_meta/--anyl_meta/--davis_root)")
    if not configs:
        raise SystemExit("no runnable configs — provide at least one of "
                         "--standard_meta/--anyl_meta/--davis_root")

    os.makedirs(args.save_addr, exist_ok=True)
    summary_path = os.path.join(args.save_addr, "sweep_summary.csv")
    rows = []
    for config in configs:
        for dilate in args.dilate_sizes:
            for rg in args.replace_gt_values:
                replace_gt = rg == "true"
                out_dir = os.path.join(args.save_addr, config,
                                       f"dilate{dilate}_rg{int(replace_gt)}")
                print(f"[sweep] {config} dilate={dilate} "
                      f"replace_gt={replace_gt} -> {out_dir}", flush=True)
                avg = eval_main(_combo_args(args, config, dilate, replace_gt,
                                            out_dir))
                row = {"config": config, "dilate_size": dilate,
                       "replace_gt": int(replace_gt), "out_dir": out_dir}
                row.update({k: round(float(v), 6) for k, v in avg.items()})
                rows.append(row)
                # flush incrementally so an interrupted sweep leaves a
                # consistent partial summary
                cols = sorted({k for r in rows for k in r},
                              key=lambda k: (k not in ("config", "dilate_size",
                                                       "replace_gt", "out_dir"), k))
                with open(summary_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=cols)
                    w.writeheader()
                    w.writerows(rows)
    print(f"[sweep] {len(rows)} combos -> {summary_path}")
    return rows


if __name__ == "__main__":
    main()
