"""Video editing CLI: instruction-driven edits propagated by inpainting.

Counterpart of `videopainter_tpu/infer/edit.py` (the reference's
infer/edit.py and edit_bench.py): an LLM rewrites the caption by the editing
instruction and describes the edited first frame, a first-frame editor
edits frame 0, the any-length pipeline propagates the edit through the
masked region, and the instruction metadata is saved beside the output. The
external models are pluggable callables (nothing here reaches a network):

  llm_fn(instruction, caption) -> (edited_caption, first_frame_description)
  first_frame_edit_fn(frame01, mask, description) -> edited_frame01
  generate_instructions_fn(video_u8, caption) -> [instruction, ...]

Without an LLM the edit falls back to caption-conditioned inpainting with
the instruction spliced into the prompt (`default_llm`).

    python -m videopainter_tpu_torch.infer.edit --instruction "..." <infer.inpaint flags>
    python -m videopainter_tpu_torch.infer.edit --bench --instructions_json i.json ...
"""

from __future__ import annotations

import argparse
import csv
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from .inpaint import (DTYPES, build_pipeline, clip_windows, export_side_by_side, get_args,
                      read_video_with_mask)


def default_llm(instruction: str, caption: str):
    """Offline fallback: splice the instruction into the caption."""
    edited = f"{caption.rstrip('.')}. {instruction}"
    return edited, instruction


def _build(args):
    return build_pipeline(args.model_path, args.inpainting_branch, args.id_adapter, args.dtype,
                          args.long_video, device=args.device)


def generate_edit(args, instruction: str, llm_fn: Optional[Callable] = None,
                  first_frame_edit_fn: Optional[Callable] = None, tag: Optional[str] = None,
                  pipe=None):
    """One edit of CSV row `args.video_id`: writes edit_<id>[_<tag>].mp4 and
    its instruction metadata (.json); returns the frames. `pipe` reuses a
    pipeline built from the same arguments."""
    if llm_fn is None:
        print("[edit] WARNING: no llm_fn hook: falling back to splicing the instruction into "
              "the caption (default_llm). The result is caption-conditioned inpainting, not "
              "instruction-following editing; plug an LLM via edit_bench_main(llm_fn=...).")
        llm_fn = default_llm
    pipe = pipe or _build(args)
    dtype = DTYPES[args.dtype]
    if first_frame_edit_fn is None and args.first_frame_inpaint == "self":
        from .first_frame import make_self_first_frame_inpaint

        first_frame_edit_fn = make_self_first_frame_inpaint(
            pipe, guidance_scale=args.guidance_scale, seed=args.seed, use_flash=args.use_flash,
            sequential_cfg=args.sequential_cfg, dtype=dtype)
    elif first_frame_edit_fn is None:
        print("[edit] WARNING: no first-frame editor: frame 0 stays masked. Pass "
              "--first_frame_inpaint self to pre-inpaint it with the port's own image-mode "
              "pipeline (the reference uses FluxFill here).")
    video_u8, masks, caption = read_video_with_mask(
        args.meta_file_path, args.video_id, args.data_root, args.height, args.width, args.fps)
    edited_caption, frame_desc = llm_fn(instruction, caption)

    num_frames, stride, usable = clip_windows(args, len(video_u8))
    video01 = video_u8[:usable].astype(np.float32) / 255.0
    masks_f = masks[:usable].astype(np.float32)
    first = video01[0] * (1 - masks_f[0][..., None])
    if first_frame_edit_fn is not None:
        first = first_frame_edit_fn(video01[0], masks_f[0], frame_desc)
        masks_f[0] = 0.0   # the edited frame 0 becomes the conditioning ground truth

    if args.prompt_embeds:
        from ..models.text_encoder import load_prompt_embeds

        embeds = load_prompt_embeds(args.prompt_embeds)
        emb_kw = dict(prompt_embeds=embeds, negative_prompt_embeds=torch.zeros_like(embeds))
    else:
        emb_kw = dict(prompt=edited_caption, negative_prompt=args.negative_prompt)
    dev = pipe.device
    out = pipe(image=torch.from_numpy(np.ascontiguousarray(first, np.float32)).to(dev)[None] * 2 - 1,
               video=torch.from_numpy(video01).to(dev)[None] * 2 - 1,
               masks=torch.from_numpy(masks_f).to(dev)[None],
               num_frames=num_frames, stride=stride, **emb_kw,
               num_inference_steps=args.num_inference_steps,
               guidance_scale=args.guidance_scale, use_dynamic_cfg=True,
               replace_gt=args.replace_gt, mask_add=args.mask_add,
               prev_clip_weight=args.prev_clip_weight, id_pool_resample=bool(args.id_adapter),
               generator=torch.Generator(device=dev).manual_seed(args.seed), dtype=dtype)
    out01 = (np.asarray(out)[0] / 2 + 0.5).clip(0, 1)

    os.makedirs(args.output_path, exist_ok=True)
    stem = f"edit_{args.video_id}" + (f"_{tag}" if tag else "")
    dst = os.path.join(args.output_path, f"{stem}.mp4")
    masked01 = video01[: len(out01)] * (1 - masks_f[: len(out01)][..., None])
    export_side_by_side(video01[: len(out01)], masked01, out01, dst, args.fps)
    with open(os.path.join(args.output_path, f"{stem}.json"), "w") as f:
        # the reference's instruction-metadata schema (infer/edit.py:491-498)
        json.dump({"Original_video_caption": caption,
                   "Edited_video_caption": edited_caption,
                   "Edited_image_caption": frame_desc,
                   "Editing_instruction": instruction}, f, indent=4, ensure_ascii=False)
    print(f"wrote {dst}")
    return out01


def run_edit_bench(args, instructions_per_video: dict, llm_fn=None, first_frame_edit_fn=None,
                   generate_instructions_fn: Optional[Callable] = None):
    """Edits over every row of a benchmark CSV: each row's instructions from
    the mapping, or from `generate_instructions_fn(video, caption)` (a VLM in
    the reference). One mp4 and one metadata JSON per (row, instruction);
    returns {(row, j): output shape}."""
    with open(args.meta_file_path, newline="") as f:
        n_rows = sum(1 for _ in csv.DictReader(f))
    pipe = None
    results = {}
    for vid in range(n_rows):
        args.video_id = vid
        instrs = instructions_per_video.get(vid)
        if instrs is None and generate_instructions_fn is not None:
            video_u8, _, caption = read_video_with_mask(
                args.meta_file_path, vid, args.data_root, args.height, args.width, args.fps)
            instrs = generate_instructions_fn(video_u8, caption)
        for j, instr in enumerate(instrs or []):
            pipe = pipe or _build(args)
            out = generate_edit(args, instr, llm_fn, first_frame_edit_fn,
                                tag=str(j) if len(instrs) > 1 else None, pipe=pipe)
            results[(vid, j)] = out.shape
    return results


def edit_bench_main(argv=None, llm_fn=None, first_frame_edit_fn=None,
                    generate_instructions_fn=None):
    """The CLI: `--instruction` for one edit of `--video_id`, or `--bench` to
    sweep the CSV with `--instructions_json` (video_id -> [instructions]);
    rows missing from it go to `generate_instructions_fn`, or get
    `--default_instruction`. Every other flag is infer.inpaint's."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--instruction", default=None)
    ap.add_argument("--instructions_json", default=None)
    ap.add_argument("--default_instruction", default=None)
    known, rest = ap.parse_known_args(argv)
    args = get_args(rest)

    if not known.bench:
        if known.instruction is None:
            raise SystemExit("--instruction is required without --bench")
        return generate_edit(args, known.instruction, llm_fn, first_frame_edit_fn)

    instrs = {}
    if known.instructions_json:
        with open(known.instructions_json) as f:
            instrs = {int(k): v for k, v in json.load(f).items()}
    if generate_instructions_fn is None and known.default_instruction:
        def generate_instructions_fn(video, caption):
            return [known.default_instruction]
    return run_edit_bench(args, instrs, llm_fn, first_frame_edit_fn, generate_instructions_fn)


def main(argv=None):
    return edit_bench_main(argv)


if __name__ == "__main__":
    main()
