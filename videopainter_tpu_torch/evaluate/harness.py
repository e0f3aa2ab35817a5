"""Inpainting evaluation harness.

Counterpart of `videopainter_tpu/evaluate/harness.py` (the reference's
evaluate/eval_inpainting.py main_worker :81-510):
 - per video: run the any-length pipeline (50 steps, 49-frame windows),
   optional replace_gt compositing, then the per-frame metrics (:400-448),
   here batched over the video's frames on the eval device
 - per-frame wall-clock accounting: time_i = (t_end - t_start) / video_length,
   corpus-averaged (:378-380, :495); the device is synchronised before the
   clock is read
 - incremental results CSV with per-video rows + running averages (:115-127),
   written with the csv module
 - idempotent resume: videos whose comp_frames/ output already exists are
   skipped (:243-262)
 - I3D activations accumulated across the corpus for a final FVID (:451-456)

The CSV and its `__average__` row are the JAX harness's, its resume quirk
included: a resumed run reads every row back, the average row too, so that
row joins the later means (after a partial run the first videos weigh twice).
"""

from __future__ import annotations

import csv
import math
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .metrics import MetricsCalculator

AVERAGE_ROW = "__average__"


def load_frames_dir(path: str, height: int, width: int) -> np.ndarray:
    """The image files of a directory ([T, H, W, 3] uint8 RGB), each resized
    to height x width (INTER_AREA)."""
    from ..training.data import read_video_frames, resize_video

    return resize_video(read_video_frames(path), height, width)


def save_frames(video01: np.ndarray, out_dir: str) -> None:
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(video01):
        cv2.imwrite(os.path.join(out_dir, f"{i:05d}.png"),
                    cv2.cvtColor((f * 255).clip(0, 255).astype(np.uint8), cv2.COLOR_RGB2BGR))


@dataclass
class EvalConfig:
    output_dir: str = "eval_out"
    num_inference_steps: int = 50
    num_frames: int = 49
    stride: Optional[int] = None
    guidance_scale: float = 6.0
    use_dynamic_cfg: bool = True
    replace_gt: bool = True
    mask_add: bool = True
    prev_clip_weight: float = 0.0
    composite_with_gt: bool = True   # paste GT background over the output
    resume: bool = True
    seed: int = 42
    max_videos: Optional[int] = None


# -- results.csv (the columns pandas would write: union of the rows' keys in
# order of appearance; NaN as an empty cell) ------------------------------------

def _columns(rows: List[Dict]) -> List[str]:
    cols: Dict[str, None] = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _cell(v) -> str:
    return "" if isinstance(v, float) and math.isnan(v) else str(v)


def _parse(v: str):
    if v == "":
        return float("nan")
    try:
        return float(v)
    except ValueError:
        return v


def column_means(rows: List[Dict]) -> Dict[str, float]:
    """Mean of each numeric column over the rows, NaN and missing cells
    skipped (pandas' `mean(numeric_only=True)`)."""
    out = {}
    for k in _columns(rows):
        vals = [r.get(k, float("nan")) for r in rows]
        if k == "name" or not all(isinstance(v, (int, float)) for v in vals):
            continue
        vals = [float(v) for v in vals if not math.isnan(v)]
        out[k] = float(np.mean(vals)) if vals else float("nan")
    return out


def write_rows(path: str, rows: List[Dict]) -> None:
    cols = _columns(rows)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows([[_cell(r.get(k, float("nan"))) for k in cols] for r in rows])


def read_rows(path: str) -> List[Dict]:
    """The rows of a results.csv; every cell but `name` as a number."""
    with open(path, newline="") as f:
        return [{k: (v if k == "name" else _parse(v)) for k, v in r.items()}
                for r in csv.DictReader(f)]


def run_inpainting_eval(pipe, dataset: Iterable[Dict], cfg: EvalConfig,
                        metrics: Optional[MetricsCalculator] = None,
                        encode_prompt_fn=None, caption_fn=None,
                        device=None) -> Dict[str, float]:
    """Evaluate `pipe` over `dataset` rows {name, video [T,H,W,3] uint8,
    masks [T,H,W] {0,1}, caption}.

    `pipe` is any callable taking the port's any-length pipeline keywords
    (bind others, e.g. `use_flash` or `dtype`, with functools.partial); it
    is called with `output_type="pt"`, so compositing and metrics stay on
    `device` (CUDA unless given); one copy goes to the host for the frames
    written to comp_frames/.

    caption_fn(video_u8, masks) -> str fills in captions for samples that
    have none — the reference runs a CogVLM2 captioner here
    (evaluate/metrics.py:621-725); external 19B model, so pluggable.

    Returns the corpus-average metric dict; writes results.csv incrementally.
    """
    dev = resolve_device(device)
    metrics = metrics or MetricsCalculator()
    os.makedirs(cfg.output_dir, exist_ok=True)
    csv_path = os.path.join(cfg.output_dir, "results.csv")
    rows: List[Dict] = []
    if cfg.resume and os.path.exists(csv_path):
        rows = read_rows(csv_path)
    done = {r["name"] for r in rows}

    n_done = 0
    for sample in dataset:
        if cfg.max_videos and n_done >= cfg.max_videos:
            break
        name = str(sample["name"])
        comp_dir = os.path.join(cfg.output_dir, "comp_frames", name)
        if cfg.resume and name in done and os.path.isdir(comp_dir):
            n_done += 1
            continue

        if caption_fn is not None and not sample.get("caption"):
            sample = dict(sample)
            sample["caption"] = caption_fn(sample["video"], sample["masks"])

        t_total = len(sample["video"])
        # trim to a valid any-length frame count
        num_frames = min(cfg.num_frames, (t_total - 1) // 4 * 4 + 1)
        stride = cfg.stride or num_frames
        usable = num_frames + ((t_total - num_frames) // stride) * stride
        video01 = torch.from_numpy(np.ascontiguousarray(sample["video"][:usable])).to(
            dev).float() / 255.0
        masks = torch.from_numpy(np.ascontiguousarray(sample["masks"][:usable])).to(dev).float()

        video = video01 * 2 - 1
        image = video[0] * (1 - masks[0][..., None])

        if encode_prompt_fn is not None:
            embeds, neg = encode_prompt_fn(sample.get("caption", ""))
        else:
            raise ValueError("encode_prompt_fn required (supply T5 embeds)")

        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.time()
        out = pipe(image=image[None], video=video[None], masks=masks[None],
                   num_frames=num_frames, stride=stride,
                   prompt_embeds=embeds, negative_prompt_embeds=neg,
                   num_inference_steps=cfg.num_inference_steps,
                   guidance_scale=cfg.guidance_scale,
                   use_dynamic_cfg=cfg.use_dynamic_cfg,
                   replace_gt=cfg.replace_gt, mask_add=cfg.mask_add,
                   prev_clip_weight=cfg.prev_clip_weight,
                   generator=torch.Generator(device=dev).manual_seed(cfg.seed),
                   output_type="pt")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        gen_time = time.time() - t0
        pred01 = (out[0].float() / 2 + 0.5).clamp(0, 1)
        n = len(pred01)

        if cfg.composite_with_gt:
            m = masks[:n, ..., None]
            pred01 = pred01 * m + video01[:n] * (1 - m)

        save_frames(pred01.cpu().numpy(), comp_dir)

        frame_rows = metrics.video_frame_metrics(pred01, video01[:n], masks=masks[:n],
                                                 caption=sample.get("caption"))
        vid_metrics = {k: float(np.mean([fr[k] for fr in frame_rows if np.isfinite(fr[k])]))
                       for k in frame_rows[0]}
        vid_metrics.update(metrics.video_metrics(pred01, masks=masks[:n]))
        metrics.accumulate_fvid(pred01, video01[:n])
        vid_metrics["time_per_frame_s"] = gen_time / n
        vid_metrics["name"] = name
        rows.append(vid_metrics)
        n_done += 1

        # incremental CSV with running averages (reference :115-127)
        write_rows(csv_path, rows + [{**column_means(rows), "name": AVERAGE_ROW}])

    fvid = metrics.compute_fvid()
    summary = column_means(rows)
    if fvid is not None:
        summary["fvid"] = fvid
    return summary
