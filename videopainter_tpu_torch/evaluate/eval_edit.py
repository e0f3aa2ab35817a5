"""Editing evaluation: CLIP-alignment metrics over edited videos.

Counterpart of `videopainter_tpu/evaluate/eval_edit.py` (the reference's
evaluate/eval_edit.py): per edited sample it scores instruction alignment
(CLIP score of the edited region vs the edited caption), temporal
consistency, and background preservation (PSNR / SSIM outside the mask,
since the background must be untouched by an edit). The metrics run batched
over the video's frames on the eval device.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .harness import column_means, read_rows, write_rows
from .metrics import (MetricsCalculator, as_tensor, call_batched, frame_psnr, frame_ssim,
                      temporal_consistency)


@dataclass
class EditEvalConfig:
    output_dir: str = "edit_eval_out"
    resume: bool = True


def edit_sample_metrics(edited01, source01, masks, edited_caption: str,
                        metrics: MetricsCalculator, device=None) -> Dict[str, float]:
    """Per-video editing metrics.

    edited01/source01: [T, H, W, 3] in [0,1]; masks [T, H, W] (1 = edited
    region). Arrays go to `device` (CUDA unless given); tensors stay where
    they are."""
    dev = edited01.device if isinstance(edited01, torch.Tensor) else resolve_device(device)
    edited01 = as_tensor(edited01, dev)
    source01, masks = as_tensor(source01, dev), as_tensor(masks, dev)
    out: Dict[str, float] = {}
    inv = (1 - masks)[..., None]
    # background preservation (outside the edit)
    bg_psnr = frame_psnr(edited01 * inv, source01 * inv).tolist()
    bg_ssim = frame_ssim(edited01 * inv, source01 * inv).tolist()
    out["background_psnr"] = float(np.mean([v for v in bg_psnr if np.isfinite(v)]
                                           or [np.inf]))
    out["background_ssim"] = float(np.mean(bg_ssim))
    # instruction alignment
    if metrics.text_image_score_fn is not None and edited_caption:
        scores = call_batched(metrics.text_image_score_fn, (edited01,), edited_caption)
        m_scores = call_batched(metrics.text_image_score_fn,
                                (edited01 * masks[..., None],), edited_caption)
        out["clip_score"] = float(np.mean([float(s) for s in scores]))
        out["masked_clip_score"] = float(np.mean([float(s) for s in m_scores]))
    # temporal consistency of the edit
    if metrics.image_embed_fn is not None:
        embeds = torch.stack([as_tensor(e, dev) for e in
                              call_batched(metrics.image_embed_fn, (edited01,))])
        out["temporal_consistency"] = temporal_consistency(embeds)
    return out


def run_edit_eval(samples: Iterable[Dict], cfg: EditEvalConfig,
                  metrics: Optional[MetricsCalculator] = None,
                  device=None) -> Dict[str, float]:
    """samples: dicts {name, edited [T,H,W,3] float01, source, masks,
    edited_caption}. Writes incremental results.csv; returns averages."""
    metrics = metrics or MetricsCalculator()
    os.makedirs(cfg.output_dir, exist_ok=True)
    csv_path = os.path.join(cfg.output_dir, "results.csv")
    rows: List[Dict] = []
    if cfg.resume and os.path.exists(csv_path):
        rows = read_rows(csv_path)
    done = {r["name"] for r in rows}

    for s in samples:
        if s["name"] in done:
            continue
        t0 = time.time()
        m = edit_sample_metrics(s["edited"], s["source"], s["masks"],
                                s.get("edited_caption", ""), metrics, device=device)
        m["time_s"] = time.time() - t0
        m["name"] = s["name"]
        rows.append(m)
        write_rows(csv_path, rows)
    return column_means(rows)
