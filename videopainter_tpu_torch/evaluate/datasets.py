"""Evaluation datasets: DAVIS (frame dirs + PNG masks) and VPBench (CSV+NPZ).

Counterpart of `videopainter_tpu/evaluate/datasets.py` (the reference's
evaluate/dataset.py DavisTestDataset :44-117, frame directories + per-frame
mask PNGs with optional binary dilation; OurTestDataset / VPBench :119-…,
CSV metadata + all_masks.npz). Host readers on cv2 and the csv module, built
on the port's `training/data.py` decoders; each yields {name, video [T, H, W,
3] uint8, masks [T, H, W] uint8 {0, 1}, caption}.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


def dilate_mask(mask: np.ndarray, iterations: int) -> np.ndarray:
    """Binary dilation with a 3x3 kernel, `iterations` times (reference uses
    scipy binary_dilation / cv2.dilate with dilate_size sweeps {0,16,32})."""
    if iterations <= 0:
        return mask
    import cv2

    return cv2.dilate(mask.astype(np.uint8), np.ones((3, 3), np.uint8), iterations=iterations)


def _binary_resized(m: np.ndarray, height: int, width: int, iterations: int) -> np.ndarray:
    import cv2

    m = cv2.resize((m > 0).astype(np.uint8), (width, height), interpolation=cv2.INTER_NEAREST)
    return dilate_mask(m, iterations)


@dataclass
class DavisTestDataset:
    """root/JPEGImages/<video>/*.jpg + root/Annotations/<video>/*.png."""

    root: str
    height: int = 480
    width: int = 720
    dilate_iterations: int = 0
    image_dir: str = "JPEGImages/480p"
    mask_dir: str = "Annotations/480p"

    def videos(self):
        d = os.path.join(self.root, self.image_dir)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    def __iter__(self) -> Iterator[Dict]:
        import cv2

        from .harness import load_frames_dir

        for name in self.videos():
            frames = load_frames_dir(os.path.join(self.root, self.image_dir, name),
                                     self.height, self.width)
            mdir = os.path.join(self.root, self.mask_dir, name)
            masks = [_binary_resized(cv2.imread(os.path.join(mdir, f), cv2.IMREAD_GRAYSCALE),
                                     self.height, self.width, self.dilate_iterations)
                     for f in sorted(os.listdir(mdir))[: len(frames)]]
            yield {"name": name, "video": frames, "masks": np.stack(masks), "caption": ""}


@dataclass
class VPBenchDataset:
    """CSV rows (path, mask_id, caption, [start/end]) + NPZ masks per video."""

    meta_file_path: str
    data_root: str = ""
    height: int = 480
    width: int = 720
    dilate_iterations: int = 0
    max_videos: Optional[int] = None

    def __iter__(self) -> Iterator[Dict]:
        import cv2  # noqa: F401  (fails by name here: training.data reads it optionally)

        from ..training.data import read_video_frames, resize_video

        with open(self.meta_file_path, newline="") as f:
            rows = list(csv.DictReader(f))
        if self.max_videos:
            rows = rows[: self.max_videos]
        for i, r in enumerate(rows):
            path = os.path.join(self.data_root, r["path"]) if self.data_root else r["path"]
            video = read_video_frames(path, int(float(r.get("start_frame") or 0)),
                                      int(float(r.get("end_frame") or 0)) or None)
            video = resize_video(video, self.height, self.width)
            mask_path = r.get("mask_path") or os.path.join(os.path.dirname(path),
                                                            "all_masks.npz")
            mask_id = r.get("mask_id") or "0"
            with np.load(mask_path) as npz:
                masks = npz[mask_id if mask_id in npz.files else npz.files[0]]
            if masks.ndim == 4:
                masks = masks[..., 0]
            masks = np.stack([_binary_resized(m, self.height, self.width,
                                              self.dilate_iterations)
                              for m in masks[: len(video)]])
            yield {"name": f"{i:04d}", "video": video, "masks": masks,
                   "caption": r.get("caption") or ""}
