"""Training data pipeline: CSV-metadata video-inpainting dataset + collator.

Behavioral parity with the reference dataset/collator
(train/train_cogvideox_inpainting_i2v_video.py:650-1023):

 - CSV metadata rows: (path, start/end frame, fps, mask_id, caption); rows with
   caption length <= 50 or out-of-range duration filtered (:758-760)
 - per-sample `all_masks.npz` segmentation masks keyed by mask_id
 - fps-downsample to target fps (:735-736)
 - frame cropping to max_num_frames and 4k+1 trim (:873-884)
 - mask transform (training/masks.py) applied w.p. mask_transform_prob (:905)
 - masked video = video * (1 - mask); mix_train_ratio collapses a clip to a
   single-frame "image mode" sample (:931-932); first_frame_gt un-masks
   frame 0 (:934-939)
 - caption dropout with proportion_empty_prompts (:801-816)

Host-side (numpy); the port's own copy of `videopainter_tpu/training/data.py`.
Batches are dicts of float32 arrays in the channels-last layout. Video decode is
pluggable: cv2.VideoCapture (ffmpeg-backed) or image-directory globs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from .masks import MaskTransformConfig, transform_video_masks

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclass
class DataConfig:
    meta_file_path: str = ""
    instance_data_root: str = ""
    height: int = 480
    width: int = 720
    max_num_frames: int = 49
    fps: int = 8
    min_sec: float = 2.0
    max_sec: float = 60.0
    min_caption_len: int = 50
    mask_transform_prob: float = 0.3
    mask_cfg: MaskTransformConfig = field(default_factory=MaskTransformConfig)
    mix_train_ratio: float = 0.0
    first_frame_gt: bool = True
    mask_background: bool = False
    proportion_empty_prompts: float = 0.0
    seed: int = 0
    # reference long-tail flags (get_args train_...video.py:120-650)
    skip_frames_start: int = 0   # drop intro frames before fps-downsampling
    skip_frames_end: int = 0     # drop outro frames
    random_flip: bool = False    # horizontal flip augmentation (video+masks)
    video_reshape_mode: str = "resize"  # resize | center | random (crop)
    video_column: str = "path"
    caption_column: str = "caption"
    id_token: Optional[str] = None  # prepended to every prompt


def read_video_frames(path: str, start: int = 0, end: Optional[int] = None,
                      stride: int = 1) -> np.ndarray:
    """Decode frames [T, H, W, 3] uint8 RGB via cv2 (ffmpeg backend) or an
    image directory."""
    if os.path.isdir(path):
        files = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        files = files[start:end:stride]
        frames = [cv2.cvtColor(cv2.imread(os.path.join(path, f)), cv2.COLOR_BGR2RGB)
                  for f in files]
        return np.stack(frames)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = []
    idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if idx >= start and (end is None or idx < end) and (idx - start) % stride == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        idx += 1
        if end is not None and idx >= end:
            break
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def resize_video(video: np.ndarray, height: int, width: int) -> np.ndarray:
    if video.shape[1] == height and video.shape[2] == width:
        return video
    return np.stack([cv2.resize(f, (width, height), interpolation=cv2.INTER_AREA)
                     for f in video])


def reshape_video(video: np.ndarray, masks: Optional[np.ndarray],
                  height: int, width: int, mode: str,
                  rng: Optional[np.random.Generator] = None):
    """--video_reshape_mode: 'resize' stretches; 'center'/'random' scale the
    short side then crop (reference _resize_for_rectangle_crop,
    train_...video.py:826-858). Masks crop with the same window
    (nearest-resized)."""
    if mode == "resize" or (video.shape[1] == height and video.shape[2] == width):
        out_v = resize_video(video, height, width)
        out_m = masks
        if masks is not None and (masks.shape[1] != height or masks.shape[2] != width):
            out_m = np.stack([cv2.resize(m.astype(np.uint8), (width, height),
                                         interpolation=cv2.INTER_NEAREST)
                              for m in masks])
        return out_v, out_m
    h0, w0 = video.shape[1:3]
    scale = max(height / h0, width / w0)
    nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
    v = np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_AREA)
                  for f in video])
    m = None
    if masks is not None:
        m = np.stack([cv2.resize(mk.astype(np.uint8), (nw, nh),
                                 interpolation=cv2.INTER_NEAREST)
                      for mk in masks])
    if mode == "center":
        top, left = (nh - height) // 2, (nw - width) // 2
    elif mode == "random":
        r = rng or np.random.default_rng()
        top = int(r.integers(0, nh - height + 1))
        left = int(r.integers(0, nw - width + 1))
    else:
        raise ValueError(f"unknown video_reshape_mode {mode!r}: "
                         "resize|center|random")
    v = v[:, top:top + height, left:left + width]
    if m is not None:
        m = m[:, top:top + height, left:left + width]
    return v, m


class VideoInpaintingDataset:
    """CSV-driven dataset. Each sample: decoded clip + per-frame binary masks.

    CSV columns (reference train_...video.py:650-770): `path`, `fps`,
    `start_frame`, `end_frame`, `mask_id`, `caption`; masks at
    `<video_dir>/all_masks.npz` (or a `mask_path` column).
    """

    def __init__(self, cfg: DataConfig):
        import pandas as pd

        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        df = pd.read_csv(cfg.meta_file_path)
        rows = []
        for _, r in df.iterrows():
            caption = str(r.get(cfg.caption_column, ""))
            if len(caption) <= cfg.min_caption_len:
                continue
            fps = float(r.get("fps", cfg.fps))
            start = int(r.get("start_frame", 0))
            end = int(r.get("end_frame", 0)) or None
            if end is not None and fps > 0:
                dur = (end - start) / fps
                if not (cfg.min_sec <= dur <= cfg.max_sec):
                    continue
            rows.append(dict(path=str(r[cfg.video_column]), fps=fps,
                             start=start, end=end,
                             mask_id=r.get("mask_id", 0),
                             mask_path=r.get("mask_path", None),
                             caption=caption))
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i: int) -> Dict:
        cfg = self.cfg
        r = self.rows[i]
        path = os.path.join(cfg.instance_data_root, r["path"]) \
            if cfg.instance_data_root else r["path"]
        stride = max(1, int(round(r["fps"] / cfg.fps))) if r["fps"] else 1
        start = (r["start"] or 0) + cfg.skip_frames_start
        end = r["end"]
        if end is not None and cfg.skip_frames_end:
            end = max(end - cfg.skip_frames_end, start + 1)
        video = read_video_frames(path, start, end, stride)
        if end is None and cfg.skip_frames_end:
            # open-ended clip: trim the decoded tail (skip counted in source
            # frames, so divide by the fps-downsample stride)
            drop = -(-cfg.skip_frames_end // stride)
            video = video[:max(len(video) - drop, 1)]

        mask_path = r["mask_path"] or os.path.join(os.path.dirname(path),
                                                   "all_masks.npz")
        with np.load(mask_path) as npz:
            key = str(r["mask_id"]) if str(r["mask_id"]) in npz.files else npz.files[0]
            masks = npz[key]
        if masks.ndim == 4:
            masks = masks[..., 0]
        masks = masks[start::stride][: len(video)]
        video, masks = reshape_video(video, masks, cfg.height, cfg.width,
                                     cfg.video_reshape_mode, self.rng)
        return {"video": video, "masks": (masks > 0).astype(np.uint8),
                "caption": r["caption"]}


class InpaintingCollator:
    """Crop/trim + mask augmentation + masked-video construction.

    Produces batches in our layout: pixel_values [B, T, H, W, 3] float32 in
    [-1, 1]; conditioning_pixel_values same; masks [B, T, H, W] float32;
    prompts list[str].
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def _trim(self, video: np.ndarray, masks: np.ndarray):
        cfg = self.cfg
        t = min(len(video), cfg.max_num_frames)
        t = ((t - 1) // 4) * 4 + 1  # 4k+1 (reference :873-884)
        return video[:t], masks[:t]

    def __call__(self, samples: List[Dict]) -> Dict:
        cfg = self.cfg
        videos, conds, masks_out, prompts = [], [], [], []
        for s in samples:
            video, masks = self._trim(s["video"], s["masks"])
            if self.rng.random() < cfg.mix_train_ratio:
                video, masks = video[:1], masks[:1]  # image mode (:931-932)
            if cfg.random_flip and self.rng.random() < 0.5:
                video = video[:, :, ::-1]  # horizontal flip (video + masks)
                masks = masks[:, :, ::-1]
            if self.rng.random() < cfg.mask_transform_prob:
                masks = transform_video_masks(
                    np.ascontiguousarray(masks), cfg.mask_cfg, self.rng)
            masks = masks.astype(np.float32)
            if cfg.first_frame_gt:
                masks[0] = 0.0  # frame 0 keeps GT (:934-939)
            v = video.astype(np.float32) / 127.5 - 1.0
            keep = (masks < 0.5) if not cfg.mask_background else (masks >= 0.5)
            cond = v * keep[..., None]
            prompt = s["caption"]
            if cfg.id_token:
                prompt = f"{cfg.id_token} {prompt}"
            if self.rng.random() < cfg.proportion_empty_prompts:
                prompt = ""
            videos.append(v)
            conds.append(cond)
            masks_out.append(masks)
            prompts.append(prompt)
        return {
            "pixel_values": np.stack(videos),
            "conditioning_pixel_values": np.stack(conds),
            "masks": np.stack(masks_out),
            "prompts": prompts,
        }


def data_loader(dataset: VideoInpaintingDataset, collator: InpaintingCollator,
                batch_size: int, *, shuffle: bool = True,
                seed: int = 0, drop_last: bool = True,
                yield_indices: bool = False) -> Iterator[Dict]:
    """Simple epoch iterator (the reference relies on torch DataLoader with a
    single worker, README.md:95 — host decode is not the bottleneck).
    yield_indices=True yields (batch, row_indices) — the key the trainer's
    latent-moments cache uses."""
    if len(dataset) == 0:
        raise ValueError(
            "dataset is empty after filtering - check meta CSV paths, the "
            "caption-length filter (min_caption_len), and duration bounds")
    rng = np.random.default_rng(seed)
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        for i in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                       batch_size):
            idx = order[i:i + batch_size]
            batch = collator([dataset[j] for j in idx])
            yield (batch, idx.tolist()) if yield_indices else batch
