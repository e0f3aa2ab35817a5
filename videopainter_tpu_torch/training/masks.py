"""Training-mask synthesis: segmentation masks → diverse inpainting masks.

Behavioral parity with train/mask_process.py (generate_random_brush :8-58,
transform_video_masks :60-215): one transform family sampled per video and
held constant across frames —

  brush        morphological dilate/erode combos with a 32x32 kernel,
               optional light Gaussian blur+rebinarize
  rect         oriented rectangle fitted to the mask bbox with margin jitter
  ellipse      oriented ellipse fitted to the bbox
  circle       circle fitted to the bbox
  random_brush free polyline strokes (width 128-256) with端-cap disks,
               random flips

Host-side numpy/cv2 (data-pipeline work, never on the card); the port's own copy
of `videopainter_tpu/training/masks.py`. Fresh implementation
with an explicit np.random.Generator for reproducible data pipelines.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


@dataclass(frozen=True)
class MaskTransformConfig:
    p_brush: float = 0.25
    p_rect: float = 0.25
    p_ellipse: float = 0.2
    p_circle: float = 0.2
    p_random_brush: float = 0.1
    margin_ratio: float = 0.1
    shape_scale_min: float = 1.1
    shape_scale_max: float = 1.5
    brush_kernel: int = 32
    brush_iterations: int = 1
    brush_width_range: tuple = (128, 256)


def random_brush_mask(h: int, w: int, rng: np.random.Generator,
                      width_range=(128, 256)) -> np.ndarray:
    """Free-form polyline stroke mask [H, W] uint8 {0,1}."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", (w, h), 0)
    avg_radius = math.sqrt(h * h + w * w) / 8
    mean_angle = 2 * math.pi / 5
    angle_spread = 2 * math.pi / 15
    n_strokes = rng.choice(5, p=[0.05, 0.3, 0.3, 0.3, 0.05])
    for _ in range(n_strokes):
        n_vertex = rng.integers(1, 8)
        a_min = mean_angle - rng.uniform(0, angle_spread)
        a_max = mean_angle + rng.uniform(0, angle_spread)
        pts = [(int(rng.integers(0, w)), int(rng.integers(0, h)))]
        for i in range(n_vertex):
            ang = (2 * math.pi - rng.uniform(a_min, a_max) if i % 2 == 0
                   else rng.uniform(a_min, a_max))
            r = float(np.clip(rng.normal(avg_radius, avg_radius / 2), 0, 2 * avg_radius))
            pts.append((int(np.clip(pts[-1][0] + r * math.cos(ang), 0, w)),
                        int(np.clip(pts[-1][1] + r * math.sin(ang), 0, h))))
        width = int(rng.uniform(*width_range))
        draw = ImageDraw.Draw(mask)
        draw.line(pts, fill=1, width=width)
        for x, y in pts:
            draw.ellipse((x - width // 2, y - width // 2,
                          x + width // 2, y + width // 2), fill=1)
    out = np.asarray(mask, np.uint8)
    if rng.random() > 0.5:
        out = np.flip(out, 0)
    if rng.random() > 0.5:
        out = np.flip(out, 1)
    return np.ascontiguousarray(out)


def _bbox_with_jitter(mask2d: np.ndarray, margin_ratio: float,
                      rng: np.random.Generator):
    ys, xs = np.where(mask2d > 0)
    if len(ys) == 0:
        return None
    h, w = mask2d.shape
    margin = int(min(h, w) * margin_ratio)
    j = lambda: int(rng.integers(0, max(margin, 1)))
    x0 = max(0, xs.min() - j())
    x1 = min(w, xs.max() + j())
    y0 = max(0, ys.min() - j())
    y1 = min(h, ys.max() + j())
    return x0, x1, y0, y1


def transform_video_masks(video_masks: np.ndarray,
                          cfg: MaskTransformConfig = MaskTransformConfig(),
                          rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """[F, H, W] or [F, H, W, C] uint8/float {0,1} → same shape, one transform
    family applied consistently across frames."""
    if cv2 is None:
        raise ImportError("mask synthesis requires cv2")
    rng = rng or np.random.default_rng()
    squeeze = video_masks.ndim == 3
    vm = video_masks[..., None] if squeeze else video_masks
    f, h, w, c = vm.shape
    out = np.zeros_like(vm)

    choice = rng.choice(["brush", "rect", "ellipse", "circle", "random_brush"],
                        p=[cfg.p_brush, cfg.p_rect, cfg.p_ellipse, cfg.p_circle,
                           cfg.p_random_brush])

    static_shape = None
    if choice == "random_brush":
        static_shape = random_brush_mask(h, w, rng, cfg.brush_width_range)
    elif choice in ("rect", "ellipse", "circle"):
        bbox = _bbox_with_jitter(vm[0, :, :, 0], cfg.margin_ratio, rng)
        if bbox is None:
            return video_masks
        x0, x1, y0, y1 = bbox
        cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
        bw, bh = x1 - x0, y1 - y0
        static_shape = np.zeros((h, w), np.uint8)
        if choice == "rect":
            sx = rng.uniform(cfg.shape_scale_min, cfg.shape_scale_max)
            sy = rng.uniform(cfg.shape_scale_min, cfg.shape_scale_max)
            angle = rng.uniform(0, 360)
            box = cv2.boxPoints(((float(cx), float(cy)),
                                 (float(bw * sx), float(bh * sy)),
                                 float(angle))).astype(np.int32)
            cv2.fillPoly(static_shape, [box], 1)
        elif choice == "ellipse":
            sx = rng.uniform(cfg.shape_scale_min / 2, cfg.shape_scale_max / 2)
            sy = rng.uniform(cfg.shape_scale_min / 2, cfg.shape_scale_max / 2)
            angle = rng.uniform(0, 360)
            cv2.ellipse(static_shape, (cx, cy), (int(bw * sx), int(bh * sy)),
                        angle, 0, 360, 1, -1)
        else:
            sr = rng.uniform(cfg.shape_scale_min / 2, cfg.shape_scale_max / 2)
            cv2.circle(static_shape, (cx, cy), int(max(bw, bh) * sr), 1, -1)

    morph_type = None
    use_blur = False
    if choice == "brush":
        morph_type = rng.choice(["dilate_erode", "erode_dilate", "dilate_only",
                                 "combined"])
        use_blur = rng.random() < 0.1
        kernel = np.ones((cfg.brush_kernel, cfg.brush_kernel), np.uint8)
        it = cfg.brush_iterations

    for i in range(f):
        if static_shape is not None:
            frame = static_shape
        else:  # brush morphology on the per-frame segmentation
            m = vm[i, :, :, 0].astype(np.uint8)
            if morph_type == "dilate_erode":
                frame = cv2.erode(cv2.dilate(m, kernel, iterations=it), kernel,
                                  iterations=it)
            elif morph_type == "erode_dilate":
                frame = cv2.dilate(cv2.erode(m, kernel, iterations=it), kernel,
                                   iterations=it)
            elif morph_type == "dilate_only":
                frame = cv2.dilate(m, kernel, iterations=it)
            else:
                opened = cv2.dilate(cv2.erode(m, kernel, iterations=it), kernel,
                                    iterations=it)
                frame = cv2.erode(cv2.dilate(opened, kernel, iterations=it),
                                  kernel, iterations=it)
            if use_blur:
                frame = cv2.GaussianBlur(frame, (3, 3), 0)
                frame = (frame > 0.5).astype(np.uint8)
        out[i, :, :, 0] = frame
        out[i, :, :, 1:] = frame[..., None]

    return out[..., 0] if squeeze else out

