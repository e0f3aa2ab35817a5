"""SAM2 single-image predictor and automatic mask generator.

Counterpart of `videopainter_tpu/segmentation/image_predictor.py` (reference
app/sam2/sam2_image_predictor.py set_image / predict, and
app/sam2/automatic_mask_generator.py: grid prompts, quality filters, box
NMS). Both share the video predictor's modules and weights (`SAM2Base`).

The generator keeps its candidate masks on the model's device; their
scores, boxes and the NMS go to the host, as in the JAX package. With
`min_mask_region_area > 0` each kept mask is repaired by
`native.get_connected_components` on the device tensor: two launches of the
connected-components kernel a kept mask on a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils import numerics
from .modules import resize_bilinear
from .predictor import SAM2Base, preprocess_frame


class SAM2ImagePredictor:
    def __init__(self, model: SAM2Base):
        self.model = model
        self.cfg = model.cfg
        self._features: Optional[dict] = None
        self._orig_hw: Optional[Tuple[int, int]] = None

    @torch.no_grad()
    def set_image(self, image: np.ndarray) -> None:
        """image [H, W, 3] uint8 or float [0, 1]; resized on the host (cv2
        INTER_AREA), encoded on the model's device."""
        self._orig_hw = tuple(image.shape[:2])
        img = preprocess_frame(image, self.cfg.image_size)
        x = torch.from_numpy(img).permute(2, 0, 1)[None].contiguous().to(self.model.device)
        self._features = self.model.encode_image(x)

    @torch.no_grad()
    def predict_tensors(self, point_coords: Optional[np.ndarray] = None,
                        point_labels: Optional[np.ndarray] = None,
                        box: Optional[np.ndarray] = None, multimask_output: bool = True):
        """(logits [K, H, W] at the image's size, iou [K], low-res logits
        [K, 4h, 4w]) as tensors on the model's device; coordinates in the
        original image's pixels."""
        if self._features is None:
            raise RuntimeError("call set_image first")
        with numerics.full_fp32():
            return self._predict(point_coords, point_labels, box, multimask_output)

    def _predict(self, point_coords, point_labels, box, multimask_output):
        cfg, m, dev = self.cfg, self.model, self.model.device
        feats = self._features
        top = feats["backbone_fpn"][-1]
        if cfg.directly_add_no_mem_embed:
            # sam2_image_predictor.py:100-101: the no-memory embedding is added
            # to the top-level feature, as in video training
            top = top + m.no_mem_embed.reshape(1, -1, 1, 1)
        scale = torch.tensor([cfg.image_size / self._orig_hw[1],
                              cfg.image_size / self._orig_hw[0]], dtype=torch.float32,
                             device=dev)
        pts = lbl = None
        if point_coords is not None:
            pts = torch.as_tensor(np.asarray(point_coords, np.float32), device=dev)[None] * scale
            lbl = torch.as_tensor(np.asarray(point_labels, np.int32), device=dev)[None]
        if box is not None:
            # the reference prepends the box as two corner points labelled 2
            # and 3 and passes no box, so the encoder pads
            # (sam2_image_predictor.py:303-316)
            bc = torch.as_tensor(np.asarray(box, np.float32), device=dev).reshape(1, 2, 2) * scale
            bl = torch.tensor([[2, 3]], dtype=torch.int32, device=dev)
            pts = bc if pts is None else torch.cat([bc, pts], 1)
            lbl = bl if lbl is None else torch.cat([bl, lbl], 1)
        sparse, dense = m.sam_prompt_encoder(points=(pts, lbl) if pts is not None else None)
        masks, iou, _, _ = m.sam_mask_decoder(
            top, m.sam_prompt_encoder.get_dense_pe(), sparse, dense,
            multimask_output=multimask_output, high_res_features=m.high_res_features(feats))
        full = resize_bilinear(masks, self._orig_hw)[0]
        return full, iou[0], masks[0]

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None, box: Optional[np.ndarray] = None,
                multimask_output: bool = True, return_logits: bool = False):
        """(masks [K, H, W] bool, or logits with return_logits; iou [K];
        low-res logits [K, 4h, 4w]) on the host."""
        full, iou, low = self.predict_tensors(point_coords, point_labels, box, multimask_output)
        full = full if return_logits else full > 0
        return full.cpu().numpy(), iou.cpu().numpy(), low.cpu().numpy()


# -- automatic mask generation ---------------------------------------------------------------

@dataclass
class AutoMaskConfig:
    points_per_side: int = 16
    pred_iou_thresh: float = 0.8
    stability_score_thresh: float = 0.9
    stability_offset: float = 1.0
    box_nms_thresh: float = 0.7
    min_mask_region_area: int = 0


def _mask_boxes(masks: torch.Tensor) -> torch.Tensor:
    """[K, H, W] bool -> [K, 4] int64 (x0, y0, x1, y1) of each mask; -1 where
    a mask is empty."""
    k, h, w = masks.shape
    rows, cols = masks.any(2), masks.any(1)
    ar_h = torch.arange(h, device=masks.device)
    ar_w = torch.arange(w, device=masks.device)
    big = max(h, w)
    y0 = torch.where(rows, ar_h, big).amin(1)
    y1 = torch.where(rows, ar_h, -1).amax(1)
    x0 = torch.where(cols, ar_w, big).amin(1)
    x1 = torch.where(cols, ar_w, -1).amax(1)
    box = torch.stack([x0, y0, x1, y1], 1)
    return torch.where(rows.any(1)[:, None], box, -1)


def _host_box(b: np.ndarray) -> np.ndarray:
    """Empty masks give [0, 0, 0, 0], as batched_mask_to_box."""
    return np.zeros(4, np.float32) if b[0] < 0 else b.astype(np.float32)


def _box_iou(a, b):
    x0 = max(a[0], b[0]); y0 = max(a[1], b[1])  # noqa: E702
    x1 = min(a[2], b[2]); y1 = min(a[3], b[3])  # noqa: E702
    inter = max(0, x1 - x0) * max(0, y1 - y0)
    area = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / area if area > 0 else 0.0


def _nms_keep(boxes: List[np.ndarray], scores: List[float], thresh: float) -> List[int]:
    """torchvision.ops.nms semantics: score-descending greedy (index
    tiebreak), suppressing IoU strictly above `thresh`."""
    order = sorted(range(len(boxes)), key=lambda i: (-scores[i], i))
    kept: List[int] = []
    for i in order:
        if all(_box_iou(boxes[i], boxes[j]) <= thresh for j in kept):
            kept.append(i)
    return kept


def _remove_small_regions(mask: torch.Tensor, area_thresh: int, mode: str):
    """sam2/utils/amg.py remove_small_regions on a [H, W] bool tensor: fill
    small holes or drop small islands (8-connectivity)."""
    from ..native import get_connected_components

    correct_holes = mode == "holes"
    working = (mask ^ correct_holes).to(torch.uint8)[None, None]
    labels, areas = get_connected_components(working)
    labels, areas = labels[0, 0], areas[0, 0]
    fg = working[0, 0] > 0
    small = fg & (areas < area_thresh)
    if not bool(small.any()):
        return mask, False
    if correct_holes:
        return mask | small, True
    # islands: keep the large ones; if none survives, the largest (reference fallback)
    keep = fg & ~small
    if not bool(keep.any()):
        best = labels[fg][torch.argmax(areas[fg])]
        keep = labels == best
    return keep, True


def _box_xyxy_to_xywh(box):
    return [float(box[0]), float(box[1]), float(box[2] - box[0]), float(box[3] - box[1])]


class SAM2AutomaticMaskGenerator:
    """Grid-prompted mask proposals with quality filters and box NMS.

    As the reference (app/sam2/automatic_mask_generator.py):
     - candidates in point-major, then mask-index order (the grid row-major,
       y outer);
     - the pred_iou filter is a strict `>`, applied only when its threshold
       is above 0 (:312);
     - NMS as torchvision's batched_nms with one category;
     - min_mask_region_area > 0 repairs each kept mask (fill holes, drop
       islands below the area), then NMS again preferring unchanged masks
       (score 1 against 0) (:186-190, :367-414);
     - the annotations carry an XYWH bbox and the crop box.
    """

    def __init__(self, predictor: SAM2ImagePredictor, cfg: AutoMaskConfig = AutoMaskConfig()):
        self.predictor = predictor
        self.cfg = cfg

    def generate(self, image: np.ndarray) -> List[dict]:
        self.predictor.set_image(image)
        h, w = image.shape[:2]
        n = self.cfg.points_per_side
        xs = (np.arange(n) + 0.5) / n * w
        ys = (np.arange(n) + 0.5) / n * h
        off = self.cfg.stability_offset
        candidates = []
        for y in ys:
            for x in xs:
                logits, ious, _ = self.predictor.predict_tensors(
                    point_coords=np.array([[x, y]], np.float32),
                    point_labels=np.array([1], np.int32), multimask_output=True)
                masks = logits > 0.0
                flat = logits.flatten(1)
                # stability from the full-size logits (amg.py calculate_stability_score)
                stats = torch.cat([(flat > off).sum(1, keepdim=True),
                                   (flat > -off).sum(1, keepdim=True), _mask_boxes(masks)], 1)
                stats, ious = stats.cpu().numpy(), ious.cpu().numpy()
                for k in range(masks.shape[0]):
                    if self.cfg.pred_iou_thresh > 0.0 and not ious[k] > self.cfg.pred_iou_thresh:
                        continue
                    hi, lo = stats[k, 0], stats[k, 1]
                    stab = float(hi / lo) if lo > 0 else 1.0
                    if self.cfg.stability_score_thresh > 0.0 and \
                            stab < self.cfg.stability_score_thresh:
                        continue
                    candidates.append({"segmentation": masks[k], "predicted_iou": float(ious[k]),
                                       "stability_score": stab, "box": _host_box(stats[k, 2:]),
                                       "point_coords": [[float(x), float(y)]]})
        keep = _nms_keep([c["box"] for c in candidates],
                         [c["predicted_iou"] for c in candidates], self.cfg.box_nms_thresh)
        kept = [candidates[i] for i in keep]
        if self.cfg.min_mask_region_area > 0:
            kept = self._postprocess_small_regions(kept, self.cfg.min_mask_region_area,
                                                   self.cfg.box_nms_thresh)
        anns = []
        for c in kept:
            seg = c["segmentation"].cpu().numpy()
            anns.append({"segmentation": seg, "area": int(seg.sum()),
                         "bbox": _box_xyxy_to_xywh(c["box"]),
                         "predicted_iou": c["predicted_iou"],
                         "point_coords": c["point_coords"],
                         "stability_score": c["stability_score"],
                         "crop_box": [0.0, 0.0, float(w), float(h)]})
        return anns

    @staticmethod
    def _postprocess_small_regions(kept: List[dict], min_area: int,
                                   nms_thresh: float) -> List[dict]:
        """Repair each mask, then NMS with score 1 for unchanged and 0 for
        changed masks, so that unchanged masks win duplicates."""
        if not kept:
            return kept
        new_masks, scores = [], []
        for c in kept:
            m, changed = _remove_small_regions(c["segmentation"], min_area, mode="holes")
            unchanged = not changed
            m, changed = _remove_small_regions(m, min_area, mode="islands")
            new_masks.append(m)
            scores.append(float(unchanged and not changed))
        boxes = [_host_box(b) for b in _mask_boxes(torch.stack(new_masks)).cpu().numpy()]
        out = []
        for i in _nms_keep(boxes, scores, nms_thresh):
            c = kept[i]
            if scores[i] == 0.0:   # changed: the repaired mask and its box
                c = dict(c, segmentation=new_masks[i], box=boxes[i])
            out.append(c)
        return out
