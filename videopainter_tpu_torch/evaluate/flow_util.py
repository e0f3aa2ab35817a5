"""Optical-flow utilities: EPE, flow warping, flow visualization.

Counterpart of `videopainter_tpu/evaluate/flow_util.py` (the reference's
evaluate/flow_util.py; EPE util cited at metrics.py:41). `warp_with_flow` and
`flow_warping_error` run where their tensors lie (the eval device), written
with explicit gathers and the JAX package's clamping (`grid_sample` treats
the border otherwise); the flow I/O, visualization and quantization helpers
are host numpy, as there. Flow estimation itself is an external model (RAFT
et al.): plug any `flow_fn(frame0, frame1) -> [H, W, 2]`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .metrics import as_tensor


def endpoint_error(flow_pred: np.ndarray, flow_gt: np.ndarray,
                   valid: Optional[np.ndarray] = None) -> float:
    """Mean EPE between [H, W, 2] flows."""
    err = np.sqrt(((flow_pred - flow_gt) ** 2).sum(-1))
    if valid is not None:
        err = err[valid > 0]
    return float(err.mean()) if err.size else 0.0


def warp_with_flow(image, flow) -> torch.Tensor:
    """Backward-warp image [H, W, C] with flow [H, W, 2] (bilinear, clamped)
    on the image's device. The bilinear weights are float64 (numpy's
    float32 - int64 promotion in the JAX package); the result is the image's
    dtype (float32 for uint8)."""
    image = as_tensor(image)
    flow = as_tensor(flow, image.device)
    h, w = flow.shape[:2]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image.device),
                            torch.arange(w, dtype=torch.float32, device=image.device),
                            indexing="ij")
    x = torch.clamp(gx + flow[..., 0], 0, w - 1)
    y = torch.clamp(gy + flow[..., 1], 0, h - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    wx = (x.double() - x0)[..., None]
    wy = (y.double() - y0)[..., None]
    img = image.float()
    out = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
           + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
    return out.to(torch.float32 if image.dtype == torch.uint8 else image.dtype)


def flow_warping_error(frames01, flow_fn: Callable, masks=None) -> float:
    """Temporal warping error: mean |warp(f_{t+1}, flow_{t->t+1}) - f_t|
    over consecutive frames (a flow-based temporal-consistency metric)."""
    frames01 = as_tensor(frames01)
    errs = []
    for t in range(len(frames01) - 1):
        flow = flow_fn(frames01[t], frames01[t + 1])
        warped = warp_with_flow(frames01[t + 1], flow)
        e = (warped - frames01[t]).abs()
        if masks is not None:
            m = as_tensor(masks[t], e.device)[..., None] > 0
            e = e[m.expand(e.shape)]
        errs.append(float(e.mean()))
    return float(np.mean(errs)) if errs else 0.0


def flow_to_color(flow: np.ndarray) -> np.ndarray:
    """Standard HSV flow visualization -> [H, W, 3] uint8."""
    import cv2

    mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1])
    hsv = np.zeros((*flow.shape[:2], 3), np.uint8)
    hsv[..., 0] = (ang * 180 / np.pi / 2).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)


# ---------------------------------------------------------------------------
# flow IO / quantization, host numpy (reference flow_util.py:6-195)
# ---------------------------------------------------------------------------

def resize_flow(flow: np.ndarray, newh: int, neww: int) -> np.ndarray:
    """Bilinear-resize a [H, W, 2] flow and rescale its magnitudes (:6-11)."""
    import cv2

    oldh, oldw = flow.shape[:2]
    flow = cv2.resize(flow, (neww, newh), interpolation=cv2.INTER_LINEAR)
    flow = flow.copy()
    flow[:, :, 0] *= neww / oldw
    flow[:, :, 1] *= newh / oldh
    return flow


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """[min_val, max_val] -> [0, levels-1] (reference :152-174)."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer, but got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val)).astype(dtype),
                      levels - 1)


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """Inverse of quantize, mid-riser (reference :176-195)."""
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f"levels must be a positive integer, but got {levels}")
    if min_val >= max_val:
        raise ValueError(f"min_val ({min_val}) must be smaller than max_val ({max_val})")
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val


def quantize_flow(flow: np.ndarray, max_val: float = 0.02, norm: bool = True):
    """Flow -> two uint8 maps for jpeg dumping (reference :102-125)."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8) for d in (dx, dy))


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 0.02,
                    denorm: bool = True) -> np.ndarray:
    """Inverse of quantize_flow (reference :128-149 — including its quirk of
    denormalizing BOTH components by dx's shape after reassignment)."""
    assert dx.shape == dy.shape
    assert dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def flowread(flow_path: str, quantize_pair: bool = False, concat_axis: int = 0,
             *args, **kwargs) -> np.ndarray:
    """Read a .flo file (PIEH header, float16 payload — the reference's
    space-saving variant, :62) or a quantized jpeg pair (:28-65)."""
    import cv2

    if quantize_pair:
        assert concat_axis in (0, 1)
        cat_flow = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if cat_flow.ndim != 2:
            raise IOError(f"{flow_path} is not a valid quantized flow file, "
                          f"its dimension is {cat_flow.ndim}.")
        assert cat_flow.shape[concat_axis] % 2 == 0
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        return dequantize_flow(dx, dy, *args, **kwargs).astype(np.float32)
    with open(flow_path, "rb") as f:
        header = f.read(4).decode("utf-8")
        if header != "PIEH":
            raise IOError(f"Invalid flow file: {flow_path}, header does not "
                          "contain PIEH")
        w = int(np.fromfile(f, np.int32, 1).squeeze())
        h = int(np.fromfile(f, np.int32, 1).squeeze())
        flow = np.fromfile(f, np.float16, w * h * 2).reshape((h, w, 2))
    return flow.astype(np.float32)


def flowwrite(flow: np.ndarray, filename: str, quantize_pair: bool = False,
              concat_axis: int = 0, *args, **kwargs) -> None:
    """Write flow as .flo (float16 payload) or quantized jpeg (:67-100)."""
    import os

    import cv2

    os.makedirs(os.path.abspath(os.path.dirname(filename)), exist_ok=True)
    if not quantize_pair:
        with open(filename, "wb") as f:
            f.write("PIEH".encode("utf-8"))
            np.array([flow.shape[1], flow.shape[0]], dtype=np.int32).tofile(f)
            flow.astype(np.float16).tofile(f)
            f.flush()
        return
    assert concat_axis in (0, 1)
    dx, dy = quantize_flow(flow, *args, **kwargs)
    cv2.imwrite(filename, np.concatenate((dx, dy), axis=concat_axis))
