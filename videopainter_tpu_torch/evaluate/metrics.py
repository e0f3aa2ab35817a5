"""Evaluation metrics for video inpainting.

Counterpart of `videopainter_tpu/evaluate/metrics.py` (the reference's
evaluate/metrics.py MetricsCalculator): per-frame PSNR / SSIM / LPIPS / MSE /
MAE, CLIP score, CLIP frame-to-frame temporal consistency, masked-region
variants by mask multiplication, and corpus-level FVID from I3D activations.

 - The closed-form metrics compute in float64 where their tensors lie (numpy
   arrays: on the CPU), so they agree with the numpy definitions to
   rounding. Each has a per-frame batched form (`frame_psnr`, ...) over
   [N, H, W, C] stacks; `psnr` & co. are those at N = 1.
 - SSIM is torchmetrics' (Gaussian window 11, sigma 1.5, valid region, the
   mean over channels): one `conv2d` per statistic, batched over frames and
   channels. scipy's `convolve2d` flips its kernel; the Gaussian is
   symmetric, so both compute the same sums.
 - The learned extractors (LPIPS, CLIP, I3D) are pluggable callables. A
   callable with a `batch` attribute (the port's extractors,
   `extractors.BatchedFn`) is called once per video; any other once per frame.
 - `frechet_distance` stays numpy / scipy on the host: it runs once per corpus.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

SSIM_CHUNK = 16   # frames per SSIM convolution batch (5 statistics x 3 channels each)


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor of `x`: a tensor stays where it is (moved to `device` when
    given), an array goes to `device` (default the CPU)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device or "cpu")


def _f64(x) -> torch.Tensor:
    return as_tensor(x).to(torch.float64)


# ---------------------------------------------------------------------------
# closed-form image metrics (inputs float in [0, 1]: one frame [H, W, C] or
# [H, W]; batched forms take [N, H, W, C] or [N, H, W] and return [N])
# ---------------------------------------------------------------------------

def frame_mse(a, b) -> torch.Tensor:
    d = _f64(a) - _f64(b)
    return (d * d).flatten(1).mean(1)


def frame_mae(a, b) -> torch.Tensor:
    return (_f64(a) - _f64(b)).abs().flatten(1).mean(1)


def _psnr_of_mse(m: torch.Tensor, data_range: float) -> torch.Tensor:
    return torch.where(m == 0, torch.full_like(m, float("inf")),
                       10.0 * torch.log10(data_range ** 2 / m))


def frame_psnr(a, b, data_range: float = 1.0) -> torch.Tensor:
    return _psnr_of_mse(frame_mse(a, b), data_range)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def frame_ssim(a, b, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03,
               chunk: int = SSIM_CHUNK) -> torch.Tensor:
    """Mean SSIM of each frame of [N, H, W, C] (or [N, H, W]) stacks."""
    a, b = _f64(a), _f64(b)
    if a.ndim == 3:
        a, b = a[..., None], b[..., None]
    n, _, _, c = a.shape
    kern = torch.from_numpy(_gaussian_kernel()).to(a.device)[None, None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    out = []
    for i in range(0, n, chunk):
        x = a[i:i + chunk].permute(0, 3, 1, 2)   # [n, C, H, W]
        y = b[i:i + chunk].permute(0, 3, 1, 2)
        m = x.shape[0]
        stats = torch.stack([x, y, x * x, y * y, x * y])     # [5, n, C, H, W]
        mu_x, mu_y, exx, eyy, exy = F.conv2d(stats.reshape(-1, 1, *x.shape[2:]),
                                             kern).reshape(5, m, c, -1)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sx, sy, sxy = exx - mu_x2, eyy - mu_y2, exy - mu_xy
        s = ((2 * mu_xy + c1) * (2 * sxy + c2)) / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2))
        out.append(s.mean(2).mean(1))   # per channel, then over channels
    return torch.cat(out)


def ssim_reference(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
                   k1: float = 0.01, k2: float = 0.03) -> float:
    """The plain host version of `ssim` (numpy / scipy `convolve2d` per
    channel in float64, one frame), the JAX package's definition: what the
    device SSIM is held to, and timed against."""
    from scipy.signal import convolve2d

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    kern = _gaussian_kernel()
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = convolve2d(x, kern, mode="valid")
        mu_y = convolve2d(y, kern, mode="valid")
        mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
        sx = convolve2d(x * x, kern, mode="valid") - mu_x2
        sy = convolve2d(y * y, kern, mode="valid") - mu_y2
        sxy = convolve2d(x * y, kern, mode="valid") - mu_xy
        s = ((2 * mu_xy + c1) * (2 * sxy + c2)) / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def mse(a, b) -> float:
    return float(frame_mse(_f64(a)[None], _f64(b)[None])[0])


def mae(a, b) -> float:
    return float(frame_mae(_f64(a)[None], _f64(b)[None])[0])


def psnr(a, b, data_range: float = 1.0) -> float:
    return float(frame_psnr(_f64(a)[None], _f64(b)[None], data_range)[0])


def ssim(a, b, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM with 11x11 gaussian window (torchmetrics-compatible)."""
    return float(frame_ssim(_f64(a)[None], _f64(b)[None], data_range, k1, k2)[0])


# ---------------------------------------------------------------------------
# distributional / embedding metrics
# ---------------------------------------------------------------------------

def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """Fréchet distance between feature sets [N, D] (FVID when feats are I3D
    activations; reference metrics.py:114-180). Host numpy / scipy."""
    from scipy import linalg

    feats_a, feats_b = np.asarray(feats_a), np.asarray(feats_b)
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(s1.dot(s2))   # SciPy 1.18 dropped `disp` and its tuple
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2 * np.trace(covmean))


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def cosine_sim(a, b) -> float:
    return float((_unit(as_tensor(a)) * _unit(as_tensor(b))).sum())


def temporal_consistency(frame_embeds) -> float:
    """Mean cosine similarity of consecutive frame embeddings [T, D]
    (reference :841-901, CLIP-B/32 features)."""
    if len(frame_embeds) < 2:
        return 1.0
    e = _unit(as_tensor(frame_embeds))
    return float((e[:-1] * e[1:]).sum(-1).mean())


# ---------------------------------------------------------------------------
# calculator
# ---------------------------------------------------------------------------

def call_batched(fn: Callable, stacks: tuple, *extra) -> list:
    """fn over stacks of items (and `extra` arguments after them): one call
    of `fn.batch` when it has one, else one call of `fn` per item."""
    if hasattr(fn, "batch"):
        return list(fn.batch(*stacks, *extra))
    return [fn(*items, *extra) for items in zip(*stacks)]


class MetricsCalculator:
    """Per-frame + corpus metrics with optional pluggable feature extractors.

    image_embed_fn: [H, W, 3] float -> [D] (CLIP image tower)
    text_image_score_fn: (image, text) -> float (CLIP score)
    lpips_fn: (a, b) -> float
    video_feature_fn: [T, H, W, 3] -> [D_i3d] (I3D activations for FVID)
    flow_fn: (frame0, frame1) -> [H, W, 2] (RAFT et al.)

    `seconds` sums the wall time of each metric group (closed-form, ssim,
    lpips, clip, temporal, flow, i3d), the device synchronised around each.
    """

    def __init__(self,
                 image_embed_fn: Optional[Callable] = None,
                 text_image_score_fn: Optional[Callable] = None,
                 lpips_fn: Optional[Callable] = None,
                 video_feature_fn: Optional[Callable] = None,
                 flow_fn: Optional[Callable] = None):
        self.image_embed_fn = image_embed_fn
        self.text_image_score_fn = text_image_score_fn
        self.lpips_fn = lpips_fn
        self.video_feature_fn = video_feature_fn
        self.flow_fn = flow_fn
        self._fvid_real: List[np.ndarray] = []
        self._fvid_fake: List[np.ndarray] = []
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def _timed(self, group: str, device: torch.device):
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda *a: None)
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        self.seconds[group] += time.perf_counter() - t0

    # -- per-frame -----------------------------------------------------------
    def video_frame_metrics(self, pred, gt, masks=None,
                            caption: Optional[str] = None) -> List[Dict[str, float]]:
        """The rows of `frame_metrics` for every frame of pred / gt [T, H, W, 3]
        in [0, 1] (masks [T, H, W] {0, 1}), each metric computed once over
        the stack on the tensors' device."""
        pred, gt = as_tensor(pred), as_tensor(gt, pred.device)
        dev = pred.device
        cols: Dict[str, list] = {}

        def closed_form(p, g, prefix):
            with self._timed("ssim", dev):
                ssim_v = frame_ssim(p, g).tolist()
            with self._timed("closed-form", dev):
                m = frame_mse(p, g)
                cols.update({prefix + "psnr": _psnr_of_mse(m, 1.0).tolist(),
                             prefix + "ssim": ssim_v, prefix + "mse": m.tolist(),
                             prefix + "mae": frame_mae(p, g).tolist()})

        def learned(key, fn, stacks, *extra):
            cols[key] = [float(v) for v in call_batched(fn, stacks, *extra)]

        closed_form(pred, gt, "")
        if self.lpips_fn is not None:
            with self._timed("lpips", dev):
                learned("lpips", self.lpips_fn, (pred, gt))
        if masks is not None:
            m = as_tensor(masks, dev)[..., None].to(pred.dtype)
            pm, gm = pred * m, gt * m
            closed_form(pm, gm, "masked_")
            if self.lpips_fn is not None:
                with self._timed("lpips", dev):
                    learned("masked_lpips", self.lpips_fn, (pm, gm))
        if self.text_image_score_fn is not None and caption:
            with self._timed("clip", dev):
                learned("clip_score", self.text_image_score_fn, (pred,), caption)
                if masks is not None:
                    learned("masked_clip_score", self.text_image_score_fn,
                            (pred * as_tensor(masks, dev)[..., None],), caption)
        return [{k: v[i] for k, v in cols.items()} for i in range(len(pred))]

    def frame_metrics(self, pred, gt, mask=None,
                      caption: Optional[str] = None) -> Dict[str, float]:
        """pred/gt [H, W, 3] in [0,1]; mask [H, W] {0,1} (1 = inpainted region)."""
        pred = as_tensor(pred)
        return self.video_frame_metrics(
            pred[None], as_tensor(gt, pred.device)[None],
            None if mask is None else as_tensor(mask, pred.device)[None], caption)[0]

    # -- per-video -----------------------------------------------------------
    def video_metrics(self, pred_video, masks=None) -> Dict[str, float]:
        pred_video = as_tensor(pred_video)
        dev = pred_video.device
        out = {}
        if self.image_embed_fn is not None:
            with self._timed("temporal", dev):
                embeds = torch.stack([as_tensor(e, dev) for e in
                                      call_batched(self.image_embed_fn, (pred_video,))])
                out["temporal_consistency"] = temporal_consistency(embeds)
        if self.flow_fn is not None:
            from .flow_util import flow_warping_error

            with self._timed("flow", dev):
                out["flow_warping_error"] = flow_warping_error(pred_video, self.flow_fn)
                if masks is not None:
                    out["masked_flow_warping_error"] = flow_warping_error(
                        pred_video, self.flow_fn, masks=masks)
        return out

    def accumulate_fvid(self, pred_video, gt_video) -> None:
        if self.video_feature_fn is None:
            return
        pred_video = as_tensor(pred_video)
        with self._timed("i3d", pred_video.device):
            for video, store in ((pred_video, self._fvid_fake), (gt_video, self._fvid_real)):
                feats = self.video_feature_fn(video)
                store.append(feats.detach().cpu().numpy() if isinstance(feats, torch.Tensor)
                             else np.asarray(feats))

    def compute_fvid(self) -> Optional[float]:
        if not self._fvid_real:
            return None
        return frechet_distance(np.stack(self._fvid_real), np.stack(self._fvid_fake))
