"""Pretrained feature extractors for the metrics stack.

Counterpart of `videopainter_tpu/evaluate/extractors.py`. Reference
dependency map (evaluate/metrics.py):
 - CLIP-L/14 CLIPScore + CLIP-B/32 temporal consistency (:841-901)
 - InceptionI3d activations for FVID (:181-598; the reference bundles a
   ~400-LoC pytorch-i3d port)
 - LPIPS (squeeze backbone via torchmetrics)

Everything loads from LOCAL paths. CLIP is transformers' torch `CLIPModel`
(eager attention: matmuls and a softmax, no fused attention kernel), a library
model as T5 is in `models/text_encoder.py`; its image and text preprocessing
stay the processor's (on the host). I3D is an nn.Module with the standard
pytorch-i3d names (Conv3d_1a_7x7.conv3d.weight, Mixed_3b.b0.bn.running_mean,
...), so `rgb_imagenet.pt` loads with `load_state_dict`. Each extractor runs
on its device (CUDA unless given) in full fp32, and has a batched form that
`MetricsCalculator` calls once per video.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from .lpips import check_device, full_fp32, load_state_file
from .metrics import as_tensor

CLIP_BATCH = 32   # images per CLIP image-tower forward


class BatchedFn:
    """A per-item function with its batched form: `fn(x, *extra)` on one
    item, `fn.batch(xs, *extra)` on a stack of them (one device pass)."""

    def __init__(self, one: Callable, batch: Callable):
        self.one, self.batch = one, batch

    def __call__(self, *a):
        return self.one(*a)


# ---------------------------------------------------------------------------
# CLIP
# ---------------------------------------------------------------------------


class ClipExtractor:
    """CLIP score + image embeddings via torch CLIP loaded from a local dir.

    `image_embed` and `clip_score` are `BatchedFn`s: one image ([H, W, 3] in
    [0, 1]) or, through `.batch`, a stack [N, H, W, 3]."""

    def __init__(self, path: str, device=None):
        from transformers import AutoProcessor, CLIPModel

        self.device = resolve_device(device)
        self.model = CLIPModel.from_pretrained(
            path, local_files_only=True, attn_implementation="eager",
            torch_dtype=torch.float32).to(self.device).eval()
        self.processor = AutoProcessor.from_pretrained(path, local_files_only=True)
        self.image_embed = BatchedFn(lambda img: self.image_embeds(as_tensor(img)[None])[0],
                                     self.image_embeds)
        self.clip_score = BatchedFn(
            lambda img, text: float(self.clip_scores(as_tensor(img)[None], text)[0]),
            self.clip_scores)

    def _pixels(self, images01) -> torch.Tensor:
        """The processor's pixel values of [N, H, W, 3] images in [0, 1]
        (quantised to uint8 first, as the reference feeds the processor)."""
        images01 = as_tensor(images01)
        check_device(images01, self.device)
        u8 = (images01.float() * 255).to(torch.uint8).cpu().numpy()
        inputs = self.processor(images=list(u8), return_tensors="pt")
        return inputs["pixel_values"].to(self.device)

    @torch.no_grad()
    def image_embeds(self, images01, chunk: int = CLIP_BATCH) -> torch.Tensor:
        """[N, H, W, 3] in [0, 1] -> [N, D] image features (for temporal
        consistency)."""
        pixels = self._pixels(images01)
        with full_fp32():
            return torch.cat([self._project_image(pixels[i:i + chunk])
                              for i in range(0, len(pixels), chunk)]).float()

    # the towers' pooled outputs through their projections, as CLIPModel's
    # get_image_features / get_text_features compute them (whose return type
    # differs between transformers releases)
    def _project_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.model.visual_projection(
            self.model.vision_model(pixel_values=pixels).pooler_output)

    @torch.no_grad()
    def text_embed(self, text: str) -> torch.Tensor:
        inputs = self.processor(text=[text], return_tensors="pt", padding=True, truncation=True)
        with full_fp32():
            return self.model.text_projection(self.model.text_model(
                input_ids=inputs["input_ids"].to(self.device),
                attention_mask=inputs["attention_mask"].to(self.device)).pooler_output)[0].float()

    def clip_scores(self, images01, text: str) -> torch.Tensor:
        """100 * max(cos(img, text), 0) per image — torchmetrics CLIPScore
        convention."""
        img = self.image_embeds(images01)
        txt = self.text_embed(text)
        cos = (img @ txt) / (torch.linalg.vector_norm(img, dim=-1)
                             * torch.linalg.vector_norm(txt) + 1e-12)
        return 100.0 * cos.clamp(min=0.0)


# ---------------------------------------------------------------------------
# InceptionI3d
# ---------------------------------------------------------------------------

# (name, type, spec): conv -> (out, kernel, stride); pool -> (kernel, stride);
# mixed -> (b0, b1a, b1b, b2a, b2b, b3b) output channels
I3D_LAYERS = [
    ("Conv3d_1a_7x7", "conv", (64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", (64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "conv", (192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", "mixed", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", "mixed", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", "mixed", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", "mixed", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", "mixed", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", "mixed", (384, 192, 384, 48, 128, 128)),
]
I3D_BN_EPS = 1e-3


def _same_pad(size, k, s):
    """TF SAME padding of one axis: (before, after), asymmetric when odd."""
    if size % s == 0:
        pad = max(k - s, 0)
    else:
        pad = max(k - size % s, 0)
    return pad // 2, pad - pad // 2


def _pad_same(x: torch.Tensor, kernel, stride, value: float = 0.0) -> torch.Tensor:
    """x [B, C, T, H, W] padded TF-SAME for `kernel` / `stride` (F.pad takes
    the last axis first)."""
    pads = [_same_pad(n, k, s) for n, k, s in zip(x.shape[2:], kernel, stride)]
    return F.pad(x, [p for pair in reversed(pads) for p in pair], value=value)


def _maxpool3d_same(x, kernel, stride):
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), kernel, stride)


class Unit3D(nn.Module):
    """pytorch-i3d Unit3D: TF-SAME conv3d, BatchNorm (eval statistics, folded
    at eps 1e-3 into a scale and a bias as the JAX converter folds it), relu."""

    def __init__(self, cin: int, cout: int, kernel, stride=(1, 1, 1), use_bn: bool = True,
                 bias: bool = False, activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.stride, bias=bias)
        self.bn = nn.BatchNorm3d(cout, eps=I3D_BN_EPS, momentum=0.01) if use_bn else None

    def forward(self, x):
        y = F.conv3d(_pad_same(x, self.kernel, self.stride), self.conv3d.weight,
                     None, self.stride)
        if self.bn is not None:
            scale = self.bn.weight / torch.sqrt(self.bn.running_var + I3D_BN_EPS)
            bias = self.bn.bias - self.bn.running_mean * scale
        else:
            scale = torch.ones_like(y[0, :, 0, 0, 0])
            bias = (self.conv3d.bias if self.conv3d.bias is not None
                    else torch.zeros_like(scale))
        y = y * scale[:, None, None, None] + bias[:, None, None, None]
        return torch.relu(y) if self.activation else y


class InceptionModule(nn.Module):
    def __init__(self, cin: int, spec):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = spec
        self.b0 = Unit3D(cin, b0, (1, 1, 1))
        self.b1a = Unit3D(cin, b1a, (1, 1, 1))
        self.b1b = Unit3D(b1a, b1b, (3, 3, 3))
        self.b2a = Unit3D(cin, b2a, (1, 1, 1))
        self.b2b = Unit3D(b2a, b2b, (3, 3, 3))
        self.b3b = Unit3D(cin, b3b, (1, 1, 1))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x):
        b3 = _maxpool3d_same(x, (3, 3, 3), (1, 1, 1))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(b3)], dim=1)


class InceptionI3d(nn.Module):
    """InceptionI3d up to Mixed_5c; `forward` returns the Logits-input
    features, spatiotemporally averaged (the reference's FVID feature).
    `logits` is kept only so that pytorch-i3d checkpoints load as they are."""

    def __init__(self, num_classes: int = 400, device=None):
        super().__init__()
        cin = 3
        for name, kind, spec in I3D_LAYERS:
            if kind == "conv":
                cout, kernel, stride = spec
                setattr(self, name, Unit3D(cin, cout, kernel, stride))
                cin = cout
            elif kind == "mixed":
                setattr(self, name, InceptionModule(cin, spec))
                cin = getattr(self, name).out_channels
        self.logits = Unit3D(cin, num_classes, (1, 1, 1), use_bn=False, bias=True,
                             activation=False)
        if device is not None:
            self.to(device)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """[B, 3, T, H, W] in [-1, 1] -> [B, 1024]."""
        x = video
        for name, kind, spec in I3D_LAYERS:
            x = _maxpool3d_same(x, *spec) if kind == "pool" else getattr(self, name)(x)
        # global average (the reference's 2x7x7 avg_pool then squeeze; the
        # mean is what the JAX package takes)
        return x.mean((2, 3, 4))


def i3d_extract_features(model: InceptionI3d, video: torch.Tensor) -> torch.Tensor:
    """[B, T, H, W, 3] in [-1, 1] (channels last, as the JAX package's
    `i3d_extract_features`) -> [B, 1024]."""
    return model(video.permute(0, 4, 1, 2, 3))


class I3DExtractor:
    """FVID feature fn: a local pytorch-i3d checkpoint (.pt, or .npz) on
    `device`, the callable for MetricsCalculator(video_feature_fn=...)."""

    def __init__(self, checkpoint_path: str, device=None):
        self.device = resolve_device(device)
        sd = {k: torch.as_tensor(v) for k, v in load_state_file(checkpoint_path).items()}
        self.model = InceptionI3d(num_classes=sd["logits.conv3d.weight"].shape[0],
                                  device="meta").to_empty(device=self.device)
        self.model.load_state_dict(sd)
        self.model.eval()

    @torch.no_grad()
    def __call__(self, video01) -> torch.Tensor:
        """[T, H, W, 3] in [0, 1] -> [1024] activations, on the extractor's
        device."""
        video01 = as_tensor(video01)
        check_device(video01, self.device)
        v = video01[None].to(self.device, torch.float32) * 2 - 1
        with full_fp32():
            return i3d_extract_features(self.model, v)[0]


def make_lpips_fn(net: str = "squeeze", weights_path: Optional[str] = None, device=None):
    """LPIPS feature fn. The port's LPIPS module when a local checkpoint path
    is given; otherwise torchmetrics on `device` when it imports and its
    weights load; else None (zero-egress)."""
    if weights_path:
        from .lpips import LpipsExtractor

        return LpipsExtractor(weights_path, device=device)
    dev = resolve_device(device)
    try:
        from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity

        metric = LearnedPerceptualImagePatchSimilarity(net_type=net, normalize=True).to(dev)

        def fn(a01, b01):
            a = as_tensor(a01, dev).float().permute(2, 0, 1)[None]
            b = as_tensor(b01, dev).float().permute(2, 0, 1)[None]
            return float(metric(a, b))

        return fn
    except Exception:
        return None
