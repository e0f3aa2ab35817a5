"""LPIPS (SqueezeNet-1.1 backbone + learned 1x1 linear heads) as an nn.Module.

Counterpart of `videopainter_tpu/evaluate/lpips.py`. The reference evaluates
LPIPS per frame (global + masked) through torchmetrics'
`LearnedPerceptualImagePatchSimilarity(net_type='squeeze')` (reference
evaluate/metrics.py:604, :761-779: images in [0,1], the masked variant
multiplies the mask in pixel space, then the metric gets `img*2-1`).
torchmetrics vendors the LPIPS architecture of Zhang et al. (CVPR 2018,
richzhang/PerceptualSimilarity): a frozen SqueezeNet-1.1 feature trunk whose
7 ReLU endpoints are channel-unit-normalized, squared-diffed, and reduced by
per-layer learned 1x1 convs, spatially averaged and summed over layers.

The module keeps the lpips package's parameter names (`net.slice1.0.weight`,
..., `lin{k}.model.1.weight`, buffers `shift` / `scale`), so a checkpoint
(or the golden's `sd::` dict) loads with `load_state_dict`.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from .metrics import as_tensor

LPIPS_CHANNELS = (64, 128, 256, 384, 384, 512, 512)
LPIPS_BATCH = 16   # frame pairs per forward in `LpipsExtractor.batch`


class Fire(nn.Module):
    """SqueezeNet Fire: squeeze 1x1 -> relu -> [expand1x1 -> relu ‖
    expand3x3 (pad 1) -> relu]."""

    def __init__(self, inp: int, sq: int, e1: int, e3: int):
        super().__init__()
        self.squeeze = nn.Conv2d(inp, sq, 1)
        self.expand1x1 = nn.Conv2d(sq, e1, 1)
        self.expand3x3 = nn.Conv2d(sq, e3, 3, padding=1)

    def forward(self, x):
        x = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(x)), torch.relu(self.expand3x3(x))], 1)


class SqueezeSlices(nn.Module):
    """torchvision squeezenet1_1 `features` split into the 7 LPIPS slices;
    torch's MaxPool2d(3, 2, ceil_mode=True) is the pool the JAX package
    writes out by hand."""

    def __init__(self):
        super().__init__()
        pool = lambda: nn.MaxPool2d(3, stride=2, ceil_mode=True)  # noqa: E731
        self.slice1 = nn.Sequential(nn.Conv2d(3, 64, 3, stride=2), nn.ReLU())
        self.slice2 = nn.Sequential(pool(), Fire(64, 16, 64, 64), Fire(128, 16, 64, 64))
        self.slice3 = nn.Sequential(pool(), Fire(128, 32, 128, 128), Fire(256, 32, 128, 128))
        self.slice4 = nn.Sequential(pool(), Fire(256, 48, 192, 192))
        self.slice5 = nn.Sequential(Fire(384, 48, 192, 192))
        self.slice6 = nn.Sequential(Fire(384, 64, 256, 256))
        self.slice7 = nn.Sequential(Fire(512, 64, 256, 256))

    def forward(self, x):
        taps = []
        for k in range(1, 8):
            x = getattr(self, f"slice{k}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    def __init__(self, chn: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(chn, 1, 1, bias=False))


class LPIPS(nn.Module):
    """forward(a, b): [B, 3, H, W] fp32 in [-1, 1] -> [B] distances."""

    def __init__(self, device=None):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None])
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450])[None, :, None, None])
        self.net = SqueezeSlices()
        for k, c in enumerate(LPIPS_CHANNELS):
            setattr(self, f"lin{k}", NetLinLayer(c))
        if device is not None:
            self.to(device)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for k, (fa, fb) in enumerate(zip(self.net((a - self.shift) / self.scale),
                                         self.net((b - self.shift) / self.scale))):
            # channel-unit normalize (eps OUTSIDE the sqrt, as upstream)
            fa = fa / (fa.square().sum(1, keepdim=True).sqrt() + 1e-10)
            fb = fb / (fb.square().sum(1, keepdim=True).sqrt() + 1e-10)
            d = getattr(self, f"lin{k}").model[1]((fa - fb) ** 2)
            total = total + d.mean((1, 2, 3))
        return total


def convert_lpips_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """An LPIPS checkpoint -> the `LPIPS` module's state dict. Accepts the
    `lpips` package naming and the torchmetrics wrapper naming (everything
    prefixed with one more `net.`); the `shift` / `scale` buffers are the
    module's own constants when a checkpoint lacks them."""
    if any(k.startswith("net.net.") for k in sd):  # torchmetrics prefix
        sd = {k[4:]: v for k, v in sd.items() if k.startswith("net.")}
    out = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()
           if k.startswith(("net.slice", "lin", "shift", "scale"))}
    ref = LPIPS().state_dict()
    for k in ("shift", "scale"):
        out.setdefault(k, ref[k])
    missing = sorted(set(ref) - set(out))
    if missing:
        raise KeyError(f"LPIPS checkpoint lacks {missing[:4]}")
    return out


def lpips_forward(model: LPIPS, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [B, H, W, 3] fp32 in [-1, 1] (channels last, as the JAX
    package's `lpips_forward`) -> [B] LPIPS distances."""
    return model(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matmuls in full fp32 (no TF32) for the duration: a
    metric must not depend on the card's reduced-precision modes."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def load_state_file(path: str) -> Dict[str, np.ndarray]:
    """A state dict from .npz or a torch checkpoint (.pt / .pth, optionally
    under "state_dict"), as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    raw = torch.load(path, map_location="cpu")
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.numpy() for k, v in raw.items()}


class LpipsExtractor:
    """lpips_fn for MetricsCalculator: fn(a01, b01) -> float, and
    fn.batch(a01s, b01s) -> [N] over frame stacks.

    Matches the reference's calculate_lpips contract (reference
    evaluate/metrics.py:761-779): inputs are [H, W, 3] floats in [0, 1]; the
    x2-1 rescale happens here, masking (if any) happened in pixel space
    before the call. Runs on `device` (CUDA unless given), in full fp32.
    """

    def __init__(self, weights_path: str, device=None):
        self.device = resolve_device(device)
        self.model = LPIPS(device="meta").to_empty(device=self.device)
        self.model.load_state_dict(convert_lpips_state_dict(load_state_file(weights_path)))
        self.model.eval()

    @torch.no_grad()
    def batch(self, a01, b01, chunk: int = LPIPS_BATCH) -> torch.Tensor:
        a01, b01 = as_tensor(a01), as_tensor(b01)
        check_device(a01, self.device)
        out = []
        with full_fp32():
            for i in range(0, len(a01), chunk):
                a = a01[i:i + chunk].to(self.device, torch.float32) * 2 - 1
                b = b01[i:i + chunk].to(self.device, torch.float32) * 2 - 1
                out.append(lpips_forward(self.model, a, b))
        return torch.cat(out)

    def __call__(self, a01, b01) -> float:
        return float(self.batch(as_tensor(a01)[None], as_tensor(b01)[None])[0])


def check_device(x: torch.Tensor, device: torch.device) -> None:
    """Tensors on another device type than the extractor's are refused: a
    metric never moves between the card and the CPU on its own."""
    if x.device.type != device.type and x.device.type != "cpu":
        raise ValueError(f"input on {x.device}, the extractor runs on {device}")
