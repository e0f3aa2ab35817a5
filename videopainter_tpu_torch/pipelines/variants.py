"""The reference's baseline and variant pipelines.

Counterpart of `videopainter_tpu/pipelines/variants.py`:

| class                                | reference file                                    | mode |
|--------------------------------------|---------------------------------------------------|------|
| CogVideoXDualInpaintPipeline         | pipeline_cogvideox_inpainting_branch.py:160       | dual (T2V backbone, no image latents) |
| CogVideoXSFTInpaintPipeline          | pipeline_cogvideox_inpainting_sft.py:156          | sft  |
| CogVideoXI2VInpaintAnyLPipeline      | pipeline_cogvideox_inpainting_i2v_anyl.py:161     | sft, any length (backbone-only baseline) |
| CogVideoXSelfGuidanceInpaintPipeline | pipeline_cogvideox_inpainting_selfguidance.py:153 | selfguidance |
| CogVideoXInpaintPipeline             | pipeline_cogvideox_inpainting.py:154              | plain (latent blend via replace_gt) |
| CogVideoXImageToVideoInpaintPipeline | pipeline_cogvideox_image2video_inpainting.py:155  | plain + image conditioning |

All share the machinery of `pipelines/inpaint.py`; the class's `_mode`
selects the model pass of the denoise loop (`pipelines/common.py`).
`make_sft_inpaint_transformer` and `init_sft_from_transformer` build the SFT
baseline's backbone, whose patch embed is widened to 2 C + 1 channels;
`share_transformer` is the step under the latter: a backbone that shares a
base's modules under a patch-embed projection of another width.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import TransformerConfig
from ..models.dit import CogVideoXTransformer3D
from .inpaint import CogVideoXI2VDualInpaintPipeline
from .inpaint_anyl import CogVideoXI2VDualInpaintAnyLPipeline


class _Branchless:
    """The variants without a branch: (transformer, vae, scheduler, text_encoder)."""

    def __init__(self, transformer, vae, scheduler, text_encoder=None, *, device=None):
        super().__init__(transformer, None, vae, scheduler, text_encoder, device=device)


class _BlendsAlways:
    """The baselines whose loop blends the known region every step."""

    def __call__(self, **kw):
        kw["replace_gt"] = True
        return super().__call__(**kw)


class CogVideoXDualInpaintPipeline(CogVideoXI2VDualInpaintPipeline):
    """T2V dual stream: the flagship path on a backbone with in_channels equal
    to the latent channels, so no image latents are concatenated."""

    _mode = "dual"


class CogVideoXSFTInpaintPipeline(_Branchless, CogVideoXI2VDualInpaintPipeline):
    """Full-backbone-finetune baseline: the widened patch embed takes
    [noisy ‖ masked ‖ mask]; no branch. The reference computes its blend each
    step but never applies it (pipeline_..._sft.py:890-904), so replace_gt is
    pinned off."""

    _mode = "sft"

    def __call__(self, **kw):
        kw["replace_gt"] = False
        return super().__call__(**kw)


class CogVideoXI2VInpaintAnyLPipeline(_Branchless, CogVideoXI2VDualInpaintAnyLPipeline):
    """Any length without a branch (the SFT backbone alone; the reference's
    evaluate/eval_inpainting_wo_branch.py:147)."""

    _mode = "sft"


class CogVideoXSelfGuidanceInpaintPipeline(_Branchless, _BlendsAlways,
                                           CogVideoXI2VDualInpaintPipeline):
    """Training-free baseline: each step a guidance pass on the noised
    masked-video latents gives per-layer states that replace the main pass's
    outside the mask. The loop starts from the noised masked-video latents and
    blends against them every step. The reference's loop breaks under CFG
    (its CFG-doubled masked latents are doubled again), so it is held for
    guidance_scale <= 1."""

    _mode = "selfguidance"


class CogVideoXInpaintPipeline(_Branchless, _BlendsAlways, CogVideoXI2VDualInpaintPipeline):
    """Plain latent-blend baseline: the bare backbone and a blend against the
    re-noised clean video latents every step (pipeline_cogvideox_inpainting.py:900-916)."""

    _mode = "plain"


class CogVideoXImageToVideoInpaintPipeline(_Branchless, _BlendsAlways,
                                           CogVideoXI2VDualInpaintPipeline):
    """Older I2V inpainting: the first-frame latents concatenated on the
    channels of an I2V backbone, and the same blend as the plain baseline
    (pipeline_cogvideox_image2video_inpainting.py:1015-1028)."""

    _mode = "plain"


def make_sft_inpaint_transformer(cfg: TransformerConfig, *, device=None, dtype=None
                                 ) -> CogVideoXTransformer3D:
    """The SFT inpainting backbone: the patch embed widened to 2 C + 1 input
    channels (noisy, masked video, mask; cogvideox_transformer_3d_inpainting.py:253-268)."""
    return CogVideoXTransformer3D(cfg, patch_in_channels=cfg.in_channels * 2 + 1,
                                  device=device, dtype=dtype)


@torch.no_grad()
def share_transformer(base: CogVideoXTransformer3D, proj_weight: torch.Tensor,
                      cfg: Optional[TransformerConfig] = None) -> CogVideoXTransformer3D:
    """A backbone (on `cfg`, default `base.cfg`) whose modules are `base`'s
    own (shared, not copied) but for the patch embed's projection: a new
    Conv2d taking `proj_weight` ([D, C_in, p, p]) and `base`'s bias."""
    cfg = cfg or base.cfg
    w, pe = proj_weight, base.patch_embed
    model = CogVideoXTransformer3D(cfg, patch_in_channels=w.shape[1], device="meta",
                                   dtype=w.dtype)
    for name, child in base.named_children():
        if name != "patch_embed":
            setattr(model, name, child)
    new = model.patch_embed
    new.text_proj = pe.text_proj
    if hasattr(pe, "pos_embedding"):
        new.register_buffer("pos_embedding", pe.pos_embedding,
                            persistent="pos_embedding" not in pe._non_persistent_buffers_set)
    new.proj = nn.Conv2d(w.shape[1], w.shape[0], cfg.patch_size, stride=cfg.patch_size,
                         device=w.device, dtype=w.dtype)
    new.proj.weight.copy_(w)
    new.proj.bias.copy_(pe.proj.bias)
    return model.train(base.training)


@torch.no_grad()
def init_sft_from_transformer(base: CogVideoXTransformer3D) -> CogVideoXTransformer3D:
    """An SFT backbone from a pretrained one: every module but the patch
    embed's projection is `base`'s own (shared, not copied); the projection
    repeats the latent slots' weights for the masked-video slots and zeroes
    the mask slot's (reference :425-433)."""
    w = base.patch_embed.proj.weight   # [D, C, p, p]
    c = base.cfg.in_channels
    if w.shape[1] != c:
        raise ValueError(f"base patch embed takes {w.shape[1]} channels, expected {c}")
    wide = torch.zeros((w.shape[0], 2 * c + 1, *w.shape[2:]), device=w.device, dtype=w.dtype)
    wide[:, :c] = w
    wide[:, c:2 * c] = w
    return share_transformer(base, wide)
