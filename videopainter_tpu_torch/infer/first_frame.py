"""Self-served first-frame pre-inpainting (the FluxFill stand-in).

Counterpart of `videopainter_tpu/infer/first_frame.py`. The reference
pre-inpaints frame 0 with FluxFill (and GPT-4o) before propagating the edit
through the video; neither runs offline. The single-clip dual pipeline run
at T=1 is an image inpainter (the same collapse the training collator uses
for image batches), so `make_self_first_frame_inpaint` packages it as the
`first_frame_inpaint_fn(frame01, mask, prompt) -> frame01` hook of
infer/inpaint.py and infer/edit.py (`--first_frame_inpaint self`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _single_clip_pipeline(pipe):
    """A single-clip pipeline on `pipe`'s models: the dual one, or the SFT one
    when there is no branch (the widened backbone is itself an inpainter)."""
    from ..pipelines import CogVideoXI2VDualInpaintPipeline, CogVideoXSFTInpaintPipeline

    if pipe.branch is not None:
        return CogVideoXI2VDualInpaintPipeline(pipe.transformer, pipe.branch, pipe.vae,
                                               pipe.scheduler, pipe.text_encoder,
                                               device=pipe.device)
    return CogVideoXSFTInpaintPipeline(pipe.transformer, pipe.vae, pipe.scheduler,
                                       pipe.text_encoder, device=pipe.device)


def make_self_first_frame_inpaint(
    pipe, *,
    num_inference_steps: int = 30,
    guidance_scale: float = 6.0,
    seed: int = 0,
    use_flash=False,
    sequential_cfg: bool = False,
    dtype=torch.float32,
    encode_prompt_fn: Optional[Callable] = None,
    prompt_embeds=None,
    negative_prompt_embeds=None,
    composite: bool = True,
) -> Callable:
    """A `first_frame_inpaint_fn(frame01, mask, prompt) -> frame01` on
    `pipe`'s models at T=1.

    frame01: [H, W, 3] float in [0, 1] (the hole is zeroed from `mask`
    either way); mask: [H, W], nonzero = hole. With composite=True only the
    hole is replaced (the reference's paste-back). Text conditioning:
    `prompt_embeds` if given, else `encode_prompt_fn(prompt)` -> (pos, neg),
    else the pipeline's text encoder. Each call draws its noise from a
    generator seeded with `seed`.
    """
    single = _single_clip_pipeline(pipe)
    dev = single.device

    def fn(frame01: np.ndarray, mask: np.ndarray, prompt: str) -> np.ndarray:
        frame01 = np.asarray(frame01, np.float32)
        hole = (np.asarray(mask, np.float32) > 0.5).astype(np.float32)
        masked01 = frame01 * (1.0 - hole[..., None])
        video = torch.from_numpy(masked01).to(dev)[None, None] * 2 - 1
        masks = torch.from_numpy(hole).to(dev)[None, None]

        if prompt_embeds is not None:
            pos = _tensor(prompt_embeds)
            neg = (torch.zeros_like(pos) if negative_prompt_embeds is None
                   else _tensor(negative_prompt_embeds))
            emb_kw = dict(prompt_embeds=pos, negative_prompt_embeds=neg)
        elif encode_prompt_fn is not None:
            pos, neg = encode_prompt_fn(prompt)
            emb_kw = dict(prompt_embeds=_tensor(pos), negative_prompt_embeds=_tensor(neg))
        else:
            emb_kw = dict(prompt=prompt)   # raises without a text encoder

        out = single(image=video[:, 0], video=video, masks=masks,
                     num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                     use_dynamic_cfg=True, replace_gt=single._mode != "sft", mask_add=True,
                     use_flash=use_flash, sequential_cfg=sequential_cfg,
                     generator=torch.Generator(device=dev).manual_seed(seed), dtype=dtype,
                     **emb_kw)
        frame = (np.asarray(out)[0, 0].astype(np.float32) / 2 + 0.5).clip(0, 1)
        if composite:
            frame = frame * hole[..., None] + frame01 * (1 - hole[..., None])
        return frame

    return fn
