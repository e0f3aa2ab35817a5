"""In-training pipeline validation: every `validating_steps`, run the full
single-clip inpainting pipeline with the current trainable weights on a fixed
validation sample and return the side-by-side video. Counterpart of
`videopainter_tpu/training/validation.py`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def make_validation_fn(transformer, branch, vae, scheduler, val_batch: Dict, *,
                       num_inference_steps: int = 20, guidance_scale: float = 6.0,
                       mode: str = "branch", lora_alpha: float = 128.0, lora_rank: int = 256,
                       replace_gt_alternate: bool = True, use_flash=False,
                       sequential_cfg: bool = False,
                       id_pool_resample: Optional[bool] = None, dtype=None) -> Callable:
    """Returns validation_fn(trainable, step) -> side-by-side video01.

    The modules are the ones being trained (the branch's current weights are
    in the module; a LoRA tree is attached for the run and taken off again).
    val_batch: {pixel_values [1,T,H,W,3] in [-1,1], conditioning_pixel_values,
    masks [1,T,H,W], prompt_embeds}. `replace_gt_alternate` alternates the
    replace_gt flag between validations.
    """
    from ..models.lora import LORA_TARGETS, _target, attach_lora
    from ..pipelines import CogVideoXI2VDualInpaintPipeline

    device = next(vae.parameters()).device
    video = val_batch["pixel_values"]
    masks = val_batch["masks"]
    embeds = val_batch["prompt_embeds"]
    image = video[:, 0] * (1 - masks[:, 0][..., None])

    def validation_fn(trainable, step: int) -> np.ndarray:
        was_training = [m.training for m in (transformer, branch, vae)]
        pipe = CogVideoXI2VDualInpaintPipeline(transformer, branch, vae, scheduler,
                                               device=device)
        if mode == "lora":   # additive attach: the frozen backbone may be int8
            attach_lora(transformer, trainable, alpha=lora_alpha, rank=lora_rank)
        replace_gt = (step % 2 == 0) if replace_gt_alternate else True
        kw = {} if dtype is None else {"dtype": dtype}
        try:
            out = pipe(image=image, video=video, masks=masks, prompt_embeds=embeds,
                       negative_prompt_embeds=torch.zeros_like(embeds),
                       num_inference_steps=num_inference_steps,
                       guidance_scale=guidance_scale, use_dynamic_cfg=True,
                       replace_gt=replace_gt, mask_add=True, use_flash=use_flash,
                       sequential_cfg=sequential_cfg,
                       id_pool_resample=(mode == "lora" if id_pool_resample is None
                                         else id_pool_resample),
                       generator=torch.Generator(device=device).manual_seed(step),
                       output_type="np", **kw)
        finally:
            if mode == "lora":
                for blk in transformer.transformer_blocks:
                    for tgt in LORA_TARGETS:
                        for name in ("lora_A", "lora_B", "lora_scale"):
                            _target(blk, tgt)._buffers.pop(name, None)
            for m, flag in zip((transformer, branch, vae), was_training):
                m.train(flag)
        out01 = (np.asarray(out, dtype=np.float32)[0] / 2 + 0.5).clip(0, 1)
        gt01 = (video.detach().float().cpu().numpy()[0] / 2 + 0.5).clip(0, 1)
        masked01 = gt01 * (1 - masks.detach().float().cpu().numpy()[0][..., None])
        return np.concatenate([gt01, masked01, out01], axis=2)

    return validation_fn
