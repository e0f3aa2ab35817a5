"""Shared pipeline machinery for the dual-stream mode: RoPE tables, mask
resize, dynamic CFG, and the denoise loop.

Counterpart of `videopainter_tpu/pipelines/common.py`. The JAX package
compiles the denoise loop into one `lax.scan`; here it is a plain Python loop
over steps with the same per-step arithmetic: CFG-batched (or sequential)
branch + backbone, dynamic CFG, the DPM step with its x0 carry, and the
replace_gt re-noise blend. Scheduler coefficients are precomputed on the
host. The `init_noise` / `dpm_noises` hooks inject identical noise for
parity tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import TransformerConfig
from ..models.vae import nearest_resize3d_ndhwc
from ..ops.rope import get_3d_rotary_pos_embed, get_resize_crop_region_for_grid
from ..schedulers import CogVideoXDPMScheduler


def get_strength_timesteps(timesteps: np.ndarray, num_inference_steps: int,
                           strength: float) -> Tuple[np.ndarray, int]:
    """Strength-based timestep slicing."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return timesteps[t_start:], num_inference_steps - t_start


def prepare_rope(cfg: TransformerConfig, height: int, width: int,
                 num_latent_frames: int, vae_spatial: int = 8,
                 base_height: int = 480, base_width: int = 720, device=None):
    """Rotary tables (cos, sin) [S_vid, head_dim] float32 for the video grid.

    The reference hardcodes the aspect-ratio base grid to 720x480 pixels,
    independent of the model's sample dims; RoPE positions are rescaled onto it.
    """
    if not cfg.use_rotary_positional_embeddings:
        return None
    p = cfg.patch_size
    grid_h = height // (vae_spatial * p)
    grid_w = width // (vae_spatial * p)
    base_w = base_width // (vae_spatial * p)
    base_h = base_height // (vae_spatial * p)
    crops = get_resize_crop_region_for_grid((grid_h, grid_w), base_w, base_h)
    cos, sin = get_3d_rotary_pos_embed(cfg.attention_head_dim, crops,
                                       (grid_h, grid_w), num_latent_frames)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def resize_mask_to_latent(mask: torch.Tensor, t_lat: int, h_lat: int, w_lat: int) -> torch.Tensor:
    """[B, T, H, W] -> [B, t_lat, h_lat, w_lat] by nearest resize."""
    return nearest_resize3d_ndhwc(mask[..., None], (t_lat, h_lat, w_lat))[..., 0]


def dynamic_cfg_scales(timesteps: np.ndarray, num_inference_steps: int,
                       guidance_scale: float) -> np.ndarray:
    """Per-step dynamic CFG: 1 + g * (1 - cos(pi * ((S - t)/S)^5)) / 2 with t
    the train timestep value (the reference's formula, kept as it is)."""
    out = []
    for t in timesteps:
        frac = (num_inference_steps - float(t)) / num_inference_steps
        out.append(1.0 + guidance_scale * (1 - math.cos(math.pi * frac**5.0)) / 2.0)
    return np.array(out, dtype=np.float32)


class DenoiseInputs(NamedTuple):
    """Device inputs to the denoise loop. B = real batch (pre-CFG)."""

    latents: torch.Tensor                  # [B, T, h, w, C]
    image_latents: torch.Tensor            # [B, T, h, w, C] first-frame latent + zero pad
    masked_video_latents: torch.Tensor     # [B, T, h, w, C]
    mask: torch.Tensor                     # [B, T, h, w] latent-grid mask (float)
    prompt_embeds: Optional[torch.Tensor]  # [2B, S_text, text_dim] (neg ‖ pos) or [B, ...]
    noise: torch.Tensor                    # [B, T, h, w, C] initial noise (replace_gt)
    video_latents: Optional[torch.Tensor]  # [B, T, h, w, C] clean latents (replace_gt)
    dpm_noises: Optional[torch.Tensor] = None  # [S, B, T, h, w, C] injected SDE noise


@dataclass(frozen=True)
class DenoiseConfig:
    """Options of the denoise loop (dual mode)."""

    num_inference_steps: int
    do_cfg: bool
    use_dynamic_cfg: bool
    guidance_scale: float
    conditioning_scale: float
    replace_gt: bool
    mask_add: bool
    mask_background: bool
    add_first: bool
    use_flash: bool = False
    sequential_cfg: bool = False     # uncond/cond as two B-sized passes
    skip_steps: Optional[Tuple[int, ...]] = None  # reuse the previous pre-CFG
                                     # prediction at these steps (step 0 always runs)


def make_denoise_fn(transformer, branch, scheduler, dcfg: DenoiseConfig,
                    timesteps: np.ndarray,
                    progress_fn: Optional[Callable[[int], None]] = None):
    """Build denoise(inputs, rope, generator) -> final latents.

    progress_fn(i) is called after step i completes on the host side.
    """
    if not isinstance(scheduler, CogVideoXDPMScheduler):
        raise NotImplementedError("only the DPM scheduler is ported so far")
    S = len(timesteps)
    # the scheduler's stride derives from the un-sliced step count; dynamic
    # CFG uses the post-slice count (both as the reference)
    coeffs = scheduler.precompute(dcfg.num_inference_steps, timesteps=np.asarray(timesteps))
    cfg_scales = (dynamic_cfg_scales(timesteps, S, dcfg.guidance_scale)
                  if dcfg.use_dynamic_cfg else
                  np.full(S, dcfg.guidance_scale, dtype=np.float32))

    # replace_gt re-noising: abar at timesteps[i+1] (the last step un-noised)
    abar = scheduler.alphas_cumprod
    sqrt_ab = np.zeros(S, dtype=np.float32)
    sqrt_1mab = np.zeros(S, dtype=np.float32)
    renoise = np.zeros(S, dtype=np.float32)
    for i in range(S - 1):
        a = abar[int(timesteps[i + 1])]
        sqrt_ab[i] = a**0.5
        sqrt_1mab[i] = (1 - a)**0.5
        renoise[i] = 1.0

    run = np.ones(S, dtype=bool)
    for si in dcfg.skip_steps or ():
        if not 0 <= si < S:
            raise ValueError(f"skip step {si} out of range [0, {S})")
        run[si] = False
    if not run[0]:
        raise ValueError("step 0 cannot be skipped (nothing cached yet)")

    def model_pass(inputs: DenoiseInputs, rope, latents, i, embeds, cfg_batch: bool):
        tcfg = transformer.cfg
        rep = (lambda x: torch.cat([x, x], dim=0)) if cfg_batch else (lambda x: x)
        latent_video_input = rep(latents)
        image_latents = rep(inputs.image_latents)
        masked_lat = rep(inputs.masked_video_latents)
        mask = rep(inputs.mask)
        if tcfg.in_channels == 2 * latents.shape[-1]:
            latent_model_input = torch.cat([latent_video_input, image_latents], dim=-1)
        else:
            latent_model_input = latent_video_input
        timestep = torch.full((latent_model_input.shape[0],), int(coeffs.timesteps[i]),
                              dtype=torch.long, device=latents.device)
        branch_cond = torch.cat([masked_lat, mask[..., None]], dim=-1)
        branch_samples = branch(latent_video_input, embeds, branch_cond, timestep,
                                rope=rope, conditioning_scale=dcfg.conditioning_scale,
                                use_flash=dcfg.use_flash)
        return transformer(latent_model_input, embeds, timestep, rope=rope,
                           branch_block_samples=branch_samples,
                           branch_block_masks=mask if dcfg.mask_add else None,
                           add_first=dcfg.add_first, use_flash=dcfg.use_flash).sample

    def model_step(inputs: DenoiseInputs, rope, latents, i):
        if dcfg.do_cfg and dcfg.sequential_cfg:
            b = latents.shape[0]
            out_u = model_pass(inputs, rope, latents, i, inputs.prompt_embeds[:b], False)
            out_c = model_pass(inputs, rope, latents, i, inputs.prompt_embeds[b:], False)
            return torch.cat([out_u, out_c], dim=0)
        return model_pass(inputs, rope, latents, i, inputs.prompt_embeds, dcfg.do_cfg)

    def scheduler_and_blend(inputs: DenoiseInputs, latents, old_x0, noise_pred, i, generator):
        noise_pred = noise_pred.float()
        if dcfg.do_cfg:
            uncond, text = noise_pred.chunk(2, dim=0)
            noise_pred = uncond + float(cfg_scales[i]) * (text - uncond)
        if inputs.dpm_noises is not None:
            sde_noise = inputs.dpm_noises[i]
        else:
            sde_noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                                    device=latents.device)
        latents, x0 = scheduler.step(coeffs, i, noise_pred, old_x0, latents, noise=sde_noise)
        if dcfg.replace_gt:
            dtype = latents.dtype
            src = inputs.video_latents.float()
            init_latents = (src * float(sqrt_ab[i]) + inputs.noise.float() * float(sqrt_1mab[i])) \
                * float(renoise[i]) + src * (1.0 - float(renoise[i]))
            m = inputs.mask[..., None].float()
            latents = latents.float()
            if dcfg.mask_background:
                latents = m * init_latents + (1 - m) * latents
            else:
                latents = (1 - m) * init_latents + m * latents
            latents = latents.to(dtype)
        return latents, x0

    @torch.no_grad()
    def denoise(inputs: DenoiseInputs, rope, generator: Optional[torch.Generator] = None):
        latents, old_x0, pred = inputs.latents, None, None
        for i in range(S):
            if run[i]:
                pred = model_step(inputs, rope, latents, i).float()
            latents, old_x0 = scheduler_and_blend(inputs, latents, old_x0, pred, i, generator)
            if progress_fn is not None:
                progress_fn(i)
        return latents

    return denoise
