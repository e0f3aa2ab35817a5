"""Flagship single-clip dual-stream I2V inpainting pipeline.

Counterpart of `videopainter_tpu/pipelines/inpaint.py`
(CogVideoXI2VDualInpaintPipeline):

 - first-frame image VAE-encoded, zero-padded over latent time;
 - masked video = video * (mask < 0.5) (or >= 0.5 with mask_background),
   VAE-encoded and scaled, with the clean video for replace_gt;
 - latent-grid mask by nearest resize;
 - strength-sliced timesteps, pure-noise or noised-video init;
 - the denoise loop (pipelines/common.py), then one VAE decode.

A prompt is encoded by the pipeline's `text_encoder` (T5, see
`models/text_encoder.py`), or its embeddings are passed in (`prompt_embeds`,
which take precedence). Runs on CUDA unless `device="cpu"` is passed.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..models.branch import CogVideoXBranch
from ..models.dit import CogVideoXTransformer3D
from ..models.text_encoder import T5TextEncoder
from ..models.vae import AutoencoderKLCogVideoX
from ..schedulers import CogVideoXDPMScheduler
from .common import (DenoiseConfig, DenoiseInputs, get_strength_timesteps,
                     make_denoise_fn, prepare_rope, resize_mask_to_latent)


class CogVideoXI2VDualInpaintPipeline:
    """Holds the three models, the scheduler and optionally a text encoder;
    the models' weights and device are the pipeline's (`to` moves them). The
    text encoder stays where it was built."""

    def __init__(self, transformer: CogVideoXTransformer3D, branch: CogVideoXBranch,
                 vae: AutoencoderKLCogVideoX, scheduler: CogVideoXDPMScheduler,
                 text_encoder: Optional[T5TextEncoder] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.transformer = transformer.to(self.device).eval()
        self.branch = branch.to(self.device).eval()
        self.vae = vae.to(self.device).eval()
        self.scheduler = scheduler
        self.text_encoder = text_encoder
        self.vae_scale_factor_spatial = vae.cfg.spatial_compression_ratio
        self.vae_scale_factor_temporal = vae.cfg.temporal_compression_ratio

    def encode_prompt(self, prompt: Optional[str], negative_prompt: str = "",
                      max_sequence_length: int = 226) -> Tuple[torch.Tensor, torch.Tensor]:
        """T5 embeddings of the prompt and the negative prompt, each
        [1, max_sequence_length, d_model]. Requires a text encoder."""
        if self.text_encoder is None:
            raise ValueError("no text encoder configured; pass prompt_embeds instead")
        return (self.text_encoder.encode(prompt, max_length=max_sequence_length),
                self.text_encoder.encode(negative_prompt, max_length=max_sequence_length))

    def _prompt_embeds(self, prompt, negative_prompt, prompt_embeds, negative_prompt_embeds,
                       do_cfg: bool) -> torch.Tensor:
        """The conditioning batch on the pipeline's device: given embeddings,
        or the prompts encoded (at the DiT's text length) when none are given;
        with CFG [negative, positive]."""
        if prompt_embeds is None:
            prompt_embeds, negative_prompt_embeds = self.encode_prompt(
                prompt, negative_prompt, self.transformer.cfg.max_text_seq_length)
        if not do_cfg:
            return prompt_embeds.to(self.device)
        if negative_prompt_embeds is None:
            raise ValueError("CFG requires negative_prompt_embeds")
        return torch.cat([negative_prompt_embeds.to(self.device),
                          prompt_embeds.to(self.device)], dim=0)

    def _vae_encode(self, x, generator, sample_mode):
        dist = self.vae.encode(x)
        lat = dist.sample(generator) if sample_mode == "sample" else dist.mode()
        return lat * self.vae.cfg.scaling_factor

    @torch.no_grad()
    def prepare_inputs(
        self, *,
        video: torch.Tensor,                  # [B, T, H, W, 3] in [-1, 1]
        image: Optional[torch.Tensor] = None,  # [B, H, W, 3] in [-1, 1] (pixels), or
                                              # [B, 1, h, w, C] (a latent: any-length path)
        masks: torch.Tensor,                  # [B, T, H, W] float 0/1 (1 = hole)
        generator: Optional[torch.Generator] = None,
        strength: float = 1.0,
        timesteps: Optional[np.ndarray] = None,
        mask_background: bool = False,
        vae_sample_mode: str = "sample",
        init_noise: Optional[torch.Tensor] = None,
        dtype=torch.float32,
    ) -> DenoiseInputs:
        """VAE prep. Returns DenoiseInputs without the prompt embeddings."""
        b, t, height, width, _ = video.shape
        t_lat = (t - 1) // self.vae_scale_factor_temporal + 1
        h_lat = height // self.vae_scale_factor_spatial
        w_lat = width // self.vae_scale_factor_spatial
        c_lat = self.vae.cfg.latent_channels
        dev = self.device
        video = video.to(dev, dtype)
        masks = masks.to(dev, torch.float32)

        if image is None:
            image_latents = torch.zeros((b, 1, h_lat, w_lat, c_lat), dtype=dtype, device=dev)
        elif image.ndim == 5:
            image_latents = image.to(dev, dtype)   # already a latent
        else:
            image_latents = self._vae_encode(image.to(dev, dtype)[:, None], generator,
                                             vae_sample_mode).to(dtype)
        pad = torch.zeros((b, t_lat - 1, h_lat, w_lat, c_lat), dtype=dtype, device=dev)
        image_latents = torch.cat([image_latents, pad], dim=1)

        keep = (masks < 0.5) if not mask_background else (masks >= 0.5)
        masked_video = video * keep[..., None].to(video.dtype)
        masked_video_latents = self._vae_encode(masked_video, generator,
                                                vae_sample_mode).to(dtype)
        mask_lat = resize_mask_to_latent(masks, t_lat, h_lat, w_lat)
        video_latents = self._vae_encode(video, generator, vae_sample_mode).to(dtype)

        if init_noise is not None:
            noise = init_noise.to(dev, dtype)
        else:
            noise = torch.randn((b, t_lat, h_lat, w_lat, c_lat), generator=generator,
                                dtype=torch.float32, device=dev).to(dtype)
        if strength >= 1.0:
            latents = noise * self.scheduler.init_noise_sigma
        else:
            if timesteps is None:
                raise ValueError("strength < 1 requires timesteps")
            latents = self.scheduler.add_noise(video_latents, noise,
                                               np.full((b,), int(timesteps[0])))
        return DenoiseInputs(latents=latents, image_latents=image_latents,
                             masked_video_latents=masked_video_latents,
                             mask=mask_lat.to(dtype), prompt_embeds=None, noise=noise,
                             video_latents=video_latents)

    @torch.no_grad()
    def __call__(
        self, *,
        video: torch.Tensor,
        masks: torch.Tensor,
        prompt: Optional[str] = None,
        negative_prompt: str = "",
        prompt_embeds: Optional[torch.Tensor] = None,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        image: Optional[torch.Tensor] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        use_dynamic_cfg: bool = False,
        strength: float = 1.0,
        conditioning_scale: float = 1.0,
        replace_gt: bool = False,
        mask_add: bool = False,
        mask_background: bool = False,
        add_first: bool = False,
        wo_text: bool = False,
        id_pool_resample: bool = False,
        generator: Optional[torch.Generator] = None,
        vae_sample_mode: str = "sample",
        init_noise: Optional[torch.Tensor] = None,
        dpm_noises: Optional[torch.Tensor] = None,
        output_type: str = "np",
        use_flash: Union[bool, str] = False,
        sequential_cfg: bool = False,
        skip_steps: Optional[Tuple[int, ...]] = None,
        progress_fn: Optional[Callable[[int, int], None]] = None,
        dtype=torch.float32,
    ):
        """Returns the decoded video [B, T, H, W, 3] in [-1, 1] (numpy for
        output_type="np", a tensor for "pt", latents for "latent").

        prompt / negative_prompt: encoded by the text encoder when no
        prompt_embeds are given (prompt_embeds take precedence).
        use_flash: True for the hand-written bf16 flash-attention kernel,
        "int8" / "int8pv" for the int8 one (their plain versions on the CPU).
        """
        if video.shape[1] > 49:
            raise ValueError(f"num_frames {video.shape[1]} > 49; longer videos need "
                             "the any-length pipeline")
        do_cfg = guidance_scale > 1.0
        dev = self.device
        embeds = self._prompt_embeds(prompt, negative_prompt, prompt_embeds,
                                     negative_prompt_embeds, do_cfg)

        ts_full = self.scheduler.timesteps(num_inference_steps)
        timesteps, _ = get_strength_timesteps(ts_full, num_inference_steps, strength)

        inputs = self.prepare_inputs(
            image=image, video=video, masks=masks, generator=generator, strength=strength,
            timesteps=timesteps, mask_background=mask_background,
            vae_sample_mode=vae_sample_mode, init_noise=init_noise, dtype=dtype)
        inputs = inputs._replace(prompt_embeds=embeds.to(dtype))
        if dpm_noises is not None:
            inputs = inputs._replace(dpm_noises=dpm_noises.to(dev, dtype))

        rope = prepare_rope(self.transformer.cfg, video.shape[2], video.shape[3],
                            inputs.latents.shape[1], self.vae_scale_factor_spatial,
                            device=dev)
        dcfg = DenoiseConfig(
            num_inference_steps=num_inference_steps, do_cfg=do_cfg,
            use_dynamic_cfg=use_dynamic_cfg, guidance_scale=guidance_scale,
            conditioning_scale=conditioning_scale, replace_gt=replace_gt,
            mask_add=mask_add, mask_background=mask_background, add_first=add_first,
            wo_text=wo_text, id_pool_resample=id_pool_resample,
            use_flash=use_flash, sequential_cfg=sequential_cfg,
            skip_steps=tuple(skip_steps) if skip_steps else None)
        n_steps = len(timesteps)
        denoise = make_denoise_fn(
            self.transformer, self.branch, self.scheduler, dcfg, timesteps,
            progress_fn=(None if progress_fn is None
                         else lambda i: progress_fn(i + 1, n_steps)))
        latents, _, _ = denoise(inputs, rope, generator)

        if output_type == "latent":
            return latents
        video_out = self.vae.decode(latents / self.vae.cfg.scaling_factor)
        video_out = torch.clamp(video_out, -1, 1)
        if output_type == "np":
            return video_out.float().cpu().numpy()
        return video_out
