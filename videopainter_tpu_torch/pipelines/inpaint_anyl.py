"""Any-length dual-stream I2V inpainting: sliding windows with cross-clip ID
resampling.

Counterpart of `videopainter_tpu/pipelines/inpaint_anyl.py`
(CogVideoXI2VDualInpaintAnyLPipeline):

 - window count n_windows = (total - num_frames) // stride + 1;
 - window 0 is conditioned on the given first-frame image, later windows on
   the previous window's latent at the overlap position;
 - per-layer hidden states and the resample mask are captured at the final
   step of each window and fed to the next window's attention as
   prev_hidden_states / prev_resample_mask / prev_clip_weight; on the
   ID-resample path the capture keeps only the masked-region tokens
   (`compress_capture`, exact) and can store them as per-token int8
   (`capture_int8`);
 - a latent frame accumulator is averaged over overlapping windows, then one
   VAE decode.

The window loop is host-level Python; every window runs the same denoise
loop. The streaming decode of the JAX package belongs to a later slice of the
port: `stream_decode=True` raises.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .common import (DenoiseConfig, capture_token_indices, get_strength_timesteps,
                     make_denoise_fn, prepare_rope)
from .inpaint import CogVideoXI2VDualInpaintPipeline


class CogVideoXI2VDualInpaintAnyLPipeline(CogVideoXI2VDualInpaintPipeline):

    @torch.no_grad()
    def __call__(  # noqa: C901
        self, *,
        video: torch.Tensor,                  # [B, T_total, H, W, 3]
        masks: torch.Tensor,                  # [B, T_total, H, W]
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: Optional[torch.Tensor] = None,
        image: Optional[torch.Tensor] = None,  # [B, H, W, 3] first frame (pixels)
        num_frames: int = 49,
        stride: Optional[int] = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        use_dynamic_cfg: bool = False,
        strength: float = 1.0,
        conditioning_scale: float = 1.0,
        prev_clip_weight: float = 0.0,
        replace_gt: bool = False,
        mask_add: bool = False,
        mask_background: bool = False,
        add_first: bool = False,
        wo_text: bool = False,
        id_pool_resample: bool = False,
        generator: Optional[torch.Generator] = None,
        vae_sample_mode: str = "sample",
        init_noises: Optional[List[torch.Tensor]] = None,     # per-window init noise
        dpm_noises_list: Optional[List[torch.Tensor]] = None,  # per-window [S, ...] SDE noise
        output_type: str = "np",
        use_flash: Union[bool, str] = False,
        sequential_cfg: bool = False,
        skip_steps: Optional[Tuple[int, ...]] = None,  # the capture step always evaluates
        stream_decode: bool = False,
        compress_capture: Optional[int] = 2048,  # bucket of the compressed cross-window
        # capture (ID-resample path only; exact, see common.capture_token_indices).
        # None / 0 keeps the full [L, 2B, S, D] state.
        capture_int8: bool = False,  # additionally store the compressed capture as
        # per-token int8 (+ scales); pairs with the W8A8 serving mode, which
        # quantizes these states at the projections anyway
        progress_fn: Optional[Callable[[int, int], None]] = None,  # (done, total) over windows
        dtype=torch.float32,
    ):
        """Returns the decoded video [B, T_total, H, W, 3] in [-1, 1] (numpy
        for output_type="np", a tensor for "pt", the averaged latents for
        "latent")."""
        if stream_decode:
            raise NotImplementedError(
                "stream_decode belongs to a later slice of the port (the VAE's "
                "streaming decoder); the windows are decoded in one VAE call")
        dev = self.device
        b, total_frames = video.shape[0], video.shape[1]
        stride = stride if stride is not None else num_frames
        if stride > num_frames:
            raise ValueError(f"stride {stride} > num_frames {num_frames}")
        if (total_frames - num_frames) % stride != 0:
            raise ValueError(
                f"total_frames {total_frames} must satisfy (total - num_frames) % stride == 0")
        n_windows = (total_frames - num_frames) // stride + 1
        tc = self.vae_scale_factor_temporal
        t_lat = (num_frames - 1) // tc + 1
        overlap_lat = (num_frames - stride) // tc
        if stride < num_frames:
            num_frame_latents = t_lat * n_windows - (n_windows - 1) * (overlap_lat + 1)
        else:
            num_frame_latents = (t_lat - 1) * n_windows + 1

        do_cfg = guidance_scale > 1.0
        if do_cfg:
            if negative_prompt_embeds is None:
                raise ValueError("CFG requires negative_prompt_embeds")
            embeds = torch.cat([negative_prompt_embeds.to(dev), prompt_embeds.to(dev)], dim=0)
        else:
            embeds = prompt_embeds.to(dev)
        embeds = embeds.to(dtype)

        ts_full = self.scheduler.timesteps(num_inference_steps)
        timesteps, _ = get_strength_timesteps(ts_full, num_inference_steps, strength)
        n_steps = len(timesteps)

        h_lat = video.shape[2] // self.vae_scale_factor_spatial
        w_lat = video.shape[3] // self.vae_scale_factor_spatial
        c_lat = self.vae.cfg.latent_channels
        rope = prepare_rope(self.transformer.cfg, video.shape[2], video.shape[3], t_lat,
                            self.vae_scale_factor_spatial, device=dev)

        accumulator = torch.zeros((b, num_frame_latents, h_lat, w_lat, c_lat), dtype=dtype,
                                  device=dev)
        counts = np.zeros(num_frame_latents, dtype=np.float32)

        base_dcfg = DenoiseConfig(
            num_inference_steps=num_inference_steps, do_cfg=do_cfg,
            use_dynamic_cfg=use_dynamic_cfg, guidance_scale=guidance_scale,
            conditioning_scale=conditioning_scale, replace_gt=replace_gt,
            mask_add=mask_add, mask_background=mask_background, add_first=add_first,
            wo_text=wo_text, id_pool_resample=id_pool_resample,
            use_flash=use_flash, sequential_cfg=sequential_cfg,
            skip_steps=tuple(skip_steps) if skip_steps else None)

        def window_start(w: int) -> int:
            if w == 0:
                return 0
            if stride < num_frames:
                return w * t_lat - (overlap_lat + 1) * w
            return w * t_lat - w

        # Capture per-layer states only when the next window will use them: with
        # weight 0 the blend is the identity, and the captured stack is large.
        wants_prev = id_pool_resample or (prev_clip_weight or 0.0) > 0.0
        # Compressed capture, on the ID-resample path only (the prev-clip blend
        # reads the full prev keys and values)
        can_compress = (bool(compress_capture) and id_pool_resample
                        and self.transformer.cfg.id_pool_resample_learnable and mask_add)

        prev_state: Optional[Dict[str, Any]] = None
        latents = None
        for window_idx in range(n_windows):
            s = window_idx * stride
            if window_idx == 0:
                image_ = image
            elif overlap_lat > 0:
                # the previous window's latent at the overlap position
                image_ = latents[:, -overlap_lat - 1:-overlap_lat]
            else:
                image_ = latents[:, -1:]

            inputs = self.prepare_inputs(
                image=image_, video=video[:, s:s + num_frames],
                masks=masks[:, s:s + num_frames], generator=generator, strength=strength,
                timesteps=timesteps, mask_background=mask_background,
                vae_sample_mode=vae_sample_mode,
                init_noise=(init_noises[window_idx] if init_noises else None), dtype=dtype)
            inputs = inputs._replace(prompt_embeds=embeds)
            if dpm_noises_list is not None:
                inputs = inputs._replace(dpm_noises=dpm_noises_list[window_idx].to(dev, dtype))

            capture = wants_prev and window_idx < n_windows - 1
            if capture and can_compress:
                inputs = inputs._replace(capture_indices=capture_token_indices(
                    inputs.mask, self.transformer.cfg.patch_size,
                    text_len=embeds.shape[1], bucket=int(compress_capture)))
            dcfg = dc_replace(base_dcfg, capture_hidden_states=capture,
                              capture_quant=bool(capture_int8 and capture and can_compress))
            base_done, total = window_idx * n_steps, n_windows * n_steps
            denoise = make_denoise_fn(
                self.transformer, self.branch, self.scheduler, dcfg, timesteps,
                progress_fn=(None if progress_fn is None else
                             lambda i, done=base_done: progress_fn(done + i + 1, total)))
            latents, hs_list, resample_mask = denoise(inputs, rope, generator, prev_state)

            if capture:
                prev_state = {"prev_hidden_states": hs_list,
                              "prev_resample_mask": resample_mask,
                              "prev_clip_weight": prev_clip_weight}
                if inputs.capture_indices is not None:
                    ci = inputs.capture_indices
                    prev_state["prev_hidden_indices"] = (torch.cat([ci, ci], dim=0)
                                                         if do_cfg else ci)
            else:
                # release the cross-window state the moment no later window reads it
                prev_state = None
            hs_list = resample_mask = None

            # accumulate into the global latent timeline
            start = window_start(window_idx)
            accumulator[:, start:start + t_lat] += latents.to(dtype)
            counts[start:start + t_lat] += 1

        accumulator = accumulator / torch.from_numpy(np.maximum(counts, 1.0)).to(
            dev, accumulator.dtype)[None, :, None, None, None]
        if output_type == "latent":
            return accumulator
        video_out = self.vae.decode(accumulator / self.vae.cfg.scaling_factor)
        video_out = torch.clamp(video_out, -1, 1)
        if output_type == "np":
            return video_out.float().cpu().numpy()
        return video_out
