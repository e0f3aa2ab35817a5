"""The stock CogVideoX generation pipelines, without inpainting conditioning.

Counterpart of `videopainter_tpu/pipelines/generation.py`: the upstream
`CogVideoXPipeline` (T2V), `CogVideoXImageToVideoPipeline` (I2V) and
`CogVideoXVideoToVideoPipeline` (V2V at a strength), which back the
VideoPainter stack, as thin wrappers over the same denoise loop (mode
"plain", no branch, an all-zero mask, no blend).
"""

from __future__ import annotations

import torch

from .inpaint import CogVideoXI2VDualInpaintPipeline


class _GenerationBase(CogVideoXI2VDualInpaintPipeline):
    _mode = "plain"

    def __init__(self, transformer, vae, scheduler, text_encoder=None, *, device=None):
        super().__init__(transformer, None, vae, scheduler, text_encoder, device=device)

    def _generate(self, *, num_frames: int, height: int, width: int, image=None, video=None,
                  strength: float = 1.0, **kw):
        if video is None:
            # pure generation: a blank video only sets the latent shapes (no
            # blend, so its latents never reach the output)
            video = torch.zeros((1, num_frames, height, width, 3), device=self.device)
        masks = torch.zeros(video.shape[:4], device=video.device)
        return super().__call__(video=video, masks=masks, image=image, strength=strength,
                                replace_gt=False, mask_add=False, **kw)


class CogVideoXPipeline(_GenerationBase):
    """Text to video."""

    def __call__(self, *, num_frames: int = 49, height: int = 480, width: int = 720, **kw):
        return self._generate(num_frames=num_frames, height=height, width=width, **kw)


class CogVideoXImageToVideoPipeline(_GenerationBase):
    """Image to video: first-frame conditioned (an I2V backbone, in_channels
    twice the latent channels)."""

    def __call__(self, *, image, num_frames: int = 49, height: int = 480, width: int = 720,
                 **kw):
        return self._generate(num_frames=num_frames, height=height, width=width, image=image,
                              **kw)


class CogVideoXVideoToVideoPipeline(_GenerationBase):
    """Video to video: the initial latents are the input video's, noised to
    `strength`."""

    def __call__(self, *, video, strength: float = 0.8, **kw):
        return self._generate(num_frames=video.shape[1], height=video.shape[2],
                              width=video.shape[3], video=video, strength=strength, **kw)
