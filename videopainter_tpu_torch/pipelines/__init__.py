from .common import (DenoiseConfig, DenoiseInputs, capture_token_indices, dynamic_cfg_scales,
                     get_strength_timesteps, make_denoise_fn, prepare_rope,
                     resize_mask_to_latent)
from .inpaint import CogVideoXI2VDualInpaintPipeline
from .inpaint_anyl import CogVideoXI2VDualInpaintAnyLPipeline

__all__ = ["DenoiseConfig", "DenoiseInputs", "capture_token_indices", "dynamic_cfg_scales",
           "get_strength_timesteps", "make_denoise_fn", "prepare_rope",
           "resize_mask_to_latent", "CogVideoXI2VDualInpaintPipeline",
           "CogVideoXI2VDualInpaintAnyLPipeline"]
