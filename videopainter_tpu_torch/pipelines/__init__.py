from .common import (DenoiseConfig, DenoiseInputs, dynamic_cfg_scales,
                     get_strength_timesteps, make_denoise_fn, prepare_rope,
                     resize_mask_to_latent)
from .inpaint import CogVideoXI2VDualInpaintPipeline

__all__ = ["DenoiseConfig", "DenoiseInputs", "dynamic_cfg_scales",
           "get_strength_timesteps", "make_denoise_fn", "prepare_rope",
           "resize_mask_to_latent", "CogVideoXI2VDualInpaintPipeline"]
