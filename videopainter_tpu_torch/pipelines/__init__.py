from .common import (DenoiseConfig, DenoiseInputs, capture_token_indices, dynamic_cfg_scales,
                     get_strength_timesteps, make_denoise_fn, parse_skip_steps, prepare_rope,
                     resize_mask_to_latent, uniform_skip_steps)
from .generation import (CogVideoXImageToVideoPipeline, CogVideoXPipeline,
                         CogVideoXVideoToVideoPipeline)
from .inpaint import CogVideoXI2VDualInpaintPipeline
from .inpaint_anyl import CogVideoXI2VDualInpaintAnyLPipeline
from .variants import (CogVideoXDualInpaintPipeline, CogVideoXI2VInpaintAnyLPipeline,
                       CogVideoXImageToVideoInpaintPipeline, CogVideoXInpaintPipeline,
                       CogVideoXSelfGuidanceInpaintPipeline, CogVideoXSFTInpaintPipeline,
                       init_sft_from_transformer, make_sft_inpaint_transformer,
                       share_transformer)

__all__ = ["DenoiseConfig", "DenoiseInputs", "capture_token_indices", "dynamic_cfg_scales",
           "get_strength_timesteps", "make_denoise_fn", "parse_skip_steps", "prepare_rope",
           "resize_mask_to_latent", "uniform_skip_steps",
           "CogVideoXPipeline", "CogVideoXImageToVideoPipeline", "CogVideoXVideoToVideoPipeline",
           "CogVideoXI2VDualInpaintPipeline", "CogVideoXI2VDualInpaintAnyLPipeline",
           "CogVideoXDualInpaintPipeline", "CogVideoXSFTInpaintPipeline",
           "CogVideoXI2VInpaintAnyLPipeline", "CogVideoXSelfGuidanceInpaintPipeline",
           "CogVideoXInpaintPipeline", "CogVideoXImageToVideoInpaintPipeline",
           "make_sft_inpaint_transformer", "init_sft_from_transformer", "share_transformer"]
