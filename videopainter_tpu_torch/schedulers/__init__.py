from .common import (add_noise, compute_alphas_cumprod, get_velocity, make_timesteps,
                     pred_original_sample, rescale_zero_terminal_snr)
from .ddim import CogVideoXDDIMScheduler, DDIMStepCoeffs
from .dpm import CogVideoXDPMScheduler, DPMStepCoeffs

__all__ = [
    "compute_alphas_cumprod", "rescale_zero_terminal_snr", "make_timesteps",
    "add_noise", "get_velocity", "pred_original_sample",
    "CogVideoXDDIMScheduler", "DDIMStepCoeffs",
    "CogVideoXDPMScheduler", "DPMStepCoeffs",
]
