from .common import (add_noise, compute_alphas_cumprod, make_timesteps,
                     pred_original_sample, rescale_zero_terminal_snr)
from .dpm import CogVideoXDPMScheduler, DPMStepCoeffs

__all__ = [
    "compute_alphas_cumprod", "rescale_zero_terminal_snr", "make_timesteps",
    "add_noise", "pred_original_sample",
    "CogVideoXDPMScheduler", "DPMStepCoeffs",
]
