"""CogVideoX DDIM scheduler.

Counterpart of `videopainter_tpu/schedulers/ddim.py`. The reference steps
with

    x0   = f(prediction_type, abar_t, x_t, model_output)
    a_t  = sqrt((1-abar_prev)/(1-abar_t))
    b_t  = sqrt(abar_prev) - sqrt(abar_t) * a_t
    x_{t-1} = a_t x_t + b_t x0

`precompute(num_inference_steps)` makes the per-step coefficients on the host
in float64 and keeps them as float32 numpy arrays; `step(coeffs, i, ...)`
reads step i's and runs the update on tensors in float32. Training uses
`add_noise` and `get_velocity` (the x0-space loss).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig
from . import common


class DDIMStepCoeffs(NamedTuple):
    """Per-inference-step coefficients, each a numpy array [S]."""

    timesteps: np.ndarray        # int64: train timestep of each step
    alpha_prod_t: np.ndarray     # float32
    alpha_prod_prev: np.ndarray
    a_t: np.ndarray
    b_t: np.ndarray


class CogVideoXDDIMScheduler:
    order = 1

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.alphas_cumprod = common.compute_alphas_cumprod(config)  # np.float64 [N]
        self.final_alpha_cumprod = 1.0 if config.set_alpha_to_one else float(self.alphas_cumprod[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return common.make_timesteps(self.config, num_inference_steps)

    def precompute(self, num_inference_steps: int,
                   timesteps: Optional[np.ndarray] = None) -> DDIMStepCoeffs:
        if timesteps is None:
            timesteps = self.timesteps(num_inference_steps)
        stride = self.config.num_train_timesteps // num_inference_steps
        abar = self.alphas_cumprod
        rows = []
        for t in timesteps:
            prev_t = int(t) - stride
            ap = abar[int(t)]
            app = abar[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
            a_t = ((1 - app) / (1 - ap)) ** 0.5
            rows.append((ap, app, a_t, app ** 0.5 - ap ** 0.5 * a_t))
        cols = [np.array(c, dtype=np.float64).astype(np.float32) for c in zip(*rows)]
        return DDIMStepCoeffs(np.asarray(timesteps, dtype=np.int64), *cols)

    def step(self, coeffs: DDIMStepCoeffs, i: int, model_output: torch.Tensor,
             sample: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DDIM update at step position i: (prev_sample, pred_original_sample),
        float32 inside, sample's dtype out."""
        c = lambda arr: torch.tensor(float(arr[i]), dtype=torch.float32, device=sample.device)
        x = sample.float()
        x0 = common.pred_original_sample(self.config.prediction_type, c(coeffs.alpha_prod_t),
                                         x, model_output.float())
        prev = c(coeffs.a_t) * x + c(coeffs.b_t) * x0
        return prev.to(sample.dtype), x0.to(sample.dtype)

    def add_noise(self, original, noise, timesteps):
        return common.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def get_velocity(self, sample, noise, timesteps):
        return common.get_velocity(self.alphas_cumprod, sample, noise, timesteps)

    def scale_model_input(self, sample, timestep=None):
        return sample
