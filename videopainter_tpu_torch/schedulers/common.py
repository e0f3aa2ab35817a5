"""Shared noise-schedule math for the CogVideoX schedulers.

Schedule constants are computed on the host in float64 numpy (the
reference's float64 `scaled_linear` beta path); the per-step update runs on
tensors in float32. Counterpart of `videopainter_tpu/schedulers/common.py`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SchedulerConfig


def _betas_for_alpha_bar(num_steps: int, max_beta: float = 0.999) -> np.ndarray:
    # Glide cosine schedule ("squaredcos_cap_v2").
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = [
        min(1.0 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps), max_beta)
        for i in range(num_steps)
    ]
    return np.array(betas, dtype=np.float64)


def rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR rescale (arXiv:2305.08891 alg. 1) of alphas_cumprod."""
    a_sqrt = np.sqrt(alphas_cumprod)
    a0, aT = a_sqrt[0], a_sqrt[-1]
    a_sqrt = a_sqrt - aT
    a_sqrt = a_sqrt * (a0 / (a0 - aT))
    return a_sqrt**2


def compute_alphas_cumprod(cfg: SchedulerConfig) -> np.ndarray:
    """Float64 alphas_cumprod with the CogVideoX SNR shift (and optional zero-SNR)."""
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, n, dtype=np.float64) ** 2
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        betas = _betas_for_alpha_bar(n)
    else:
        raise NotImplementedError(f"beta_schedule={cfg.beta_schedule}")

    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    # SNR shift following SD3: abar <- abar / (s + (1-s)*abar)
    s = cfg.snr_shift_scale
    alphas_cumprod = alphas_cumprod / (s + (1 - s) * alphas_cumprod)
    if cfg.rescale_betas_zero_snr:
        alphas_cumprod = rescale_zero_terminal_snr(alphas_cumprod)
    return alphas_cumprod


def make_timesteps(cfg: SchedulerConfig, num_inference_steps: int) -> np.ndarray:
    """Descending int64 timesteps per the configured spacing."""
    n = cfg.num_train_timesteps
    if num_inference_steps > n:
        raise ValueError(f"num_inference_steps {num_inference_steps} > {n}")
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps).round()[::-1].astype(np.int64)
    elif cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
        ts = ts + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        ts = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(f"timestep_spacing={cfg.timestep_spacing}")
    return np.ascontiguousarray(ts)


def _abar_at(alphas_cumprod: np.ndarray, timesteps, ref: torch.Tensor) -> torch.Tensor:
    """float32 abar[t] on ref's device, broadcastable against ref."""
    ab = torch.as_tensor(np.asarray(alphas_cumprod, dtype=np.float32), device=ref.device)
    if torch.is_tensor(timesteps):
        t = timesteps.to(device=ref.device, dtype=torch.long)
    else:
        t = torch.as_tensor(np.asarray(timesteps), device=ref.device, dtype=torch.long)
    abar = ab[t]
    while abar.ndim < ref.ndim:
        abar = abar[..., None]
    return abar


def add_noise(alphas_cumprod: np.ndarray, original: torch.Tensor, noise: torch.Tensor,
              timesteps) -> torch.Tensor:
    """x_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps; timesteps int [B] or scalar."""
    abar = _abar_at(alphas_cumprod, timesteps, original)
    return (torch.sqrt(abar) * original.float()
            + torch.sqrt(1.0 - abar) * noise.float()).to(original.dtype)


def get_velocity(alphas_cumprod: np.ndarray, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps) -> torch.Tensor:
    """v = sqrt(abar_t) eps - sqrt(1-abar_t) x_0, in sample's dtype."""
    abar = _abar_at(alphas_cumprod, timesteps, sample)
    return (torch.sqrt(abar) * noise.float()
            - torch.sqrt(1.0 - abar) * sample.float()).to(sample.dtype)


def pred_original_sample(prediction_type: str, alpha_prod_t, sample, model_output):
    """Recover x0 from the model output at noise level alpha_prod_t
    (a float32 tensor broadcastable against sample)."""
    beta_prod_t = 1.0 - alpha_prod_t
    if prediction_type == "epsilon":
        return (sample - beta_prod_t**0.5 * model_output) / alpha_prod_t**0.5
    if prediction_type == "sample":
        return model_output
    if prediction_type == "v_prediction":
        return alpha_prod_t**0.5 * sample - beta_prod_t**0.5 * model_output
    raise ValueError(f"prediction_type={prediction_type}")
