"""CogVideoX DPM-Solver++ (SDE, 2M-style) scheduler.

Counterpart of `videopainter_tpu/schedulers/dpm.py`. The per-step
coefficients are computed on the host in float64 and kept as float32 numpy
arrays; `step` reads step i's coefficients and runs the update on tensors in
float32. The multistep state (the previous step's x0 prediction) is an
explicit argument and return value, carried by the caller's loop:

    lamb  = log(sqrt(abar/(1-abar)))
    h     = lamb_next - lamb ;  r = h_last / h
    m1    = sqrt((1-abar_prev)/(1-abar)) * exp(-h)
    m2    = expm1(-2h) * sqrt(abar_prev)
    m3    = 1 + 1/(2r) ; m4 = 1/(2r)
    mn    = sqrt(1-abar_prev) * sqrt(1 - exp(-2h))
    first-order:  x' = m1 x - m2 x0 + mn eps
    second-order: x' = m1 x - m2 (m3 x0 - m4 old_x0) + mn eps   (step > 0, prev_t >= 0)
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import SchedulerConfig
from . import common


class DPMStepCoeffs(NamedTuple):
    """Per-inference-step coefficients, each a numpy array [S]."""

    timesteps: np.ndarray        # int64
    alpha_prod_t: np.ndarray     # float32
    alpha_prod_prev: np.ndarray
    mult1: np.ndarray
    mult2: np.ndarray
    mult3: np.ndarray            # second-order; 0 where unused
    mult4: np.ndarray
    mult_noise: np.ndarray
    use_multistep: np.ndarray    # bool: second-order branch taken
    null_noise: np.ndarray       # bool: last step (prev_t < 0)


class CogVideoXDPMScheduler:
    """DPM scheduler with an explicit multistep carry."""

    order = 1

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.alphas_cumprod = common.compute_alphas_cumprod(config)
        self.final_alpha_cumprod = 1.0 if config.set_alpha_to_one else float(self.alphas_cumprod[0])
        self.init_noise_sigma = 1.0

    def timesteps(self, num_inference_steps: int) -> np.ndarray:
        return common.make_timesteps(self.config, num_inference_steps)

    def precompute(self, num_inference_steps: int,
                   timesteps: Optional[np.ndarray] = None) -> DPMStepCoeffs:
        if timesteps is None:
            timesteps = self.timesteps(num_inference_steps)
        n = self.config.num_train_timesteps
        stride = n // num_inference_steps
        abar = self.alphas_cumprod

        def lam(a):
            # np.float64: a==1.0 gives +inf and a==0.0 gives -inf, the limits
            # the reference's math relies on at the last step
            a = np.float64(a)
            with np.errstate(divide="ignore"):
                return np.log((a / (1 - a)) ** 0.5)

        rows = []
        for idx, t in enumerate(timesteps):
            t = int(t)
            prev_t = t - stride
            t_back = int(timesteps[idx - 1]) if idx > 0 else None
            ap = abar[t]
            app = abar[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
            h = lam(app) - lam(ap)
            m1 = ((1 - app) / (1 - ap)) ** 0.5 * np.exp(-h)
            m2 = np.expm1(-2 * h) * app**0.5
            mn = (1 - app) ** 0.5 * (1 - np.exp(-2 * h)) ** 0.5
            use_ms = (t_back is not None) and (prev_t >= 0)
            if use_ms:
                h_last = lam(ap) - lam(abar[t_back])
                r = h_last / h
                m3 = 1 + 1 / (2 * r)
                m4 = 1 / (2 * r)
            else:
                m3, m4 = 0.0, 0.0
            rows.append((t, ap, app, m1, m2, m3, m4, mn, use_ms, prev_t < 0))

        cols = list(zip(*rows))
        f32 = lambda c: np.array(c, dtype=np.float64).astype(np.float32)
        return DPMStepCoeffs(
            timesteps=np.array(cols[0], dtype=np.int64),
            alpha_prod_t=f32(cols[1]),
            alpha_prod_prev=f32(cols[2]),
            mult1=f32(cols[3]),
            mult2=f32(cols[4]),
            mult3=f32(cols[5]),
            mult4=f32(cols[6]),
            mult_noise=f32(cols[7]),
            use_multistep=np.array(cols[8], dtype=bool),
            null_noise=np.array(cols[9], dtype=bool),
        )

    def step(self, coeffs: DPMStepCoeffs, i: int, model_output: torch.Tensor,
             old_pred_original_sample: Optional[torch.Tensor], sample: torch.Tensor,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DPM update at step position i.

        Returns (prev_sample, pred_original_sample); pass the returned x0 back
        as `old_pred_original_sample` on the next step (None on the first).
        `noise` is this step's SDE noise (None: deterministic ODE variant).
        """
        dev = sample.device
        c = lambda arr: torch.tensor(float(arr[i]), dtype=torch.float32, device=dev)
        mo = model_output.float()
        x = sample.float()
        x0 = common.pred_original_sample(self.config.prediction_type,
                                         c(coeffs.alpha_prod_t), x, mo)
        if bool(coeffs.use_multistep[i]):
            target = c(coeffs.mult3) * x0 - c(coeffs.mult4) * old_pred_original_sample.float()
        else:
            target = x0
        prev = c(coeffs.mult1) * x - c(coeffs.mult2) * target
        if noise is not None:
            prev = prev + c(coeffs.mult_noise) * noise.float()
        return prev.to(sample.dtype), x0.to(sample.dtype)

    def add_noise(self, original, noise, timesteps):
        return common.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def scale_model_input(self, sample, timestep=None):
        return sample
