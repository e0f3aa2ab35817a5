"""Plain reference of the served loop's arithmetic around the model: the
CogVideoX noise schedule (scaled-linear betas, the SNR shift, the
zero-terminal-SNR rescale, trailing timesteps), dynamic CFG, one step of the
DPM-Solver++ (2M, SDE) update with v-prediction, and VideoPainter's
replace_gt blend. Schedule constants in float64, tensors in float32.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def alphas_cumprod(sched: dict) -> np.ndarray:
    n = sched["num_train_timesteps"]
    betas = np.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, n,
                        dtype=np.float64) ** 2
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError("the reference covers the scaled_linear schedule")
    abar = np.cumprod(1.0 - betas)
    s = sched["snr_shift_scale"]
    abar = abar / (s + (1 - s) * abar)
    if sched["rescale_betas_zero_snr"]:
        r = np.sqrt(abar)
        r0, rt = r[0], r[-1]
        abar = ((r - rt) * (r0 / (r0 - rt))) ** 2
    return abar


def timesteps(sched: dict, steps: int) -> np.ndarray:
    n = sched["num_train_timesteps"]
    if sched["timestep_spacing"] != "trailing":
        raise ValueError("the reference covers trailing timesteps")
    return np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1


def cfg_scale(t: int, steps: int, guidance: float, dynamic: bool) -> float:
    """CogVideoX's dynamic CFG, with the train timestep t as its pipeline
    writes it."""
    if not dynamic:
        return guidance
    return 1 + guidance * (1 - math.cos(math.pi * ((steps - t) / steps) ** 5.0)) / 2


class DPMStep:
    """Step k of `steps` of the DPM-Solver++ SDE sampler."""

    def __init__(self, sched: dict, steps: int, k: int):
        self.abar = alphas_cumprod(sched)
        self.ts = timesteps(sched, steps)
        self.k, self.steps = k, steps
        stride = sched["num_train_timesteps"] // steps
        t = int(self.ts[k])
        prev_t = t - stride
        final = 1.0 if sched.get("set_alpha_to_one", True) else self.abar[0]
        a, ap = self.abar[t], (self.abar[prev_t] if prev_t >= 0 else final)
        lam = lambda x: 0.5 * math.log(x / (1 - x)) if 0 < x < 1 else (
            math.inf if x >= 1 else -math.inf)
        h = lam(ap) - lam(a)
        self.a = a
        self.m1 = math.sqrt((1 - ap) / (1 - a)) * math.exp(-h)
        self.m2 = math.expm1(-2 * h) * math.sqrt(ap)
        self.mn = math.sqrt(1 - ap) * math.sqrt(-math.expm1(-2 * h))
        self.multistep = k > 0 and prev_t >= 0
        if self.multistep:
            r = (lam(a) - lam(self.abar[int(self.ts[k - 1])])) / h
            self.m3, self.m4 = 1 + 1 / (2 * r), 1 / (2 * r)
        self.t = t

    def __call__(self, x, v_pred, old_x0: Optional[torch.Tensor], noise):
        x, v = x.double(), v_pred.double()
        x0 = math.sqrt(self.a) * x - math.sqrt(1 - self.a) * v
        target = (self.m3 * x0 - self.m4 * old_x0.double()) if self.multistep else x0
        out = self.m1 * x - self.m2 * target + self.mn * noise.double()
        return out.float(), x0.float()

    def blend(self, x_next, clean, noise0, mask_lat):
        """replace_gt: outside the hole, the clean latents re-noised to the
        next timestep (left clean after the last step)."""
        if self.k < self.steps - 1:
            a = self.abar[int(self.ts[self.k + 1])]
            init = clean.double() * math.sqrt(a) + noise0.double() * math.sqrt(1 - a)
        else:
            init = clean.double()
        m = mask_lat[..., None].double()
        return ((1 - m) * init + m * x_next.double()).float()
