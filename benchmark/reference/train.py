"""Plain float32 reference of VideoPainter's branch training step: the VAE
prep (a sigma-noised first frame, the posterior samples of the video and the
masked video, dropout of the image latents, noise and timesteps, in the
order the trainer draws them), the branch and the frozen DiT forward, the
x0-space v-prediction loss, its gradient with respect to the branch, and
AdamW with optax's global-norm clip.

The gradient flows through the frozen DiT into the branch's features, block
by block under checkpoints; attention's backward recomputes its
probabilities from the saved log-sum-exp (`cogvideox.ExactAttention`), so
17,776 tokens fit. Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from . import cogvideox as ref
from .dpm import alphas_cumprod


def velocity_to_x0(abar, noisy, v):
    a = abar[:, None, None, None, None]
    return a.sqrt() * noisy - (1 - a).sqrt() * v


def x0_loss(abar_all, pred_v, noisy, t, x0, mask_lat, inpaint_weight: float):
    abar = abar_all[t]
    pred = velocity_to_x0(abar, noisy, pred_v)
    w = (1.0 / (1.0 - abar))[:, None, None, None, None]
    b = pred.shape[0]
    loss = (w * (pred - x0) ** 2).reshape(b, -1).mean(dim=1).mean()
    m = mask_lat[..., None]
    inp = (w * (pred * m - x0 * m) ** 2).reshape(b, -1).mean(dim=1).mean()
    return loss + inpaint_weight * inp


class AdamW:
    """optax's chain: clip by global norm (g * c / max(norm, c)), then adamw
    (bias-corrected moments, eps outside the root, decoupled weight decay
    added to the update), times -lr. Masters, moments and arithmetic in
    `dtype`."""

    def __init__(self, params: List[torch.Tensor], *, lr, betas, eps, weight_decay,
                 max_grad_norm, dtype=torch.float32):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.clip, self.dtype, self.count = max_grad_norm, dtype, 0
        self.mu = [torch.zeros_like(p, dtype=dtype) for p in params]
        self.nu = [torch.zeros_like(p, dtype=dtype) for p in params]

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Updates `params` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        factor = self.clip / torch.clamp(norm, min=self.clip)
        grads = [(g.double() * factor).to(self.dtype) for g in grads]
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.wd * p.to(self.dtype)
            p.copy_((p.to(self.dtype) - self.lr * upd).to(p.dtype))
        return grads


def prepare(enc, video, cond_video, masks, gen, *, sched_abar, num_train_timesteps: int,
            dropout: float, device, latent_dtype=torch.bfloat16):
    """The VAE prep of one step, drawing from `gen` in the trainer's order:
    the first frame's sigma and noise, the posterior samples of the noised
    first frame, the video and the masked video (each eps drawn in
    `latent_dtype`, the served encoder's output type), the dropout coin, the
    noise and the timesteps. Returns (noisy, image_latents, branch_cond,
    mask_lat, x0, t)."""
    b = video.shape[0]
    sf = enc.cfg["scaling_factor"]
    randn = lambda shape, dt=torch.float32: torch.randn(shape, generator=gen, device=device,
                                                         dtype=dt)
    sigma = torch.exp(-3.0 + 0.5 * randn((b,)))
    first = video[:, :1]
    noisy_first = (first + randn(first.shape).to(latent_dtype).float()
                   * sigma.to(latent_dtype).float()[:, None, None, None, None])

    def sample(x):
        mean, logvar = enc.moments(x)
        eps = randn(mean.shape, latent_dtype).float()
        return (mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * eps) * sf

    image_lat = sample(noisy_first)
    x0 = sample(video)
    cond = sample(cond_video)
    t_lat, h, w = x0.shape[1:4]
    image_lat = torch.cat([image_lat, torch.zeros_like(x0[:, 1:])], dim=1)
    drop = torch.rand((), generator=gen, device=device) < dropout
    image_lat = torch.where(drop, torch.zeros_like(image_lat), image_lat)
    m = masks
    for dim, n in ((1, t_lat), (2, h), (3, w)):
        m = m.index_select(dim, torch.arange(n, device=m.device) * m.shape[dim] // n)
    noise = randn((b,) + tuple(x0.shape[1:])).to(latent_dtype).float()
    t = torch.randint(0, num_train_timesteps, (b,), generator=gen, device=device)
    a = sched_abar[t][:, None, None, None, None]
    noisy = a.sqrt() * x0 + (1 - a).sqrt() * noise
    return noisy, image_lat, torch.cat([cond, m[..., None]], dim=-1), m, x0, t


def loss_and_grads(dit_sd, branch: Dict[str, torch.Tensor], names: List[str], tcfg: dict,
                   n_branch: int, prep, text, abar, inpaint_weight: float, device):
    """The step's loss and its gradient with respect to the branch's leaves
    `names` (the state dict `branch` also holds its buffers, such as the
    positional table; a leaf the forward does not use gets zeros)."""
    noisy, image_lat, cond, mask_lat, x0, t = prep
    with torch.enable_grad():
        feats = ref.branch_features(branch, dict(tcfg, num_layers=n_branch), noisy, cond, text,
                                    t, device=device, checkpoint=True)
        pred = ref.dit_forward(dit_sd, tcfg, torch.cat([noisy, image_lat], dim=-1), text, t,
                               device=device, feats=feats, mask_lat=mask_lat, checkpoint=True)
        total = x0_loss(abar, pred, noisy, t, x0, mask_lat, inpaint_weight)
        leaves = [branch[n] for n in names]
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    return float(total.detach()), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)]


def schedule_abar(sched: dict, device) -> torch.Tensor:
    return torch.from_numpy(alphas_cumprod(sched)).float().to(device)


def relative_leaf_gap(prog: List[torch.Tensor], refs: List[torch.Tensor],
                      keep: List[bool]) -> float:
    """The worst leaf's gap between the two norms, against the reference's
    norm of that leaf or of the median leaf, whichever is larger; over the
    leaves in `keep`."""
    pn = [float(torch.linalg.vector_norm(p.double())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.double())) for r in refs]
    kept = [i for i, k in enumerate(keep) if k]
    med = sorted(rn[i] for i in kept)[len(kept) // 2]
    return max(abs(pn[i] - rn[i]) / max(rn[i], med) for i in kept)


def moving(grad_norms: List[float]) -> List[bool]:
    """Leaves the check counts: a reference gradient of at least a thousandth
    of the median leaf's (a zero-to-rounding gradient, such as that of a leaf
    the forward does not use, moves under Adam by round-off alone)."""
    med = sorted(grad_norms)[len(grad_norms) // 2]
    return [g >= 1e-3 * med and g > 0 for g in grad_norms]


def leaf_norms(xs: List[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(x.double())) for x in xs]
