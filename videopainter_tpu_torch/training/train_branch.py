"""Branch (context-encoder) and ID-LoRA training steps.

Counterpart of `videopainter_tpu/training/train_branch.py`; behavioural parity
with the reference trainer (train_cogvideox_inpainting_i2v_video.py:1737-1898):

 - first-frame conditioning latent from a sigma-noised image,
   sigma = exp(N(-3, 0.5)), optional noised_image_dropout
 - GT video / masked video VAE-encoded (sampled posterior) * scaling
 - masks nearest-resized to the latent grid, concatenated to the branch cond
 - v-prediction model; loss computed in x0 space: model_pred =
   get_velocity(model_output, noisy_latents, t) == predicted x0;
   loss = mean(w*(x0_pred - x0)^2) + inpainting_loss_weight *
   mean(w*(x0_pred*m - x0*m)^2), w = 1/(1-abar_t)
 - grad norm before / after clip reported

PyTorch idiom where the JAX package is functional: the models are
`nn.Module`s that hold their weights, so a step is made from the modules and
called as `train_step(state, batch, generator)`. Frozen modules get
`requires_grad_(False)`, so no weight gradient is ever formed for the
backbone or the VAE; the VAE encodes run under `no_grad` before the step and
their temporaries are freed before the DiT's backward. `state.trainable` is
the dict of the branch's parameters (or the stacked LoRA tree); the optimizer
updates those tensors in place and the step returns the state with its
counter advanced. Randomness comes from an explicit `torch.Generator`.

Both steps expose `train_step.grad_step(state, noisy_vid, image_latents,
branch_cond, mask_lat, model_input, timesteps, prompt_embeds, rope)`, the
part after the VAE prep, so a test can feed the same prepared tensors to this
package and to the JAX one, `train_step.prepare(batch, generator)` and
`train_step.rope(prepared)`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from ..models.lora import attach_lora
from ..models.vae import DiagonalGaussian
from ..pipelines.common import prepare_rope, resize_mask_to_latent
from .optim import global_norm


@dataclass(frozen=True)
class BranchTrainConfig:
    height: int = 480
    width: int = 720
    inpainting_loss_weight: float = 1.0
    mask_add: bool = False
    add_first: bool = False
    wo_text: bool = False
    noised_image_dropout: float = 0.05
    max_grad_norm: float = 1.0
    lora_rank: int = 256
    lora_alpha: float = 128.0
    id_pool_resample: bool = True  # LoRA training forwards with resample attn
    remat: bool = True             # checkpoint every block
    remat_chunk: Optional[int] = None  # blocks per outer checkpointed group of
                                       # the backbone (models/dit.py)
    use_flash: bool = False  # the flash kernels (differentiable: ops/flash_attention.py)
    seq_axis: Optional[str] = None  # sequence parallelism: not ported yet


class BranchTrainState(NamedTuple):
    step: int
    trainable: Any          # {name: parameter} of the branch, or the LoRA tree
    opt_state: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_branch_train_state(trainable, optimizer) -> BranchTrainState:
    """`trainable`: the branch module, or a LoRA tree {target: {"lora_A",
    "lora_B"}}. Its tensors are made to require grad and become the state's
    trainable leaves (updated in place by the steps)."""
    names = None
    if isinstance(trainable, nn.Module):
        trainable.requires_grad_(True)
        trainable = dict(trainable.named_parameters())
        names = sorted(trainable)
    else:
        for leaf in tree_leaves(trainable):
            leaf.requires_grad_(True)
    return BranchTrainState(step=0, trainable=trainable,
                            opt_state=optimizer.init(tree_leaves(trainable), names))


def _make_prepare(vae, scheduler, cfg: BranchTrainConfig):
    """The VAE prep of a step, all under no_grad: three encodes (or the
    batch's precomputed posterior moments), the posterior samples, dropout of
    the image latents, the latent-grid mask, noise, timesteps, add_noise."""

    @torch.no_grad()
    def prepare(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        video = batch["pixel_values"]          # [B, T, H, W, 3] in [-1, 1]
        dev, dt = video.device, video.dtype
        b = video.shape[0]
        sf = vae.cfg.scaling_factor
        randn = lambda shape: torch.randn(shape, generator=generator, device=dev,
                                          dtype=torch.float32)
        # sigma-noised first frame
        sigma = torch.exp(-3.0 + 0.5 * randn((b,)))
        first = video[:, :1]
        noisy_images = (first + randn(first.shape).to(dt) * sigma.to(dt)[:, None, None, None, None])
        image_latents = vae.encode(noisy_images).sample(generator) * sf
        # with the posterior moments in the batch (encode_batch_latent_moments)
        # the two long encodes are skipped; the per-step sample is still drawn
        if "video_latent_mean" in batch:
            model_input = DiagonalGaussian(batch["video_latent_mean"],
                                           batch["video_latent_logvar"]).sample(generator) * sf
        else:
            model_input = vae.encode(video).sample(generator) * sf
        if "cond_latent_mean" in batch:
            cond_latents = DiagonalGaussian(batch["cond_latent_mean"],
                                            batch["cond_latent_logvar"]).sample(generator) * sf
        else:
            cond_latents = vae.encode(batch["conditioning_pixel_values"]).sample(generator) * sf

        t_lat, h_lat, w_lat = model_input.shape[1:4]
        pad = torch.zeros((b, t_lat - 1) + tuple(model_input.shape[2:]),
                          dtype=model_input.dtype, device=dev)
        image_latents = torch.cat([image_latents.to(model_input.dtype), pad], dim=1)
        drop = torch.rand((), generator=generator, device=dev) < cfg.noised_image_dropout
        image_latents = torch.where(drop, torch.zeros_like(image_latents), image_latents)
        mask_lat = resize_mask_to_latent(batch["masks"], t_lat, h_lat, w_lat)
        branch_cond = torch.cat([cond_latents, mask_lat[..., None].to(cond_latents.dtype)],
                                dim=-1)
        noise = randn(model_input.shape).to(model_input.dtype)
        timesteps = torch.randint(0, scheduler.config.num_train_timesteps, (b,),
                                  generator=generator, device=dev)
        noisy = scheduler.add_noise(model_input, noise, timesteps)
        return noisy, image_latents, branch_cond, mask_lat, model_input, timesteps

    return prepare


@torch.no_grad()
def encode_batch_latent_moments(vae, batch: Dict) -> Dict:
    """Precompute the VAE posterior moments of a batch (the precomputed-latents
    fast path of the prepare step). The returned batch adds video / cond
    latent mean + logvar; training then samples the same posterior per step.
    Cache only when the pixels feeding an encode are the same every step: the
    GT video always is; the masked video is not when mask augmentation
    re-randomizes per step: drop the cond moments in that case."""
    out = dict(batch)
    d = vae.encode(batch["pixel_values"])
    out["video_latent_mean"], out["video_latent_logvar"] = d.mean, d.logvar
    d = vae.encode(batch["conditioning_pixel_values"])
    out["cond_latent_mean"], out["cond_latent_logvar"] = d.mean, d.logvar
    return out


def _x0_loss(scheduler, model_output, noisy_video_latents, timesteps,
             target_x0, mask_lat, inpainting_loss_weight):
    """x0-space weighted loss: (total, (loss, inpainting_loss))."""
    model_pred = scheduler.get_velocity(model_output, noisy_video_latents, timesteps)
    abar = torch.as_tensor(scheduler.alphas_cumprod, dtype=torch.float32,
                           device=model_pred.device)[timesteps.long()]
    w = (1.0 / (1.0 - abar))[:, None, None, None, None]
    b = model_pred.shape[0]
    sq = w * torch.square(model_pred - target_x0)
    loss = sq.reshape(b, -1).mean(dim=1).mean()
    m = mask_lat[..., None].to(model_pred.dtype)
    sq_m = w * torch.square(model_pred * m - target_x0 * m)
    inp_loss = sq_m.reshape(b, -1).mean(dim=1).mean()
    return loss + inpainting_loss_weight * inp_loss, (loss, inp_loss)


def _check_cfg(cfg: BranchTrainConfig, ring_mesh) -> None:
    if cfg.seq_axis is not None or ring_mesh is not None:
        raise NotImplementedError("sequence parallelism (seq_axis / ring_mesh) is not "
                                  "ported yet: it comes with the multi-chip slice")


def _backbone_input(transformer, noisy_vid, image_latents):
    if transformer.cfg.in_channels == 2 * noisy_vid.shape[-1]:
        return torch.cat([noisy_vid, image_latents.to(noisy_vid.dtype)], dim=-1)
    return noisy_vid


def _update(state: BranchTrainState, optimizer, cfg, total, loss, inp_loss):
    """Gradients of `total` w.r.t. the trainable leaves, the optimizer's
    in-place update, and the step's metrics."""
    leaves = tree_leaves(state.trainable)
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    # a parameter the forward does not use has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    gnorm_before = global_norm(grads)
    with torch.no_grad():
        opt_state = optimizer.update_(leaves, grads, state.opt_state)
    metrics = {"loss": loss.detach(), "inpainting_loss": inp_loss.detach(),
               "total_loss": total.detach(),
               "gradient_norm_before_clip": gnorm_before,
               "gradient_norm_after_clip": torch.clamp(gnorm_before, max=cfg.max_grad_norm)}
    return BranchTrainState(state.step + 1, state.trainable, opt_state), metrics


def _make_train_step(prepare, grad_step, transformer, vae, cfg):
    def rope(prep):
        """The rotary tables for a prepared batch (its latent frame count)."""
        return prepare_rope(transformer.cfg, cfg.height, cfg.width, prep[4].shape[1],
                            vae.cfg.spatial_compression_ratio, device=prep[0].device)

    def train_step(state: BranchTrainState, batch, generator: Optional[torch.Generator] = None):
        prep = prepare(batch, generator)
        return grad_step(state, *prep, batch["prompt_embeds"], rope(prep))

    train_step.grad_step = grad_step
    train_step.prepare = prepare
    train_step.rope = rope
    return train_step


def make_branch_train_step(transformer, branch, vae, scheduler, optimizer,
                           cfg: BranchTrainConfig, ring_mesh=None):
    """Branch SFT: trains only the branch; backbone and VAE frozen.

    batch keys: pixel_values, conditioning_pixel_values, masks, prompt_embeds.
    `state` comes from `init_branch_train_state(branch, optimizer)`. Returns
    `train_step(state, batch, generator) -> (state, metrics)` with loss /
    inpainting_loss / total_loss / gradient norms as 0-d tensors.
    """
    _check_cfg(cfg, ring_mesh)
    transformer.requires_grad_(False)
    vae.requires_grad_(False)
    prepare = _make_prepare(vae, scheduler, cfg)

    def grad_step(state, noisy_vid, image_latents, branch_cond, mask_lat, model_input,
                  timesteps, prompt_embeds, rope):
        samples = branch(noisy_vid, prompt_embeds, branch_cond, timesteps, rope=rope,
                         remat=cfg.remat, use_flash=cfg.use_flash)
        out = transformer(
            _backbone_input(transformer, noisy_vid, image_latents), prompt_embeds, timesteps,
            rope=rope, branch_block_samples=samples,
            branch_block_masks=mask_lat if cfg.mask_add else None,
            add_first=cfg.add_first, remat=cfg.remat, remat_chunk=cfg.remat_chunk,
            use_flash=cfg.use_flash)
        total, (loss, inp_loss) = _x0_loss(scheduler, out.sample, noisy_vid, timesteps,
                                           model_input, mask_lat, cfg.inpainting_loss_weight)
        return _update(state, optimizer, cfg, total, loss, inp_loss)

    return _make_train_step(prepare, grad_step, transformer, vae, cfg)


def make_lora_train_step(transformer, branch, vae, scheduler, optimizer,
                         cfg: BranchTrainConfig, ring_mesh=None):
    """ID-resample LoRA: trains a rank-r adapter on the backbone's to_q / to_k /
    to_v / to_out; branch, backbone base and VAE frozen; forwards with the
    ID-resampling attention. `state` comes from
    `init_branch_train_state(lora_params, optimizer)`. The adapter is attached
    additively (not merged), so the frozen backbone may be int8 (QLoRA):
    gradients reach A / B through the linears' low-rank term."""
    _check_cfg(cfg, ring_mesh)
    for frozen in (transformer, branch, vae):
        frozen.requires_grad_(False)
    prepare = _make_prepare(vae, scheduler, cfg)

    def grad_step(state, noisy_vid, image_latents, branch_cond, mask_lat, model_input,
                  timesteps, prompt_embeds, rope):
        with torch.no_grad():   # the branch output is a constant of this step
            samples = branch(noisy_vid, prompt_embeds, branch_cond, timesteps, rope=rope,
                             use_flash=cfg.use_flash)
        attach_lora(transformer, state.trainable, alpha=cfg.lora_alpha, rank=cfg.lora_rank,
                    trainable=True)
        out = transformer(
            _backbone_input(transformer, noisy_vid, image_latents), prompt_embeds, timesteps,
            rope=rope, branch_block_samples=samples,
            branch_block_masks=mask_lat if cfg.mask_add else None,
            add_first=cfg.add_first, id_pool_resample=cfg.id_pool_resample,
            remat=cfg.remat, remat_chunk=cfg.remat_chunk, use_flash=cfg.use_flash)
        total, (loss, inp_loss) = _x0_loss(scheduler, out.sample, noisy_vid, timesteps,
                                           model_input, mask_lat, cfg.inpainting_loss_weight)
        return _update(state, optimizer, cfg, total, loss, inp_loss)

    return _make_train_step(prepare, grad_step, transformer, vae, cfg)
