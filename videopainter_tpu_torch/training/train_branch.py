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
Under a profiler a step is traced as the span `train.step`, its backward
as `train.backward` and its gradient norm and update as `train.optimizer`
(`utils/profiling.py`).

Both steps expose `train_step.grad_step(state, noisy_vid, image_latents,
branch_cond, mask_lat, model_input, timesteps, prompt_embeds, rope)`, the
part after the VAE prep, so a test can feed the same prepared tensors to this
package and to the JAX one, `train_step.prepare(batch, generator)` and
`train_step.rope(prepared)`.

On a mesh (`mesh=`, or one entered with `parallel.use_mesh`): the batch is
the global one, as in the JAX package (`train_batch_size` must divide by
`data`); each `data` rank takes its contiguous slice. Noise, timesteps and
dropout are drawn for the global batch from the step's generator on every
rank, then sliced, so a `data=2` step equals the one-card step at the same
global batch. `cfg.seq_axis` (and `ring_mesh`) run the branch and the
backbone sequence-parallel. After the backward the trainable gradients are
summed over `seq` and averaged over `data` (`comm.py`'s rule), before the
clip; the optimizer's state is split ZeRO-2-style by
`init_branch_train_state(..., mesh=)` (`optim.Zero`). The metrics are
averaged over `data`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch import nn

from ..models.lora import attach_lora
from ..models.vae import DiagonalGaussian
from ..parallel import comm
from ..parallel.mesh import AXES, axis_rank, axis_size, current_mesh, use_mesh
from ..pipelines.common import prepare_rope, resize_mask_to_latent
from ..utils.profiling import annotate
from .optim import Zero, global_norm


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
    seq_axis: Optional[str] = None  # sequence parallelism over this mesh axis


class BranchTrainState(NamedTuple):
    step: int
    trainable: Any          # {name: parameter} of the branch, or the LoRA tree
    opt_state: Any


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a (nested) dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def make_zero(names: List[str], params: List[torch.Tensor], mesh) -> Optional[Zero]:
    """The ZeRO-2 / tensor-parallel layout of a branch's parameters on a mesh
    (None without one, or on a mesh of one rank in `data` and `model`)."""
    from ..parallel.sharding import optimizer_state_specs, param_spec, placement

    n_data, n_model = axis_size(mesh, AXES.data), axis_size(mesh, AXES.model)
    if mesh is None or (n_data == 1 and n_model == 1):
        return None
    zero_spec = lambda name: optimizer_state_specs({name: param_spec(name)})[name]
    # a tensor-parallel part holds rows of a column-parallel linear's weight,
    # bias and scales, columns of a row-parallel one's weight
    split = {name: (0 if placement(name) == "col" else 1)
             if getattr(p, "tp_split", False) else None for name, p in zip(names, params)}
    return Zero(names, [p.shape for p in params], mesh.get_group(AXES.data), n_data,
                axis_rank(mesh, AXES.data), lambda name: zero_spec(name)[:1] == (AXES.data,),
                tp_group=mesh.get_group(AXES.model) if n_model > 1 else None,
                tp_dim=split.__getitem__)


def init_branch_train_state(trainable, optimizer, mesh=None) -> BranchTrainState:
    """`trainable`: the branch module, or a LoRA tree {target: {"lora_A",
    "lora_B"}}. Its tensors are made to require grad and become the state's
    trainable leaves (updated in place by the steps). On a mesh the branch's
    optimizer state is split ZeRO-2-style over `data` (`make_zero`; the LoRA
    tree's stays whole, as in the JAX package)."""
    names = None
    zero = None
    if isinstance(trainable, nn.Module):
        trainable.requires_grad_(True)
        trainable = dict(trainable.named_parameters())
        names = sorted(trainable)
        zero = make_zero(names, tree_leaves(trainable), mesh)
    else:
        for leaf in tree_leaves(trainable):
            leaf.requires_grad_(True)
    leaves = tree_leaves(trainable)
    opt_state = (optimizer.init(leaves, names) if zero is None
                 else optimizer.init(leaves, names, zero))
    return BranchTrainState(step=0, trainable=trainable, opt_state=opt_state)


def _make_prepare(vae, scheduler, cfg: BranchTrainConfig, data=None):
    """The VAE prep of a step, all under no_grad: three encodes (or the
    batch's precomputed posterior moments), the posterior samples, dropout of
    the image latents, the latent-grid mask, noise, timesteps, add_noise.
    `data`: (process group, ranks, rank) of a data-parallel mesh axis: the
    rank preps its slice of the global batch, every draw made for the global
    batch and sliced."""

    @torch.no_grad()
    def prepare(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]):
        video = batch["pixel_values"]          # [B, T, H, W, 3] in [-1, 1]
        dev, dt = video.device, video.dtype
        b = video.shape[0]
        lo, hi = 0, b
        if data is not None:
            n, r = data[1], data[2]
            if b % n:
                raise ValueError(f"the global batch {b} must divide by the data axis {n}")
            lo, hi = r * b // n, (r + 1) * b // n
        whole = (lo, hi) == (0, b)
        part = (lambda x: x) if whole else (lambda x: x[lo:hi])
        sf = vae.cfg.scaling_factor
        randn = lambda shape: torch.randn(shape, generator=generator, device=dev,
                                          dtype=torch.float32)

        def sample(dist):
            """A posterior sample of this rank's rows, drawn for the global batch."""
            if whole:
                return dist.sample(generator)
            eps = torch.randn((b,) + tuple(dist.mean.shape[1:]), generator=generator,
                              dtype=dist.mean.dtype, device=dist.mean.device)[lo:hi]
            return dist.mean + torch.exp(0.5 * torch.clamp(dist.logvar, -30.0, 20.0)) * eps

        def moments(key):
            return DiagonalGaussian(part(batch[f"{key}_latent_mean"]),
                                    part(batch[f"{key}_latent_logvar"]))

        # sigma-noised first frame
        sigma = part(torch.exp(-3.0 + 0.5 * randn((b,))))
        first = video[:, :1]
        noisy_images = part(first) + part(randn(first.shape)).to(dt) * \
            sigma.to(dt)[:, None, None, None, None]
        image_latents = sample(vae.encode(noisy_images)) * sf
        # with the posterior moments in the batch (encode_batch_latent_moments)
        # the two long encodes are skipped; the per-step sample is still drawn
        if "video_latent_mean" in batch:
            model_input = sample(moments("video")) * sf
        else:
            model_input = sample(vae.encode(part(video))) * sf
        if "cond_latent_mean" in batch:
            cond_latents = sample(moments("cond")) * sf
        else:
            cond_latents = sample(vae.encode(part(batch["conditioning_pixel_values"]))) * sf

        t_lat, h_lat, w_lat = model_input.shape[1:4]
        pad = torch.zeros((hi - lo, t_lat - 1) + tuple(model_input.shape[2:]),
                          dtype=model_input.dtype, device=dev)
        image_latents = torch.cat([image_latents.to(model_input.dtype), pad], dim=1)
        drop = torch.rand((), generator=generator, device=dev) < cfg.noised_image_dropout
        image_latents = torch.where(drop, torch.zeros_like(image_latents), image_latents)
        mask_lat = resize_mask_to_latent(part(batch["masks"]), t_lat, h_lat, w_lat)
        branch_cond = torch.cat([cond_latents, mask_lat[..., None].to(cond_latents.dtype)],
                                dim=-1)
        noise = part(randn((b,) + tuple(model_input.shape[1:]))).to(model_input.dtype)
        timesteps = part(torch.randint(0, scheduler.config.num_train_timesteps, (b,),
                                       generator=generator, device=dev))
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


def _backbone_input(transformer, noisy_vid, image_latents):
    if transformer.cfg.in_channels == 2 * noisy_vid.shape[-1]:
        return torch.cat([noisy_vid, image_latents.to(noisy_vid.dtype)], dim=-1)
    return noisy_vid


class _MeshView:
    """What a train step needs of a mesh: the data axis (its group, ranks,
    this rank) for the batch slice, and the gradient / metric sync."""

    def __init__(self, mesh):
        self.data = (mesh.get_group(AXES.data), axis_size(mesh, AXES.data),
                     axis_rank(mesh, AXES.data))
        self.seq = mesh.get_group(AXES.seq) if axis_size(mesh, AXES.seq) > 1 else None
        self.model = mesh.get_group(AXES.model) if axis_size(mesh, AXES.model) > 1 else None

    def grad_norm(self, grads: List[torch.Tensor], params: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of synced gradients: the squares of a
        tensor-parallel parameter's part summed over `model` too."""
        split = [getattr(p, "tp_split", False) for p in params]
        if self.model is None or not any(split):
            return global_norm(grads)
        sq = [g.float().square().sum() for g in grads]
        part = sum(v for v, s in zip(sq, split) if s)
        whole = sum((v for v, s in zip(sq, split) if not s), torch.zeros_like(part))
        return torch.sqrt(comm.all_reduce_(part.clone(), self.model) + whole)

    def sync_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over `seq`, mean over `data`, in one flat buffer per dtype."""
        out = list(grads)
        for dtype in {g.dtype for g in grads}:
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            if self.seq is not None:
                comm.all_reduce_(flat, self.seq)
            comm.all_reduce_(flat, self.data[0])
            if self.data[1] > 1:
                flat.div_(self.data[1])
            for i, piece in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = piece.view_as(grads[i])
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        if self.data[1] == 1:
            return x.detach()
        return comm.all_reduce_(x.detach().clone(), self.data[0]) / self.data[1]


def _update(state: BranchTrainState, optimizer, cfg, total, loss, inp_loss, view=None):
    """Gradients of `total` w.r.t. the trainable leaves (synced over the
    mesh), the optimizer's in-place update, and the step's metrics."""
    leaves = tree_leaves(state.trainable)
    with annotate("train.backward"):
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    # a parameter the forward does not use has a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if view is not None:
        grads = view.sync_grads(grads)
    with annotate("train.optimizer"):
        gnorm_before = global_norm(grads) if view is None else view.grad_norm(grads, leaves)
        with torch.no_grad():
            opt_state = optimizer.update_(leaves, grads, state.opt_state)
    mean = (lambda x: x.detach()) if view is None else view.mean
    metrics = {"loss": mean(loss), "inpainting_loss": mean(inp_loss),
               "total_loss": mean(total),
               "gradient_norm_before_clip": gnorm_before,
               "gradient_norm_after_clip": torch.clamp(gnorm_before, max=cfg.max_grad_norm)}
    return BranchTrainState(state.step + 1, state.trainable, opt_state), metrics


def _make_train_step(prepare, grad_step, transformer, vae, cfg, mesh=None):
    def rope(prep):
        """The rotary tables for a prepared batch (its latent frame count)."""
        return prepare_rope(transformer.cfg, cfg.height, cfg.width, prep[4].shape[1],
                            vae.cfg.spatial_compression_ratio, device=prep[0].device)

    def train_step(state: BranchTrainState, batch, generator: Optional[torch.Generator] = None):
        with annotate("train.step"):
            prep = prepare(batch, generator)
            embeds = batch["prompt_embeds"]
            if mesh is None:
                return grad_step(state, *prep, embeds, rope(prep))
            n, r = axis_size(mesh, AXES.data), axis_rank(mesh, AXES.data)
            b = embeds.shape[0]
            with use_mesh(mesh):
                return grad_step(state, *prep, embeds[r * b // n:(r + 1) * b // n], rope(prep))

    train_step.grad_step = grad_step
    train_step.prepare = prepare
    train_step.rope = rope
    return train_step


def _step_mesh(mesh, ring_mesh):
    """The mesh a step runs on: the one given, else `ring_mesh`, else the one
    entered with `use_mesh`."""
    return mesh if mesh is not None else (ring_mesh if ring_mesh is not None
                                          else current_mesh())


def make_branch_train_step(transformer, branch, vae, scheduler, optimizer,
                           cfg: BranchTrainConfig, ring_mesh=None, mesh=None):
    """Branch SFT: trains only the branch; backbone and VAE frozen.

    batch keys: pixel_values, conditioning_pixel_values, masks, prompt_embeds.
    `state` comes from `init_branch_train_state(branch, optimizer[, mesh])`.
    Returns `train_step(state, batch, generator) -> (state, metrics)` with
    loss / inpainting_loss / total_loss / gradient norms as 0-d tensors.
    `mesh` / `ring_mesh` / `cfg.seq_axis`: see the module note.
    """
    transformer.requires_grad_(False)
    vae.requires_grad_(False)
    mesh = _step_mesh(mesh, ring_mesh)
    view = None if mesh is None else _MeshView(mesh)
    prepare = _make_prepare(vae, scheduler, cfg, None if view is None else view.data)
    par = dict(seq_axis=cfg.seq_axis, ring_mesh=ring_mesh)

    def grad_step(state, noisy_vid, image_latents, branch_cond, mask_lat, model_input,
                  timesteps, prompt_embeds, rope):
        samples = branch(noisy_vid, prompt_embeds, branch_cond, timesteps, rope=rope,
                         remat=cfg.remat, use_flash=cfg.use_flash, **par)
        out = transformer(
            _backbone_input(transformer, noisy_vid, image_latents), prompt_embeds, timesteps,
            rope=rope, branch_block_samples=samples,
            branch_block_masks=mask_lat if cfg.mask_add else None,
            add_first=cfg.add_first, remat=cfg.remat, remat_chunk=cfg.remat_chunk,
            use_flash=cfg.use_flash, **par)
        total, (loss, inp_loss) = _x0_loss(scheduler, out.sample, noisy_vid, timesteps,
                                           model_input, mask_lat, cfg.inpainting_loss_weight)
        return _update(state, optimizer, cfg, total, loss, inp_loss, view)

    return _make_train_step(prepare, grad_step, transformer, vae, cfg, mesh)


def make_lora_train_step(transformer, branch, vae, scheduler, optimizer,
                         cfg: BranchTrainConfig, ring_mesh=None, mesh=None):
    """ID-resample LoRA: trains a rank-r adapter on the backbone's to_q / to_k /
    to_v / to_out; branch, backbone base and VAE frozen; forwards with the
    ID-resampling attention. `state` comes from
    `init_branch_train_state(lora_params, optimizer)`. The adapter is attached
    additively (not merged), so the frozen backbone may be int8 (QLoRA):
    gradients reach A / B through the linears' low-rank term."""
    for frozen in (transformer, branch, vae):
        frozen.requires_grad_(False)
    mesh = _step_mesh(mesh, ring_mesh)
    view = None if mesh is None else _MeshView(mesh)
    prepare = _make_prepare(vae, scheduler, cfg, None if view is None else view.data)
    par = dict(seq_axis=cfg.seq_axis, ring_mesh=ring_mesh)

    def grad_step(state, noisy_vid, image_latents, branch_cond, mask_lat, model_input,
                  timesteps, prompt_embeds, rope):
        with torch.no_grad():   # the branch output is a constant of this step
            samples = branch(noisy_vid, prompt_embeds, branch_cond, timesteps, rope=rope,
                             use_flash=cfg.use_flash, **par)
        attach_lora(transformer, state.trainable, alpha=cfg.lora_alpha, rank=cfg.lora_rank,
                    trainable=True)
        out = transformer(
            _backbone_input(transformer, noisy_vid, image_latents), prompt_embeds, timesteps,
            rope=rope, branch_block_samples=samples,
            branch_block_masks=mask_lat if cfg.mask_add else None,
            add_first=cfg.add_first, id_pool_resample=cfg.id_pool_resample,
            remat=cfg.remat, remat_chunk=cfg.remat_chunk, use_flash=cfg.use_flash, **par)
        total, (loss, inp_loss) = _x0_loss(scheduler, out.sample, noisy_vid, timesteps,
                                           model_input, mask_lat, cfg.inpainting_loss_weight)
        return _update(state, optimizer, cfg, total, loss, inp_loss, view)

    return _make_train_step(prepare, grad_step, transformer, vae, cfg, mesh)
