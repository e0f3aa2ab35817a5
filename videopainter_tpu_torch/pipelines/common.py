"""Shared pipeline machinery: RoPE tables, mask resize, dynamic CFG, the
step-skip schedule, and the denoise loop.

Counterpart of `videopainter_tpu/pipelines/common.py`. The JAX package
compiles the denoise loop into one `lax.scan`; here it is a plain Python loop
over steps with the same per-step arithmetic: CFG-batched (or sequential)
branch + backbone, dynamic CFG, the DPM step with its x0 carry (SDE noise
drawn each step unless `dpm_sde` is off), and the replace_gt re-noise blend.
Scheduler coefficients are precomputed on the host. The `init_noise` /
`dpm_noises` hooks inject identical noise for parity tests.

The model pass has four modes (`DenoiseConfig.mode`):
 - "dual": branch features injected into the backbone (the flagship);
 - "sft": the conditioning channels [masked-video latents ‖ mask]
   concatenated straight into a widened backbone, no branch (the SFT
   baseline; its backbone is T2V, so no image-latent concat);
 - "plain": the bare backbone (the latent-blend baseline and the stock
   generation pipelines);
 - "selfguidance": a guidance pass on the noised masked-video latents whose
   per-layer video states are swapped into the main pass outside the mask;
   its replace_gt blend re-noises the masked-video latents.

For the any-length pipeline the loop takes the previous window's state
(`prev_state`: per-layer hidden states, resample mask, weight, and the token
indices of a compressed capture) into every model pass, and captures this
window's per-layer states at the final step only; `capture_token_indices`
picks the masked-region tokens a compressed capture keeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import TransformerConfig
from ..models.dit import TransformerOutput
from ..models.vae import nearest_resize3d_ndhwc
from ..ops.patch_embed import pool_patch_mask
from ..ops.rope import get_3d_rotary_pos_embed, get_resize_crop_region_for_grid
from ..schedulers import CogVideoXDPMScheduler
from ..utils.profiling import annotate


def get_strength_timesteps(timesteps: np.ndarray, num_inference_steps: int,
                           strength: float) -> Tuple[np.ndarray, int]:
    """Strength-based timestep slicing."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return timesteps[t_start:], num_inference_steps - t_start


def prepare_rope(cfg: TransformerConfig, height: int, width: int,
                 num_latent_frames: int, vae_spatial: int = 8,
                 base_height: int = 480, base_width: int = 720, device=None):
    """Rotary tables (cos, sin) [S_vid, head_dim] float32 for the video grid.

    The reference hardcodes the aspect-ratio base grid to 720x480 pixels,
    independent of the model's sample dims; RoPE positions are rescaled onto it.
    """
    if not cfg.use_rotary_positional_embeddings:
        return None
    p = cfg.patch_size
    grid_h = height // (vae_spatial * p)
    grid_w = width // (vae_spatial * p)
    base_w = base_width // (vae_spatial * p)
    base_h = base_height // (vae_spatial * p)
    crops = get_resize_crop_region_for_grid((grid_h, grid_w), base_w, base_h)
    cos, sin = get_3d_rotary_pos_embed(cfg.attention_head_dim, crops,
                                       (grid_h, grid_w), num_latent_frames)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def resize_mask_to_latent(mask: torch.Tensor, t_lat: int, h_lat: int, w_lat: int) -> torch.Tensor:
    """[B, T, H, W] -> [B, t_lat, h_lat, w_lat] by nearest resize."""
    return nearest_resize3d_ndhwc(mask[..., None], (t_lat, h_lat, w_lat))[..., 0]


def dynamic_cfg_scales(timesteps: np.ndarray, num_inference_steps: int,
                       guidance_scale: float) -> np.ndarray:
    """Per-step dynamic CFG: 1 + g * (1 - cos(pi * ((S - t)/S)^5)) / 2 with t
    the train timestep value (the reference's formula, kept as it is)."""
    out = []
    for t in timesteps:
        frac = (num_inference_steps - float(t)) / num_inference_steps
        out.append(1.0 + guidance_scale * (1 - math.cos(math.pi * frac**5.0)) / 2.0)
    return np.array(out, dtype=np.float32)


def capture_token_indices(mask: torch.Tensor, patch_size: int, text_len: int,
                          bucket: int = 2048) -> torch.Tensor:
    """Joint-sequence gather indices for a compressed cross-window capture.

    The ID-resample path stores per-layer hidden states only to multiply them
    by `prev_resample_mask` in the next window, so keeping just the
    masked-region tokens is exact while the [L, 2B, S, D] state shrinks by the
    mask fraction. `mask` is the latent-grid mask [B, T_lat, h_lat, w_lat], the
    tensor the model pools in its patch embed, so the indices match the
    model's resample mask. Returns int32 [B, M] joint-sequence positions (text
    offset applied), padded with S_joint (one past the end; the model's
    scatter drops those). M is the largest per-sample masked-token count
    rounded up to `bucket`, capped at S_joint.
    """
    pm = pool_patch_mask(mask, patch_size).cpu().numpy()
    b, s_vid = pm.shape
    s_joint = text_len + s_vid
    counts = pm.sum(axis=1).astype(int)
    m = int(np.ceil(max(int(counts.max()), 1) / bucket) * bucket)
    m = min(m, s_joint)
    idx = np.full((b, m), s_joint, dtype=np.int32)
    for i in range(b):
        nz = np.nonzero(pm[i])[0] + text_len
        idx[i, :len(nz)] = nz
    return torch.from_numpy(idx).to(mask.device)


class DenoiseInputs(NamedTuple):
    """Device inputs to the denoise loop. B = real batch (pre-CFG)."""

    latents: torch.Tensor                  # [B, T, h, w, C]
    image_latents: torch.Tensor            # [B, T, h, w, C] first-frame latent + zero pad
    masked_video_latents: torch.Tensor     # [B, T, h, w, C]
    mask: torch.Tensor                     # [B, T, h, w] latent-grid mask (float)
    prompt_embeds: Optional[torch.Tensor]  # [2B, S_text, text_dim] (neg ‖ pos) or [B, ...]
    noise: torch.Tensor                    # [B, T, h, w, C] initial noise (replace_gt)
    video_latents: Optional[torch.Tensor]  # [B, T, h, w, C] clean latents (replace_gt)
    dpm_noises: Optional[torch.Tensor] = None  # [S, B, T, h, w, C] injected SDE noise
    capture_indices: Optional[torch.Tensor] = None  # int32 [B, M]: compressed capture
                                           # keeps only these joint-sequence positions


def uniform_skip_steps(num_steps: int, start: int, end: int,
                       stride: int = 2) -> Tuple[int, ...]:
    """Step-skip schedule: inside [start, end) the model runs only every
    `stride`-th step and the other steps reuse the cached pre-CFG prediction;
    steps outside always run. Returns the skipped indices."""
    if not 0 < start <= end <= num_steps:
        raise ValueError(f"bad skip window [{start}, {end}) for {num_steps} steps")
    if stride < 2:
        raise ValueError("stride must be >= 2 (stride 1 would skip every step)")
    return tuple(i for i in range(start, end) if (i - start) % stride)


def parse_skip_steps(spec: str, num_steps: int) -> Tuple[int, ...]:
    """The CLI spelling of a skip schedule: "start:end[:stride]" (a uniform
    window) or a comma list of step indices (deduplicated, range-checked)."""
    if ":" in spec:
        parts = [int(x) for x in spec.split(":")]
        return uniform_skip_steps(num_steps, parts[0], parts[1],
                                  parts[2] if len(parts) > 2 else 2)
    steps = sorted({int(x) for x in spec.split(",") if x.strip()})
    for si in steps:
        if not 0 <= si < num_steps:
            raise ValueError(f"skip step {si} out of range [0, {num_steps})")
    return tuple(steps)


MODES = ("dual", "sft", "plain", "selfguidance")


@dataclass(frozen=True)
class DenoiseConfig:
    """Options of the denoise loop."""

    num_inference_steps: int
    do_cfg: bool
    use_dynamic_cfg: bool
    guidance_scale: float
    conditioning_scale: float
    replace_gt: bool
    mask_add: bool
    mask_background: bool
    add_first: bool
    wo_text: bool = False
    id_pool_resample: bool = False
    capture_hidden_states: bool = False   # capture per-layer states at the final step
    capture_quant: bool = False           # int8 per-token capture (any-length ID path)
    use_flash: Union[bool, str] = False   # False | True | "int8" | "int8pv"
    sequential_cfg: bool = False     # uncond/cond as two B-sized passes
    skip_steps: Optional[Tuple[int, ...]] = None  # reuse the previous pre-CFG
                                     # prediction at these steps (step 0 always runs)
    dpm_sde: bool = True             # draw SDE noise each DPM step (unless injected)
    mode: str = "dual"               # "dual" | "sft" | "plain" | "selfguidance"
    seq_axis: Optional[str] = None   # sequence parallelism over this mesh axis
    ring_mesh: Any = None            # DeviceMesh: ring attention over seq_axis


def make_denoise_fn(transformer, branch, scheduler, dcfg: DenoiseConfig,
                    timesteps: np.ndarray,
                    progress_fn: Optional[Callable[[int], None]] = None):
    """Build denoise(inputs, rope, generator, prev_state) ->
    (final latents, hidden_states_list | None, resample_mask | None).

    prev_state: None or a dict with `prev_hidden_states` ([L, B, S, D], or
    compressed [L, B, M, D], or the int8 dict), `prev_resample_mask` [B, S],
    `prev_clip_weight` (float) and optionally `prev_hidden_indices` [B, M]:
    the any-length cross-window conditioning. With
    dcfg.capture_hidden_states the final step also returns its per-layer
    states. progress_fn(i) is called after step i completes on the host side,
    outside the step's `denoise.step` span.
    """
    if dcfg.mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {dcfg.mode!r}")
    S = len(timesteps)
    # the scheduler's stride derives from the un-sliced step count; dynamic
    # CFG uses the post-slice count (both as the reference)
    coeffs = scheduler.precompute(dcfg.num_inference_steps, timesteps=np.asarray(timesteps))
    cfg_scales = (dynamic_cfg_scales(timesteps, S, dcfg.guidance_scale)
                  if dcfg.use_dynamic_cfg else
                  np.full(S, dcfg.guidance_scale, dtype=np.float32))

    # replace_gt re-noising: abar at timesteps[i+1] (the last step un-noised)
    abar = scheduler.alphas_cumprod
    sqrt_ab = np.zeros(S, dtype=np.float32)
    sqrt_1mab = np.zeros(S, dtype=np.float32)
    renoise = np.zeros(S, dtype=np.float32)
    for i in range(S - 1):
        a = abar[int(timesteps[i + 1])]
        sqrt_ab[i] = a**0.5
        sqrt_1mab[i] = (1 - a)**0.5
        renoise[i] = 1.0

    run = np.ones(S, dtype=bool)
    for si in dcfg.skip_steps or ():
        if not 0 <= si < S:
            raise ValueError(f"skip step {si} out of range [0, {S})")
        run[si] = False
    if not run[0]:
        raise ValueError("step 0 cannot be skipped (nothing cached yet)")
    if dcfg.capture_hidden_states and not run[S - 1]:
        raise ValueError(f"step {S - 1} cannot be skipped with capture_hidden_states: the "
                         "final (capture) step always evaluates the model")

    def model_pass(inputs: DenoiseInputs, rope, latents, i, embeds, cfg_batch: bool,
                   prev_state: Optional[Dict[str, Any]], capture: bool) -> TransformerOutput:
        tcfg = transformer.cfg
        rep = (lambda x: torch.cat([x, x], dim=0)) if cfg_batch else (lambda x: x)
        latent_video_input = rep(latents)
        image_latents = rep(inputs.image_latents)
        masked_lat = rep(inputs.masked_video_latents)
        mask = rep(inputs.mask)
        # I2V: the image latents join the backbone input; the SFT backbone is
        # T2V (widened to noisy + masked + mask), so never there
        i2v = tcfg.in_channels == 2 * latents.shape[-1]
        if dcfg.mode != "sft" and i2v:
            latent_model_input = torch.cat([latent_video_input, image_latents], dim=-1)
        else:
            latent_model_input = latent_video_input
        timestep = torch.full((latent_model_input.shape[0],), int(coeffs.timesteps[i]),
                              dtype=torch.long, device=latents.device)
        kw: Dict[str, Any] = {}
        if prev_state is not None:
            kw.update({k: prev_state[k] for k in ("prev_hidden_states", "prev_clip_weight",
                                                  "prev_resample_mask")})
            if prev_state.get("prev_hidden_indices") is not None:
                kw["prev_hidden_indices"] = prev_state["prev_hidden_indices"]
        if capture and inputs.capture_indices is not None:
            kw["capture_indices"] = rep(inputs.capture_indices)
            kw["capture_quant"] = dcfg.capture_quant
        par = dict(seq_axis=dcfg.seq_axis, ring_mesh=dcfg.ring_mesh)
        kw.update(return_hidden_states=capture, use_flash=dcfg.use_flash, **par)
        if dcfg.mode == "dual":
            branch_cond = torch.cat([masked_lat, mask[..., None]], dim=-1)
            branch_samples = branch(latent_video_input, embeds, branch_cond, timestep,
                                    rope=rope, conditioning_scale=dcfg.conditioning_scale,
                                    use_flash=dcfg.use_flash, **par)
            return transformer(latent_model_input, embeds, timestep, rope=rope,
                               branch_block_samples=branch_samples,
                               branch_block_masks=mask if dcfg.mask_add else None,
                               add_first=dcfg.add_first,
                               id_pool_resample=dcfg.id_pool_resample, **kw)
        if dcfg.mode == "sft":
            # the widened backbone takes [noisy ‖ masked-video ‖ mask]
            model_in = torch.cat([latent_model_input, masked_lat, mask[..., None]], dim=-1)
            return transformer(model_in, embeds, timestep, rope=rope, **kw)
        if dcfg.mode == "selfguidance":
            # guidance pass on the noised masked-video latents; its per-layer
            # video states replace the main pass's outside the mask
            abar_t = np.float32(scheduler.alphas_cumprod[int(coeffs.timesteps[i])])
            noised = (float(np.sqrt(abar_t)) * masked_lat.float()
                      + float(np.sqrt(np.float32(1) - abar_t)) * rep(inputs.noise).float()
                      ).to(masked_lat.dtype)
            if i2v:
                noised = torch.cat([noised, image_latents], dim=-1)
            g = transformer(noised, embeds, timestep, rope=rope, return_hidden_states=True,
                            use_flash=dcfg.use_flash, **par)
            sg = g.hidden_states_list[:, :, embeds.shape[1]:]
            del g
            return transformer(latent_model_input, embeds, timestep, rope=rope,
                               self_guidance_hidden_states=sg, self_guidance_masks=mask, **kw)
        return transformer(latent_model_input, embeds, timestep, rope=rope, **kw)   # plain

    def tree_map(fn, *trees):
        """fn over tensors or over the int8-capture dicts of tensors."""
        if isinstance(trees[0], dict):
            return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
        return fn(*trees)

    def model_step(inputs: DenoiseInputs, rope, latents, i, prev_state,
                   capture: bool) -> TransformerOutput:
        if dcfg.do_cfg and dcfg.sequential_cfg:
            # uncond and cond as two B-sized passes; prev state and captures are
            # handled per CFG half, so the cross-window conditioning equals the
            # batched run's
            b = latents.shape[0]

            def half(lo, hi):
                if prev_state is None:
                    return None
                out = dict(prev_state,
                           prev_hidden_states=tree_map(lambda x: x[:, lo:hi],
                                                       prev_state["prev_hidden_states"]),
                           prev_resample_mask=prev_state["prev_resample_mask"][lo:hi])
                if prev_state.get("prev_hidden_indices") is not None:
                    out["prev_hidden_indices"] = prev_state["prev_hidden_indices"][lo:hi]
                return out

            out_u = model_pass(inputs, rope, latents, i, inputs.prompt_embeds[:b], False,
                               half(0, b), capture)
            out_c = model_pass(inputs, rope, latents, i, inputs.prompt_embeds[b:], False,
                               half(b, 2 * b), capture)
            out = out_c._replace(sample=torch.cat([out_u.sample, out_c.sample], dim=0))
            if capture:
                out = out._replace(
                    hidden_states_list=tree_map(lambda u, c: torch.cat([u, c], dim=1),
                                                out_u.hidden_states_list,
                                                out_c.hidden_states_list),
                    resample_mask=(None if out_c.resample_mask is None else
                                   torch.cat([out_u.resample_mask, out_c.resample_mask],
                                             dim=0)))
            return out
        return model_pass(inputs, rope, latents, i, inputs.prompt_embeds, dcfg.do_cfg,
                          prev_state, capture)

    def scheduler_and_blend(inputs: DenoiseInputs, latents, old_x0, noise_pred, i, generator):
        noise_pred = noise_pred.float()
        if dcfg.do_cfg:
            uncond, text = noise_pred.chunk(2, dim=0)
            noise_pred = uncond + float(cfg_scales[i]) * (text - uncond)
        if not isinstance(scheduler, CogVideoXDPMScheduler):
            # DDIM (the trainer's scheduler, in its validation runs): no SDE noise
            latents, x0 = scheduler.step(coeffs, i, noise_pred, latents)
        else:
            sde_noise = None
            if inputs.dpm_noises is not None:
                sde_noise = inputs.dpm_noises[i]
            elif dcfg.dpm_sde:
                sde_noise = torch.randn(latents.shape, generator=generator,
                                        dtype=torch.float32, device=latents.device)
            latents, x0 = scheduler.step(coeffs, i, noise_pred, old_x0, latents,
                                         noise=sde_noise)
        if dcfg.replace_gt:
            dtype = latents.dtype
            # self-guidance blends against the masked-video latents, every
            # other mode against the clean video latents
            src = (inputs.masked_video_latents if dcfg.mode == "selfguidance"
                   else inputs.video_latents).float()
            init_latents = (src * float(sqrt_ab[i]) + inputs.noise.float() * float(sqrt_1mab[i])) \
                * float(renoise[i]) + src * (1.0 - float(renoise[i]))
            m = inputs.mask[..., None].float()
            latents = latents.float()
            if dcfg.mask_background:
                latents = m * init_latents + (1 - m) * latents
            else:
                latents = (1 - m) * init_latents + m * latents
            latents = latents.to(dtype)
        return latents, x0

    @torch.no_grad()
    def denoise(inputs: DenoiseInputs, rope, generator: Optional[torch.Generator] = None,
                prev_state: Optional[Dict[str, Any]] = None):
        latents, old_x0, pred = inputs.latents, None, None
        hidden_states_list = resample_mask = None
        for i in range(S):
            with annotate("denoise.step"):
                if run[i]:
                    capture = dcfg.capture_hidden_states and i == S - 1
                    out = model_step(inputs, rope, latents, i, prev_state, capture)
                    pred = out.sample.float()
                    if capture:
                        hidden_states_list = out.hidden_states_list
                        resample_mask = out.resample_mask
                    del out
                latents, old_x0 = scheduler_and_blend(inputs, latents, old_x0, pred, i,
                                                      generator)
            if progress_fn is not None:
                progress_fn(i)
        return latents, hidden_states_list, resample_mask

    return denoise
