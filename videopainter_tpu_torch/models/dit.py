"""CogVideoX spatiotemporal diffusion transformer (DiT).

Counterpart of `videopainter_tpu/models/dit.py` (CogVideoXTransformer3DModel):
joint [text ‖ video] token sequence, AdaLN-Zero conditioning, per-layer
branch-feature injection with optional mask gating. The blocks are an
`nn.ModuleList` run by a Python loop; parameter names are the diffusers
names, so a reference state dict loads with `load_state_dict`.

The JAX package pads the joint sequence once to the flash block multiple (a
Mosaic out-of-bounds rule); the port's kernels mask ragged tails themselves,
so the sequence stays at its true length.

The any-length path lives here too: the joint `resample_mask` for ID
resampling, per-layer previous-window states in three forms (full
[L, B, S, D]; compressed [L, B, M, D] with `prev_hidden_indices`, scattered
into a zero buffer whose extra slot S_joint takes the pad indices; the int8
dict {"values", "scales"} dequantized per layer), captures of the per-layer
states (`return_hidden_states`, `capture_indices`, `capture_quant`) and the
activation-amax calibration pass of the int8 linears. The self-guidance swap
belongs to the variants slice.

Training: `remat=True` runs every block under a non-reentrant
`torch.utils.checkpoint`, so only block inputs stay resident and each block
that a gradient reaches is recomputed in the backward (the branch injection
runs between the checkpoints); `remat_chunk=k` additionally
puts groups of k blocks under an outer checkpoint (group inputs stay, one
group's block inputs at a time, one more forward of each group). The JAX
package's scan-specific parts of that code (per-layer dynamic gather,
optimization barrier) have no counterpart in a Python loop over modules.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import TransformerConfig
from ..ops.attention import Attention
from ..ops.basic import LayerNorm, Linear, calibration, init_random_
from ..ops.embeddings import TimestepEmbedding, timestep_embedding
from ..ops.feed_forward import FeedForward
from ..ops.norms import AdaLayerNorm, LayerNormZero
from ..ops.patch_embed import PatchEmbed, unpatchify
from ..ops.sincos import get_3d_sincos_pos_embed


def crop_pos_embedding(pos, cfg, text_len: int, num_frames: int,
                       height: int, width: int):
    """Size the stored joint sincos table to the input: a prefix crop for a
    shorter video at the sample spatial dims and full text length; anything
    else raises, as the reference does under learned embeddings."""
    if pos is None:
        return None
    p = cfg.patch_size
    need = text_len + num_frames * (height // p) * (width // p)
    if pos.shape[1] == need:
        return pos
    if (height != cfg.sample_height or width != cfg.sample_width
            or text_len != cfg.max_text_seq_length or pos.shape[1] < need):
        raise ValueError(
            f"positional-embedding table ({pos.shape[1]} tokens) cannot be "
            f"cropped to the input ({need} tokens: text {text_len}, video "
            f"{num_frames}x{height // p}x{width // p}): only a shorter video "
            f"at the sample spatial dims ({cfg.sample_height}x"
            f"{cfg.sample_width}) and full text length "
            f"({cfg.max_text_seq_length}) is a prefix of the stored table")
    return pos[:, :need]


def positional_embeddings(cfg: TransformerConfig) -> np.ndarray:
    """Joint [text-zeros ‖ 3D-sincos] table [1, S_text + S_vid, D] float32."""
    p = cfg.patch_size
    post_t = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
    pe = get_3d_sincos_pos_embed(
        cfg.inner_dim, (cfg.sample_width // p, cfg.sample_height // p), post_t,
        cfg.spatial_interpolation_scale, cfg.temporal_interpolation_scale)
    pe = pe.reshape(-1, cfg.inner_dim)
    joint = np.zeros((1, cfg.max_text_seq_length + pe.shape[0], cfg.inner_dim),
                     dtype=np.float32)
    joint[0, cfg.max_text_seq_length:] = pe
    return joint


class CogVideoXBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.inner_dim
        self.num_heads = cfg.num_attention_heads
        self.norm1 = LayerNormZero(cfg.time_embed_dim, d, eps=cfg.norm_eps,
                                   elementwise_affine=cfg.norm_elementwise_affine, **kw)
        self.attn1 = Attention(d, num_heads=cfg.num_attention_heads, qk_norm=True,
                               bias=cfg.attention_bias, **kw)
        self.norm2 = LayerNormZero(cfg.time_embed_dim, d, eps=cfg.norm_eps,
                                   elementwise_affine=cfg.norm_elementwise_affine, **kw)
        self.ff = FeedForward(d, **kw)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor],
                temb: torch.Tensor, rope, *, use_flash: Union[bool, str] = False,
                resample_mask: Optional[torch.Tensor] = None,
                prev_hidden_states: Optional[torch.Tensor] = None,  # [B, S_joint, D] raw
                prev_clip_weight: Optional[float] = None,
                prev_resample_mask: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """encoder_hidden_states=None selects the wo_text path."""
        wo_text = encoder_hidden_states is None
        text_len = 0 if wo_text else encoder_hidden_states.shape[1]
        norm_h, norm_e, gate_msa, enc_gate_msa = self.norm1(
            hidden_states, encoder_hidden_states, temb)

        norm_prev = None
        if prev_hidden_states is not None:
            # the raw previous-window states are re-normed with norm1 and the
            # current temb before attention
            np_vid, np_enc, _, _ = self.norm1(prev_hidden_states[:, text_len:],
                                              prev_hidden_states[:, :text_len], temb)
            norm_prev = torch.cat([np_enc, np_vid], dim=1)

        attn_h, attn_e = self.attn1(norm_h, norm_e, rope=rope, use_flash=use_flash,
                                    resample_mask=resample_mask,
                                    prev_hidden_states=norm_prev,
                                    prev_clip_weight=prev_clip_weight,
                                    prev_resample_mask=prev_resample_mask)
        hidden_states = hidden_states + gate_msa * attn_h
        if not wo_text:
            encoder_hidden_states = encoder_hidden_states + enc_gate_msa * attn_e

        norm_h, norm_e, gate_ff, enc_gate_ff = self.norm2(
            hidden_states, encoder_hidden_states, temb)
        if wo_text:
            return hidden_states + gate_ff * self.ff(norm_h), None
        ff_out = self.ff(torch.cat([norm_e, norm_h], dim=1))
        hidden_states = hidden_states + gate_ff * ff_out[:, text_len:]
        encoder_hidden_states = encoder_hidden_states + enc_gate_ff * ff_out[:, :text_len]
        return hidden_states, encoder_hidden_states


def run_block_calibrated(block: nn.Module, *args, **kwargs):
    """Run one block and return (its outputs, the [n_sites] activation amaxes
    of its dynamic int8 linears in call order)."""
    with calibration(block) as taps:
        out = block(*args, **kwargs)
    if not taps:
        raise ValueError("calibrate=True but no dynamic int8 linear ran: quantize the model "
                         "first (quantize_transformer_int8) and don't pre-attach static scales")
    return out, torch.stack(taps)


def checkpointed(fn):
    """`fn` under a non-reentrant checkpoint: its intermediates are dropped
    after the forward and recomputed in the backward. Randomness is not
    replayed: nothing on this path draws any."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def quantize_capture(ys: torch.Tensor) -> dict:
    """Per-token symmetric int8 of captured states (scale = max|x| / 127 over
    D, floored): {"values": int8 [..., D], "scales": fp32 [...]}."""
    y32 = ys.float()
    sc = y32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    return {"values": torch.round(y32 / sc[..., None]).to(torch.int8), "scales": sc}


class TransformerOutput(NamedTuple):
    sample: torch.Tensor                       # [B, T, H, W, out_C]
    hidden_states_list: Optional[Any] = None   # [L, B, S_joint | M, D], or the int8 dict
    resample_mask: Optional[torch.Tensor] = None   # bool [B, S_joint]
    calib_amax: Optional[torch.Tensor] = None      # [L, n_sites] (calibrate=True)


class _CogVideoXBase(nn.Module):
    """Shared trunk of the backbone and the branch: patch embed (with the
    learned/sincos table as `patch_embed.pos_embedding`), time embedding,
    blocks and the output-head parameters the reference state dict holds."""

    def __init__(self, cfg: TransformerConfig, patch_in_channels: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.inner_dim
        self.patch_embed = PatchEmbed(patch_size=cfg.patch_size, in_channels=patch_in_channels,
                                      embed_dim=d, text_embed_dim=cfg.text_embed_dim, **kw)
        if not cfg.use_rotary_positional_embeddings or cfg.use_learned_positional_embeddings:
            pos = torch.from_numpy(positional_embeddings(cfg))
            # persistent only when learned, as in the reference state dict
            self.patch_embed.register_buffer(
                "pos_embedding", pos.to(device=device, dtype=dtype or torch.float32),
                persistent=cfg.use_learned_positional_embeddings)
        self.time_embedding = TimestepEmbedding(d, cfg.time_embed_dim, **kw)
        self.transformer_blocks = nn.ModuleList(
            [CogVideoXBlock(cfg, **kw) for _ in range(cfg.num_layers)])
        self.norm_final = LayerNorm(d, eps=cfg.norm_eps,
                                    elementwise_affine=cfg.norm_elementwise_affine, **kw)
        self.norm_out = AdaLayerNorm(cfg.time_embed_dim, 2 * d, eps=cfg.norm_eps,
                                     elementwise_affine=cfg.norm_elementwise_affine, **kw)
        self.proj_out = Linear(d, cfg.patch_size * cfg.patch_size * cfg.out_channels, **kw)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator):
        """Seeded random weights (see ops.basic.init_random_) and the sincos
        table, for a model made on the meta device and moved with to_empty."""
        init_random_(self, generator)
        if hasattr(self.patch_embed, "pos_embedding"):
            pe = self.patch_embed.pos_embedding
            pe.copy_(torch.from_numpy(positional_embeddings(self.cfg)).to(pe.dtype))
        return self

    def _embed(self, hidden_states, encoder_hidden_states, timestep, masks=None):
        cfg = self.cfg
        b, num_frames, height, width, _ = hidden_states.shape
        timestep = torch.as_tensor(timestep, device=hidden_states.device)
        if timestep.ndim == 0:
            timestep = timestep.expand(b)
        t_emb = timestep_embedding(timestep, cfg.inner_dim,
                                   flip_sin_to_cos=cfg.flip_sin_to_cos,
                                   downscale_freq_shift=cfg.freq_shift)
        emb = self.time_embedding(t_emb.to(hidden_states.dtype))
        pos = crop_pos_embedding(getattr(self.patch_embed, "pos_embedding", None), cfg,
                                 encoder_hidden_states.shape[1], num_frames, height, width)
        embeds, patch_mask = self.patch_embed(encoder_hidden_states, hidden_states,
                                              masks=masks, pos_embedding=pos)
        text_len = encoder_hidden_states.shape[1]
        return emb, embeds[:, text_len:], embeds[:, :text_len], patch_mask


class CogVideoXTransformer3D(_CogVideoXBase):
    """The DiT backbone. `patch_in_channels` may exceed cfg.in_channels (the
    SFT variant widens the patch embed)."""

    def __init__(self, cfg: TransformerConfig, patch_in_channels: Optional[int] = None, *,
                 device=None, dtype=None):
        super().__init__(cfg, patch_in_channels or cfg.in_channels, device=device, dtype=dtype)

    def forward(
        self,
        hidden_states: torch.Tensor,             # [B, T, H, W, C_in] latents
        encoder_hidden_states: torch.Tensor,     # [B, S_text, text_dim]
        timestep,                                # [B] or scalar
        *,
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        branch_block_samples: Optional[torch.Tensor] = None,  # [n_branch, B, S_vid, D]
        branch_block_masks: Optional[torch.Tensor] = None,    # [B, T_lat, H, W] float
        add_first: bool = False,
        prev_hidden_states: Optional[Any] = None,   # [L, B, S_joint, D], or compressed
                                                    # [L, B, M, D], or {"values": int8,
                                                    # "scales": fp32}
        prev_clip_weight: Optional[float] = None,
        prev_resample_mask: Optional[torch.Tensor] = None,   # bool [B, S_joint]
        prev_hidden_indices: Optional[torch.Tensor] = None,  # int [B, M]: joint-sequence
                                                    # positions of compressed prev states
        id_pool_resample: bool = False,
        return_hidden_states: bool = False,
        capture_indices: Optional[torch.Tensor] = None,  # int [B, M]: capture only these
        capture_quant: bool = False,                     # int8 per-token capture
        use_flash: Union[bool, str] = False,
        calibrate: bool = False,   # collect per-layer per-site activation amax of the
                                   # dynamic int8 linears (quantize.calibrate_ascales)
        remat: bool = False,       # checkpoint every block (training)
        remat_chunk: Optional[int] = None,   # blocks per outer checkpointed group
    ) -> TransformerOutput:
        cfg = self.cfg
        if (prev_hidden_indices is not None or isinstance(prev_hidden_states, dict)) \
                and prev_hidden_states is not None and not cfg.id_pool_resample_learnable:
            raise ValueError(
                "compressed prev_hidden_states (prev_hidden_indices) are only valid on the "
                "ID-resample path: the base processor's prev-clip blend reads the full "
                "sequence of prev keys and values")
        if calibrate and (return_hidden_states or remat or prev_hidden_states is not None
                          or id_pool_resample):
            # the variant paths add to_k / to_v calls and a checkpoint reruns the
            # block, both of which would scramble the site order of the
            # recorded amaxes
            raise ValueError("calibrate=True requires the plain forward path "
                             "(no captures, variants, or remat)")
        if prev_hidden_states is not None and prev_clip_weight is None:
            # the attention variant keys on both; without a weight the prev
            # states would be silently ignored
            raise ValueError("prev_hidden_states requires prev_clip_weight")
        b, num_frames, height, width, _ = hidden_states.shape
        emb, h, enc_h, patch_mask = self._embed(hidden_states, encoder_hidden_states,
                                                timestep, masks=branch_block_masks)
        text_len, s_vid = enc_h.shape[1], h.shape[1]
        s_joint = text_len + s_vid

        # resample mask over the joint sequence
        resample_mask = None
        if (id_pool_resample or return_hidden_states or prev_resample_mask is not None) \
                and patch_mask is not None:
            resample_mask = torch.cat(
                [torch.zeros((b, text_len), dtype=torch.bool, device=h.device), patch_mask],
                dim=1)
        learnable = cfg.id_pool_resample_learnable
        attn_resample_mask = resample_mask if (id_pool_resample and learnable) else None
        prev_rs = prev_resample_mask if learnable else None

        n_layers = cfg.num_layers
        if branch_block_samples is not None:
            nb = branch_block_samples.shape[0]
            if add_first:
                bidx = [min(i, nb - 1) for i in range(n_layers)]
                bvalid = [i < nb for i in range(n_layers)]
            else:
                interval = int(math.ceil(n_layers / nb))
                bidx = [i // interval for i in range(n_layers)]
                bvalid = [True] * n_layers
        gate_mask = None if patch_mask is None else patch_mask[..., None]  # True: no injection

        def prev_for_layer(i: int) -> Optional[torch.Tensor]:
            if prev_hidden_states is None:
                return None
            if isinstance(prev_hidden_states, dict):
                prev_h = (prev_hidden_states["values"][i].float()
                          * prev_hidden_states["scales"][i][..., None]).to(h.dtype)
            else:
                prev_h = prev_hidden_states[i]
            if prev_hidden_indices is not None:
                # only masked-region tokens were captured, the only positions the
                # resample processor reads (prev_resample_mask zeroes the rest), so
                # scattering them into a zero buffer is exact; pad indices land in
                # the extra slot S_joint, sliced off
                full = torch.zeros((b, s_joint + 1, prev_h.shape[-1]), dtype=prev_h.dtype,
                                   device=prev_h.device)
                full[torch.arange(b, device=prev_h.device)[:, None],
                     prev_hidden_indices.long()] = prev_h
                prev_h = full[:, :s_joint]
            return prev_h

        def block_kw(i: int) -> dict:
            return dict(use_flash=use_flash, resample_mask=attn_resample_mask,
                        prev_hidden_states=prev_for_layer(i), prev_clip_weight=prev_clip_weight,
                        prev_resample_mask=prev_rs)

        def run_block(i: int, h, enc_h):
            return self.transformer_blocks[i](h, enc_h, emb, rope, **block_kw(i))

        def inject(i: int, h):
            """Block i's branch injection. It stays outside the block's
            checkpoint: it keeps nothing but the gate mask for the backward,
            and inside it would make a block whose input needs no gradient
            (block 0 under branch training) recompute for that mask alone."""
            if branch_block_samples is None:
                return h
            injected = h + branch_block_samples[bidx[i]].to(h.dtype) * float(bvalid[i])
            return injected if gate_mask is None else torch.where(gate_mask, h, injected)

        def capture(h, enc_h):
            ys = torch.cat([enc_h, h], dim=1)
            if capture_indices is not None:
                # compressed capture: keep only the masked-region tokens (pad
                # slots gather a clamped in-range token; the consumer's scatter
                # drops them)
                idx = capture_indices.long().clamp(0, s_joint - 1)
                ys = torch.gather(ys, 1, idx[..., None].expand(-1, -1, ys.shape[-1]))
            return quantize_capture(ys) if capture_quant else ys

        def run_layers(lo: int, hi: int, h, enc_h):
            """Blocks [lo, hi): (h, enc_h, their captures, their amaxes)."""
            caps, amaxes = [], []
            for i in range(lo, hi):
                if remat:
                    h, enc_h = checkpointed(lambda a, b, i=i: run_block(i, a, b))(h, enc_h)
                elif calibrate:
                    (h, enc_h), amax = run_block_calibrated(
                        self.transformer_blocks[i], h, enc_h, emb, rope, **block_kw(i))
                    amaxes.append(amax)
                else:
                    h, enc_h = run_block(i, h, enc_h)
                h = inject(i, h)
                if return_hidden_states:
                    caps.append(capture(h, enc_h))
            return h, enc_h, caps, amaxes

        if remat and remat_chunk and remat_chunk < n_layers:
            # two-level rematerialization: the last group may be smaller. A
            # checkpoint returns tensors, so int8 captures cross it flattened.
            captures, amaxes = [], []
            for lo in range(0, n_layers, remat_chunk):
                def group(a, b, lo=lo, hi=min(lo + remat_chunk, n_layers)):
                    a, b, caps, _ = run_layers(lo, hi, a, b)
                    if capture_quant:
                        caps = [c[k] for c in caps for k in ("values", "scales")]
                    return (a, b, *caps)
                h, enc_h, *caps = checkpointed(group)(h, enc_h)
                if capture_quant:
                    caps = [{"values": v, "scales": sc} for v, sc in zip(caps[::2], caps[1::2])]
                captures += caps
        else:
            h, enc_h, captures, amaxes = run_layers(0, n_layers, h, enc_h)

        hs_list = None
        if return_hidden_states:
            if capture_quant:
                hs_list = {k: torch.stack([c[k] for c in captures]) for k in captures[0]}
            else:
                hs_list = torch.stack(captures)

        # 2B norms the video tokens, 5B the joint sequence; the norm is per
        # token, so both are the norm of the video slice
        h = self.norm_final(h)
        h = self.norm_out(h, emb)
        h = self.proj_out(h)
        return TransformerOutput(
            sample=unpatchify(h, num_frames, height, width, cfg.patch_size),
            hidden_states_list=hs_list, resample_mask=resample_mask,
            calib_amax=torch.stack(amaxes) if calibrate else None)
