"""CogVideoX spatiotemporal diffusion transformer (DiT).

Counterpart of `videopainter_tpu/models/dit.py` (CogVideoXTransformer3DModel):
joint [text ‖ video] token sequence, AdaLN-Zero conditioning, per-layer
branch-feature injection with optional mask gating. The blocks are an
`nn.ModuleList` run by a Python loop; parameter names are the diffusers
names, so a reference state dict loads with `load_state_dict`.

The JAX package pads the joint sequence once to the flash block multiple (a
Mosaic out-of-bounds rule); the port's kernel masks ragged tails itself, so
the sequence stays at its true length. The resample, prev-clip,
self-guidance and capture paths belong to the any-length slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import TransformerConfig
from ..ops.attention import Attention
from ..ops.basic import LayerNorm, Linear, init_random_
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

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                temb: torch.Tensor, rope, *, use_flash: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        text_len = encoder_hidden_states.shape[1]
        norm_h, norm_e, gate_msa, enc_gate_msa = self.norm1(
            hidden_states, encoder_hidden_states, temb)
        attn_h, attn_e = self.attn1(norm_h, norm_e, rope=rope, use_flash=use_flash)
        hidden_states = hidden_states + gate_msa * attn_h
        encoder_hidden_states = encoder_hidden_states + enc_gate_msa * attn_e

        norm_h, norm_e, gate_ff, enc_gate_ff = self.norm2(
            hidden_states, encoder_hidden_states, temb)
        ff_out = self.ff(torch.cat([norm_e, norm_h], dim=1))
        hidden_states = hidden_states + gate_ff * ff_out[:, text_len:]
        encoder_hidden_states = encoder_hidden_states + enc_gate_ff * ff_out[:, :text_len]
        return hidden_states, encoder_hidden_states


class TransformerOutput(NamedTuple):
    sample: torch.Tensor  # [B, T, H, W, out_C]


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
        prev_hidden_states=None,
        prev_clip_weight=None,
        use_flash: bool = False,
    ) -> TransformerOutput:
        cfg = self.cfg
        if prev_hidden_states is not None and prev_clip_weight is None:
            # the attention variant keys on both; without a weight the prev
            # states would be silently ignored
            raise ValueError("prev_hidden_states requires prev_clip_weight")
        if prev_hidden_states is not None:
            raise NotImplementedError("prev-clip conditioning belongs to the any-length slice")
        b, num_frames, height, width, _ = hidden_states.shape
        emb, h, enc_h, patch_mask = self._embed(hidden_states, encoder_hidden_states,
                                                timestep, masks=branch_block_masks)

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

        for i, block in enumerate(self.transformer_blocks):
            h, enc_h = block(h, enc_h, emb, rope, use_flash=use_flash)
            if branch_block_samples is not None:
                injected = h + branch_block_samples[bidx[i]].to(h.dtype) * float(bvalid[i])
                h = injected if gate_mask is None else torch.where(gate_mask, h, injected)

        # 2B norms the video tokens, 5B the joint sequence; the norm is per
        # token, so both are the norm of the video slice
        h = self.norm_final(h)
        h = self.norm_out(h, emb)
        h = self.proj_out(h)
        return TransformerOutput(unpatchify(h, num_frames, height, width, cfg.patch_size))
