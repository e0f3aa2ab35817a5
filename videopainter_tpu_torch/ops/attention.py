"""Joint [text ‖ video] self-attention with RoPE and QK-LayerNorm.

Counterpart of `videopainter_tpu/ops/attention.py` (reference processor
CogVideoXAttnProcessor2_0): joint attention over the concatenated sequence,
RoPE on the video slice only. `sdpa` is the exact path (fp32 softmax);
`use_flash=True` routes to the hand-written flash kernel
(`ops/flash_attention.py`). The resample, prev-clip and wo_text variants
belong to the any-length slice of the port and raise NotImplementedError.

Heads are split by a view ([B, S, H, d]) and handed to the flash kernel as
[B, H, S, d] strided views: no transposed copies.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .basic import LayerNorm, Linear
from .flash_attention import flash_attention
from .rope import apply_rotary_emb


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """Exact scaled dot-product attention, fp32 softmax. q,k,v: [B, H, S, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def _rope_video_slice(x: torch.Tensor, rope, text_len: int) -> torch.Tensor:
    """RoPE on positions [text_len:] of [B, S, H, D]; cos/sin are [S_vid, D]."""
    if rope is None:
        return x
    cos, sin = rope
    out = torch.empty_like(x)
    out[:, :text_len] = x[:, :text_len]
    out[:, text_len:] = apply_rotary_emb(x[:, text_len:], cos[:, None, :], sin[:, None, :])
    return out


class Attention(nn.Module):
    """diffusers Attention with the CogVideoX processor's parameter names
    (`to_q`, `to_k`, `to_v`, `to_out.0`, `norm_q`, `norm_k`)."""

    def __init__(self, dim: int, *, num_heads: int, qk_norm: bool = True,
                 bias: bool = True, out_bias: bool = True, qk_norm_eps: float = 1e-6,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.to_q = Linear(dim, dim, bias=bias, **kw)
        self.to_k = Linear(dim, dim, bias=bias, **kw)
        self.to_v = Linear(dim, dim, bias=bias, **kw)
        self.to_out = nn.ModuleList([Linear(dim, dim, bias=out_bias, **kw)])
        self.norm_q = LayerNorm(head_dim, eps=qk_norm_eps, **kw) if qk_norm else None
        self.norm_k = LayerNorm(head_dim, eps=qk_norm_eps, **kw) if qk_norm else None

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor], *,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_flash: bool = False, **variant) -> Tuple[torch.Tensor, torch.Tensor]:
        """Base processor. Returns (attn_hidden_states, attn_encoder_hidden_states)."""
        return joint_attention(self, hidden_states, encoder_hidden_states, rope=rope,
                               use_flash=use_flash, **variant)


def joint_attention(
    attn: Attention,
    hidden_states: torch.Tensor,                     # [B, S_vid, D]
    encoder_hidden_states: Optional[torch.Tensor],   # [B, S_text, D]
    *,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_flash: bool = False,
    resample_mask: Optional[torch.Tensor] = None,
    prev_hidden_states: Optional[torch.Tensor] = None,
    prev_clip_weight: Optional[float] = None,
    prev_resample_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if encoder_hidden_states is None:
        raise NotImplementedError("wo_text attention belongs to the any-length slice")
    if resample_mask is not None or prev_resample_mask is not None \
            or prev_hidden_states is not None:
        raise NotImplementedError(
            "resample / prev-clip attention variants belong to the any-length slice")
    if use_flash not in (False, True):
        raise NotImplementedError(f"use_flash={use_flash!r}: the int8 modes come later")

    text_len = encoder_hidden_states.shape[1]
    x = torch.cat([encoder_hidden_states, hidden_states], dim=1)
    b, s, dim = x.shape
    heads = attn.num_heads
    q = attn.to_q(x).view(b, s, heads, dim // heads)
    k = attn.to_k(x).view(b, s, heads, dim // heads)
    v = attn.to_v(x).view(b, s, heads, dim // heads)
    if attn.norm_q is not None:
        q = attn.norm_q(q)
    if attn.norm_k is not None:
        k = attn.norm_k(k)
    q = _rope_video_slice(q, rope, text_len)
    k = _rope_video_slice(k, rope, text_len)

    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = flash_attention(qh, kh, vh) if use_flash else sdpa(qh, kh, vh)
    out = attn.to_out[0](out.transpose(1, 2).reshape(b, s, dim))
    return out[:, text_len:], out[:, :text_len]
