"""Joint [text ‖ video] self-attention with RoPE, QK-LayerNorm, cross-clip
blending and target-region ID resampling.

Counterpart of `videopainter_tpu/ops/attention.py` (reference processors
CogVideoXAttnProcessor2_0, ..._resample and ..._wo_text):

 - base: joint attention over the concatenated sequence, RoPE on the video
   slice only; with `prev_hidden_states` and `prev_clip_weight` two attention
   calls blended on their outputs, `(1 - w) * attn + w * attn_prev`;
 - resample (`resample_mask` or `prev_resample_mask` given): masked K / V
   tokens are concatenated onto K / V (2 S keys), so target-region tokens get
   double attention weight. The mask multiplies the *pre-norm, pre-RoPE* K and
   V projections; norm_k and RoPE then run on the masked K, as the reference
   does. With prev states the masked pair comes from `prev_hidden_states`
   times `prev_clip_weight`;
 - wo_text (`encoder_hidden_states` None): video-only attention.

`sdpa` is the exact path (fp32 softmax). `use_flash=True` routes to the
hand-written bf16 flash kernel (`ops/flash_attention.py`), `"int8"` and
`"int8pv"` to the int8 one (`ops/flash_attention_int8.py`; inference only).

Heads are split by a view ([B, S, H, d]) and handed to the flash kernels as
[B, H, S, d] strided views: no transposed copies. The sequence is never
padded, so the 2 S-key call needs no paged mask here.

`fuse_qkv_projections` folds a model's to_q / to_k / to_v into one
Linear(D, 3 D) named `to_qkv` (diffusers' fuse_qkv_projections, the
FusedCogVideoXAttnProcessor2_0): one product where there were three, whose
output is split into the same q, k and v.

Under tensor parallelism (`parallel/sharding.shard_params`) `num_heads` is
the rank's local head count and the projections hold its heads only; under
sequence parallelism (`sp`, a `parallel.sequence.SeqShard`) the rank holds
the text and its shard of the video tokens. K and V, and the masked or
previous-window pages of the variants, are then all-gathered over `seq`
before attention (the counterpart of GSPMD's all-gathers), so local queries
attend to every key through the same kernels; or, on the plain joint path
with `sp.ring`, the call goes to ring attention (`parallel/ring_attention`),
which runs the bf16 kernel B1 whatever the `use_flash` mode.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..utils.profiling import annotate
from .basic import LayerNorm, Linear
from .flash_attention import flash_attention
from .flash_attention_int8 import flash_attention_int8
from .rope import apply_rotary_emb


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: Optional[float] = None) -> torch.Tensor:
    """Exact scaled dot-product attention, fp32 softmax. q,k,v: [B, H, S, D]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)


def _pick_flash(use_flash):
    """use_flash=True -> the bf16 kernel; "int8" -> int8 Q.K^T; "int8pv" ->
    additionally int8 P.V (slightly lossier). Both int8 modes are serving
    modes, like the W8A8 block projections."""
    if use_flash is True:
        return flash_attention
    if use_flash == "int8":
        return flash_attention_int8
    if use_flash == "int8pv":
        return functools.partial(flash_attention_int8, int8_pv=True)
    raise ValueError(f"use_flash must be False, True, 'int8' or 'int8pv', got {use_flash!r}")


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

    @property
    def fused(self) -> bool:
        return "to_qkv" in self._modules

    def project(self, x: torch.Tensor, with_q: bool = True):
        """(q, k, v) projections of x [B, S, D], by the fused or the separate
        linears. Without q, the separate linears skip to_q; the fused one
        projects q all the same (and the caller drops it), as the reference's
        fused processor does."""
        if self.fused:
            return tuple(self.to_qkv(x).chunk(3, dim=-1))
        k_flat, v_flat = self.to_k(x), self.to_v(x)
        return (self.to_q(x) if with_q else None), k_flat, v_flat

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor], *,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_flash: Union[bool, str] = False, **variant
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (attn_hidden_states, attn_encoder_hidden_states)."""
        return joint_attention(self, hidden_states, encoder_hidden_states, rope=rope,
                               use_flash=use_flash, **variant)


def joint_attention(
    attn: Attention,
    hidden_states: torch.Tensor,                     # [B, S_vid, D]
    encoder_hidden_states: Optional[torch.Tensor],   # [B, S_text, D] | None (wo_text)
    *,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    use_flash: Union[bool, str] = False,             # False | True | "int8" | "int8pv"
    resample_mask: Optional[torch.Tensor] = None,        # bool [B, S_joint]
    prev_hidden_states: Optional[torch.Tensor] = None,   # [B, S_joint, D] (pre-normed)
    prev_clip_weight: Optional[float] = None,
    prev_resample_mask: Optional[torch.Tensor] = None,   # bool [B, S_joint]
    sp=None,                                             # parallel.sequence.SeqShard
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Variant selection mirrors the reference:
     - encoder_hidden_states is None      -> wo_text processor
     - resample_mask / prev_resample given -> resample processor
     - prev_hidden_states + weight         -> base processor with the two-call blend
    The whole call runs under the `attn` span.
    """
    with annotate("attn"):
        if encoder_hidden_states is not None:
            text_len = encoder_hidden_states.shape[1]
            x = torch.cat([encoder_hidden_states, hidden_states], dim=1)
        else:
            text_len = 0
            x = hidden_states
        b, s, _ = x.shape
        heads = attn.num_heads   # local heads under tensor parallelism
        split = lambda t: t.view(t.shape[0], t.shape[1], heads, t.shape[2] // heads)
        norm_k = (lambda t: t) if attn.norm_k is None else attn.norm_k
        attend = _pick_flash(use_flash) if use_flash else sdpa
        # under sequence parallelism the keys and values of every rank's video
        # tokens ([B, S, H, D] rows) are gathered before attention
        gather = (lambda t: t) if sp is None else (lambda t: sp.gather_kv(t, text_len))
        heads_first = lambda t: t.transpose(1, 2)

        use_resample = resample_mask is not None or prev_resample_mask is not None
        has_prev = prev_hidden_states is not None and prev_clip_weight is not None

        q_flat, k_flat, v_flat = attn.project(x)
        q = split(q_flat)
        if attn.norm_q is not None:
            q = attn.norm_q(q)
        q = heads_first(_rope_video_slice(q, rope, text_len))
        k = _rope_video_slice(norm_k(split(k_flat)), rope, text_len)
        v = split(v_flat)

        if sp is not None and sp.ring and text_len > 0 and not use_resample and not has_prev:
            from ..parallel.ring_attention import ring_joint_attention

            k, v = heads_first(k), heads_first(v)
            out_t, out_v = ring_joint_attention(
                q[:, :, :text_len], q[:, :, text_len:], k[:, :, :text_len], k[:, :, text_len:],
                v[:, :, :text_len], v[:, :, text_len:], sp.group, use_flash=bool(use_flash))
            out = torch.cat([out_t, out_v], dim=2)
        else:
            k, v = heads_first(gather(k)), heads_first(gather(v))
            if use_resample:
                # the mask multiplies the raw K / V projections
                if has_prev:
                    m = prev_resample_mask[..., None]
                    _, km_flat, vm_flat = attn.project(prev_hidden_states, with_q=False)
                    km_flat = km_flat * m.to(km_flat.dtype) * prev_clip_weight
                    vm_flat = vm_flat * m.to(vm_flat.dtype) * prev_clip_weight
                else:
                    m = resample_mask[..., None]
                    km_flat = k_flat * m.to(k_flat.dtype)
                    vm_flat = v_flat * m.to(v_flat.dtype)
                km = heads_first(gather(_rope_video_slice(norm_k(split(km_flat)), rope, text_len)))
                vm = heads_first(gather(split(vm_flat)))
                # S_kv = 2 * S_q: the kernels take asymmetric lengths
                out = attend(q, torch.cat([k, km], dim=2), torch.cat([v, vm], dim=2))
            elif has_prev:
                # the blend is linear in the attention outputs, so two calls replace
                # the reference's two SDPAs
                _, pk_flat, pv_flat = attn.project(prev_hidden_states, with_q=False)
                pk = heads_first(gather(_rope_video_slice(norm_k(split(pk_flat)), rope, text_len)))
                pv = heads_first(gather(split(pv_flat)))
                w = prev_clip_weight
                out = attend(q, k, v) * (1.0 - w) + attend(q, pk, pv) * w
            else:
                out = attend(q, k, v)

        out = attn.to_out[0](out.transpose(1, 2).reshape(b, s, -1))
        if encoder_hidden_states is None:
            return out, None
        return out[:, text_len:], out[:, :text_len]


@torch.no_grad()
def fuse_qkv(attn: Attention) -> Attention:
    """Replace `attn`'s to_q / to_k / to_v by one `to_qkv` whose weight
    stacks theirs ([3 D, D], q then k then v) and whose bias concatenates
    theirs; in place, returns `attn`. Plain linears only: quantize after
    fusing, and merge an adapter before."""
    lins = [attn.to_q, attn.to_k, attn.to_v]
    if not all(type(lin) is Linear and getattr(lin, "lora_A", None) is None for lin in lins):
        raise ValueError("fuse_qkv takes plain linears: fuse before quantizing or "
                         "attaching an adapter")
    w = lins[0].weight
    fused = Linear(w.shape[1], 3 * w.shape[0], bias=lins[0].bias is not None,
                   device=w.device, dtype=w.dtype)
    fused.weight.copy_(torch.cat([lin.weight for lin in lins], dim=0))
    if fused.bias is not None:
        fused.bias.copy_(torch.cat([lin.bias for lin in lins], dim=0))
    for name in ("to_q", "to_k", "to_v"):
        delattr(attn, name)
    attn.to_qkv = fused
    return attn


def fuse_qkv_projections(model: nn.Module) -> nn.Module:
    """`fuse_qkv` on the attention of every block of a DiT or branch; in
    place, returns `model`."""
    for block in model.transformer_blocks:
        fuse_qkv(block.attn1)
    return model
