"""SAM2 memory attention and memory encoder.

Counterpart of `videopainter_tpu/segmentation/memory.py` (reference
app/sam2/modeling/memory_attention.py: MemoryAttentionLayer :15-100,
MemoryAttention :103-170; memory_encoder.py: MaskDownSampler :17-60, CXBlock
:63-115, Fuser :118-135, MemoryEncoder :138-181; transformer.py RoPEAttention
:285-360: axial 2D RoPE on the queries and the spatial keys, the
object-pointer tokens left out), with the torch SAM2's module names.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .modules import (LayerNorm2d, apply_rotary_enc, compute_axial_cis, gelu_exact, sdpa,
                      sine_pos_embed)
from .sam_heads import Attention


class RoPEAttention(Attention):
    def __init__(self, embedding_dim: int, num_heads: int, kv_in_dim=None,
                 rope_theta: float = 10000.0, rope_k_repeat: bool = False):
        super().__init__(embedding_dim, num_heads, 1, kv_in_dim)
        self.rope_theta, self.rope_k_repeat = rope_theta, rope_k_repeat

    def forward(self, q, k, v, *, feat_size: Tuple[int, int], num_k_exclude_rope: int = 0):
        """q / k / v [B, S, C]; `feat_size` is (w, h) of the query grid."""
        qh, kh, vh = (self.split(self.q_proj(q)), self.split(self.k_proj(k)),
                      self.split(self.v_proj(v)))
        cis = compute_axial_cis(qh.shape[-1], feat_size[0], feat_size[1], self.rope_theta)
        num_k_rope = kh.shape[-2] - num_k_exclude_rope
        qh, k_rot = apply_rotary_enc(qh, kh[:, :, :num_k_rope], cis,
                                     repeat_freqs_k=self.rope_k_repeat)
        if num_k_exclude_rope > 0:
            kh = torch.cat([k_rot, kh[:, :, num_k_rope:]], dim=-2)
        else:
            kh = k_rot
        return self.merge(sdpa(qh, kh, vh))


class MemoryAttentionLayer(nn.Module):
    """The SAM2 yamls' layer: pos_enc_at_attn False, pos_enc_at_cross_attn_keys
    True, pos_enc_at_cross_attn_queries False, relu feed-forward."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, kv_in_dim: int):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, num_heads)
        self.cross_attn_image = RoPEAttention(d_model, num_heads, kv_in_dim=kv_in_dim,
                                              rope_k_repeat=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model)
        self.norm2 = nn.LayerNorm(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, x, mem, mpos, *, feat_size, num_obj_ptr_tokens: int):
        t2 = self.norm1(x)
        x = x + self.self_attn(t2, t2, t2, feat_size=feat_size)
        t2 = self.norm2(x)
        x = x + self.cross_attn_image(t2, mem + mpos, mem, feat_size=feat_size,
                                      num_k_exclude_rope=num_obj_ptr_tokens)
        t2 = self.norm3(x)
        return x + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    def __init__(self, d_model: int = 256, num_layers: int = 4, num_heads: int = 1,
                 dim_feedforward: int = 2048, kv_in_dim: int = 64):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model, num_heads, dim_feedforward, kv_in_dim)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model)

    def forward(self, curr, memory, curr_pos, memory_pos, *, feat_size: Tuple[int, int],
                num_obj_ptr_tokens: int = 0, pos_enc_at_input: bool = True) -> torch.Tensor:
        """curr / curr_pos [S_cur, B, C], memory / memory_pos [S_mem, B, C_mem]
        (sequence first, as the reference) -> [S_cur, B, C] (reference :103-170)."""
        output = curr + 0.1 * curr_pos if pos_enc_at_input else curr
        x, mem, mpos = output.transpose(0, 1), memory.transpose(0, 1), memory_pos.transpose(0, 1)
        for layer in self.layers:
            x = layer(x, mem, mpos, feat_size=feat_size, num_obj_ptr_tokens=num_obj_ptr_tokens)
        return self.norm(x).transpose(0, 1)


class MaskDownSampler(nn.Module):
    """`encoder`: (conv k / s / p, LayerNorm2d, GELU) x log_s(total_stride),
    channels times s^2 each, then a 1x1 conv to `embed_dim`."""

    def __init__(self, embed_dim: int, kernel_size: int, stride: int, padding: int,
                 total_stride: int = 16):
        super().__init__()
        layers, cin = [], 1
        for _ in range(int(math.log2(total_stride) // math.log2(stride))):
            cout = cin * stride ** 2
            layers += [nn.Conv2d(cin, cout, kernel_size, stride, padding), LayerNorm2d(cout),
                       nn.GELU()]
            cin = cout
        layers.append(nn.Conv2d(cin, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class CXBlock(nn.Module):
    def __init__(self, dim: int, kernel_size: int = 7, padding: int = 3):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel_size, padding=padding, groups=dim)
        self.norm = LayerNorm2d(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(1e-6 * torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        z = self.gamma * self.pwconv2(gelu_exact(self.pwconv1(z)))
        return x + z.permute(0, 3, 1, 2)


class Fuser(nn.Module):
    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    def __init__(self, in_dim: int = 256, out_dim: int = 64, mask_downsampler=(3, 2, 1),
                 fuser_layers: int = 2):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(in_dim, *mask_downsampler)
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, fuser_layers)
        if out_dim != in_dim:
            self.out_proj = nn.Conv2d(in_dim, out_dim, 1)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor, *,
                skip_mask_sigmoid: bool = False):
        """pix_feat [B, C, h, w]; masks [B, 1, H, W] logits at image size ->
        (features [B, C_out, h, w], their sine encoding) (reference :138-181)."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        y = self.fuser(self.pix_feat_proj(pix_feat) + self.mask_downsampler(masks))
        if hasattr(self, "out_proj"):
            y = self.out_proj(y)
        pos = sine_pos_embed(y.shape[2], y.shape[3], y.shape[1], y.device)
        return y, pos.expand(y.shape[0], -1, -1, -1)
