"""Plain float32 reference of CogVideoX-5b-I2V's DiT and VideoPainter's
context branch, written from the published model description (diffusers'
CogVideoXTransformer3DModel, VideoPainter's CogvideoXBranchModel) over a
state dict with the diffusers parameter names.

Nothing here imports the program under test: every tensor comes from the
state dict and the inputs the benchmark made. Weights are upcast to float32
one layer at a time; attention is computed exactly (float32 softmax) in
blocks of heads and query rows so that 17,776 tokens fit. Run with TF32 off
(`cli.reference_numerics`).

`quant` (a `quant.Quantizer` or None) puts the block projections (q, k,
v, out and the feed-forward) through the W8A8 configuration's int8, the
model's definition there; `attn_qk` gives the score product's operands
(that configuration's int8 Q.K^T). `control` (a `quant.Control`) instead
computes every matrix product in its product precision (every linear's
operands, attention's Q, K, V and probabilities, per row) and holds the
activations the program holds in bf16 (every linear's output and the
residual stream) in its activation precision.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

StateDict = Dict[str, torch.Tensor]
SCORE_BUDGET = 1 << 31   # bytes of float32 scores held at once


def f32(sd: StateDict, name: str, device) -> torch.Tensor:
    return sd[name].to(device=device, dtype=torch.float32)


def timestep_features(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                      freq_shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64,
                                                        device=t.device) / (half - freq_shift))
    ang = t.double()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb.float()


def rope_tables(head_dim: int, t: int, gh: int, gw: int, base_h: int, base_w: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CogVideoX's 3D rotary tables [t*gh*gw, head_dim]: the head split
    t : h : w = 1/4 : 3/8 : 3/8, positions rescaled onto the 720x480 base
    grid, each frequency repeated for the pair it rotates."""
    if gh / gw > base_h / base_w:
        rh, rw = base_h, int(round(base_h / gh * gw))
    else:
        rw, rh = base_w, int(round(base_w / gw * gh))
    top, left = int(round((base_h - rh) / 2.0)), int(round((base_w - rw) / 2.0))
    pos_h = np.linspace(top, top + rh, gh, endpoint=False)
    pos_w = np.linspace(left, left + rw, gw, endpoint=False)
    pos_t = np.arange(t, dtype=np.float64)
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)

    def axis(dim, pos):
        freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
        return np.repeat(np.outer(pos, freqs), 2, axis=1)

    at, ah, aw = axis(dims[0], pos_t), axis(dims[1], pos_h), axis(dims[2], pos_w)
    ang = np.concatenate([
        np.broadcast_to(at[:, None, None], (t, gh, gw, dims[0])),
        np.broadcast_to(ah[None, :, None], (t, gh, gw, dims[1])),
        np.broadcast_to(aw[None, None, :], (t, gh, gw, dims[2]))], axis=-1).reshape(-1, head_dim)
    ang = torch.from_numpy(ang).to(device)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, H, S, d]: pairs (x0, x1) -> (x0 c - x1 s, x1 c + x0 s)."""
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              qk: Optional[Callable] = None, control=None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, H, S, d] in float32, in blocks of
    heads and query rows. `qk(q, k)` -> (q', k') replaces the operands of
    the score product, a head's whole sequence at a time (the int8
    configuration's quantized Q and K)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if qk is not None or control is not None:
            raise ValueError("the reference's backward covers exact attention only")
        return ExactAttention.apply(q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = torch.empty_like(q)
    hc = min(h, 8)
    qc = max(1, min(sq, SCORE_BUDGET // (4 * hc * skv)))
    scale = d ** -0.5
    for bi in range(b):
        for h0 in range(0, h, hc):
            qh, kk, vv = q[bi, h0:h0 + hc], k[bi, h0:h0 + hc], v[bi, h0:h0 + hc]
            if qk is not None:
                qh, kk = qk(qh, kk)
            if control is not None:
                qh, kk, vv = control.fake(qh), control.fake(kk), control.fake(vv)
            for s0 in range(0, sq, qc):
                s = (qh[:, s0:s0 + qc] @ kk.transpose(-1, -2)) * scale
                p = torch.softmax(s, dim=-1)
                if control is not None:
                    p = control.fake(p)
                out[bi, h0:h0 + hc, s0:s0 + qc] = p @ vv
    return out


class ExactAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(d)) v in float32 with a memory-light backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, h, s, d = q.shape
        scale = d ** -0.5
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:3], dtype=q.dtype, device=q.device)
        for bi, h0, h1, s0, s1 in _blocks(q, k):
            sc = (q[bi, h0:h1, s0:s1] @ k[bi, h0:h1].transpose(-1, -2)) * scale
            m = torch.logsumexp(sc, dim=-1)
            lse[bi, h0:h1, s0:s1] = m
            out[bi, h0:h1, s0:s1] = torch.exp(sc - m[..., None]) @ v[bi, h0:h1]
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        delta = (do * out).sum(dim=-1)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        for bi, h0, h1, s0, s1 in _blocks(q, k):
            qq, kk, vv = q[bi, h0:h1, s0:s1], k[bi, h0:h1], v[bi, h0:h1]
            p = torch.exp((qq @ kk.transpose(-1, -2)) * scale - lse[bi, h0:h1, s0:s1, None])
            g = do[bi, h0:h1, s0:s1]
            dv[bi, h0:h1] += p.transpose(-1, -2) @ g
            ds = p * (g @ vv.transpose(-1, -2) - delta[bi, h0:h1, s0:s1, None])
            dq[bi, h0:h1, s0:s1] = (ds @ kk) * scale
            dk[bi, h0:h1] += (ds.transpose(-1, -2) @ qq) * scale
        return dq, dk, dv


def _blocks(q, k):
    b, h, sq, _ = q.shape
    hc = min(h, 8)
    qc = max(1, min(sq, SCORE_BUDGET // (4 * hc * k.shape[2])))
    for bi in range(b):
        for h0 in range(0, h, hc):
            for s0 in range(0, sq, qc):
                yield bi, h0, min(h0 + hc, h), s0, min(s0 + qc, sq)


class CogVideoX:
    """The DiT (prefix "") or the branch over one state dict of each.

    cfg: the transformer config.json keys (num_layers, num_attention_heads,
    attention_head_dim, patch_size, norm_eps, max_text_seq_length, ...).
    """

    def __init__(self, sd: StateDict, cfg: dict, *, device, quant=None, attn_qk=None,
                 control=None):
        self.sd, self.cfg, self.dev = sd, cfg, device
        self.quant, self.attn_qk, self.control = quant, attn_qk, control
        self.heads = cfg["num_attention_heads"]
        self.hd = cfg["attention_head_dim"]
        self.p = cfg["patch_size"]
        self.eps = cfg.get("norm_eps", 1e-5)

    def w(self, name):
        return f32(self.sd, name, self.dev)

    def linear(self, x, name, quantized=False):
        w, b = self.w(name + ".weight"), self.sd.get(name + ".bias")
        b = None if b is None else b.to(self.dev).float()
        if self.control is not None:
            return self.control.act(self.control.linear(x, w, b))
        if quantized and self.quant is not None:
            return self.quant.linear(x, w, b)
        return F.linear(x, w, b)

    def layer_norm(self, x, name, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w(name + ".weight"),
                            self.w(name + ".bias"), eps)

    # -- embeddings ---------------------------------------------------------
    def embed(self, video: torch.Tensor, text: torch.Tensor, t: torch.Tensor):
        """video [B, T, H, W, C] latents, text [B, S_text, 4096], t [B]:
        (temb [B, 512], video tokens [B, S_vid, D], text tokens)."""
        b, nt, hh, ww, c = video.shape
        p = self.p
        tf = timestep_features(t.float(), self.heads * self.hd, self.cfg.get("flip_sin_to_cos", True),
                               self.cfg.get("freq_shift", 0))
        temb = self.linear(F.silu(self.linear(tf, "time_embedding.linear_1")),
                           "time_embedding.linear_2")
        frames = video.permute(0, 1, 4, 2, 3).reshape(b * nt, c, hh, ww)
        wp = self.w("patch_embed.proj.weight")
        if self.control is not None:   # the patch embed as the product it is
            patches = F.unfold(frames, p, stride=p).transpose(1, 2)
            vid = self.control.linear(patches, wp.flatten(1), self.w("patch_embed.proj.bias"))
            vid = vid.reshape(b, nt, hh // p, ww // p, -1)
        else:
            vid = F.conv2d(frames, wp, self.w("patch_embed.proj.bias"), stride=p)
            vid = vid.reshape(b, nt, -1, hh // p, ww // p).permute(0, 1, 3, 4, 2)
        vid = vid.reshape(b, nt * (hh // p) * (ww // p), -1)
        txt = self.linear(text, "patch_embed.text_proj")
        joint = torch.cat([txt, vid], dim=1)
        if "patch_embed.pos_embedding" in self.sd:
            joint = joint + self.w("patch_embed.pos_embedding")[:, :joint.shape[1]]
        s_text = text.shape[1]
        return temb, joint[:, s_text:], joint[:, :s_text]

    # -- one block ------------------------------------------------------------
    def block(self, i: int, h, e, temb, rope, resample: Optional[torch.Tensor] = None):
        pre = f"transformer_blocks.{i}."
        d = h.shape[-1]

        def modulate(name):
            mod = self.linear(F.silu(temb), pre + name + ".linear")
            sh, sc, g, esh, esc, eg = mod.chunk(6, dim=-1)
            hn = self.layer_norm(h, pre + name + ".norm", self.eps) * (1 + sc[:, None]) + sh[:, None]
            en = self.layer_norm(e, pre + name + ".norm", self.eps) * (1 + esc[:, None]) + esh[:, None]
            return hn, en, g[:, None], eg[:, None]

        hn, en, g, eg = modulate("norm1")
        text_len = e.shape[1]
        x = torch.cat([en, hn], dim=1)
        bsz, s, _ = x.shape
        heads = lambda y: y.view(bsz, -1, self.heads, self.hd).transpose(1, 2)
        cos, sin = rope
        rot = lambda y: torch.cat([y[:, :, :text_len],
                                   apply_rope(y[:, :, text_len:], cos, sin)], dim=2)
        norm_k = lambda y: self.layer_norm(heads(y), pre + "attn1.norm_k", 1e-6)
        q = rot(self.layer_norm(heads(self.linear(x, pre + "attn1.to_q", True)),
                                pre + "attn1.norm_q", 1e-6))
        k_flat = self.linear(x, pre + "attn1.to_k", True)
        v_flat = self.linear(x, pre + "attn1.to_v", True)
        k, v = rot(norm_k(k_flat)), heads(v_flat)
        if resample is not None:
            # VideoPainter's ID resample: a second page of keys and values,
            # the raw projections times the resample mask (own tokens) or a
            # zero page (the previous window's states at weight 0), through
            # the key norm and RoPE like the first
            m = resample.to(k_flat.dtype)[..., None]
            km_flat, vm_flat = k_flat * m, v_flat * m
            k = torch.cat([k, rot(norm_k(km_flat))], dim=2)
            v = torch.cat([v, heads(vm_flat)], dim=2)
            del km_flat, vm_flat
        del k_flat, v_flat
        o = attention(q, k, v, None if self.control is not None else self.attn_qk, self.control)
        del q, k, v
        o = self.linear(o.transpose(1, 2).reshape(bsz, s, d), pre + "attn1.to_out.0", True)
        h = self.act(h + g * o[:, text_len:])
        e = self.act(e + eg * o[:, :text_len])
        del o
        hn, en, g, eg = modulate("norm2")
        y = torch.cat([en, hn], dim=1)
        y = F.gelu(self.linear(y, pre + "ff.net.0.proj", True), approximate="tanh")
        y = self.linear(y, pre + "ff.net.2", True)
        return self.act(h + g * y[:, text_len:]), self.act(e + eg * y[:, :text_len])

    def act(self, x):
        return x if self.control is None else self.control.act(x)

    def rope(self, nt, gh, gw, vae_spatial=8):
        if not self.cfg.get("use_rotary_positional_embeddings", False):
            raise ValueError("the reference covers the rotary CogVideoX-5b family only")
        base = self.p * vae_spatial
        return rope_tables(self.hd, nt, gh, gw, 480 // base, 720 // base, self.dev)


def patch_mask(mask: torch.Tensor, p: int) -> torch.Tensor:
    """Latent-grid mask [B, T, h, w] -> bool [B, T*(h/p)*(w/p)]: a patch is
    masked when any of its cells is."""
    b, t, h, w = mask.shape
    m = mask.reshape(b, t, h // p, p, w // p, p).amax(dim=(3, 5))
    return (m > 0).reshape(b, -1)


def _run_block(m, i, h, e, temb, rope, page=None, checkpoint=False):
    if not checkpoint:
        return m.block(i, h, e, temb, rope, page)
    from torch.utils.checkpoint import checkpoint as ckpt
    return ckpt(lambda a, b: m.block(i, a, b, temb, rope, page), h, e, use_reentrant=False)


def branch_features(sd: StateDict, cfg: dict, latents, cond, text, t, *, device, quant=None,
                    conditioning_scale: float = 1.0, attn_qk=None,
                    control=None, checkpoint: bool = False) -> List[torch.Tensor]:
    """VideoPainter's branch: the first N blocks over [noisy ‖ masked-video
    latents ‖ mask], each block's video tokens through its `branch_blocks.i`
    projection. Returns the N features [B, S_vid, D]."""
    m = CogVideoX(sd, cfg, device=device, quant=quant, attn_qk=attn_qk, control=control)
    x = torch.cat([latents, cond], dim=-1)
    b, nt, hh, ww, _ = x.shape
    temb, h, e = m.embed(x, text, t)
    rope = m.rope(nt, hh // m.p, ww // m.p)
    feats = []
    for i in range(cfg["num_layers"]):
        h, e = _run_block(m, i, h, e, temb, rope, checkpoint=checkpoint)
        feats.append(m.linear(h, f"branch_blocks.{i}") * conditioning_scale)
    return feats


def dit_forward(sd: StateDict, cfg: dict, latents, text, t, *, device, feats=None,
                mask_lat=None, quant=None, attn_qk=None, resample: Optional[str] = None,
                control=None, checkpoint: bool = False) -> torch.Tensor:
    """The DiT's prediction [B, T, H, W, out_channels] for input latents
    [B, T, H, W, in_channels]; branch features, when given, are added to the
    video tokens after each block (block i takes feature i // ceil(L / N))
    outside the masked patches of `mask_lat`. resample: None, "own" (the ID
    resample page of this clip's masked tokens) or "zero" (the previous
    window's page at clip weight 0). checkpoint: recompute each block in the
    backward (training)."""
    m = CogVideoX(sd, cfg, device=device, quant=quant, attn_qk=attn_qk, control=control)
    b, nt, hh, ww, _ = latents.shape
    p = m.p
    temb, h, e = m.embed(latents, text, t)
    rope = m.rope(nt, hh // p, ww // p)
    n = cfg["num_layers"]
    keep = None if mask_lat is None else patch_mask(mask_lat, p)[..., None]
    page = None
    if resample is not None:
        text_len = e.shape[1]
        page = torch.zeros((b, text_len + h.shape[1]), dtype=torch.bool, device=h.device)
        if resample == "own":
            page[:, text_len:] = keep[..., 0]
    for i in range(n):
        h, e = _run_block(m, i, h, e, temb, rope, page, checkpoint)
        if feats is not None:
            f = feats[i // int(math.ceil(n / len(feats)))]
            h = h + f if keep is None else torch.where(keep, h, h + f)
    h = m.layer_norm(h, "norm_final", m.eps)
    sh, sc = m.linear(F.silu(temb), "norm_out.linear").chunk(2, dim=-1)
    h = m.layer_norm(h, "norm_out.norm", m.eps) * (1 + sc[:, None]) + sh[:, None]
    h = m.linear(h, "proj_out")
    c = h.shape[-1] // (p * p)
    h = h.reshape(b, nt, hh // p, ww // p, c, p, p).permute(0, 1, 2, 5, 3, 6, 4)
    return h.reshape(b, nt, hh, ww, c)
