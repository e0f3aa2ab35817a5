"""Plain float32 reference of CogVideoX1.5-5B-I2V's DiT and of a
VideoPainter branch cloned from it, written from the published model
description (diffusers' CogVideoXTransformer3DModel with `patch_size_t`,
and its CogVideoXImageToVideoPipeline's 1.5 inputs) over state dicts with
the diffusers parameter names.

What 1.5 changes around the block, which `cogvideox.py` holds and this file
reuses as it is (imported, not edited):
 - patches of q = patch_size_t latent frames by p x p cells: a token
   (t', h', w') holds its window's values ordered channel-major
   (c, dt, dh, dw), projected by `patch_embed.proj` [D, C q p p] (no bias in
   the published model); no position table;
 - the time embedding plus the `ofs` embedding (sinusoid of ofs_embed_dim,
   `ofs_embedding.linear_1/2` with a SiLU between), ofs = 2.0;
 - the output head projects each token to its q x p x p cells (the
   inverse of the patch order);
 - RoPE on the integer latent grid (t < T/q, h < H/p, w < W/p);
 - the patch mask: a token is masked when any cell of its (q, p, p) window is;
 - the I2V inputs: T0 latent frames padded at the front to a multiple of q
   (the masked-video and clean latents and the latent mask repeat their
   frame 0, the noise is drawn at the padded length), the image latent at
   frame 0 with zeros after it, scaled by 1 / scaling_factor
   (`invert_scale_latents`), the video latents by scaling_factor.

Imports nothing of the program under test. Attention is exact (float32
softmax) in blocks of heads and query rows, as in `cogvideox.py`, so that
45,106 tokens fit. Run with TF32 off (`cli.reference_numerics`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference.cogvideox import CogVideoX, _run_block, timestep_features

OFS = 2.0   # the 1.5 I2V pipeline's ofs, for every sample


def rope_tables(head_dim: int, t: int, gh: int, gw: int,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3D rotary tables [t*gh*gw, head_dim] on the integer grid: the
    head split t : h : w = 1/4 : 3/8 : 3/8, each frequency repeated for the
    pair it rotates."""
    dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)

    def axis(dim, n):
        freqs = 1.0 / (10000.0 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
        return np.repeat(np.outer(np.arange(n, dtype=np.float64), freqs), 2, axis=1)

    at, ah, aw = axis(dims[0], t), axis(dims[1], gh), axis(dims[2], gw)
    ang = np.concatenate([
        np.broadcast_to(at[:, None, None], (t, gh, gw, dims[0])),
        np.broadcast_to(ah[None, :, None], (t, gh, gw, dims[1])),
        np.broadcast_to(aw[None, None, :], (t, gh, gw, dims[2]))], axis=-1).reshape(-1, head_dim)
    ang = torch.from_numpy(ang).to(device)
    return torch.cos(ang).float(), torch.sin(ang).float()


def patch_mask(mask: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Latent-grid mask [B, T, h, w] -> bool [B, (T/q)*(h/p)*(w/p)]: a token
    is masked when any cell of its (q, p, p) window is."""
    b, t, h, w = mask.shape
    m = mask.reshape(b, t // q, q, h // p, p, w // p, p).amax(dim=(2, 4, 6))
    return (m > 0).reshape(b, -1)


class CogVideoX15(CogVideoX):
    """The 1.5 DiT or branch over one state dict: `cogvideox.CogVideoX`'s
    blocks with the 1.5 embeddings, output head and rotary grid."""

    def __init__(self, sd, cfg: dict, **kw):
        super().__init__(sd, cfg, **kw)
        self.q = cfg["patch_size_t"]

    def embed(self, video: torch.Tensor, text: torch.Tensor, t: torch.Tensor,
              ofs: float = OFS):
        """video [B, T, H, W, C] latents (T a multiple of q), text
        [B, S_text, 4096], t [B]: (temb + ofs embedding [B, 512], video
        tokens [B, S_vid, D], text tokens)."""
        b, nt, hh, ww, c = video.shape
        p, q = self.p, self.q
        flip, shift = self.cfg.get("flip_sin_to_cos", True), self.cfg.get("freq_shift", 0)
        tf = timestep_features(t.float(), self.heads * self.hd, flip, shift)
        temb = self.linear(F.silu(self.linear(tf, "time_embedding.linear_1")),
                           "time_embedding.linear_2")
        of = timestep_features(torch.full((b,), float(ofs), device=video.device),
                               self.cfg["ofs_embed_dim"], flip, shift)
        temb = temb + self.linear(F.silu(self.linear(of, "ofs_embedding.linear_1")),
                                  "ofs_embedding.linear_2")
        tokens = video.reshape(b, nt // q, q, hh // p, p, ww // p, p, c)
        tokens = tokens.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
            b, (nt // q) * (hh // p) * (ww // p), c * q * p * p)
        vid = self.linear(tokens, "patch_embed.proj")
        return temb, vid, self.linear(text, "patch_embed.text_proj")

    def head(self, h: torch.Tensor, temb: torch.Tensor, shape) -> torch.Tensor:
        """The output head: [B, S_vid, D] -> [B, T, H, W, out_channels]."""
        b, nt, hh, ww = shape
        p, q = self.p, self.q
        h = self.layer_norm(h, "norm_final", self.eps)
        sh, sc = self.linear(F.silu(temb), "norm_out.linear").chunk(2, dim=-1)
        h = self.layer_norm(h, "norm_out.norm", self.eps) * (1 + sc[:, None]) + sh[:, None]
        h = self.linear(h, "proj_out")
        c = h.shape[-1] // (q * p * p)
        h = h.reshape(b, nt // q, hh // p, ww // p, c, q, p, p).permute(0, 1, 5, 2, 6, 3, 7, 4)
        return h.reshape(b, nt, hh, ww, c)

    def rope(self, nt, gh, gw, vae_spatial=8):
        return rope_tables(self.hd, nt // self.q, gh, gw, self.dev)


def branch_features(sd, cfg: dict, latents, cond, text, t, *, device, ofs: float = OFS,
                    conditioning_scale: float = 1.0, control=None) -> List[torch.Tensor]:
    """The branch: the first N blocks over [noisy ‖ masked-video latents ‖
    mask], each block's video tokens through its `branch_blocks.i`
    projection. Returns the N features [B, S_vid, D]."""
    m = CogVideoX15(sd, cfg, device=device, control=control)
    x = torch.cat([latents, cond], dim=-1)
    b, nt, hh, ww, _ = x.shape
    temb, h, e = m.embed(x, text, t, ofs)
    rope = m.rope(nt, hh // m.p, ww // m.p)
    feats = []
    for i in range(cfg["num_layers"]):
        h, e = _run_block(m, i, h, e, temb, rope)
        feats.append(m.linear(h, f"branch_blocks.{i}") * conditioning_scale)
    return feats


def dit_forward(sd, cfg: dict, latents, text, t, *, device, feats=None, mask_lat=None,
                ofs: float = OFS, control=None) -> torch.Tensor:
    """The DiT's prediction [B, T, H, W, out_channels] for input latents
    [B, T, H, W, in_channels]; branch features, when given, are added to the
    video tokens after each block (block i takes feature i // ceil(L / N))
    outside the masked tokens of `mask_lat`."""
    m = CogVideoX15(sd, cfg, device=device, control=control)
    b, nt, hh, ww, _ = latents.shape
    temb, h, e = m.embed(latents, text, t, ofs)
    rope = m.rope(nt, hh // m.p, ww // m.p)
    n = cfg["num_layers"]
    keep = None if mask_lat is None else patch_mask(mask_lat, m.p, m.q)[..., None]
    for i in range(n):
        h, e = _run_block(m, i, h, e, temb, rope)
        if feats is not None:
            f = feats[i // int(math.ceil(n / len(feats)))]
            h = h + f if keep is None else torch.where(keep, h, h + f)
    return m.head(h, temb, (b, nt, hh, ww))


def pad_frames(t0: int, q: int) -> int:
    """The leading latent frames that make t0 a multiple of q."""
    return -t0 % q


def i2v_latents(enc, video: torch.Tensor, masks: torch.Tensor, image: torch.Tensor, q: int,
                scaling_factor: float, encodes: Optional[dict] = None):
    """The padded I2V inputs of one clip: (masked-video latents, clean
    latents, latent mask, image latents), each at T0 + k frames. `enc` is a
    `vae_encoder.Encoder`; video [B, T, H, W, 3] and image [B, H, W, 3] in
    [-1, 1], masks [B, T, H, W] (1 = hole). `encodes`, when given, keeps the
    three encodes for a second call."""
    encodes = {} if encodes is None else encodes
    if "masked" not in encodes:
        encodes["masked"] = enc.latents(video * (masks < 0.5)[..., None])
        encodes["clean"] = enc.latents(video)
        encodes["image"] = enc.moments(image[:, None])[0] / scaling_factor
    masked, clean, image_lat = encodes["masked"], encodes["clean"], encodes["image"]
    m = masks
    for dim, n in zip((1, 2, 3), masked.shape[1:4]):
        m = m.index_select(dim, torch.arange(n, device=m.device) * m.shape[dim] // n)
    k = pad_frames(masked.shape[1], q)
    pad = lambda x: torch.cat([x[:, :1].expand(-1, k, *x.shape[2:]), x], dim=1)
    image_lat = torch.cat([image_lat, torch.zeros_like(pad(masked)[:, 1:])], dim=1)
    return pad(masked), pad(clean), pad(m), image_lat
