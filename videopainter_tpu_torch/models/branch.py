"""VideoPainter context encoder ("branch").

Counterpart of `videopainter_tpu/models/branch.py` (CogvideoXBranchModel): a
clone of the first N backbone blocks with a widened patch embed (noisy latent
‖ masked-video latent ‖ mask = latent*2+1 channels) and per-layer Linear
projections (`branch_blocks.{i}`) of the block outputs, returned stacked and
scaled by `conditioning_scale`. `norm_final`, `norm_out`, `proj_out` and
`branch_x_embedder` exist in the reference state dict but are unused by the
forward; they are kept so the state dict round-trips.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..config import BranchConfig, TransformerConfig
from ..ops.basic import Linear
from .dit import CogVideoXTransformer3D, _CogVideoXBase, checkpointed, run_block_calibrated


class CogVideoXBranch(_CogVideoXBase):
    def __init__(self, cfg: BranchConfig, *, device=None, dtype=None):
        super().__init__(cfg, cfg.patch_in_channels, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        d = cfg.inner_dim
        self.branch_blocks = nn.ModuleList([Linear(d, d, **kw) for _ in range(cfg.num_layers)])
        self.branch_x_embedder = Linear(cfg.in_channels, d, **kw)

    @torch.no_grad()
    def init_from_transformer(self, transformer: CogVideoXTransformer3D) -> "CogVideoXBranch":
        """Copy the backbone's weights into the branch (reference
        from_transformer): the patch-embed kernel's latent slots duplicated,
        the mask slot zeroed, text projection, time embedding and the first N
        blocks copied; the per-layer projections zeroed."""
        cfg = self.cfg
        tcfg: TransformerConfig = transformer.cfg
        c_in = cfg.in_channels
        bb = transformer.patch_embed.proj.weight  # [O, C_bb, p, p]
        new = torch.zeros_like(self.patch_embed.proj.weight)
        if cfg.patch_in_channels == 2 * c_in + 1:
            # T2V-style: both latent slots get the full kernel
            new[:, :c_in] = bb
            new[:, c_in:2 * c_in] = bb
        elif cfg.patch_in_channels == c_in + 1:
            # I2V-style (in = 2*latent): the noisy-latent half, duplicated
            half = c_in // 2
            new[:, :half] = bb[:, :half]
            new[:, half:c_in] = bb[:, :half]
        else:
            raise ValueError(f"in_channels {c_in} not supported")
        if tcfg.in_channels != bb.shape[1]:
            raise ValueError("backbone patch embed does not match its config")
        self.patch_embed.proj.weight.copy_(new)
        self.patch_embed.proj.bias.copy_(transformer.patch_embed.proj.bias)
        self.patch_embed.text_proj.load_state_dict(transformer.patch_embed.text_proj.state_dict())
        self.time_embedding.load_state_dict(transformer.time_embedding.state_dict())
        for i, blk in enumerate(self.transformer_blocks):
            blk.load_state_dict(transformer.transformer_blocks[i].state_dict())
        for lin in self.branch_blocks:
            lin.weight.zero_()
            lin.bias.zero_()
        return self

    def forward(
        self,
        hidden_states: torch.Tensor,            # [B, T, H, W, C_lat] noisy latents
        encoder_hidden_states: torch.Tensor,    # [B, S_text, text_dim]
        branch_cond: torch.Tensor,              # [B, T, H, W, C_lat+1] masked latents ‖ mask
        timestep,
        *,
        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        conditioning_scale: float = 1.0,
        use_flash: Union[bool, str] = False,
        calibrate: bool = False,   # also return the [L, n_sites] activation amax of the
                                   # dynamic int8 linears (quantize.calibrate_ascales)
        remat: bool = False,       # checkpoint every block (training)
    ):
        """Returns stacked branch features [num_layers, B, S_vid, D] (with
        calibrate, the pair (features, amax)). cfg.wo_text runs video-only
        blocks: the text is embedded but takes no part in the blocks."""
        if calibrate and remat:
            raise ValueError("calibrate=True requires remat=False (a checkpoint reruns the "
                             "block and records its amaxes twice)")
        x = torch.cat([hidden_states, branch_cond], dim=-1)
        emb, h, enc_h, _ = self._embed(x, encoder_hidden_states, timestep)
        wo_text = self.cfg.wo_text
        outs, amaxes = [], []
        for blk, proj in zip(self.transformer_blocks, self.branch_blocks):
            args = (h, None if wo_text else enc_h, emb, rope)
            if calibrate:
                (h, e), amax = run_block_calibrated(blk, *args, use_flash=use_flash)
                amaxes.append(amax)
            elif wo_text and remat:   # a checkpoint returns tensors: drop the None
                h, e = checkpointed(lambda h_, blk=blk: blk(
                    h_, None, emb, rope, use_flash=use_flash)[0])(h), None
            elif remat:
                h, e = checkpointed(lambda h_, e_, blk=blk: blk(
                    h_, e_, emb, rope, use_flash=use_flash))(h, enc_h)
            else:
                h, e = blk(*args, use_flash=use_flash)
            enc_h = enc_h if wo_text else e
            y = torch.nn.functional.linear(h, proj.weight.to(h.dtype))
            outs.append((y + proj.bias.to(y.dtype)) * conditioning_scale)
        out = torch.stack(outs)
        return (out, torch.stack(amaxes)) if calibrate else out
