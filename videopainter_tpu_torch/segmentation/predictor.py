"""SAM2 interactive video predictor.

Counterpart of `videopainter_tpu/segmentation/predictor.py` (reference
app/sam2/sam2_video_predictor.py: init_state :41, add_new_points :170,
propagate_in_video :606, reset_state :719; sam2_base.SAM2Base.track_step).
Per frame:
  1. image-encoder features, cached per frame (`SAM2State.features`, which
     the app shares between the objects of one clip);
  2. memory conditioning: the conditioning frames (clicks) at t_pos 0, the
     last num_maskmem - 1 frames' memories with temporal embeddings, and the
     object-pointer tokens (sam2_base.py:493-662);
  3. the SAM heads: prompt encoder and mask decoder;
  4. the memory encoder on the predicted mask (sam2_base.py:664-700).

`SAM2Base` holds the modules under the torch SAM2's names, so a published
`sam2_hiera_*.pt` state dict (or a golden's `sd::` entries) loads with
`load_state_dict`. The resized frames, the feature cache and the memory bank
stay on the predictor's device; only the mask logits a caller takes go to
the host. Frames are resized on the host with cv2 INTER_AREA, as the JAX
package does, so both start from the same inputs. Everything runs in float32
with TF32 off (`utils.numerics.full_fp32`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..utils import numerics
from .hiera import HieraConfig, ImageEncoder
from .memory import MemoryAttention, MemoryEncoder
from .modules import MLP, resize_bilinear
from .sam_heads import MaskDecoder, PromptEncoder


@dataclass(frozen=True)
class SAM2Config:
    """The JAX package's SAM2Config, plus the module widths it reads off its
    parameter trees (defaults: the published checkpoints')."""
    hiera: HieraConfig = field(default_factory=HieraConfig)
    image_size: int = 512
    num_maskmem: int = 7
    mem_dim: int = 64
    hidden_dim: int = 256
    memory_attention_heads: int = 1
    mask_decoder_heads: int = 8
    max_obj_ptrs_in_encoder: int = 16
    use_obj_ptrs_in_encoder: bool = True
    directly_add_no_mem_embed: bool = True
    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    multimask_output_for_tracking: bool = True
    iou_prediction_use_sigmoid: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    pred_obj_scores: bool = True
    fixed_no_obj_ptr: bool = True
    add_tpos_enc_to_obj_ptrs: bool = True
    binarize_mask_from_pts_for_mem_enc: bool = True
    # module widths
    use_high_res_features_in_sam: bool = True
    prompt_mask_in_chans: int = 16
    mask_decoder_mlp_dim: int = 2048
    iou_head_hidden_dim: int = 256
    memory_attention_layers: int = 4
    memory_attention_ff: int = 2048
    mask_downsampler: Tuple[int, int, int] = (3, 2, 1)   # kernel, stride, padding
    memory_encoder_fuser_layers: int = 2

    @property
    def feat_stride(self) -> int:
        return 16

    @property
    def feat_size(self) -> int:
        return self.image_size // self.feat_stride


def get_1d_sine_pe(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    pe_dim = dim // 2
    dim_t = temperature ** (torch.arange(pe_dim, dtype=torch.float32, device=pos.device) / pe_dim)
    t = pos[..., None] / dim_t
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)


@dataclass
class FrameOutput:
    maskmem_features: torch.Tensor    # [1, mem_dim, h, w]
    maskmem_pos: torch.Tensor         # [1, mem_dim, h, w]
    pred_mask: torch.Tensor           # [1, H, W] logits at image size
    obj_ptr: torch.Tensor             # [1, C]


@dataclass
class SAM2State:
    images: torch.Tensor              # [T, 3, S, S] normalized, on the predictor's device
    features: Dict[int, dict] = field(default_factory=dict)
    points: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    cond_outputs: Dict[int, FrameOutput] = field(default_factory=dict)
    non_cond_outputs: Dict[int, FrameOutput] = field(default_factory=dict)


IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_frame(frame: np.ndarray, size: int) -> np.ndarray:
    """uint8 or [0, 1] float [H, W, 3] -> normalized float32 [S, S, 3] on the
    host (cv2 INTER_AREA, as the JAX package)."""
    import cv2

    if frame.dtype == np.uint8:
        frame = frame.astype(np.float32) / 255.0
    frame = cv2.resize(frame, (size, size), interpolation=cv2.INTER_AREA)
    return (frame - IMG_MEAN) / IMG_STD


class SAM2Base(nn.Module):
    """The SAM2 modules and parameters, named as in the torch SAM2."""

    def __init__(self, cfg: SAM2Config):
        super().__init__()
        self.cfg = cfg
        c, e = cfg.hidden_dim, cfg.feat_size
        self.image_encoder = ImageEncoder(cfg.hiera)
        self.sam_prompt_encoder = PromptEncoder(c, (e, e), (cfg.image_size, cfg.image_size),
                                                cfg.prompt_mask_in_chans)
        self.sam_mask_decoder = MaskDecoder(
            c, cfg.mask_decoder_heads, mlp_dim=cfg.mask_decoder_mlp_dim,
            iou_head_hidden_dim=cfg.iou_head_hidden_dim,
            use_high_res_features=cfg.use_high_res_features_in_sam,
            pred_obj_scores=cfg.pred_obj_scores,
            iou_prediction_use_sigmoid=cfg.iou_prediction_use_sigmoid)
        self.memory_attention = MemoryAttention(c, cfg.memory_attention_layers,
                                                cfg.memory_attention_heads,
                                                cfg.memory_attention_ff, cfg.mem_dim)
        self.memory_encoder = MemoryEncoder(c, cfg.mem_dim, cfg.mask_downsampler,
                                            cfg.memory_encoder_fuser_layers)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, cfg.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, c))
        if cfg.pred_obj_scores and cfg.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, c))
        self.obj_ptr_proj = MLP(c, c, c, 3)
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)   # unused by the tracker

    @property
    def device(self) -> torch.device:
        return self.no_mem_embed.device

    def encode_image(self, image: torch.Tensor) -> dict:
        """The image encoder on [B, 3, S, S] normalized frames."""
        with numerics.full_fp32():
            return self.image_encoder(image)

    def high_res_features(self, feats: dict):
        if not self.cfg.use_high_res_features_in_sam:
            return None
        dec = self.sam_mask_decoder
        return [dec.conv_s0(feats["backbone_fpn"][0]), dec.conv_s1(feats["backbone_fpn"][1])]


class SAM2VideoPredictor(SAM2Base):
    # -- public API (mirrors sam2_video_predictor.py) ----------------------------------
    def init_state(self, video: np.ndarray) -> SAM2State:
        """video: [T, H, W, 3] uint8 or float [0, 1]; resized to image_size on
        the host, then moved to the predictor's device."""
        frames = np.stack([preprocess_frame(f, self.cfg.image_size) for f in video])
        images = torch.from_numpy(frames).permute(0, 3, 1, 2).contiguous().to(self.device)
        return SAM2State(images=images)

    def reset_state(self, state: SAM2State) -> None:
        state.points.clear()
        state.cond_outputs.clear()
        state.non_cond_outputs.clear()

    @torch.no_grad()
    def _frame_features(self, state: SAM2State, idx: int) -> dict:
        if idx not in state.features:
            state.features[idx] = self.encode_image(state.images[idx:idx + 1])
        return state.features[idx]

    def add_new_points(self, state: SAM2State, frame_idx: int, points: np.ndarray,
                       labels: np.ndarray) -> np.ndarray:
        """points [N, 2] (x, y) in image_size pixels, labels [N] (1 foreground,
        0 background); clicks on a frame accumulate. Returns the frame's mask
        logits [S, S] on the host."""
        prev = state.points.get(frame_idx)
        if prev is not None:
            points = np.concatenate([prev[0], points], axis=0)
            labels = np.concatenate([prev[1], labels], axis=0)
        state.points[frame_idx] = (points, labels)
        out = self._track_frame(state, frame_idx, is_cond=True,
                                points=(points[None], labels[None]))
        state.cond_outputs[frame_idx] = out
        state.non_cond_outputs.pop(frame_idx, None)
        return out.pred_mask[0].cpu().numpy()

    def propagate_in_video(self, state: SAM2State, start_frame_idx: int = 0,
                           reverse: bool = False):
        """Yields (frame_idx, mask logits [S, S] on the host) across the video."""
        t = len(state.images)
        order = range(start_frame_idx, t) if not reverse else range(start_frame_idx, -1, -1)
        for idx in order:
            if idx in state.cond_outputs:
                yield idx, state.cond_outputs[idx].pred_mask[0].cpu().numpy()
                continue
            out = self._track_frame(state, idx, is_cond=False, points=None, reverse=reverse)
            state.non_cond_outputs[idx] = out
            yield idx, out.pred_mask[0].cpu().numpy()

    # -- internals ---------------------------------------------------------------------------
    def _memory_bank(self, state: SAM2State, frame_idx: int, reverse: bool):
        """(memory [S_mem, 1, mem_dim], its positions, object-pointer tokens)
        following sam2_base.py:516-636 (stride 1)."""
        cfg = self.cfg
        mems, poss = [], []
        t_pos_and_prevs = [(0, out) for _, out in sorted(state.cond_outputs.items())]
        for t_pos in range(1, cfg.num_maskmem):
            t_rel = cfg.num_maskmem - t_pos
            prev_idx = frame_idx + t_rel if reverse else frame_idx - t_rel
            t_pos_and_prevs.append((t_pos, state.non_cond_outputs.get(prev_idx)))
        for t_pos, prev in t_pos_and_prevs:
            if prev is None:
                continue
            mems.append(prev.maskmem_features.flatten(2).permute(2, 0, 1))
            pos = prev.maskmem_pos.flatten(2).permute(2, 0, 1)
            poss.append(pos + self.maskmem_tpos_enc[cfg.num_maskmem - t_pos - 1])

        n_ptr_tokens = 0
        if cfg.use_obj_ptrs_in_encoder:
            pos_and_ptrs = [(abs(frame_idx - t), o.obj_ptr)
                            for t, o in state.cond_outputs.items()
                            if (t >= frame_idx if reverse else t <= frame_idx)]
            max_ptrs = min(len(state.images), cfg.max_obj_ptrs_in_encoder)
            for t_diff in range(1, max_ptrs):
                t = frame_idx + t_diff if reverse else frame_idx - t_diff
                if t < 0 or t >= len(state.images):
                    break
                out = state.non_cond_outputs.get(t)
                if out is not None:
                    pos_and_ptrs.append((t_diff, out.obj_ptr))
            if pos_and_ptrs:
                pos_list, ptrs = zip(*pos_and_ptrs)
                obj_ptrs = torch.stack(ptrs)                      # [P, 1, C]
                c = obj_ptrs.shape[-1]
                if cfg.add_tpos_enc_to_obj_ptrs:
                    # sam2_base.py:612-620: mem_dim-wide sine (no projection follows)
                    rel = torch.tensor(pos_list, dtype=torch.float32, device=self.device)
                    tpos = get_1d_sine_pe(rel / max(max_ptrs - 1, 1), dim=cfg.mem_dim)
                else:
                    tpos = torch.zeros((len(pos_list), cfg.mem_dim), device=self.device)
                # split C-wide pointers into mem_dim tokens (sam2_base.py:627-631)
                k = c // cfg.mem_dim
                obj_ptrs = obj_ptrs.reshape(-1, 1, k, cfg.mem_dim).permute(0, 2, 1, 3)
                mems.append(obj_ptrs.reshape(-1, 1, cfg.mem_dim))
                poss.append(tpos[:, None].repeat_interleave(k, 0).reshape(-1, 1, cfg.mem_dim))
                n_ptr_tokens = mems[-1].shape[0]
        if not mems:
            return None, None, 0
        return torch.cat(mems, 0), torch.cat(poss, 0), n_ptr_tokens

    @torch.no_grad()
    def _track_frame(self, state: SAM2State, frame_idx: int, *, is_cond: bool, points,
                     reverse: bool = False) -> FrameOutput:
        feats = self._frame_features(state, frame_idx)
        with numerics.full_fp32():
            cfg = self.cfg
            dev = self.device
            top = feats["backbone_fpn"][-1]                  # [1, C, h, w]
            top_pos = feats["vision_pos_enc"][-1]
            _, c, h, w = top.shape
            hi_res = self.high_res_features(feats)
            curr = top.flatten(2).permute(2, 0, 1)            # [h*w, 1, C]
            curr_pos = top_pos.flatten(2).permute(2, 0, 1)

            if is_cond and cfg.directly_add_no_mem_embed:
                pix = top + self.no_mem_embed.reshape(1, -1, 1, 1)
            else:
                memory, memory_pos, n_ptr = self._memory_bank(state, frame_idx, reverse)
                if memory is None:
                    memory = self.no_mem_embed.reshape(1, 1, -1)
                    memory_pos = self.no_mem_pos_enc.reshape(1, 1, -1)
                    n_ptr = 0
                pix = self.memory_attention(curr, memory, curr_pos, memory_pos,
                                            feat_size=(w, h), num_obj_ptr_tokens=n_ptr)
                pix = pix.permute(1, 2, 0).reshape(1, c, h, w)

            # SAM heads
            if points is not None:
                pts = torch.as_tensor(np.asarray(points[0], np.float32), device=dev)
                lbl = torch.as_tensor(np.asarray(points[1], np.int32), device=dev)
            else:
                pts = torch.zeros((1, 1, 2), device=dev)
                lbl = -torch.ones((1, 1), dtype=torch.int32, device=dev)
            sparse, dense = self.sam_prompt_encoder(points=(pts, lbl))
            # _use_multimask (sam2_base.py:770-778): a frame without points counts
            # as num_pts = 0, which the shipped configs' min_pt_num = 0 includes
            num_pts = 0 if points is None else int(points[1].shape[1])
            multimask = (cfg.multimask_output_in_sam
                         and (is_cond or cfg.multimask_output_for_tracking)
                         and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)
            masks, iou, sam_tokens, obj_logits = self.sam_mask_decoder(
                pix, self.sam_prompt_encoder.get_dense_pe(), sparse, dense,
                multimask_output=multimask, high_res_features=hi_res)
            if cfg.pred_obj_scores:
                # hard object / no-object gate of the mask (sam2_base.py:353-362)
                masks = torch.where((obj_logits > 0)[..., None, None], masks, -1024.0)
            if multimask:
                best = int(torch.argmax(iou[0]))
                low_res = masks[:, best]
                token = sam_tokens[:, best] if sam_tokens.shape[1] > 1 else sam_tokens[:, 0]
            else:
                low_res = masks[:, 0]
                token = sam_tokens[:, 0]
            obj_ptr = self.obj_ptr_proj(token)
            if cfg.pred_obj_scores and hasattr(self, "no_obj_ptr"):
                # occlusion handling of the pointer (sam2_base.py:388-399)
                lam = (obj_logits > 0).to(obj_ptr.dtype)
                if cfg.fixed_no_obj_ptr:
                    obj_ptr = lam * obj_ptr
                obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr

            high_res = resize_bilinear(low_res[:, None], (cfg.image_size, cfg.image_size))[:, 0]

            # encode the memory (sam2_base.py:664-700)
            binarize = cfg.binarize_mask_from_pts_for_mem_enc and points is not None
            mask_for_mem = (high_res > 0).float() if binarize else torch.sigmoid(high_res)
            mask_for_mem = (mask_for_mem * cfg.sigmoid_scale_for_mem_enc
                            + cfg.sigmoid_bias_for_mem_enc)
            mem_feat, mem_pos = self.memory_encoder(top, mask_for_mem[:, None],
                                                    skip_mask_sigmoid=True)
            return FrameOutput(maskmem_features=mem_feat, maskmem_pos=mem_pos, pred_mask=high_res,
                               obj_ptr=obj_ptr)
