"""SAM prompt encoder, two-way transformer and mask decoder.

Counterpart of `videopainter_tpu/segmentation/sam_heads.py` (reference
app/sam2/modeling/sam/prompt_encoder.py :20-185, transformer.py
TwoWayTransformer :46-140, TwoWayAttentionBlock :143-215, Attention
:219-280, mask_decoder.py :15-300), with the torch SAM2's module names.
Image embeddings are NCHW; tokens [B, N, C].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from .modules import MLP, LayerNorm2d, PositionEmbeddingRandom, sdpa


# -- prompt encoder ----------------------------------------------------------------------

class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2), LayerNorm2d(mask_in_chans // 4),
            nn.GELU(), nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(), nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """[1, C, h, w] (reference :69-78)."""
        return self.pe_layer.grid(*self.image_embedding_size)

    def _size(self, dtype, device) -> torch.Tensor:
        return torch.tensor([self.input_image_size[1], self.input_image_size[0]],
                            dtype=dtype, device=device)

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor, pad: bool) -> torch.Tensor:
        """points [B, N, 2] (x, y in pixels), labels [B, N] in {-1, 0, 1, 2, 3}
        -> [B, N(+1), C] (reference :81-103)."""
        b = points.shape[0]
        pts = points + 0.5
        if pad:
            pts = torch.cat([pts, torch.zeros((b, 1, 2), dtype=pts.dtype, device=pts.device)], 1)
            labels = torch.cat([labels, -torch.ones((b, 1), dtype=labels.dtype,
                                                    device=labels.device)], 1)
        pe = self.pe_layer.encode(pts / self._size(pts.dtype, pts.device))
        lab = labels[..., None]
        emb = torch.where(lab == -1, 0.0, pe)
        emb = emb + torch.where(lab == -1, self.not_a_point_embed.weight[0], 0.0)
        for i in range(4):
            emb = emb + torch.where(lab == i, self.point_embeddings[i].weight[0], 0.0)
        return emb

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, 4] -> [B, 2, C] corner embeddings (reference :105-114)."""
        coords = (boxes.reshape(-1, 2, 2) + 0.5) / self._size(boxes.dtype, boxes.device)
        emb = self.pe_layer.encode(coords)
        emb[:, 0] += self.point_embeddings[2].weight[0]
        emb[:, 1] += self.point_embeddings[3].weight[0]
        return emb

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, 1, H, W] -> dense embeddings [B, C, h, w] (reference :116-119)."""
        return self.mask_downscaling(masks)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None, masks: Optional[torch.Tensor] = None):
        """(sparse [B, N, C], dense [B, C, h, w]) (reference :139-185)."""
        parts, bs = [], 1
        dev = self.no_mask_embed.weight.device
        if points is not None:
            bs = points[0].shape[0]
            parts.append(self.embed_points(points[0], points[1], pad=boxes is None))
        if boxes is not None:
            bs = boxes.shape[0]
            parts.append(self.embed_boxes(boxes))
        sparse = (torch.cat(parts, 1) if parts
                  else torch.zeros((bs, 0, self.embed_dim), device=dev))
        if masks is not None:
            dense = self.embed_masks(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(bs, -1, h, w)
        return sparse, dense


# -- two-way transformer -------------------------------------------------------------------

class Attention(nn.Module):
    """Attention with an internal downsample of the width (reference :219-280)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 kv_in_dim: Optional[int] = None):
        super().__init__()
        internal = embedding_dim // downsample_rate
        kv_in = kv_in_dim or embedding_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(kv_in, internal)
        self.v_proj = nn.Linear(kv_in, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        b, h, n, d = x.shape
        return self.out_proj(x.transpose(1, 2).reshape(b, n, h * d))

    def forward(self, q, k, v) -> torch.Tensor:
        return self.merge(sdpa(self.split(self.q_proj(q)), self.split(self.k_proj(k)),
                               self.split(self.v_proj(v))))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int, downsample_rate: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(dim, num_heads)
        self.norm1 = nn.LayerNorm(dim)
        self.cross_attn_token_to_image = Attention(dim, num_heads, downsample_rate)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = MLP(dim, mlp_dim, dim, 2)
        self.norm3 = nn.LayerNorm(dim)
        self.norm4 = nn.LayerNorm(dim)
        self.cross_attn_image_to_token = Attention(dim, num_heads, downsample_rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            # the first layer REPLACES the queries (reference :188-189)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, mlp_dim: int,
                 downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(dim, num_heads, mlp_dim, downsample_rate, i == 0)
            for i in range(depth))
        self.final_attn_token_to_image = Attention(dim, num_heads, downsample_rate)
        self.norm_final_attn = nn.LayerNorm(dim)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe [B, N_img, C], point_embedding [B, N_pts, C]
        -> (queries, keys) (reference :46-140)."""
        queries, keys = point_embedding, image_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, image_pe)
        q, k = queries + point_embedding, keys + image_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


# -- mask decoder -----------------------------------------------------------------------

class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_heads: int = 8, depth: int = 2,
                 mlp_dim: int = 2048, num_multimask_outputs: int = 3,
                 iou_head_hidden_dim: int = 256, use_high_res_features: bool = True,
                 pred_obj_scores: bool = True, pred_obj_scores_mlp: bool = True,
                 iou_prediction_use_sigmoid: bool = False):
        super().__init__()
        c = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_prediction_use_sigmoid = iou_prediction_use_sigmoid
        self.transformer = TwoWayTransformer(depth, c, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.pred_obj_scores = pred_obj_scores
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2), LayerNorm2d(c // 4), nn.GELU(),
            nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2), nn.GELU())
        self.use_high_res_features = use_high_res_features
        if use_high_res_features:
            self.conv_s0 = nn.Conv2d(c, c // 8, 1)
            self.conv_s1 = nn.Conv2d(c, c // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(c, c, c // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(c, iou_head_hidden_dim, self.num_mask_tokens, 3)
        if pred_obj_scores:
            self.pred_obj_score_head = MLP(c, c, 1, 3) if pred_obj_scores_mlp else nn.Linear(c, 1)

    def forward(self, image_embeddings: torch.Tensor,       # [B, C, h, w]
                image_pe: torch.Tensor,                     # [1, C, h, w]
                sparse_prompt_embeddings: torch.Tensor,     # [B, N, C]
                dense_prompt_embeddings: torch.Tensor,      # [B, C, h, w]
                multimask_output: bool,
                high_res_features: Optional[List[torch.Tensor]] = None,
                dynamic_multimask_via_stability: bool = False,
                stability_delta: float = 0.05, stability_thresh: float = 0.98):
        """(masks [B, k, 4h, 4w], iou [B, k], sam_tokens [B, t, C], obj_logits
        [B, 1]) (reference :110-260)."""
        b, c, h, w = image_embeddings.shape
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        s = 0
        if self.pred_obj_scores:
            toks = [self.obj_score_token.weight] + toks
            s = 1
        output_tokens = torch.cat(toks, 0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1), sparse_prompt_embeddings], 1)

        src = image_embeddings + dense_prompt_embeddings
        src_flat = src.flatten(2).transpose(1, 2)
        pe_flat = image_pe.flatten(2).transpose(1, 2).expand(b, -1, -1)
        hs, src_out = self.transformer(src_flat, pe_flat, tokens)
        iou_token_out = hs[:, s]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens]

        src_img = src_out.transpose(1, 2).reshape(b, c, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        if high_res_features is None:
            x = act2(dc2(act1(ln1(dc1(src_img)))))
        else:
            feat_s0, feat_s1 = high_res_features
            x = act1(ln1(dc1(src_img) + feat_s1))
            x = act2(dc2(x) + feat_s0)

        hyper = torch.stack([mlp(mask_tokens_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bkc,bchw->bkhw", hyper, x)

        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.iou_prediction_use_sigmoid:
            iou_pred = torch.sigmoid(iou_pred)
        if self.pred_obj_scores:
            obj_logits = self.pred_obj_score_head(hs[:, 0])
        else:
            obj_logits = 10.0 * iou_pred.new_ones((b, 1))

        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
            sam_tokens = mask_tokens_out[:, 1:]
        else:
            if dynamic_multimask_via_stability:
                out_masks, out_iou = _dynamic_multimask(masks, iou_pred, stability_delta,
                                                        stability_thresh)
            else:
                out_masks, out_iou = masks[:, :1], iou_pred[:, :1]
            sam_tokens = mask_tokens_out[:, :1]
        return out_masks, out_iou, sam_tokens, obj_logits


def _dynamic_multimask(all_masks, all_iou, delta, thresh):
    """Stability-based fallback to the best multimask output (reference :262-300)."""
    multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
    best = torch.argmax(multi_iou, dim=-1)
    bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
    best_masks = multi[bidx, best][:, None]
    best_iou = multi_iou[bidx, best][:, None]
    single = all_masks[:, :1]
    flat = single.flatten(2)
    area_i = (flat > delta).sum(-1).float()
    area_u = (flat > -delta).sum(-1).float()
    stability = torch.where(area_u > 0, area_i / area_u.clamp_min(1), 1.0)
    stable = stability >= thresh
    return (torch.where(stable[..., None, None], single, best_masks),
            torch.where(stable, all_iou[:, :1], best_iou))

