from .attention import Attention, joint_attention, sdpa
from .basic import (GroupNorm, LayerNorm, Linear, gelu_tanh, group_norm,
                    init_random_, layer_norm, linear, silu)
from .embeddings import TimestepEmbedding, timestep_embedding
from .feed_forward import FeedForward
from .norms import AdaLayerNorm, LayerNormZero
from .patch_embed import PatchEmbed, patchify, pool_patch_mask, unpatchify
from .rope import (apply_rotary_emb, get_3d_rotary_pos_embed,
                   get_resize_crop_region_for_grid)
from .sincos import get_3d_sincos_pos_embed

__all__ = [
    "Attention", "joint_attention", "sdpa",
    "GroupNorm", "LayerNorm", "Linear", "gelu_tanh", "group_norm", "init_random_",
    "layer_norm", "linear", "silu",
    "TimestepEmbedding", "timestep_embedding", "FeedForward",
    "AdaLayerNorm", "LayerNormZero",
    "PatchEmbed", "patchify", "pool_patch_mask", "unpatchify",
    "apply_rotary_emb", "get_3d_rotary_pos_embed", "get_resize_crop_region_for_grid",
    "get_3d_sincos_pos_embed",
]
