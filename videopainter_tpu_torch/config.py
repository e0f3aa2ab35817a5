"""Configuration dataclasses for the PyTorch port.

The port's own copy of `videopainter_tpu/config.py`'s model and scheduler
configs, with the same field names (the HF `config.json` keys of the
reference models) and the same presets, so a config round-trips between the
two packages through `to_dict` / `from_dict`. Plain frozen dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


def _from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class TransformerConfig:
    """CogVideoX DiT backbone config. Defaults = CogVideoX-2B."""

    num_attention_heads: int = 30
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    time_embed_dim: int = 512
    text_embed_dim: int = 4096
    num_layers: int = 30
    attention_bias: bool = True
    sample_width: int = 90
    sample_height: int = 60
    sample_frames: int = 49
    patch_size: int = 2
    temporal_compression_ratio: int = 4
    max_text_seq_length: int = 226
    activation_fn: str = "gelu-approximate"
    timestep_activation_fn: str = "silu"
    norm_elementwise_affine: bool = True
    norm_eps: float = 1e-5
    spatial_interpolation_scale: float = 1.875
    temporal_interpolation_scale: float = 1.0
    use_rotary_positional_embeddings: bool = False
    use_learned_positional_embeddings: bool = False
    id_pool_resample_learnable: bool = False
    # CogVideoX 1.5: spatio-temporal patches of patch_size_t latent frames
    # (None: the 1.0 per-frame patches), the ofs embedding's width (None:
    # none) and whether the patch projection has a bias
    patch_size_t: Optional[int] = None
    ofs_embed_dim: Optional[int] = None
    patch_bias: bool = True

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def cogvideox_2b(cls, **kw) -> "TransformerConfig":
        return cls(**kw)

    @classmethod
    def cogvideox_5b(cls, **kw) -> "TransformerConfig":
        kw.setdefault("num_attention_heads", 48)
        kw.setdefault("num_layers", 42)
        kw.setdefault("use_rotary_positional_embeddings", True)
        return cls(**kw)

    @classmethod
    def cogvideox_5b_i2v(cls, **kw) -> "TransformerConfig":
        kw.setdefault("in_channels", 32)
        kw.setdefault("use_learned_positional_embeddings", True)
        return cls.cogvideox_5b(**kw)

    @classmethod
    def cogvideox15_5b_i2v(cls, **kw) -> "TransformerConfig":
        """THUDM/CogVideoX1.5-5B-I2V: 5b-I2V's widths with 2x2x2 patches, no
        position table (the RoPE grid is capped at sample / patch_size) and
        the ofs embedding."""
        kw.setdefault("patch_size_t", 2)
        kw.setdefault("patch_bias", False)
        kw.setdefault("ofs_embed_dim", 512)
        kw.setdefault("sample_frames", 81)
        kw.setdefault("sample_height", 300)
        kw.setdefault("sample_width", 300)
        kw.setdefault("use_learned_positional_embeddings", False)
        return cls.cogvideox_5b_i2v(**kw)

    @classmethod
    def tiny(cls, **kw) -> "TransformerConfig":
        """Small config for tests: same structure, tiny dims."""
        kw.setdefault("num_attention_heads", 2)
        kw.setdefault("attention_head_dim", 16)  # head_dim//8*3 even for 3D RoPE
        kw.setdefault("num_layers", 2)
        kw.setdefault("time_embed_dim", 16)
        kw.setdefault("text_embed_dim", 12)
        kw.setdefault("sample_width", 8)
        kw.setdefault("sample_height", 4)
        kw.setdefault("sample_frames", 9)
        kw.setdefault("max_text_seq_length", 5)
        kw.setdefault("use_rotary_positional_embeddings", True)
        return cls(**kw)

    @classmethod
    def from_dict(cls, d: dict) -> "TransformerConfig":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        """The config's keys; the 1.5 keys only where they differ from 1.0,
        so a 1.0 config writes the keys its published config.json holds."""
        d = dataclasses.asdict(self)
        for k, v in (("patch_size_t", None), ("ofs_embed_dim", None), ("patch_bias", True)):
            if d[k] == v:
                del d[k]
        return d


def refuse_3d_patches(cfg: TransformerConfig, what: str) -> None:
    """Raise NotImplementedError where `what` has only the 1.0 per-frame
    patch path and `cfg` has spatio-temporal patches (CogVideoX 1.5)."""
    if getattr(cfg, "patch_size_t", None) is not None:
        raise NotImplementedError(
            f"{what} supports only per-frame patches (CogVideoX 1.0); this model has "
            f"patch_size_t={cfg.patch_size_t} (CogVideoX 1.5)")


@dataclass(frozen=True)
class BranchConfig(TransformerConfig):
    """Context-encoder ("branch") config: a clone of the first N backbone
    blocks with a widened patch embed (latent*2+1) and per-layer output
    projections."""

    num_layers: int = 2
    wo_text: bool = False
    latent_channels: Optional[int] = None

    def _latent(self) -> int:
        lat = self.latent_channels
        if lat is None:
            lat = self.in_channels if self.in_channels == 16 else self.in_channels // 2
        return lat

    @property
    def patch_in_channels(self) -> int:
        # noisy latents (latent ch) ‖ masked-video latents (latent ch) ‖ mask (1)
        return 2 * self._latent() + 1

    @property
    def hidden_in_channels(self) -> int:
        """Channels of the noisy-latent stream fed to the branch."""
        return self._latent()

    @classmethod
    def from_transformer(cls, t: TransformerConfig, num_layers: int = 2,
                         wo_text: bool = False,
                         latent_channels: Optional[int] = None) -> "BranchConfig":
        d = t.to_dict()
        d["num_layers"] = num_layers
        d["wo_text"] = wo_text
        d["latent_channels"] = latent_channels
        return _from_dict(cls, d)


@dataclass(frozen=True)
class VAEConfig:
    """Causal 3D VAE config (AutoencoderKLCogVideoX)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    latent_channels: int = 16
    layers_per_block: int = 3
    act_fn: str = "silu"
    norm_eps: float = 1e-6
    norm_num_groups: int = 32
    temporal_compression_ratio: int = 4
    sample_height: int = 480
    sample_width: int = 720
    scaling_factor: float = 1.15258426
    shift_factor: Optional[float] = None
    use_quant_conv: bool = False
    use_post_quant_conv: bool = False
    invert_scale_latents: bool = False

    @property
    def spatial_compression_ratio(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        kw.setdefault("block_out_channels", (8, 8, 16, 16))
        kw.setdefault("latent_channels", 4)
        kw.setdefault("layers_per_block", 1)
        kw.setdefault("norm_num_groups", 4)
        kw.setdefault("sample_height", 64)
        kw.setdefault("sample_width", 96)
        return cls(**kw)

    @classmethod
    def from_dict(cls, d: dict) -> "VAEConfig":
        d = dict(d)
        if "block_out_channels" in d:
            d["block_out_channels"] = tuple(d["block_out_channels"])
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class SchedulerConfig:
    """Shared config for the CogVideoX DDIM / DPM schedulers."""

    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.0120
    beta_schedule: str = "scaled_linear"
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    prediction_type: str = "epsilon"
    clip_sample_range: float = 1.0
    sample_max_value: float = 1.0
    timestep_spacing: str = "leading"
    rescale_betas_zero_snr: bool = False
    snr_shift_scale: float = 3.0

    @classmethod
    def cogvideox_5b_inference(cls, **kw) -> "SchedulerConfig":
        kw.setdefault("prediction_type", "v_prediction")
        kw.setdefault("rescale_betas_zero_snr", True)
        kw.setdefault("timestep_spacing", "trailing")
        return cls(**kw)

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulerConfig":
        return _from_dict(cls, d)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_config(path: str, cls):
    """An HF `config.json` as `cls` (unknown keys ignored)."""
    with open(path) as f:
        return cls.from_dict(json.load(f))
