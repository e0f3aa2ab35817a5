"""SAM2 video segmentation (the interactive demo's click-to-mask tracker).

Counterpart of `videopainter_tpu/segmentation/`:
  modules        — shared primitives (MLP, LayerNorm2d, windowing, position encodings)
  hiera          — Hiera trunk + FPN neck (image encoder)
  sam_heads      — prompt encoder, two-way transformer, mask decoder
  memory         — memory attention (RoPE cross-attention) + memory encoder
  predictor      — SAM2Base (the modules under the torch SAM2's names) and
                   SAM2VideoPredictor: init_state / add_new_points /
                   propagate_in_video / reset_state
  image_predictor — SAM2ImagePredictor and SAM2AutomaticMaskGenerator
  convert        — checkpoints: torch .pt state dicts load as they are
"""

from __future__ import annotations

from .predictor import SAM2Config, SAM2VideoPredictor


def build_sam2_video_predictor(variant: str, checkpoint_path=None, image_size: int = 1024,
                               device=None) -> SAM2VideoPredictor:
    """build_sam.py analog: `variant` in {tiny, small, base_plus, large}, the
    checkpoint a torch SAM2 .pt or the JAX package's converted .npz; None
    leaves the weights as constructed (the caller fills them). On the card
    unless `device` says otherwise."""
    from .. import resolve_device
    from .convert import load_sam2_checkpoint
    from .hiera import hiera_config

    dev = resolve_device(device)
    predictor = SAM2VideoPredictor(SAM2Config(hiera=hiera_config(variant),
                                              image_size=image_size)).to(dev)
    if checkpoint_path is not None:
        predictor.load_state_dict(load_sam2_checkpoint(checkpoint_path))
    return predictor.eval()


__all__ = ["SAM2VideoPredictor", "SAM2Config", "build_sam2_video_predictor"]
