from .branch import CogVideoXBranch
from .dit import CogVideoXBlock, CogVideoXTransformer3D, TransformerOutput
from .text_encoder import T5TextEncoder, load_prompt_embeds
from .vae import AutoencoderKLCogVideoX, DiagonalGaussian, VAEStreamDecoder

__all__ = ["CogVideoXBranch", "CogVideoXBlock", "CogVideoXTransformer3D",
           "TransformerOutput", "T5TextEncoder", "load_prompt_embeds",
           "AutoencoderKLCogVideoX", "DiagonalGaussian", "VAEStreamDecoder"]
