from .branch import CogVideoXBranch
from .dit import CogVideoXBlock, CogVideoXTransformer3D, TransformerOutput
from .vae import AutoencoderKLCogVideoX, DiagonalGaussian

__all__ = ["CogVideoXBranch", "CogVideoXBlock", "CogVideoXTransformer3D",
           "TransformerOutput", "AutoencoderKLCogVideoX", "DiagonalGaussian"]
