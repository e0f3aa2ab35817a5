"""Evaluation of the port: metrics, LPIPS / CLIP / I3D extractors, the
DAVIS / VPBench readers, the inpainting harness, the edit evaluation, the
eval CLI and its sweep (counterpart of `videopainter_tpu/evaluate/`)."""

from .harness import EvalConfig, run_inpainting_eval
from .lpips import LpipsExtractor, convert_lpips_state_dict, lpips_forward
from .metrics import MetricsCalculator, frechet_distance, mae, mse, psnr, ssim

__all__ = [
    "MetricsCalculator", "psnr", "ssim", "mse", "mae", "frechet_distance",
    "EvalConfig", "run_inpainting_eval",
    "LpipsExtractor", "convert_lpips_state_dict", "lpips_forward",
]
