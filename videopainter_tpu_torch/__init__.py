"""PyTorch/CUDA port of videopainter_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (`ops/`, `models/`, `schedulers/`,
`pipelines/`, `convert/`). Plain tensor code is PyTorch; each Pallas kernel of
the JAX package becomes a kernel written by hand for Hopper under `csrc/`,
built with `nvcc` at first use (`_kernels.py`).

Entry points run on CUDA unless the caller passes `device="cpu"`; they never
fall back to the CPU on their own (`resolve_device`).
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

__all__ = ["card_line", "resolve_device", "set_numerics"]


def card_line() -> str:
    """The card's name and power limit as `nvidia-smi` gives them, to print
    beside every time measured on it (a card set below its maximum runs
    slower under load)."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and no card is
    present, instead of quietly running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def set_numerics(*, conv_tf32: bool) -> None:
    """Set the precision flags the port's numbers depend on.

    float32 matmuls run in full fp32 (no TF32). float32 convolutions (the
    VAE's conv3d through cuDNN) use TF32 when `conv_tf32`. bf16 matmuls
    accumulate in fp32 (reduced-precision split-K reductions off), as the
    JAX package's bf16 dots do.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = conv_tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
