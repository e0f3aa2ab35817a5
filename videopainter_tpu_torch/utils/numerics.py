"""Precision contexts shared by the float32 paths (the evaluation extractors,
SAM2)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matmuls in full fp32 (no TF32) for the duration: a
    metric or a float32 model must not depend on the card's reduced-precision
    modes."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
