"""Simulated low-precision linears for the reference: symmetric per-token
activation scales and per-output-channel weight scales, the rounded values
multiplied in float32 and rescaled.

 - "int8": the W8A8 configuration's own arithmetic (scale amax / 127, round
   half to even, clip at +-127; an all-zero row or channel gets scale 1);
 - "fp8": float8 e4m3 with scale amax / 448 (one step below bf16);
 - "int4": scale amax / 7, clip at +-7 (one step below int8).

A control (`Control`) is the reference one precision below its
configuration: products in `products` ("fp8" below bf16 products, "int4"
below int8 ones), and what the program holds in bf16 (activations, the
loop's latents) in fp8.

Imports nothing of the program under test.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LEVELS = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}


def fake_quant(x: torch.Tensor, kind: str) -> torch.Tensor:
    """x quantized along its last axis and dequantized, float32."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / LEVELS[kind], torch.ones_like(amax))
    if kind == "fp8":
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    lv = LEVELS[kind]
    return torch.clamp(torch.round(x / scale), -lv, lv) * scale


class Quantizer:
    def __init__(self, kind: str):
        if kind not in LEVELS:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def fake(self, x: torch.Tensor) -> torch.Tensor:
        return fake_quant(x, self.kind)

    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor]) -> torch.Tensor:
        return F.linear(fake_quant(x, self.kind), fake_quant(w, self.kind), b)


class Control(Quantizer):
    """The products in `kind`, the bf16-held tensors in fp8 (`act`)."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fake_quant(x, "fp8")


def block_int8(x: torch.Tensor, blk: int) -> torch.Tensor:
    """x [H, S, d] quantized symmetric int8 per block of `blk` rows of a
    head (scale max|x| / 127 over the block, floored at 1e-8; the last
    block ragged) and dequantized."""
    h, s, d = x.shape
    out = torch.empty_like(x)
    for s0 in range(0, s, blk):
        xb = x[:, s0:s0 + blk]
        sc = (xb.abs().amax(dim=(1, 2), keepdim=True) / 127.0).clamp_min(1e-8)
        out[:, s0:s0 + blk] = torch.round(xb / sc) * sc
    return out


def int8_qk(blk_q: int = 512, blk_k: int = 2048):
    """The int8 configuration's Q.K^T operands: K centred by its mean over
    all keys of a head (a shift shared by a query row's scores, which the
    softmax does not see), then Q and K quantized per block (`block_int8`);
    their product is exact in float32 up to the scales' rounding."""
    def prep(q: torch.Tensor, k: torch.Tensor):
        k_mean = k.double().mean(dim=1, keepdim=True).float()
        return block_int8(q, blk_q), block_int8(k - k_mean, blk_k)
    return prep
