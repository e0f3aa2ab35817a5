"""Primitive ops and the mixed-precision policy.

Counterpart of `videopainter_tpu/ops/basic.py`. Matmuls run in the
activation dtype (bf16 on the card: tensor cores with fp32 accumulation);
normalizations run with float32 statistics and return the input dtype.
Parameters keep their own dtype and are cast to the activation dtype at use,
as the JAX package's `linear` does.

The modules subclass `torch.nn` ones so their parameter names are the
diffusers names (`weight`, `bias`), and a reference state dict loads with
`load_state_dict`.

`Int8Linear` is the W8A8 serving form of a linear (the JAX `linear`'s
`kernel_q` dispatch): int8 weights with per-out-channel scales, activations
quantized per token (dynamic `amax / 127`) or by a static calibrated `ascale`
that clips at +-127, an exact int32 product (`torch._int_mm` on the card; the
JAX package leaves this product to XLA too), dequantized in fp32. Under
autograd it is a straight-through estimator (`Int8MatmulSTE`): the quantize
is treated as the identity, so a frozen int8 backbone passes gradients to
whatever feeds it; the int8 weights and the scales get none. Both linears add
a low-rank `lora` term when one is attached (`models/lora.attach_lora`),
which carries gradients to A and B.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ weight.T + bias with weight [out, in], in x's dtype."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over channel-first input [B, C, *spatial] with fp32 statistics
    (per batch and group, across all spatial dims)."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu-approximate (tanh), the CogVideoX feed-forward activation."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _lora_delta(mod: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """scale * (x @ A) @ B of an attached adapter (A [in, r], B [r, out])."""
    a = getattr(mod, "lora_A", None)
    if a is None:
        return None
    return (x @ a.to(x.dtype)) @ mod.lora_B.to(x.dtype) * mod.lora_scale.to(x.dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear(x, self.weight, self.bias)
        delta = _lora_delta(self, x)
        return y if delta is None else y + delta


def quantize_weight_int8(weight: torch.Tensor):
    """weight [out, in] -> (int8 [out, in], fp32 scale [out]): symmetric
    per-out-channel scales amax / 127 (1 for an all-zero channel)."""
    w32 = weight.float()
    amax = w32.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(xq: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product xq [M, K] int8 @ weight_q [N, K]^T int8 -> [M, N].
    On the card `torch._int_mm` (it wants more than 16 rows, so fewer are
    padded, and K and N multiples of 8); on the CPU an int32 matmul."""
    if xq.device.type != "cuda":
        return torch.matmul(xq.to(torch.int32), weight_q.to(torch.int32).t())
    m, k = xq.shape
    n = weight_q.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"int8 matmul needs K and N multiples of 8, got K={k}, N={n}")
    if m <= 16:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
    return torch._int_mm(xq.contiguous(), weight_q.t())[:m]


class Int8MatmulSTE(torch.autograd.Function):
    """y = clip(round(x32 / xs)) @ weight_q^T * xs * kscale with an exact int32
    product. Backward is the straight-through estimator of the JAX package's
    `_int8_matmul_ste`: round / clip and the dependence of a dynamic xs on x
    are treated as the identity, so dx = (g * kscale) @ weight_q as a bf16
    product with fp32 accumulation; xs, weight_q and kscale get no gradient."""

    @staticmethod
    def forward(ctx, x32, xs, weight_q, kscale):
        ctx.save_for_backward(weight_q, kscale)
        xq = torch.clamp(torch.round(x32 / xs), -127, 127).to(torch.int8)
        acc = int8_matmul(xq.reshape(-1, weight_q.shape[1]), weight_q)
        return acc.reshape(*x32.shape[:-1], weight_q.shape[0]).float() * xs * kscale

    @staticmethod
    def backward(ctx, g):
        weight_q, kscale = ctx.saved_tensors
        gk = (g * kscale.float()).to(torch.bfloat16)
        if g.device.type == "cuda":   # bf16 operands, fp32 accumulation, fp32 out
            dx = torch.matmul(gk, weight_q.to(torch.bfloat16)).float()
        else:   # the same product of the same bf16 values, summed in fp32
            dx = torch.matmul(gk.float(), weight_q.float())
        return dx, None, None, None


class Int8Linear(nn.Module):
    """W8A8 linear: `weight_q` int8 [out, in], `kscale` fp32 [out], optional
    `bias`, optional static `ascale` (a scalar buffer; without it the
    activation scale is dynamic per token)."""

    def __init__(self, weight_q: torch.Tensor, kscale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 ascale: Optional[torch.Tensor] = None):
        super().__init__()
        self.out_features, self.in_features = weight_q.shape
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("kscale", kscale)
        self.register_buffer("bias", bias)
        self.register_buffer("ascale", ascale)
        self.calib: Optional[List[torch.Tensor]] = None   # see `calibration`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.ascale is not None:
            xs = self.ascale.float()
        else:
            amax = x32.detach().abs().amax(dim=-1, keepdim=True)   # no grad through amax
            if self.calib is not None:
                self.calib.append(amax.max())   # global amax, in call order
            xs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        y = Int8MatmulSTE.apply(x32, xs, self.weight_q, self.kscale)
        if self.bias is not None:
            y = y + self.bias.float()
        y = y.to(x.dtype)
        delta = _lora_delta(self, x)
        return y if delta is None else y + delta


def quantize_linear_int8(lin: nn.Linear, *, free_source: bool = False) -> Int8Linear:
    """A linear -> its W8A8 form (int8 weights, per-out-channel scales; bias
    and an attached adapter carried over). free_source=True drops the source
    weight from `lin` as soon as the int8 copy is built, so quantizing a model
    on the card never holds both."""
    q, scale = quantize_weight_int8(lin.weight.detach())
    out = Int8Linear(q, scale, None if lin.bias is None else lin.bias.detach())
    for name in ("lora_A", "lora_B", "lora_scale"):
        if getattr(lin, name, None) is not None:
            out.register_buffer(name, getattr(lin, name).detach(), persistent=False)
    if free_source:
        lin.weight = None
    return out


@contextmanager
def calibration(module: nn.Module):
    """Collect, for the duration of the block, the global activation amax of
    every dynamic Int8Linear under `module`, in call order, into the list the
    context yields. The collector is handed to exactly these linears and taken
    away on exit."""
    taps: List[torch.Tensor] = []
    linears = [m for m in module.modules() if isinstance(m, Int8Linear)]
    for m in linears:
        m.calib = taps
    try:
        yield taps
    finally:
        for m in linears:
            m.calib = None


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


class GroupNorm(nn.GroupNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias, eps=self.eps)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator` the way the JAX package's `init`
    does: weights of linears and convs U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    their biases zero, norm scales one and norm biases zero. Works on a module
    made on the meta device and moved with `to_empty`."""
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif name == "bias" and p.ndim == 1:
                p.zero_()
            else:
                fan_in = p[0].numel() if p.ndim >= 2 else p.shape[0]
                bound = fan_in ** -0.5
                r = torch.rand(p.shape, generator=generator, device=p.device,
                               dtype=torch.float32)
                p.copy_(r.mul_(2 * bound).sub_(bound))
    return module
