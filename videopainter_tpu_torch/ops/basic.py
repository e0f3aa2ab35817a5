"""Primitive ops and the mixed-precision policy.

Counterpart of `videopainter_tpu/ops/basic.py`. Matmuls run in the
activation dtype (bf16 on the card: tensor cores with fp32 accumulation);
normalizations run with float32 statistics and return the input dtype.
Parameters keep their own dtype and are cast to the activation dtype at use,
as the JAX package's `linear` does.

The modules subclass `torch.nn` ones so their parameter names are the
diffusers names (`weight`, `bias`), and a reference state dict loads with
`load_state_dict`. The W8A8 int8 path of the JAX `linear` belongs to a later
slice of the port.
"""

from __future__ import annotations

from typing import Optional

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


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


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
