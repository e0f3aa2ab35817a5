"""Seeded weights under the diffusers names, drawn on the device in the type
they are served in.

The names and shapes are those of the program's modules built on the meta
device (they carry the diffusers names, so a real checkpoint loads the same
way). Values, by the parameter's role:
 - weights of linears and convolutions: U(-1/sqrt(fan_in), 1/sqrt(fan_in));
 - their biases: the same bound as their weight;
 - norm scales U(0.8, 1.2), norm shifts U(-0.1, 0.1);
 - the learned positional embedding U(-1, 1).
Parameters of one layer that share a shape and a range are drawn by one
call, so the 5 billion values take a few hundred calls. The same seed gives
the same tensors, which is how the reference gets them again after the
program's state is freed.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

Shape = Tuple[int, ...]


def _layer(name: str) -> str:
    """The name up to its first numeric component: one group per layer."""
    m = re.match(r"^(.*?\.\d+)\.", name)
    return m.group(1) if m else ""


def _ranges(shapes: Dict[str, Shape]) -> Dict[str, Tuple[float, float]]:
    out = {}
    for name, shape in shapes.items():
        base, _, leaf = name.rpartition(".")
        wshape = shapes.get(base + ".weight", shape)
        if leaf == "pos_embedding":
            out[name] = (-1.0, 1.0)
        elif len(wshape) == 1:   # a norm's affine
            out[name] = (0.8, 1.2) if leaf == "weight" else (-0.1, 0.1)
        else:
            fan_in = 1
            for s in wshape[1:]:
                fan_in *= s
            b = fan_in ** -0.5
            out[name] = (-b, b)
    return out


def draw(shapes: Dict[str, Shape], generator: torch.Generator, *, device,
         dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """{name: tensor} for `shapes`, in a fixed order from `generator`."""
    ranges = _ranges(shapes)
    groups: Dict[tuple, List[str]] = {}
    for name, shape in shapes.items():
        groups.setdefault((_layer(name), tuple(shape), ranges[name]), []).append(name)
    out = {}
    for (_, shape, (lo, hi)), names in groups.items():
        buf = torch.rand((len(names), *shape), generator=generator, device=device, dtype=dtype)
        buf.mul_(hi - lo).add_(lo)
        for j, name in enumerate(names):
            out[name] = buf[j]
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Shape]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """Independent streams of one seed (0 weights, 1 a clip's inputs, 2 a
    training step's draws, 16 + i training step i's clip)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1024 + stream) % (1 << 63))
