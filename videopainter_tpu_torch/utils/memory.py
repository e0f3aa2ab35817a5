"""Device-memory hygiene: one dense allocation per dtype.

Counterpart of `videopainter_tpu/utils/memory.py`, kept for API parity.
`compact_params` copies every parameter and buffer of the given modules
into one allocation per (device, dtype) and rebinds them as views of it.
The values stay bit-identical; the transient cost is one extra copy of each
group. The JAX CLI calls it after W8A8 quantization to defragment XLA's
heap. The port's CLI does not: after its `--int8` load of a full-width
checkpoint, `torch.cuda.empty_cache()` alone gave back as much reserved
memory as compaction followed by it (chip_smoke phase 12).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

_ALIGN_BYTES = 256   # each tensor starts on an allocator-sized boundary


def compact_params(*modules: nn.Module) -> int:
    """Rebind every parameter and buffer of `modules` (shared ones once) as
    views of one flat tensor per (device, dtype). Returns the bytes moved."""
    slots: Dict[Tuple[torch.device, torch.dtype], List[tuple]] = {}
    seen: Dict[int, tuple] = {}
    for module in modules:
        for mod in module.modules():
            for kind in ("_parameters", "_buffers"):
                for name, t in getattr(mod, kind).items():
                    if t is None:
                        continue
                    if id(t) not in seen:
                        seen[id(t)] = (t, [])
                        slots.setdefault((t.device, t.dtype), []).append(seen[id(t)])
                    seen[id(t)][1].append((mod, kind, name))
    moved = 0
    with torch.no_grad():
        for (device, dtype), entries in slots.items():
            align = max(1, _ALIGN_BYTES // torch.empty((), dtype=dtype).element_size())
            offsets, total = [], 0
            for t, _ in entries:
                offsets.append(total)
                total += -(-t.numel() // align) * align
            flat = torch.empty(total, dtype=dtype, device=device)
            for (t, owners), off in zip(entries, offsets):
                view = flat[off:off + t.numel()].view(t.shape)
                view.copy_(t)
                moved += t.numel() * t.element_size()
                if isinstance(t, nn.Parameter):
                    t.data = view           # the Parameter object (and its owners) stays
                else:
                    for mod, kind, name in owners:
                        getattr(mod, kind)[name] = view
    return moved
