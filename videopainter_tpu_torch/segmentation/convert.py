"""SAM2 checkpoints for the port's modules.

Counterpart of `videopainter_tpu/segmentation/convert.py`. The port's
modules carry the torch SAM2's names and layouts, so a torch state dict
needs no conversion: `load_sam2_checkpoint` unwraps a `.pt`'s `"model"` entry
(as the JAX package does) and hands it to `load_state_dict`. The JAX
package's flattened `.npz` (written by tools/convert_checkpoint.py: JAX
parameter-tree paths joined by '/') goes back to the torch names through
`convert.from_jax.sam2_state_dict`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _insert(tree, keys, value):
    k = keys[0]
    idx = int(k) if k.isdigit() else None
    if len(keys) == 1:
        if idx is None:
            tree[k] = value
        else:
            tree.extend([None] * (idx + 1 - len(tree)))
            tree[idx] = value
        return
    empty = [] if keys[1].isdigit() else {}
    if idx is None:
        tree.setdefault(k, empty)
        _insert(tree[k], keys[1:], value)
    else:
        tree.extend([None] * (idx + 1 - len(tree)))
        if tree[idx] is None:
            tree[idx] = empty
        _insert(tree[idx], keys[1:], value)


def load_sam2_npz(path: str) -> Dict[str, torch.Tensor]:
    """The JAX package's flat SAM2 .npz -> a torch-named state dict."""
    from ..convert.from_jax import sam2_state_dict

    root: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            _insert(root, key.split("/"), flat[key])
    return sam2_state_dict(root)


def load_sam2_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch SAM2 `.pt` (its "model" entry when there is one) or the JAX
    package's `.npz` -> a state dict for `SAM2Base.load_state_dict`."""
    if path.endswith(".npz"):
        return load_sam2_npz(path)
    ckpt = torch.load(path, map_location="cpu")
    return ckpt.get("model", ckpt)
