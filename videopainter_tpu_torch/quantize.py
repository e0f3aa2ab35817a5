"""Opt-in int8 (W8A8) inference quantization of the DiT / branch blocks.

Counterpart of `videopainter_tpu/quantize.py`. The block projections
(attention q / k / v / out and both feed-forward linears) of every
transformer block become `ops.basic.Int8Linear`: per-out-channel weight
scales, dynamic per-token activation scales (or static calibrated ones), an
int32 product. Norms, modulation, patch / time embeddings and `proj_out`
keep their precision. Approximate by design; the reference has no quantized
path. Per-frame patch models only: a CogVideoX 1.5 model raises
NotImplementedError.

Sites carry the JAX package's names (`to_q`, `to_k`, `to_v`, `to_out`,
`proj_in`, `proj_out`, and `to_qkv` on a model whose projections were fused
by `ops.attention.fuse_qkv_projections`), which are also the keys of a saved
scales file (`<model>/<site>`, one value per layer), so `calib_ascales.npz`
at the root of the repository loads here unchanged.

    quantize_transformer_int8(pipe.transformer, free_source=True)
    quantize_transformer_int8(pipe.branch, free_source=True)
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import refuse_3d_patches
from .ops.basic import Int8Linear, quantize_linear_int8

# site name -> path of the linear inside a CogVideoXBlock, in the forward's call
# order; a block has either the fused to_qkv or to_q / to_k / to_v
_SITES: Tuple[Tuple[str, str], ...] = (
    ("to_qkv", "attn1.to_qkv"),
    ("to_q", "attn1.to_q"), ("to_k", "attn1.to_k"), ("to_v", "attn1.to_v"),
    ("to_out", "attn1.to_out.0"), ("proj_in", "ff.net.0.proj"), ("proj_out", "ff.net.2"))
_LAYOUTS = (["to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out"],
            ["to_qkv", "to_out", "proj_in", "proj_out"])


def _set(block: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(block.get_submodule(parent), name, new)


def _sites(block: nn.Module):
    """(name, path, linear) of each site the block has."""
    for name, path in _SITES:
        parent, _, attr = path.rpartition(".")
        lin = getattr(block.get_submodule(parent), attr, None)
        if lin is not None:
            yield name, path, lin


def quantize_transformer_int8(model: nn.Module, *, free_source: bool = False) -> nn.Module:
    """Quantize the block projections of a DiT or branch to int8.

    free_source=True rewrites `model` in place, dropping each source weight as
    its int8 copy lands, so a full-size model is never held twice; otherwise
    `model` is left as it is and a quantized deep copy is returned.
    """
    refuse_3d_patches(getattr(model, "cfg", None), "W8A8 (quantize_transformer_int8)")
    if not free_source:
        model = copy.deepcopy(model)
    with torch.no_grad():
        for block in model.transformer_blocks:
            for _, path, lin in list(_sites(block)):
                if isinstance(lin, nn.Linear):
                    # the model being rewritten is disposable either way
                    _set(block, path, quantize_linear_int8(lin, free_source=True))
    return model


def ascale_site_order(model: nn.Module) -> List[str]:
    """Names of the quantized linears of a block in the forward's call order,
    the order a calibration pass records activation amaxes in. Raises unless
    every site of one of the two layouts (separate or fused q / k / v) is
    quantized."""
    sites = [name for name, _, lin in _sites(model.transformer_blocks[0])
             if isinstance(lin, Int8Linear)]
    if sites not in _LAYOUTS:
        raise ValueError(f"unexpected quantized-site layout: {sites}")
    return sites


def attach_static_ascale(model: nn.Module, ascale) -> nn.Module:
    """Attach static activation scales to the int8 block linears of `model`
    (in place; returns it). With an `ascale` the per-token max-reduce is
    skipped and activation outliers clip at +-127 instead of rescaling.

    ascale: a float (uniform), or a dict mapping site names to per-layer [L]
    arrays from `calibrate_ascales`; sites missing from the dict stay dynamic.
    """
    for i, block in enumerate(model.transformer_blocks):
        for name, _, lin in _sites(block):
            if not isinstance(lin, Int8Linear):
                continue
            if isinstance(ascale, dict):
                if name not in ascale:
                    continue
                value = float(np.asarray(ascale[name], np.float32)[i])
            else:
                value = float(ascale)
            lin.ascale = torch.tensor(value, dtype=torch.float32, device=lin.kscale.device)
    return model


def calibrate_ascales(model: nn.Module, samples: Iterable, *, margin: float = 1.0
                      ) -> Dict[str, np.ndarray]:
    """Static per-layer activation scales from sample forwards.

    Runs `model(*args, calibrate=True, **kwargs)` for each `(args, kwargs)` of
    `samples` on a dynamically quantized model and takes each site's largest
    input amax per layer: scale = max over samples * margin / 127. Returns
    {site: [L] float32} for `attach_static_ascale`. Works for the DiT
    (`TransformerOutput.calib_amax`) and the branch ((features, amax)).
    """
    acc: Optional[np.ndarray] = None
    for args, kwargs in samples:
        with torch.no_grad():
            out = model(*args, calibrate=True, **kwargs)
        a = out.calib_amax if hasattr(out, "calib_amax") else out[1]
        a = a.detach().float().cpu().numpy()   # [L, n_sites]
        acc = a if acc is None else np.maximum(acc, a)
    if acc is None:
        raise ValueError("calibrate_ascales needs at least one sample")
    return ascales_from_amax(model, acc, margin=margin)


def ascales_from_amax(model: nn.Module, amax, *, margin: float = 1.0
                      ) -> Dict[str, np.ndarray]:
    """{site: [L] float32} from recorded amaxes [L, n_sites] (the models'
    calibrate=True tap, its maximum over any number of forwards):
    amax * margin / 127, sites in `ascale_site_order`."""
    acc = np.asarray(amax, np.float32)
    sites = ascale_site_order(model)
    if acc.shape[1] != len(sites):
        raise ValueError(f"recorded {acc.shape[1]} sites per layer but the model has "
                         f"{len(sites)} quantized linears ({sites})")
    return {name: acc[:, i] * (float(margin) / 127.0) for i, name in enumerate(sites)}


def clear_static_ascale(model: nn.Module) -> nn.Module:
    """Drop the static activation scales of `model`'s int8 linears (in place;
    returns it): they quantize per token again."""
    for m in model.modules():
        if isinstance(m, Int8Linear):
            m.ascale = None
    return model


def save_ascales(path: str, scales_by_model: dict, provenance: Optional[dict] = None) -> None:
    """Write calibrated scales to an .npz: {"transformer": {site: [L]}, ...}
    flattens to "<model>/<site>"; `provenance` (JSON-serializable) goes under
    the reserved key "__provenance__"."""
    flat = {f"{m}/{s}": np.asarray(v, np.float32)
            for m, sites in scales_by_model.items() for s, v in sites.items()}
    if not flat:
        raise ValueError("no scales to save")
    if provenance is not None:
        flat["__provenance__"] = np.frombuffer(
            json.dumps(provenance, sort_keys=True).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_ascales(path: str, return_provenance: bool = False):
    """Inverse of `save_ascales`: {"<model>": {site: [L] float32}}, and the
    provenance dict (or None) with return_provenance."""
    out: dict = {}
    prov = None
    with np.load(path) as z:
        for k in z.files:
            if k == "__provenance__":
                prov = json.loads(bytes(z[k].tobytes()).decode())
                continue
            m, s = k.split("/", 1)
            out.setdefault(m, {})[s] = z[k]
    return (out, prov) if return_provenance else out
