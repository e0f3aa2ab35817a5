"""Multi-card inference: tensor- and sequence-parallel pipeline runs.

Counterpart of `videopainter_tpu/parallel/inference.py`. The reference has no
inference parallelism (one GPU); the port, as the JAX package, runs the
denoise loop over a mesh:

 - the DiT's and the branch's block linears tensor-parallel over `model`
   (`sharding.shard_params`; each row-parallel linear sums over the group),
 - the video tokens optionally sequence-parallel over `seq` (the pipelines'
   `seq_axis`, with `ring_mesh` for ring attention),
 - everything else, the VAE included, replicated: every rank runs the
   same loop on the same inputs and returns the whole video.

Usage, on every rank:

    mesh = make_mesh(data=1, seq=2, model=2)
    shard_inference_params({"transformer": pipe.transformer,
                            "branch": pipe.branch}, mesh)
    with use_mesh(mesh):
        video = pipe(..., seq_axis="seq")
"""

from __future__ import annotations

from typing import Dict

from torch import nn

from torch.distributed.device_mesh import DeviceMesh
from .sharding import (Spec, branch_param_specs, shard_params, transformer_param_specs,
                       vae_param_specs)


def inference_param_specs(modules: Dict[str, nn.Module]) -> Dict[str, Dict[str, Spec]]:
    """Spec trees of a pipeline's modules {transformer, branch, vae, ...}."""
    specs = {}
    for k, m in modules.items():
        if k == "transformer":
            specs[k] = transformer_param_specs(m)
        elif k == "branch":
            specs[k] = branch_param_specs(m)
        else:
            specs[k] = vae_param_specs(m)
    return specs


def shard_inference_params(modules: Dict[str, nn.Module], mesh: DeviceMesh
                           ) -> Dict[str, nn.Module]:
    """Make the transformer and the branch tensor-parallel over the mesh's
    `model` axis, in place; the other modules stay replicated. Returns the
    dict."""
    for k, m in modules.items():
        if k in ("transformer", "branch") and m is not None:
            shard_params(m, mesh)
    return modules


def denoise_shardings(modules: Dict[str, nn.Module], mesh: DeviceMesh):
    """(the modules' spec trees, the replicated spec of the loop's inputs):
    the placements the JAX package hands its fused denoise function. The
    port's loop runs the same on every rank, so only the parameters carry
    a placement."""
    del mesh
    return inference_param_specs(modules), ()
