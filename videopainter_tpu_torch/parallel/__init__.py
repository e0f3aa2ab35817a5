"""Mesh, tensor and sequence parallelism, and the collectives they use.

Counterpart of `videopainter_tpu/parallel/` on `torch.distributed`; the
names the JAX package exports, plus `use_mesh` (its `with mesh:`),
`run_local` (several ranks on one host) and `ring_joint_attention`."""

from .inference import denoise_shardings, inference_param_specs, shard_inference_params
from .launch import run_local
from .mesh import (MeshAxes, auto_mesh, current_mesh, initialize_distributed, make_hybrid_mesh,
                   make_mesh, use_mesh)
from .ring_attention import ring_attention, ring_joint_attention
from .sharding import (activation_spec, branch_param_specs, fit_spec, opt_state_specs,
                       optimizer_state_specs, shard_params, transformer_param_specs,
                       vae_param_specs)

__all__ = [
    "make_mesh", "auto_mesh", "make_hybrid_mesh",
    "initialize_distributed", "MeshAxes", "ring_attention",
    "shard_inference_params", "inference_param_specs",
    "transformer_param_specs", "branch_param_specs", "vae_param_specs",
    "activation_spec", "optimizer_state_specs", "opt_state_specs", "shard_params",
    "use_mesh", "current_mesh", "run_local", "ring_joint_attention", "fit_spec",
    "denoise_shardings",
]
