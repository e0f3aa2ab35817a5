"""The process mesh.

Counterpart of `videopainter_tpu/parallel/mesh.py`. The reference scales by
data parallelism only (8-GPU DeepSpeed ZeRO-2 over NCCL); the port, as the
JAX package, lays its ranks on one mesh with three axes:

  data  - batch / data parallel (gradients are averaged over it, optimizer
          moments of the stacked block weights shard over it: ZeRO-2)
  seq   - sequence parallel over the video tokens (K / V all-gathers, or the
          ring of `ring_attention.py`)
  model - Megatron-style tensor parallel over attention heads and the FFN
          hidden axis (`sharding.py`, `ops/basic.py`)

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with dims
("data", "seq", "model"), `model` innermost so tensor-parallel ranks are
neighbours (one node, NVLink) and `data` outermost. Where XLA inserts the
collectives in the JAX package, the port calls them itself (`comm.py`).

A launch is one process per card, from torchrun (`initialize_distributed`
reads its environment) or, on one host, `launch.run_local`. Without a
process group, `make_mesh(1, 1, 1)` starts a one-rank group of its own.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    seq: str = "seq"
    model: str = "model"


AXES = MeshAxes()
AXIS_NAMES = (AXES.data, AXES.seq, AXES.model)


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_single_rank(device_type: str) -> None:
    """A one-rank process group on a free localhost port."""
    dist.init_process_group(_default_backend(device_type),
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)


def make_mesh(data: int = 1, seq: int = 1, model: int = 1, *,
              device: str = "cuda") -> DeviceMesh:
    """Mesh with ("data", "seq", "model") dims over every rank of the process
    group, rank r at coordinates unravel(r, (data, seq, model)). The product
    must equal the world size (ValueError otherwise, as the JAX package
    raises for the device count). `device` is "cuda" unless the caller asks
    for "cpu". Called by every rank, in the same order."""
    n = data * seq * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"mesh {data}x{seq}x{model}={n} != {world} ranks (world size)")
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a card; pass device='cpu' to run on the CPU")
    if not dist.is_initialized():
        _start_single_rank(device_type)
    return DeviceMesh(device_type, torch.arange(n).reshape(data, seq, model),
                      mesh_dim_names=AXIS_NAMES)


def auto_mesh(n_ranks: Optional[int] = None, *, device: str = "cuda") -> DeviceMesh:
    """Every rank on `data` (the reference's strategy)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(data=n_ranks or world, device=device)


def make_hybrid_mesh(dcn_data: int = 1, data: int = 1, seq: int = 1, model: int = 1, *,
                     device: str = "cuda") -> DeviceMesh:
    """Multi-node mesh: `dcn_data` ranges over nodes (the gradient average
    crosses the network there) while (data, seq, model) stay within a node.
    torchrun numbers ranks node-major, so folding `dcn_data` into `data`
    keeps each node's ranks adjacent and the `seq` / `model` groups inside a
    node."""
    n = dcn_data * data * seq * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"hybrid mesh {dcn_data}x{data}x{seq}x{model}={n} != {world} "
                         "ranks (world size)")
    return make_mesh(data=dcn_data * data, seq=seq, model=model, device=device)


def initialize_distributed(**kwargs) -> int:
    """Multi-process bring-up from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR): `init_process_group` on NCCL when a card is present (after
    selecting the card LOCAL_RANK), gloo otherwise; `kwargs` go to
    `init_process_group`. Nothing happens without that environment or when a
    group exists already. Returns this process's rank."""
    if not dist.is_initialized() and all(k in os.environ for k in
                                         ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        kwargs.setdefault("backend", "nccl" if cuda else "gloo")
        dist.init_process_group(**kwargs)
    return dist.get_rank() if dist.is_initialized() else 0


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.get_local_rank(axis))


_CURRENT: list = []


class use_mesh:
    """`with use_mesh(mesh):` makes `mesh` the one that a `seq_axis` name
    refers to (the counterpart of the JAX package's `with mesh:`)."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh

    def __enter__(self):
        _CURRENT.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _CURRENT.pop()


def current_mesh() -> Optional[DeviceMesh]:
    return _CURRENT[-1] if _CURRENT else None
