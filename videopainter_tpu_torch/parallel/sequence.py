"""Sequence parallelism of the DiT and the branch: which video tokens a rank
holds, and the gathers that cross the shards.

The JAX package constrains the video tokens to P(None, "seq", None) after
the patch embed and lets GSPMD insert the collectives. In the port a model
called with `seq_axis` (and a mesh: `ring_mesh`, or one entered with
`use_mesh`) cuts the video tokens into contiguous shards after the patch
embed (ceil(S / n) each, the last shorter, as GSPMD splits an uneven axis),
runs its blocks on its shard (text tokens on every rank), and gathers the
video tokens back before the output projection, so the model's inputs and
outputs are whole tensors as in JAX. Attention sees the other shards by
all-gathering K and V (`gather_kv`), or through the ring
(`ring_attention.py`) when `ring_mesh` is given; the ring needs equal
shards, so there a video length the ring size does not divide raises
`ValueError`, as the JAX `shard_map` does. Shards are cut on the per-frame
patch grid: a CogVideoX 1.5 model (spatio-temporal patches) raises
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from . import comm
from .mesh import AXES, axis_rank, axis_size, current_mesh


@dataclass
class SeqShard:
    group: object
    n: int
    rank: int
    total: int          # video tokens in all
    sizes: List[int]    # video tokens of each rank
    lo: int
    hi: int
    ring: bool

    def take(self, x: Optional[torch.Tensor], dim: int) -> Optional[torch.Tensor]:
        """This rank's video tokens of a whole-sequence tensor (no copy)."""
        return None if x is None else x.narrow(dim, self.lo, self.hi - self.lo)

    def take_joint(self, x: Optional[torch.Tensor], text_len: int, dim: int = 1):
        """[text ‖ this rank's video tokens] of a joint-sequence tensor."""
        if x is None:
            return None
        return torch.cat([x.narrow(dim, 0, text_len),
                          x.narrow(dim, text_len + self.lo, self.hi - self.lo)], dim=dim)

    def gather(self, x: torch.Tensor, dim: int, backward: str = "slice") -> torch.Tensor:
        """Every rank's video tokens of `x` concatenated along `dim`."""
        return comm.all_gather(x, dim, self.group, sizes=self.sizes, backward=backward)

    def gather_kv(self, x: torch.Tensor, text_len: int) -> torch.Tensor:
        """[B, S_text + S_local, H, D] -> [B, S_text + S_vid, H, D]: the text
        rows as they are, the video rows of every rank (the gradient of the
        gathered rows is summed over the ranks back onto their owner)."""
        vid = self.gather(x[:, text_len:], 1, backward="sum")
        return vid if text_len == 0 else torch.cat([x[:, :text_len], vid], dim=1)


def seq_shard(seq_axis: Optional[str], ring_mesh, s_vid: int,
              patch_size_t: Optional[int] = None) -> Optional[SeqShard]:
    """The SeqShard a model's `seq_axis` / `ring_mesh` arguments name for
    `s_vid` video tokens, or None without sequence parallelism. `ring_mesh`
    alone rings over "seq"; `seq_axis` alone needs a mesh entered with
    `use_mesh`. `patch_size_t`: the model's (CogVideoX 1.5 raises)."""
    if seq_axis is None and ring_mesh is None:
        return None
    if patch_size_t is not None:
        raise NotImplementedError(
            "sequence parallelism supports only per-frame patches (CogVideoX 1.0); this "
            f"model has patch_size_t={patch_size_t} (CogVideoX 1.5)")
    axis = seq_axis or AXES.seq
    mesh = ring_mesh if ring_mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"seq_axis={seq_axis!r} needs a mesh: pass ring_mesh or call "
                         "under `with use_mesh(mesh):`")
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    ring = ring_mesh is not None
    if ring and s_vid % n:
        raise ValueError(f"ring attention needs the video length {s_vid} divisible by the "
                         f"'{axis}' axis size {n}")
    sizes = comm.shard_sizes(s_vid, n)
    lo, hi = comm.shard_range(s_vid, n, r)
    return SeqShard(mesh.get_group(axis), n, r, s_vid, sizes, lo, hi, ring)
