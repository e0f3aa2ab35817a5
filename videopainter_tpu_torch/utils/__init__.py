"""Utilities of the entry points. The JAX package's `utils/memory.compact_params`
has no counterpart: it defragments XLA's heap after in-place quantization,
and PyTorch's caching allocator needs no such copy."""

from .profiling import annotate, maybe_profile, profile_region

__all__ = ["annotate", "maybe_profile", "profile_region"]
