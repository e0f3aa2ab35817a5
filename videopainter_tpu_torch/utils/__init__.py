"""Utilities of the entry points: profiling regions, precision contexts and
`compact_params` (one dense allocation per dtype after an in-place rewrite)."""

from .memory import compact_params
from .numerics import full_fp32
from .profiling import annotate, maybe_profile, profile_region

__all__ = ["annotate", "compact_params", "full_fp32", "maybe_profile", "profile_region"]
