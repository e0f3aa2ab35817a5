"""Profiling regions for the entry points.

Counterpart of `videopainter_tpu/utils/profiling.py`, on `torch.profiler`:
`profile_region("denoise", out_dir)` traces a region (CPU, and the card's
kernels when CUDA is present) and writes a Chrome trace to
`out_dir/<name>/trace.json` (Perfetto opens it); `maybe_profile(enabled, ...)`
is the same behind a flag (the CLIs' `--profile`); `annotate(name)` names a
span inside a trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

DEFAULT_DIR = os.path.join("build", "torch_trace")


@contextlib.contextmanager
def profile_region(name: str, out_dir: str = DEFAULT_DIR):
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(out_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time()
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    print(f"[profile] {name}: {time.time() - t0:.2f}s -> {path}")


@contextlib.contextmanager
def maybe_profile(enabled: bool, name: str = "region", out_dir: str = DEFAULT_DIR):
    if not enabled:
        yield None
        return
    with profile_region(name, out_dir) as p:
        yield p


def annotate(name: str):
    """A named span in the trace (a context manager)."""
    return torch.profiler.record_function(name)
