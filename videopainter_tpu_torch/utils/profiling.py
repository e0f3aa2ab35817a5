"""Profiling regions for the entry points, and the port's spans.

Counterpart of `videopainter_tpu/utils/profiling.py`, on `torch.profiler`:
`profile_region("denoise", out_dir)` traces a region (CPU, and the card's
kernels when CUDA is present) and writes a Chrome trace to
`out_dir/<name>/trace.json` (Perfetto opens it); `maybe_profile(enabled, ...)`
is the same behind a flag (the CLIs' `--profile`).

`annotate(name)` is the port's one span: a `record_function` range in the
trace of whatever `torch.profiler` is active (these regions, a benchmark's
traced window), on the profiler's clock, so the profiler's correlation ids
tie every kernel to the span it was launched in. With no profiler active it
records nothing. The spans the port opens:

 - `denoise.step`: one step of `make_denoise_fn`'s loop, the model and the
   scheduler with its blend, closed before the caller's `progress_fn`;
 - `dit.adaln`: a DiT or branch block's AdaLN norm (`LayerNormZero`), its
   modulation linear and the float32 modulation;
 - `attn`: one `joint_attention` call, from the text / video join through
   the projections, QK norms, RoPE, the kernel(s) and `to_out`;
 - `train.step`: one training step, the VAE prep and the gradient step;
 - `train.backward`: the backward, with the checkpoints' recompute (which
   reopens `dit.adaln` and `attn` inside it);
 - `train.optimizer`: the gradient norm and the optimizer's update;
 - `vae.encode`: one `AutoencoderKLCogVideoX.encode`;
 - `vae.norm`: a VAE GroupNorm (or `SpatialNorm3D`) with the SiLU after it.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

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


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span called `name` in the active profiler's trace (a context
    manager). With no profiler active, one shared null context: an untraced
    run pays one flag check a span, not a `record_function`'s enter and
    exit. The flag is process-wide, so spans opened on the autograd
    engine's threads (a checkpoint's recompute) are gated as the caller's
    are."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
