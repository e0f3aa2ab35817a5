"""The flagship configuration at full width with seeded random weights, and a
profile of one of its denoise steps.

`build_pipeline` makes CogVideoXI2VDualInpaintPipeline at CogVideoX-5b-I2V
width (42-layer DiT, 48x64 heads, 2-layer branch, default VAE) with random
bf16 weights drawn on the device from a torch.Generator; `random_clip` makes
a 49x480x720 clip, a mask and prompt embeddings. The real checkpoints are
not in the repository, so numbers from these weights measure speed and
memory, not quality.

    python -m videopainter_tpu_torch.flagship [--out DIR]

runs 3 denoise steps on the card and profiles the second with torch.profiler:
prints device time by kernel class (flash attention, GEMM, other), the
step's elapsed device time between two CUDA events, the device's idle share
in that same step, and the wall time of the third (untraced) step; the full
table goes to DIR/flagship_profile.txt (default build/profile/).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch

from .config import BranchConfig, SchedulerConfig, TransformerConfig, VAEConfig
from .models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D
from .pipelines import CogVideoXI2VDualInpaintPipeline
from .schedulers import CogVideoXDPMScheduler


def build_pipeline(generator: torch.Generator, *, device="cuda", dtype=torch.bfloat16,
                   tcfg: Optional[TransformerConfig] = None, branch_layers: int = 2,
                   vcfg: Optional[VAEConfig] = None) -> CogVideoXI2VDualInpaintPipeline:
    """Random-weight pipeline, built on the meta device and filled in place
    (the weights are never materialized twice)."""
    tcfg = tcfg or TransformerConfig.cogvideox_5b_i2v()
    bcfg = BranchConfig.from_transformer(tcfg, num_layers=branch_layers)
    vcfg = vcfg or VAEConfig()

    def build(ctor):
        m = ctor(device="meta", dtype=dtype).to_empty(device=device)
        return m.init_random_(generator)

    return CogVideoXI2VDualInpaintPipeline(
        build(lambda **kw: CogVideoXTransformer3D(tcfg, **kw)),
        build(lambda **kw: CogVideoXBranch(bcfg, **kw)),
        build(lambda **kw: AutoencoderKLCogVideoX(vcfg, **kw)),
        CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference()), device=device)


def random_clip(generator: torch.Generator, *, frames=49, height=480, width=720,
                text_len=226, text_dim=4096, device="cuda") -> Dict[str, torch.Tensor]:
    """A clip in [-1, 1] with a centred rectangular hole (half of each side),
    its masked first frame, and positive / negative prompt embeddings."""
    video = torch.rand((1, frames, height, width, 3), generator=generator, device=device) * 2 - 1
    masks = torch.zeros((1, frames, height, width), device=device)
    masks[:, :, height // 4:3 * height // 4, width // 4:3 * width // 4] = 1.0
    return {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
            "prompt_embeds": torch.randn((1, text_len, text_dim), generator=generator,
                                         device=device),
            "negative_prompt_embeds": torch.randn((1, text_len, text_dim),
                                                  generator=generator, device=device)}


FLAGSHIP_CALL = dict(guidance_scale=6.0, use_dynamic_cfg=True, replace_gt=True,
                     mask_add=True, use_flash=True, dtype=torch.bfloat16)


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n:
        return "flash_attention"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")):
        return "gemm"
    if "conv" in n or "cudnn" in n:
        return "conv"
    return "other"


def profile_step(out_dir: str, seed: int = 0) -> dict:
    """Profile denoise step 2 of 3 at full width; returns the summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    gen = torch.Generator(device="cuda").manual_seed(seed)
    pipe = build_pipeline(gen)
    clip = random_clip(gen)
    ends, starts = {}, {1: None}
    ev_start = {i: torch.cuda.Event(enable_timing=True) for i in (2, 3)}
    ev_end = {i: torch.cuda.Event(enable_timing=True) for i in (2, 3)}

    def mark(i, n):
        if i in ev_end:
            ev_end[i].record()
        torch.cuda.synchronize()
        ends[i] = time.perf_counter()
        prof.step()  # may stop the trace and process it: not part of any step
        starts[i + 1] = time.perf_counter()
        if i + 1 in ev_start:
            ev_start[i + 1].record()

    # wait=1: the first profiler step is VAE encode + denoise step 1;
    # active=1: the second is exactly denoise step 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=0, active=1, repeat=1)) as prof:
        pipe(**clip, num_inference_steps=3, generator=gen, output_type="latent",
             progress_fn=mark, **FLAGSHIP_CALL)
    torch.cuda.synchronize()
    by_class: Dict[str, float] = {}
    rows = []
    for evt in prof.key_averages():
        # kernels only: an op's own row repeats its kernels' time, and the
        # step annotation spans the whole step
        if evt.device_type != DeviceType.CUDA or evt.key.startswith("ProfilerStep"):
            continue
        dev_us = evt.self_device_time_total
        if dev_us <= 0:
            continue
        rows.append((dev_us, evt.count, evt.key))
        cls = _kernel_class(evt.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
    rows.sort(reverse=True)
    # busy and elapsed both from the traced step 2 (its host side slowed by
    # the tracer, so the idle share is an upper bound); step 3 ran untraced
    elapsed_ms = ev_start[2].elapsed_time(ev_end[2])
    busy_ms = sum(by_class.values())
    idle = 1 - busy_ms / elapsed_ms
    if idle < 0:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds the step's elapsed "
                           f"{elapsed_ms:.3f} ms: the trace miscounts")
    summary = {"step_wall_ms": (ends[3] - starts[3]) * 1e3,
               "untraced_step_device_ms": ev_start[3].elapsed_time(ev_end[3]),
               "profiled_step_wall_ms": (ends[2] - starts[2]) * 1e3,
               "profiled_step_device_ms": elapsed_ms,
               "device_busy_ms": busy_ms, "idle_share": idle,
               "device_ms_by_class": by_class,
               "device": torch.cuda.get_device_name(0)}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "flagship_profile.txt"), "w") as f:
        f.write(json.dumps(summary) + "\n")
        for dev_us, count, key in rows:
            f.write(f"{dev_us / 1e3:12.3f} ms {count:6d}  {key}\n")
    for dev_us, count, key in rows[:15]:
        print(f"{dev_us / 1e3:10.3f} ms {count:5d}  {key[:110]}")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the flagship profile needs an NVIDIA GPU")
    from . import set_numerics
    set_numerics(conv_tf32=True)
    print(json.dumps(profile_step(args.out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
