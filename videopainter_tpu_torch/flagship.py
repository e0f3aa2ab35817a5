"""The flagship configurations at full width with seeded random weights, and
a profile of one of their denoise steps.

`build_pipeline` makes CogVideoXI2VDualInpaintPipeline at CogVideoX-5b-I2V
width (42-layer DiT, 48x64 heads, 2-layer branch, default VAE) with random
bf16 weights drawn on the device from a torch.Generator; `random_clip` makes
a 49x480x720 clip, a mask and prompt embeddings. `build_anyl_int8_pipeline`
makes the any-length ID-resample pipeline in its int8 serving mode: the same
models with the learnable ID resample, a seeded rank-256 adapter merged into
the DiT's attention weights, then the block projections of DiT and branch
quantized to W8A8 in place; `ANYL_INT8_CALL` holds its call arguments (int8
flash attention, compressed int8 capture). The real checkpoints are not in
the repository, so numbers from these weights measure speed and memory, not
quality. `build_training` makes the branch-SFT (or ID-LoRA) training set-up
at the same width: the frozen bf16 backbone and VAE, a float32 branch
initialised from the backbone (or a frozen bf16 branch and a float32 rank-256
adapter), the DDIM scheduler, AdamW, and a synthetic batch.

    python -m videopainter_tpu_torch.flagship [--anyl-int8 | --train] [--out DIR]

runs 3 denoise steps on the card and profiles the second with torch.profiler
(with --anyl-int8: two windows of an 81-frame clip, 3 steps each, profiling
the second step of the second window, which attends to the first window's
captured state): prints device time by kernel class (flash attention, GEMM,
other), the step's elapsed device time between two CUDA events, the device's
idle share in that same step, and the wall time of the next (untraced) step;
the full table goes to DIR/flagship_profile.txt or
DIR/flagship_anyl_int8_profile.txt (default build/profile/). With --train:
3 optimizer steps of branch SFT (batch 1, 49x480x720, per-block
checkpointing, the flash kernels), profiling the second from after its VAE
prep to the end of the optimizer update; the table goes to
DIR/flagship_train_profile.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch

from . import card_line
from .config import BranchConfig, SchedulerConfig, TransformerConfig, VAEConfig
from .models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D
from .models.lora import init_lora_params, merge_lora
from .pipelines import CogVideoXI2VDualInpaintAnyLPipeline, CogVideoXI2VDualInpaintPipeline
from .quantize import quantize_transformer_int8
from .schedulers import CogVideoXDDIMScheduler, CogVideoXDPMScheduler


def build_pipeline(generator: torch.Generator, *, device="cuda", dtype=torch.bfloat16,
                   tcfg: Optional[TransformerConfig] = None, branch_layers: int = 2,
                   vcfg: Optional[VAEConfig] = None,
                   pipeline_cls=CogVideoXI2VDualInpaintPipeline):
    """Random-weight pipeline, built on the meta device and filled in place
    (the weights are never materialized twice)."""
    tcfg = tcfg or TransformerConfig.cogvideox_5b_i2v()
    bcfg = BranchConfig.from_transformer(tcfg, num_layers=branch_layers)
    vcfg = vcfg or VAEConfig()

    def build(ctor):
        m = ctor(device="meta", dtype=dtype).to_empty(device=device)
        return m.init_random_(generator)

    return pipeline_cls(
        build(lambda **kw: CogVideoXTransformer3D(tcfg, **kw)),
        build(lambda **kw: CogVideoXBranch(bcfg, **kw)),
        build(lambda **kw: AutoencoderKLCogVideoX(vcfg, **kw)),
        CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference()), device=device)


LORA_RANK, LORA_ALPHA = 256, 128.0   # the VideoPainterID adapter's


def build_anyl_int8_pipeline(generator: torch.Generator, *, device="cuda",
                             dtype=torch.bfloat16, tcfg: Optional[TransformerConfig] = None,
                             branch_layers: int = 2, vcfg: Optional[VAEConfig] = None,
                             lora_rank: int = LORA_RANK, int8: bool = True
                             ) -> CogVideoXI2VDualInpaintAnyLPipeline:
    """The any-length ID-resample pipeline as it is served: random weights with
    the learnable ID resample, a seeded adapter of `lora_rank` merged into the
    DiT, then (int8) the W8A8 quantization of DiT and branch in place."""
    tcfg = tcfg or TransformerConfig.cogvideox_5b_i2v(id_pool_resample_learnable=True)
    pipe = build_pipeline(generator, device=device, dtype=dtype, tcfg=tcfg,
                          branch_layers=branch_layers, vcfg=vcfg,
                          pipeline_cls=CogVideoXI2VDualInpaintAnyLPipeline)
    lora = init_lora_params(generator, pipe.transformer, rank=lora_rank, dtype=dtype)
    for ab in lora.values():   # a trained adapter's B is not zero
        b = ab["lora_B"]
        ab["lora_B"] = ((torch.rand(b.shape, generator=generator, device=b.device) * 2 - 1)
                        * b.shape[1] ** -0.5).to(dtype)
    merge_lora(pipe.transformer, lora, alpha=LORA_ALPHA * lora_rank / LORA_RANK, rank=lora_rank)
    del lora
    if int8:
        quantize_transformer_int8(pipe.transformer, free_source=True)
        quantize_transformer_int8(pipe.branch, free_source=True)
    return pipe


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


def build_training(generator: torch.Generator, *, device="cuda",
                   tcfg: Optional[TransformerConfig] = None,
                   vcfg: Optional[VAEConfig] = None, mode: str = "branch",
                   frames=49, height=480, width=720, text_len=226) -> Dict:
    """The training set-up with seeded random weights: {"transformer",
    "branch", "vae", "scheduler", "optimizer", "trainable", "batch"}.
    mode "branch": the backbone and VAE in bf16, the 2-layer branch
    initialised from the backbone in float32 (masters) and trainable.
    mode "lora": the backbone (with the learnable ID resample) and the branch
    in bf16, trainable a fresh float32 adapter of rank LORA_RANK.
    The optimizer is AdamW at the reference's 1e-5; the batch is one synthetic
    bf16 clip with a centred rectangular hole."""
    from .training.optim import make_optimizer

    if mode not in ("branch", "lora"):
        raise ValueError(f"mode must be 'branch' or 'lora', got {mode!r}")
    dtype = torch.bfloat16
    tcfg = tcfg or TransformerConfig.cogvideox_5b_i2v(id_pool_resample_learnable=mode == "lora")
    bcfg = BranchConfig.from_transformer(tcfg, num_layers=2)
    vcfg = vcfg or VAEConfig()

    def build(ctor, dt):
        m = ctor(device="meta", dtype=dt).to_empty(device=device)
        return m.init_random_(generator)

    transformer = build(lambda **kw: CogVideoXTransformer3D(tcfg, **kw), dtype)
    vae = build(lambda **kw: AutoencoderKLCogVideoX(vcfg, **kw), dtype)
    branch = build(lambda **kw: CogVideoXBranch(bcfg, **kw),
                   torch.float32 if mode == "branch" else dtype)
    branch.init_from_transformer(transformer)
    if mode == "branch":
        trainable = branch
    else:
        for lin in branch.branch_blocks:   # a trained branch's projections are not zero
            w = lin.weight
            w.data.copy_((torch.rand(w.shape, generator=generator, device=w.device) * 2 - 1)
                         * w.shape[1] ** -0.5)
        trainable = init_lora_params(generator, transformer, rank=LORA_RANK,
                                     dtype=torch.float32)
    clip = random_clip(generator, frames=frames, height=height, width=width,
                       text_len=text_len, text_dim=tcfg.text_embed_dim, device=device)
    keep = 1 - clip["masks"][..., None]
    batch = {"pixel_values": clip["video"].to(dtype),
             "conditioning_pixel_values": (clip["video"] * keep).to(dtype),
             "masks": clip["masks"].to(dtype), "prompt_embeds": clip["prompt_embeds"].to(dtype)}
    return {"transformer": transformer, "branch": branch, "vae": vae,
            "scheduler": CogVideoXDDIMScheduler(SchedulerConfig(prediction_type="v_prediction")),
            "optimizer": make_optimizer(lr=1e-5), "trainable": trainable, "batch": batch}


FLAGSHIP_CALL = dict(guidance_scale=6.0, use_dynamic_cfg=True, replace_gt=True,
                     mask_add=True, use_flash=True, dtype=torch.bfloat16)
# 81 frames in windows of 49 with a stride of 32: 2 windows that overlap by 4
# latent frames; prev_clip_weight 0 is the serving default (the resample path
# still attends to the zeroed page of masked keys)
ANYL_INT8_CALL = dict(FLAGSHIP_CALL, use_flash="int8", num_frames=49, stride=32,
                      id_pool_resample=True, prev_clip_weight=0.0, compress_capture=2048,
                      capture_int8=True)
ANYL_FRAMES = 81


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_int8" in n:
        return "flash_attention_int8"
    if "flash_fwd" in n:
        return "flash_attention"
    if "flash_dq" in n:
        return "flash_attention_dq"
    if "flash_dkv" in n:
        return "flash_attention_dkv"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")):
        return "gemm_int8" if any(s in n for s in ("i8", "s8", "imma", "int8")) else "gemm"
    if "conv" in n or "cudnn" in n:
        return "conv"
    return "other"


def profile_step(out_dir: str, seed: int = 0, anyl_int8: bool = False) -> dict:
    """Profile one denoise step at full width; returns the summary. The
    single-clip flagship: step 2 of 3. The any-length int8 flagship: step 2 of
    3 of the second window (global step 5 of 6)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    gen = torch.Generator(device="cuda").manual_seed(seed)
    if anyl_int8:
        pipe, clip = build_anyl_int8_pipeline(gen), random_clip(gen, frames=ANYL_FRAMES)
        call, traced, name = ANYL_INT8_CALL, 5, "flagship_anyl_int8_profile.txt"
    else:
        pipe, clip = build_pipeline(gen), random_clip(gen)
        call, traced, name = FLAGSHIP_CALL, 2, "flagship_profile.txt"
    after = traced + 1
    ends, starts = {}, {1: None}
    ev_start = {i: torch.cuda.Event(enable_timing=True) for i in (traced, after)}
    ev_end = {i: torch.cuda.Event(enable_timing=True) for i in (traced, after)}

    def mark(i, n):
        if i in ev_end:
            ev_end[i].record()
        torch.cuda.synchronize()
        ends[i] = time.perf_counter()
        prof.step()  # may stop the trace and process it: not part of any step
        starts[i + 1] = time.perf_counter()
        if i + 1 in ev_start:
            ev_start[i + 1].record()

    # the first profiler step is VAE encode + denoise step 1; after `wait`
    # of them, active=1 is exactly the traced denoise step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=traced - 1, warmup=0, active=1, repeat=1)) as prof:
        pipe(**clip, num_inference_steps=3, generator=gen, output_type="latent",
             progress_fn=mark, **call)
    torch.cuda.synchronize()
    # busy and elapsed both from the traced step (its host side slowed by the
    # tracer, so the idle share is an upper bound); the next step ran untraced
    summary = {"path": "anyl_int8" if anyl_int8 else "single_clip", "traced_step": traced,
               "step_wall_ms": (ends[after] - starts[after]) * 1e3,
               "untraced_step_device_ms": ev_start[after].elapsed_time(ev_end[after]),
               "profiled_step_wall_ms": (ends[traced] - starts[traced]) * 1e3}
    return _write_summary(prof, ev_start[traced].elapsed_time(ev_end[traced]), summary,
                          out_dir, name)


def _write_summary(prof, elapsed_ms: float, summary: dict, out_dir: str, name: str) -> dict:
    """Device time by kernel class of a one-step trace, its idle share against
    the step's elapsed device time, the table to out_dir/name."""
    from torch.autograd import DeviceType

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
    busy_ms = sum(by_class.values())
    idle = 1 - busy_ms / elapsed_ms
    if idle < 0:
        raise RuntimeError(f"device busy {busy_ms:.3f} ms exceeds the step's elapsed "
                           f"{elapsed_ms:.3f} ms: the trace miscounts")
    summary = dict(summary, profiled_step_device_ms=elapsed_ms, device_busy_ms=busy_ms,
                   idle_share=idle, device_ms_by_class=by_class,
                   device=torch.cuda.get_device_name(0), card=card_line())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write(json.dumps(summary) + "\n")
        for dev_us, count, key in rows:
            f.write(f"{dev_us / 1e3:12.3f} ms {count:6d}  {key}\n")
    for dev_us, count, key in rows[:15]:
        print(f"{dev_us / 1e3:10.3f} ms {count:5d}  {key[:110]}")
    return summary


def profile_train_step(out_dir: str, seed: int = 0) -> dict:
    """Three full-width branch-SFT steps; the second one's grad step (branch
    and backbone forward, backward, optimizer update; its VAE prep runs
    before the trace) is profiled. Returns the summary."""
    from torch.profiler import ProfilerActivity, profile

    from . import _kernels
    from .training import BranchTrainConfig, init_branch_train_state, make_branch_train_step

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = build_training(gen)
    cfg = BranchTrainConfig(mask_add=True, use_flash=True, remat=True)
    state = init_branch_train_state(t["trainable"], t["optimizer"])
    step = make_branch_train_step(t["transformer"], t["branch"], t["vae"], t["scheduler"],
                                  t["optimizer"], cfg)
    walls, prep_s, summary = [], [], {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prep = step.prepare(t["batch"], gen)
        rope = step.rope(prep)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        traced = i == 1
        if traced:
            _kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
        with prof if traced else contextlib.nullcontext():
            start.record()
            state, metrics = step.grad_step(state, *prep, t["batch"]["prompt_embeds"], rope)
            end.record()
            torch.cuda.synchronize()
        if traced:
            summary = {"path": "train_branch", "traced_step": 2,
                       "launches": dict(_kernels.LAUNCHES),
                       "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "profiled_grad_step_ms": start.elapsed_time(end)}
        walls.append(time.perf_counter() - t1)
        prep_s.append(t1 - t0)
        del prep
    summary.update(grad_step_wall_s=walls, vae_prep_wall_s=prep_s,
                   loss=float(metrics["total_loss"]))
    return _write_summary(prof, summary["profiled_grad_step_ms"], summary, out_dir,
                          "flagship_train_profile.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--anyl-int8", action="store_true",
                    help="profile the any-length int8 flagship instead of the single clip")
    ap.add_argument("--train", action="store_true",
                    help="profile one full-width branch-SFT training step instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the flagship profile needs an NVIDIA GPU")
    from . import set_numerics
    set_numerics(conv_tf32=True)
    if args.train:
        print(json.dumps(profile_train_step(args.out)))
    else:
        print(json.dumps(profile_step(args.out, anyl_int8=args.anyl_int8)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
