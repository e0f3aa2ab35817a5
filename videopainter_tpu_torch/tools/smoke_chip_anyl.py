"""The complete any-length inpainting path at flagship width, on the card.

Counterpart of the JAX package's `tools/smoke_chip_anyl.py`: VAE encode, the
sliding-window 50-step dual-stream denoise (2-layer branch and 42-layer
backbone, CFG 6 with dynamic guidance, replace_gt), the cross-window capture
and the VAE decode, through `CogVideoXI2VDualInpaintAnyLPipeline` at
480x720 in windows of 49 frames, with seeded random weights. Prints one
stage-timed JSON line per window (its VAE encodes, each denoise step, its
streamed decode) and a summary with the launches and the peak memory.

    --resample       the VideoPainterID deployment: the learnable ID resample,
                     ID resampling across windows, prev-clip weight 0.3, the
                     compressed capture
    --int8_attn      int8 flash attention (else the bf16 kernel)
    --scales PATH    static activation scales (`save_ascales`) on the W8A8
                     projections
    --skip_steps S   step-skip schedule "start:end:stride" (the capture step
                     always runs)
    --capture_int8   store the compressed capture as per-token int8
    --stream-decode  decode each window's final frames as they become final
    --bf16           no W8A8 quantization
    --compare-full   run the pipeline twice, with --skip_steps and without,
                     on the same generator seed, and write the pixel PSNR
                     between the two videos to --out (ANYL_SKIP_cuda.json)

The weights are those of the gate tools (the same seed, the same constructor,
`flagship.build_pipeline`), so `--scales` written by `gate_int8_flagship`
apply to the weights they were calibrated on. The JAX tool's
`compact_params` step and its one-latent-frame decode batches
were TPU-memory workarounds; the card needs neither (the summary records the
peak memory). It runs on the card; `--smoke` (tiny widths, 2 layers, 64x96,
17 frames in two windows of 9, 3 steps) and `--device cpu` are its only CPU
routes.

    python -m videopainter_tpu_torch.tools.smoke_chip_anyl --resample --int8_attn \\
        --capture_int8 --scales calib_ascales_cuda.npz --skip_steps 4:48:4 --compare-full
    python -m videopainter_tpu_torch.tools.smoke_chip_anyl --smoke --compare-full --skip_steps 1
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device, set_numerics
from ..config import SchedulerConfig, VAEConfig
from ..flagship import build_pipeline
from ..pipelines import CogVideoXI2VDualInpaintAnyLPipeline
from ..pipelines.common import parse_skip_steps
from ..quantize import attach_static_ascale, load_ascales, quantize_transformer_int8
from ..schedulers import CogVideoXDPMScheduler
from . import gates
from .gate_int8_flagship import model_config

ANYL_ARTIFACT = "ANYL_SKIP_cuda.json"
GENERATOR_SEED = 42   # the pipeline's generator, reseeded for every run


def make_clip(frames: int, height: int, width: int, tcfg, *, device, seed: int = 0,
              dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The JAX tool's clip: uniform frames in [-1, 1] from
    numpy.random.RandomState(seed), a central hole (rows H/4..3H/4, columns
    W/4..3W/4), the first frame as the image, seeded prompt embeddings and
    zero negative ones."""
    rng = np.random.RandomState(seed)
    video = torch.from_numpy(rng.rand(1, frames, height, width, 3).astype(np.float32) * 2 - 1)
    video = video.to(device, dtype)
    masks = torch.zeros((1, frames, height, width), device=device)
    masks[:, :, height // 4:3 * height // 4, width // 4:3 * width // 4] = 1.0
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    embeds = torch.randn((1, tcfg.max_text_seq_length, tcfg.text_embed_dim), generator=gen,
                         device=device).to(dtype)
    return {"video": video, "masks": masks, "image": video[:, 0],
            "prompt_embeds": embeds, "negative_prompt_embeds": torch.zeros_like(embeds)}


class StageClock:
    """Wall seconds of each stage of a pipeline run, window by window: the
    VAE's encodes (a window's video and first frame), each denoise step (the
    pipeline's progress callback, less the encodes and decodes inside the
    interval), the streaming decoder's feed after a window's last step, and
    the one-shot decode at the end. The VAE's methods are wrapped on the
    instance, the device synchronised around each, and restored by
    `close`."""

    def __init__(self, pipe, device, steps: int):
        self.pipe, self.device, self.steps = pipe, device, steps
        self.events: List[tuple] = []   # (window, stage, seconds)
        self.done = 0                    # steps finished
        vae = pipe.vae
        self._saved = [k for k in ("encode", "decode", "stream_decoder") if k in vae.__dict__]
        vae.encode = self._timed(vae.encode, "vae_encode")
        vae.decode = self._timed(vae.decode, "vae_decode")
        make_streamer = vae.stream_decoder

        def stream_decoder(*a, **kw):
            streamer = make_streamer(*a, **kw)
            streamer.feed = self._timed(streamer.feed, "stream_decode")
            return streamer
        vae.stream_decoder = stream_decoder

    def _timed(self, fn, stage):
        def run(*a, **kw):
            with gates.Timer(self.device) as tm:
                out = fn(*a, **kw)
            # a window's encodes come before its first step; a feed or the
            # final decode after its last
            w = self.done // self.steps
            if stage != "vae_encode":
                w = max(w - 1, 0) if self.done % self.steps == 0 else w
            self.events.append((w, stage, tm.s))
            self.last += tm.s
            return out
        return run

    def start(self) -> None:
        gates.sync(self.device)
        self.last = time.perf_counter()

    def progress(self, done: int, total: int) -> None:
        gates.sync(self.device)
        now = time.perf_counter()
        self.events.append(((done - 1) // self.steps, "step", now - self.last))
        self.last, self.done = now, done

    def windows(self) -> List[Dict]:
        out: Dict[int, Dict] = {}
        for w, stage, s in self.events:
            rec = out.setdefault(w, {"window": w, "vae_encode_s": 0.0, "step_s": [],
                                     "stream_decode_s": 0.0, "vae_decode_s": 0.0})
            if stage == "step":
                rec["step_s"].append(s)
            else:
                rec[f"{stage}_s"] += s
        for rec in out.values():
            rec["denoise_s"] = sum(rec["step_s"])
        return [out[w] for w in sorted(out)]

    def close(self) -> None:
        for k in ("encode", "decode", "stream_decoder"):
            if k not in self._saved:
                self.pipe.vae.__dict__.pop(k, None)


def run_anyl(pipe, clip: Dict, *, steps: int, stride: int, num_frames: int = 49,
             resample: bool, use_flash, capture_int8: bool, stream_decode: bool,
             skip_spec: Optional[str], seed: int = GENERATOR_SEED, dtype=torch.bfloat16):
    """One pipeline run: (video [1, T, H, W, 3] in [-1, 1] float32, wall
    seconds, the per-window stage records)."""
    device = clip["video"].device
    clock = StageClock(pipe, device, steps)
    skip = parse_skip_steps(skip_spec, steps) if skip_spec else None
    try:
        gen = torch.Generator(device=device).manual_seed(seed)
        with gates.Timer(device) as tm:
            clock.start()
            out = pipe(**clip, num_frames=num_frames, stride=stride, num_inference_steps=steps,
                       guidance_scale=6.0, use_dynamic_cfg=True, replace_gt=True,
                       mask_add=True, id_pool_resample=resample, sequential_cfg=True,
                       capture_int8=capture_int8, prev_clip_weight=0.3 if resample else 0.0,
                       generator=gen, use_flash=use_flash, skip_steps=skip,
                       stream_decode=stream_decode, output_type="pt",
                       progress_fn=clock.progress, dtype=dtype)
    finally:
        clock.close()
    return out.float(), tm.s, clock.windows()


def compare_full(pipe, clip: Dict, *, steps: int, stride: int, skip_spec: str,
                 mode: str, **kw) -> Dict:
    """The skip run and the full run on the same generator seed; the record
    of `--compare-full` (pixel PSNR of the skip video against the full one
    over [0, 1] frames; null with "identical" when they are equal)."""
    out, wall, windows = run_anyl(pipe, clip, steps=steps, stride=stride, skip_spec=skip_spec,
                                  **kw)
    for w in windows:
        gates.emit({"window": dict(w, run="skip")})
    full, wall_full, windows_full = run_anyl(pipe, clip, steps=steps, stride=stride,
                                             skip_spec=None, **kw)
    for w in windows_full:
        gates.emit({"window": dict(w, run="full")})
    frames = clip["video"].shape[1]
    rec = {"leg": f"any-length skip against full, same generator seed, same serving model "
                  f"({mode})",
           "frames": frames, "windows": len(windows_full), "steps": steps,
           "skip_schedule": skip_spec, "skipped_steps": len(parse_skip_steps(skip_spec, steps))}
    gates.put_psnr(rec, "pixel_psnr_skip_vs_full_db", (out + 1) / 2, (full + 1) / 2,
                   data_range=1.0)
    rec.update(wall_s={"skip": wall, "full": wall_full},
               windows_by_run={"skip": windows, "full": windows_full},
               finite=bool(torch.isfinite(out).all() and torch.isfinite(full).all()),
               note="seeded random weights; the cross-window capture is taken at the final, "
                    "always evaluated step of each window: this leg checks that the skip "
                    "carry does not corrupt the window hand-off")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=73)
    ap.add_argument("--stride", type=int, default=24)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--bf16", action="store_true", help="no W8A8 quantization")
    ap.add_argument("--layers", type=int, default=42)
    ap.add_argument("--resample", action="store_true")
    ap.add_argument("--stream-decode", action="store_true")
    ap.add_argument("--int8_attn", action="store_true")
    ap.add_argument("--scales", default=None)
    ap.add_argument("--skip_steps", default=None)
    ap.add_argument("--capture_int8", action="store_true")
    ap.add_argument("--compare-full", action="store_true")
    ap.add_argument("--out", default=str(gates.REPO / ANYL_ARTIFACT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths, 2 layers, 64x96, 17 frames, 3 steps, on the CPU")
    args = ap.parse_args(argv)
    if args.compare_full and not args.skip_steps:
        ap.error("--compare-full requires --skip_steps")
    if args.scales and args.bf16:
        ap.error("--scales applies to the W8A8 projections, not --bf16")
    height, width, num_frames = 480, 720, 49
    if args.smoke:
        args.layers, args.steps, args.device = 2, 3, "cpu"
        args.frames, args.stride, height, width, num_frames = 17, 8, 64, 96, 9
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics(conv_tf32=True)
        torch.cuda.reset_peak_memory_stats(device)
    gates.reset_launches()

    tcfg = model_config(args.layers, smoke=args.smoke, learnable=args.resample)
    vcfg = VAEConfig.tiny(latent_channels=16) if args.smoke else None
    gen = torch.Generator(device=device).manual_seed(gates.WEIGHTS_SEED)
    with gates.Timer(device) as tm:
        pipe = build_pipeline(gen, device=device, tcfg=tcfg, vcfg=vcfg,
                              pipeline_cls=CogVideoXI2VDualInpaintAnyLPipeline)
        if not args.bf16:
            quantize_transformer_int8(pipe.transformer, free_source=True)
            quantize_transformer_int8(pipe.branch, free_source=True)
        pipe.scheduler = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())
        if not args.smoke:   # the reference's tiles (half the sample size) do not tile 64x96
            pipe.vae.enable_tiling()
    if args.scales:
        scales = load_ascales(args.scales)
        attach_static_ascale(pipe.transformer, scales["transformer"])
        attach_static_ascale(pipe.branch, scales["branch"])
    mode = ("bf16" if args.bf16 else "int8") + ("+int8attn" if args.int8_attn else "") \
        + ("+ascale" if args.scales else "") + ("+resample" if args.resample else "")
    clip = make_clip(args.frames, height, width, tcfg, device=device)
    kw = dict(num_frames=num_frames, resample=args.resample,
              use_flash="int8" if args.int8_attn else True, capture_int8=args.capture_int8,
              stream_decode=args.stream_decode)
    if args.compare_full:
        result = compare_full(pipe, clip, steps=args.steps, stride=args.stride,
                              skip_spec=args.skip_steps, mode=mode, **kw)
    else:
        out, wall, windows = run_anyl(pipe, clip, steps=args.steps, stride=args.stride,
                                      skip_spec=args.skip_steps, **kw)
        for w in windows:
            gates.emit({"window": w})
        result = {"frames": args.frames, "windows": len(windows), "steps": args.steps,
                  "skip_schedule": args.skip_steps, "wall_s": wall, "windows_by_run": windows,
                  "finite": bool(torch.isfinite(out).all()), "shape": list(out.shape)}
    result.update(mode=mode, layers=args.layers, build_wall_s=tm.s,
                  memory_workarounds="none: no compact_params, VAE decode batches of "
                                     f"{pipe.vae.num_latent_frames_batch_size} latent frames")
    gates.finish(result, device, argv)
    gates.check_finite(result)
    if not result["finite"]:
        raise AssertionError("the pipeline's output is not finite")
    gates.emit({k: v for k, v in result.items() if k != "windows_by_run"})
    if args.compare_full:
        gates.write_artifact(args.out, result)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
