"""Training smoke at flagship width on the card: branch SFT (or ID-LoRA)
steps with the full 42-layer frozen backbone, or the deepest that fits.

Counterpart of the JAX package's `tools/smoke_chip_train.py`. Reference
set-up: batch 1, 49 x 480 x 720, a frozen backbone and a trainable 2-layer
branch (train_cogvideox_inpainting_i2v_video.py:1413-1418), here on one card
with seeded random weights (`flagship.build_training`).

One rung (`--layers N`), `measure`: the build (`init_s`), the first step
(`first_step_s`, the JAX tool's `compile_s`), then `--steps` steps timed
(`step_s`, their mean), the
loss of each (`loss_curve` when more than 2), the last gradient norm,
`peak_memory_gib` and the environment (`gates.environment`, launches by
kernel). Options:

    --mode branch|lora      branch SFT, or a rank-256 ID-LoRA on the backbone's
                            q / k / v / out (branch frozen, ID resampling)
    --int8-backbone         the frozen DiT in W8A8 (`quantize_transformer_int8`);
                            gradients reach the branch through `Int8MatmulSTE`
    --optimizer             adam | adamw | prodigy | adafactor
    --bf16-branch           a bf16 trainable branch (bf16 adapter in lora mode)
    --remat-chunk N         two-level checkpointing, N blocks a group
    --precomputed-latents   the VAE posterior moments encoded once
                            (`encode_batch_latent_moments`), not every step
    --fixed-noise           the same generator state every step: one loss
                            surface, so the last loss must be below the first
                            (the overfit gate; `measure` raises otherwise)
    --validate              the single-clip pipeline after training with the
                            trained weights; three frames as PNGs under artifacts/

Without `--layers` the ladder [42, 32, 28, 24, 21] runs each depth in a
subprocess of this module until one succeeds (an out-of-memory failure is
recorded as "OOM") and accumulates the result in TRAIN_SMOKE_cuda.json under
the JAX tool's section name (`section_name`). It runs on the card; `--smoke`
(tiny widths, 2 layers, on the CPU) and `--device cpu` are its only CPU
routes.

    python -m videopainter_tpu_torch.tools.smoke_chip_train --steps 20 [--fixed-noise]
    python -m videopainter_tpu_torch.tools.smoke_chip_train --layers 42 --steps 2
    python -m videopainter_tpu_torch.tools.smoke_chip_train --smoke --steps 3 --fixed-noise
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, set_numerics
from ..config import TransformerConfig, VAEConfig
from . import gates

LADDER = [42, 32, 28, 24, 21]
OUT = "TRAIN_SMOKE_cuda.json"
SMOKE_DIMS = dict(frames=9, height=64, width=96, text_len=5)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="0 = the subprocess ladder 42 -> 21, accumulated in --out")
    ap.add_argument("--steps", type=int, default=2, help="timed steps after the first")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--frames", type=int, default=49)
    ap.add_argument("--int8-backbone", action="store_true",
                    help="the frozen backbone in W8A8 (straight-through gradients)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adam", "adamw", "prodigy", "adafactor"])
    ap.add_argument("--bf16-branch", action="store_true",
                    help="bf16 trainable branch (bf16 adapter in lora mode)")
    ap.add_argument("--mode", default="branch", choices=["branch", "lora"])
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--fixed-noise", action="store_true",
                    help="one generator state every step (the overfit gate)")
    ap.add_argument("--validate", action="store_true",
                    help="run the pipeline after training and save three frames as PNGs")
    ap.add_argument("--validate-steps", type=int, default=6)
    ap.add_argument("--artifacts", default=str(gates.REPO / "artifacts"),
                    help="where --validate writes its PNGs")
    ap.add_argument("--remat-chunk", type=int, default=0,
                    help="blocks per outer checkpointed group of the backbone (0 = per block)")
    ap.add_argument("--precomputed-latents", action="store_true",
                    help="encode the batch's VAE posterior moments once")
    ap.add_argument("--out", default=None, help=f"ladder artifact (default {OUT})")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="tiny widths, 2 layers, on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.device = "cpu"
        args.height, args.width, args.frames = (SMOKE_DIMS["height"], SMOKE_DIMS["width"],
                                                SMOKE_DIMS["frames"])
        args.layers = args.layers or 2
    return args


def section_name(args) -> str:
    """The JAX tool's section key (tools/smoke_chip_train.py:320-327)."""
    return (("int8_backbone" if args.int8_backbone else "bf16_backbone")
            + f"_{args.frames}f"
            + (f"_{args.optimizer}" if args.optimizer != "adamw" else "")
            + ("_bf16branch" if args.bf16_branch else "")
            + ("_lora" if args.mode == "lora" else "")
            + ("_overfit" if args.fixed_noise else "")
            + ("_precomp" if args.precomputed_latents else "")
            + (f"_rc{args.remat_chunk}" if args.remat_chunk else ""))


def rung_argv(layers: int, args) -> List[str]:
    """The argv of one rung of the ladder."""
    return (["--layers", str(layers), "--steps", str(args.steps), "--frames", str(args.frames),
             "--height", str(args.height), "--width", str(args.width),
             "--optimizer", args.optimizer, "--mode", args.mode, "--lr", repr(args.lr),
             "--validate-steps", str(args.validate_steps), "--remat-chunk",
             str(args.remat_chunk), "--device", args.device]
            + (["--int8-backbone"] if args.int8_backbone else [])
            + (["--bf16-branch"] if args.bf16_branch else [])
            + (["--fixed-noise"] if args.fixed_noise else [])
            + (["--validate", "--artifacts", args.artifacts] if args.validate else [])
            + (["--precomputed-latents"] if args.precomputed_latents else []))


def model_config(args) -> TransformerConfig:
    lora = args.mode == "lora"
    if args.smoke:
        return TransformerConfig.tiny(in_channels=32, out_channels=16, sample_height=8,
                                      sample_width=12, num_layers=args.layers,
                                      id_pool_resample_learnable=lora)
    return TransformerConfig.cogvideox_5b_i2v(num_layers=args.layers,
                                             id_pool_resample_learnable=lora)


def build(args, generator: torch.Generator, device: torch.device) -> Dict:
    """`flagship.build_training` at `args`' depth and dims, then the options
    that change the built modules: W8A8 backbone, bf16 trainable weights,
    the optimizer and the learning rate. Keys as `build_training`'s."""
    from ..flagship import build_training
    from ..quantize import quantize_transformer_int8
    from ..training import make_optimizer

    dims = dict(SMOKE_DIMS) if args.smoke else {"text_len": 226}
    dims.update(frames=args.frames, height=args.height, width=args.width)
    t = build_training(generator, device=device, tcfg=model_config(args), mode=args.mode,
                       vcfg=VAEConfig.tiny(latent_channels=16) if args.smoke else None, **dims)
    if args.int8_backbone:
        quantize_transformer_int8(t["transformer"], free_source=True)
    if args.bf16_branch:
        if args.mode == "branch":
            t["branch"].to(torch.bfloat16)
        else:
            t["trainable"] = {k: {n: x.to(torch.bfloat16) for n, x in ab.items()}
                              for k, ab in t["trainable"].items()}
    t["optimizer"] = make_optimizer(lr=args.lr, optimizer=args.optimizer)
    return t


def make_step(t: Dict, args) -> Tuple[Callable, object]:
    """(train_step, state) of `args.mode` on the built set-up `t`."""
    from ..training import (BranchTrainConfig, init_branch_train_state, make_branch_train_step,
                            make_lora_train_step)

    cfg = BranchTrainConfig(height=args.height, width=args.width, mask_add=True, remat=True,
                            use_flash=True, remat_chunk=args.remat_chunk or None)
    make = make_lora_train_step if args.mode == "lora" else make_branch_train_step
    step = make(t["transformer"], t["branch"], t["vae"], t["scheduler"], t["optimizer"], cfg)
    step.cfg = cfg
    return step, init_branch_train_state(t["trainable"], t["optimizer"])


def step_generator(i: int, device, fixed_noise: bool) -> torch.Generator:
    """The generator of step i: seed 4 every step with --fixed-noise, else 4 + i
    (the JAX tool's keys)."""
    return torch.Generator(device=device).manual_seed(4 if fixed_noise else 4 + i)


def measure(t: Dict, args, argv=None, init_s: Optional[float] = None
            ) -> Tuple[Dict, object, List[Dict[str, float]]]:
    """The rung on a built set-up (`build`, which took `init_s` seconds): the
    first step, then `args.steps` timed steps. Returns (record, the final
    train state, each step's metrics as floats)."""
    device = next(t["vae"].parameters()).device
    batch = t["batch"]
    if args.precomputed_latents:
        from ..training import encode_batch_latent_moments
        batch = encode_batch_latent_moments(t["vae"], batch)
    step, state = make_step(t, args)
    gates.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    metrics, walls = [], []
    for i in range(args.steps + 1):
        with gates.Timer(device) as tm:
            state, m = step(state, batch, step_generator(i, device, args.fixed_noise))
            m = {k: float(v) for k, v in m.items()}
        walls.append(tm.s)
        metrics.append(m)
    curve = [m["total_loss"] for m in metrics]
    if not all(np.isfinite(curve)):
        raise FloatingPointError(f"non-finite loss: {curve}")
    if args.fixed_noise and not curve[-1] < curve[0]:
        raise AssertionError(f"overfit gate: with --fixed-noise the loss did not fall "
                             f"over the run: {curve}")
    lora = args.mode == "lora"
    frozen = ("int8 W8A8 frozen (straight-through gradients)" if args.int8_backbone
              else "bf16 frozen")
    trained = (f"r={step.cfg.lora_rank} LoRA q/k/v/out (frozen bf16 branch)" if lora
               else "bf16 branch" if args.bf16_branch else "fp32 branch")
    out = {"layers": t["transformer"].cfg.num_layers, "ok": True, "mode": args.mode,
           "int8_backbone": bool(args.int8_backbone), "optimizer": args.optimizer,
           "bf16_branch": bool(args.bf16_branch), "lr": args.lr,
           "fixed_noise": bool(args.fixed_noise),
           "precomputed_latents": bool(args.precomputed_latents),
           "remat_chunk": args.remat_chunk or None,
           "dims": f"{args.frames}f x {args.height}x{args.width}, batch 1, {frozen} + {trained} "
                   f"({args.optimizer}), flash fwd+bwd, remat, mask_add",
           "step_s": sum(walls[1:]) / max(args.steps, 1), "step_walls_s": walls[1:],
           "first_step_s": walls[0], "init_s": init_s, "loss_first": curve[0],
           "loss_last": curve[-1],
           "grad_norm": metrics[-1]["gradient_norm_before_clip"]}
    if args.steps > 2:
        out["loss_curve"] = curve
    if args.validate:
        out["validation"] = validate(t, state, batch, args)
    out["peak_memory_gib"] = gates.peak_memory_gib(device)
    out["launches"] = gates.launches()
    out["environment"] = gates.environment(device, argv)
    return out, state, metrics


def write_png(path: str, rgb01: np.ndarray) -> None:
    """An [H, W, 3] image in [0, 1] as an 8-bit PNG (zlib; no imaging library)."""
    img = (np.clip(rgb01, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def validate(t: Dict, state, batch: Dict, args) -> Dict:
    """The single-clip pipeline with the trained weights (sequential CFG, the
    flash kernels), frames [GT | masked | output] 0, middle and last written
    as PNGs under `args.artifacts`."""
    from ..training import BranchTrainConfig
    from ..training.validation import make_validation_fn

    tc = BranchTrainConfig()
    val_fn = make_validation_fn(t["transformer"], t["branch"], t["vae"], t["scheduler"], batch,
                                num_inference_steps=args.validate_steps, mode=args.mode,
                                lora_alpha=tc.lora_alpha, lora_rank=tc.lora_rank,
                                replace_gt_alternate=False, use_flash=True,
                                sequential_cfg=True, dtype=torch.bfloat16)
    device = next(t["vae"].parameters()).device
    with gates.Timer(device) as tm:
        video01 = val_fn(state.trainable, int(state.step))
    os.makedirs(args.artifacts, exist_ok=True)
    frames = [0, video01.shape[0] // 2, video01.shape[0] - 1]
    names = [os.path.join(args.artifacts, f"train_val_{args.mode}_f{fi}.png") for fi in frames]
    for fi, name in zip(frames, names):
        write_png(name, video01[fi])
    return {"steps": args.validate_steps, "wall_s": tm.s,
            "finite": bool(np.isfinite(video01).all()), "frames_png": names}


def run_rung(layers: int, args, runner=None) -> Dict:
    """One depth of the ladder in a subprocess of this module: its last JSON
    line, or {"ok": false, "error": "OOM" | "error" | "timeout"}."""
    out, failure = gates.run_module_rung("videopainter_tpu_torch.tools.smoke_chip_train",
                                         rung_argv(layers, args), 3600 + 60 * args.steps,
                                         runner)
    return out if out is not None else {"layers": layers, "ok": False, **failure}


def ladder(args, runner=None) -> Dict:
    """The depths of LADDER until one succeeds; each result printed as it
    lands. Returns {"rungs", "best"}."""
    results, best = [], None
    for layers in LADDER:
        r = run_rung(layers, args, runner)
        results.append(r)
        gates.emit(r)
        if r.get("ok"):
            best = r
            break
    return {"rungs": results, "best": best}


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.layers:
        if device.type == "cuda":
            set_numerics(conv_tf32=True)
        with gates.Timer(device) as tm:
            t = build(args, torch.Generator(device=device).manual_seed(gates.WEIGHTS_SEED),
                      device)
        record, _, _ = measure(t, args, argv, init_s=tm.s)
        gates.check_finite(record)
        gates.emit(record)
        return 0
    section = ladder(args)
    path = args.out or str(gates.REPO / OUT)
    out = gates.read_artifact(path) if os.path.exists(path) else {}
    out[section_name(args)] = section
    gates.write_artifact(path, out)
    gates.emit({"best": section["best"]})
    return 0 if section["best"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
