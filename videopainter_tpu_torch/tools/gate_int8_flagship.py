"""Quality gate of the int8 serving mode at flagship width, on the card.

Counterpart of the JAX package's `tools/gate_int8_flagship.py`. The int8
mode (W8A8 block projections, `ops.basic.Int8Linear`, and int8 flash
attention, `csrc/flash_int8_wgmma.cu`) is held against the bf16 mode
(`csrc/flash_fwd_wgmma.cu`) on the same seeded weights and inputs, through
the tool's own trajectory: sequential CFG (two B = 1 passes a step) and the
fixed `combine` step, so that only the quantization differs.

Quick mode (default, 5 steps): the final latents' PSNR, cosine and relative
L1 of the int8 trajectory against the bf16 one (`--pv`: int8 P.V too).

    --ascale       calibrate static activation scales during the dynamic
                   int8 trajectory (each site's amax, the maximum over both
                   CFG halves and every step, from the models' calibrate=True
                   tap; `quantize.ascales_from_amax`), rerun the trajectory
                   static (`quantize.attach_static_ascale`), report its PSNR
                   against bf16 and against dynamic int8
    --save-scales  write those scales with their provenance (`save_ascales`)
    --deep         50 steps (unless --steps says otherwise) on a model with
                   the learnable ID resample and a rectangular hole, plus the
                   capture-int8 legs (the per-token int8 capture's round trip
                   against the bf16 one, its propagation through a
                   window-1-style ID-resample forward, and the zero-state
                   consumption control) and the decoded-pixel PSNR / SSIM of
                   both final latents through the tiled VAE decode, with the
                   share of saturated pixels; writes --out

The weights are random (no checkpoint is in the repository): the gate
measures how quantization error propagates through the 42-layer arithmetic,
not quality on real content. It runs on the card; `--smoke` (tiny widths,
2 layers, 2 steps) and `--device cpu` are its only CPU routes, where each
kernel runs its plain version.

    python -m videopainter_tpu_torch.tools.gate_int8_flagship [--steps 5] [--pv] [--ascale]
    python -m videopainter_tpu_torch.tools.gate_int8_flagship --deep --ascale \\
        --save-scales calib_ascales_cuda.npz            # writes GATE_int8_cuda.json
    python -m videopainter_tpu_torch.tools.gate_int8_flagship --smoke --out /tmp/gate.json
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, set_numerics
from ..config import TransformerConfig, VAEConfig
from ..flagship import build_pipeline
from ..pipelines.common import capture_token_indices, prepare_rope
from ..quantize import (ascales_from_amax, attach_static_ascale, clear_static_ascale,
                        quantize_transformer_int8, save_ascales)
from . import gates

FLAGSHIP_LATENT = (1, 13, 60, 90)    # B, T, h, w of a 49x480x720 clip
SMOKE_LATENT = (1, 3, 8, 12)
PREV_CLIP_WEIGHT = 0.3               # the any-length hand-off weight of the propagation leg


def smoke_config(**kw) -> TransformerConfig:
    """The tiny model of `--smoke` and the CPU tests (2 layers, narrow
    widths, the 3x8x12 latent grid)."""
    return TransformerConfig.tiny(in_channels=32, out_channels=16, sample_height=8,
                                  sample_width=12, sample_frames=9, **kw)


def model_config(layers: int, *, smoke: bool, learnable: bool) -> TransformerConfig:
    if smoke:
        return smoke_config(num_layers=layers, id_pool_resample_learnable=learnable)
    return TransformerConfig.cogvideox_5b_i2v(num_layers=layers,
                                             id_pool_resample_learnable=learnable)


def gate_inputs(generator: torch.Generator, tcfg: TransformerConfig, latent_dims, *,
                rect_mask: bool, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Seeded inputs of the trajectory: initial and masked-video latents,
    zero image latents, the latent mask (the rectangular hole of
    `gates.MASK_GEOMS["rect"]`, or a random half of the positions), the
    [negative; positive] prompt embeddings and the rotary tables."""
    b, t, h, w = latent_dims
    dev = generator.device
    c = tcfg.out_channels
    latents = torch.randn((b, t, h, w, c), generator=generator, device=dev).to(dtype)
    masked = torch.randn((b, t, h, w, c), generator=generator, device=dev).to(dtype)
    if rect_mask:
        mask = torch.from_numpy(gates.MASK_GEOMS["rect"](t, h, w)).to(dev)[None].expand(
            b, -1, -1, -1)
    else:
        mask = (torch.rand((b, t, h, w), generator=generator, device=dev) > 0.5).float()
    embeds = torch.randn((2 * b, tcfg.max_text_seq_length, tcfg.text_embed_dim),
                         generator=generator, device=dev).to(dtype)
    cos, sin = prepare_rope(tcfg, h * 8, w * 8, t, 8, device=dev)
    return {"latents": latents, "masked": masked, "image_latents": torch.zeros_like(latents),
            "mask": mask.to(dtype).contiguous(), "embeds": embeds,
            "rope": (cos.to(dtype), sin.to(dtype))}


def make_forward(transformer, branch, inp: Dict, use_flash, *, calibrate: bool = False,
                 **extra) -> Callable:
    """forward(latents, embeds_b, timestep, **dyn): the branch, then the
    backbone with its features injected under the mask; returns the
    backbone's TransformerOutput, with `calibrate` also (branch amax,
    backbone amax)."""
    def forward(latents, embeds_b, ts, **dyn):
        model_in = torch.cat([latents, inp["image_latents"]], dim=-1)
        cond = torch.cat([inp["masked"], inp["mask"][..., None]], dim=-1)
        samples = branch(latents, embeds_b, cond, ts, rope=inp["rope"], use_flash=use_flash,
                         calibrate=calibrate)
        amax_b = None
        if calibrate:
            samples, amax_b = samples
        out = transformer(model_in, embeds_b, ts, rope=inp["rope"],
                          branch_block_samples=samples, branch_block_masks=inp["mask"],
                          use_flash=use_flash, calibrate=calibrate, **extra, **dyn)
        return (out, amax_b, out.calib_amax) if calibrate else out
    return forward


def combine(latents: torch.Tensor, u: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The tool's fixed update: CFG 6 in fp32, then a small step towards the
    prediction, back in the latents' dtype."""
    pred = u.float() + 6.0 * (c - u).float()
    return (latents.float() * 0.99 - 0.01 * pred).to(latents.dtype)


@torch.no_grad()
def run_traj(transformer, branch, inp: Dict, steps: int, use_flash, *,
             calibrate: bool = False):
    """The trajectory from `inp["latents"]`: per step at timestep 500 - i,
    the unconditional and the conditional pass (sequential CFG), then
    `combine`. Returns (final latents fp32, branch amax, backbone amax): the
    amaxes ([L, sites] float32, the maximum over both CFG halves and every
    step) with `calibrate`, else None."""
    fwd = make_forward(transformer, branch, inp, use_flash, calibrate=calibrate)
    lat, embeds = inp["latents"], inp["embeds"]
    b = lat.shape[0]
    am_b = am_t = None
    for i in range(steps):
        ts = torch.full((b,), 500 - i, dtype=torch.long, device=lat.device)
        u = fwd(lat, embeds[:b], ts)
        c = fwd(lat, embeds[b:], ts)
        if calibrate:
            (u, ab1, at1), (c, ab2, at2) = u, c
            ab = torch.maximum(ab1.float(), ab2.float()).cpu().numpy()
            at = torch.maximum(at1.float(), at2.float()).cpu().numpy()
            am_b = ab if am_b is None else np.maximum(am_b, ab)
            am_t = at if am_t is None else np.maximum(am_t, at)
        lat = combine(lat, u.sample, c.sample)
    return lat.float(), am_b, am_t


def timed_traj(device, *a, **kw):
    with gates.Timer(device) as tm:
        out = run_traj(*a, **kw)
    return out, tm.s


def bf16_reference(transformer, branch, inp: Dict, steps: int) -> Tuple[torch.Tensor, float]:
    """(final latents, wall seconds) of the bf16 trajectory (the bf16 flash
    kernel)."""
    (ref, _, _), wall = timed_traj(inp["latents"].device, transformer, branch, inp, steps, True)
    gates.emit({"bf16_trajectory": {"steps": steps, "wall_s": wall}})
    return ref, wall


@torch.no_grad()
def capture_legs(transformer, branch, inp: Dict, final: torch.Tensor, use_flash) -> Dict:
    """The capture-int8 legs at the trajectory's final latents, timestep 450,
    the positive prompt: the per-token int8 capture of the masked-region
    tokens against the bf16 capture (round trip), each consumed by a
    window-1-style ID-resample forward (propagation PSNR), and the forward
    on zeroed states (consumption control: it must differ)."""
    tcfg = transformer.cfg
    b = final.shape[0]
    lat = final.to(inp["latents"].dtype)
    emb = inp["embeds"][b:]
    ts = torch.full((b,), 450, dtype=torch.long, device=lat.device)
    cap_idx = capture_token_indices(inp["mask"].float(), tcfg.patch_size,
                                    tcfg.max_text_seq_length)
    cap = make_forward(transformer, branch, inp, use_flash, return_hidden_states=True,
                       capture_indices=cap_idx)(lat, emb, ts)
    hs_bf16, resample_mask = cap.hidden_states_list, cap.resample_mask
    del cap
    hs_int8 = make_forward(transformer, branch, inp, use_flash, return_hidden_states=True,
                           capture_indices=cap_idx, capture_quant=True)(
                               lat, emb, ts).hidden_states_list
    dot = n_deq = n_ref = abs_err = abs_ref = 0.0
    for layer in range(hs_bf16.shape[0]):   # float64, a layer at a time
        deq = (hs_int8["values"][layer].double() * hs_int8["scales"][layer][..., None].double())
        ref = hs_bf16[layer].double()
        dot += float((deq * ref).sum())
        n_deq += float(deq.square().sum())
        n_ref += float(ref.square().sum())
        abs_err += float((deq - ref).abs().sum())
        abs_ref += float(ref.abs().sum())
    prop = make_forward(transformer, branch, inp, use_flash, prev_hidden_indices=cap_idx,
                        id_pool_resample=True, prev_resample_mask=resample_mask,
                        prev_clip_weight=PREV_CLIP_WEIGHT)
    out_b = prop(lat, emb, ts, prev_hidden_states=hs_bf16).sample.float()
    out_q = prop(lat, emb, ts, prev_hidden_states=hs_int8).sample.float()
    out_none = prop(lat, emb, ts, prev_hidden_states=torch.zeros_like(hs_bf16)).sample.float()
    leg = {"captured_tokens": int(cap_idx.shape[1]),
           "roundtrip_rel_l1": abs_err / (abs_ref + 1e-12),
           "roundtrip_cosine": dot / (np.sqrt(n_deq) * np.sqrt(n_ref) + 1e-12)}
    gates.put_psnr(leg, "window1_propagation_psnr_db", out_q, out_b)
    leg["consumption_control_maxdiff"] = float((out_b - out_none).abs().max())
    leg["note"] = ("per-token symmetric int8 capture against the bf16 compressed capture, "
                   "both made and consumed by the int8 serving forward (ID-resample "
                   "paged-key path)")
    return leg


def pixel_leg(vae, ref: torch.Tensor, got: torch.Tensor) -> Dict:
    """Both final latents through the tiled VAE decode: pixel PSNR, frame-mean
    SSIM, and the share of reference pixels the [-1, 1] clip saturates."""
    px_ref = gates.decode01(vae, ref)
    px_got = gates.decode01(vae, got)
    out = gates.put_pixel_metrics({}, px_got, px_ref)
    leg = {"psnr_db": out.pop("pixel_psnr_db"), "ssim": out.pop("pixel_ssim"), **out,
           "clip_saturation_frac": float(((px_ref * 2 - 1).abs() >= 0.999).float().mean())}
    leg["note"] = ("both final latents decoded by the tiled VAE (random weights); "
                   "clip_saturation_frac is the share of the frame the [-1, 1] clip "
                   "saturates")
    return leg


def run_gate(transformer, branch, vae, inp: Dict, *, steps: int, pv: bool = False,
             ascale: bool = False, margin: float = 1.0, capture: bool = False,
             pixel: bool = False,
             save_scales: Optional[str] = None, provenance: Optional[Dict] = None,
             ref: Optional[Tuple[torch.Tensor, float]] = None) -> Dict:
    """The whole gate on built bf16 modules: the bf16 trajectory (or `ref`,
    its final latents and wall seconds from `bf16_reference`), the W8A8
    quantization of both models in place, the int8 trajectory (calibrated
    with `ascale`), the static rerun, the capture legs and the pixel leg as
    asked. Returns the artifact's body (without the environment), with the
    scales under "_scales" when `ascale`."""
    device = inp["latents"].device
    int8_flash = "int8pv" if pv else "int8"
    legs = gates.LegLaunches()
    ref, t_bf16 = ref or bf16_reference(transformer, branch, inp, steps)
    legs.mark("bf16_trajectory")
    quantize_transformer_int8(transformer, free_source=True)
    quantize_transformer_int8(branch, free_source=True)
    gc.collect()
    (got, am_b, am_t), t_int8 = timed_traj(device, transformer, branch, inp, steps, int8_flash,
                                           calibrate=ascale)
    legs.mark("int8_trajectory")
    gates.emit({"int8_trajectory": {"steps": steps, "wall_s": t_int8}})
    tcfg = transformer.cfg
    result = {"gate": (f"{'int8+int8pv' if pv else 'int8+int8'}-attn against bf16, "
                       f"{tcfg.num_layers} layers, {tcfg.num_attention_heads} x "
                       f"{tcfg.attention_head_dim} heads, latents {list(ref.shape[1:4])}"),
              "steps": steps, "layers": transformer.cfg.num_layers,
              "mode": int8_flash,
              "weights": "seeded random weights (no checkpoint in the repository): measures "
                         "how quantization error propagates through the model's arithmetic",
              "latent": gates.latent_stats(got, ref),
              "traj_wall_s": {"bf16": t_bf16, "int8": t_int8}}
    if ascale:
        scales = {"transformer": ascales_from_amax(transformer, am_t, margin=margin),
                  "branch": ascales_from_amax(branch, am_b, margin=margin)}
        if save_scales:
            save_ascales(save_scales, scales, provenance=provenance)
        attach_static_ascale(transformer, scales["transformer"])
        attach_static_ascale(branch, scales["branch"])
        (got_sta, _, _), t_sta = timed_traj(device, transformer, branch, inp, steps, int8_flash)
        legs.mark("static_ascale_trajectory")
        for m in (transformer, branch):
            clear_static_ascale(m)
        result["static_ascale"] = {"margin": margin, "traj_wall_s": t_sta}
        gates.put_psnr(result["static_ascale"], "latent_psnr_vs_bf16_db", got_sta, ref)
        gates.put_psnr(result["static_ascale"], "latent_psnr_vs_dynamic_int8_db", got_sta, got)
        result["static_ascale"]["note"] = (
            "scales calibrated over the whole dynamic-int8 trajectory (both CFG halves, "
            "every step); outliers clip at +-127 instead of per-token rescaling")
        result["_scales"] = scales
        gates.emit({"static_ascale": result["static_ascale"]})
    if capture:
        with gates.Timer(device) as tm:
            result["capture_int8"] = capture_legs(transformer, branch, inp, got, int8_flash)
        legs.mark("capture_int8")
        result["capture_int8"]["wall_s"] = tm.s
        gates.emit({"capture_int8": result["capture_int8"]})
    if pixel:
        with gates.Timer(device) as tm:
            result["pixel"] = pixel_leg(vae, ref, got)
        result["pixel"]["wall_s"] = tm.s
    result["launches_by_leg"] = legs.legs
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--layers", type=int, default=42)
    ap.add_argument("--pv", action="store_true", help="gate the int8pv mode (int8 P.V too)")
    ap.add_argument("--deep", action="store_true",
                    help="50 steps, capture-int8 and decoded-pixel legs; writes --out")
    ap.add_argument("--ascale", action="store_true",
                    help="also gate static calibrated activation scales")
    ap.add_argument("--ascale-margin", type=float, default=1.0)
    ap.add_argument("--save-scales", default=None,
                    help="with --ascale: write the scales to this .npz (infer --int8_scales)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default GATE_int8_cuda.json with --deep; a quick "
                         "run prints its result and, given --out, records it in that file "
                         "under quick_<mode>)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths, 2 layers, 2 steps, on the CPU")
    args = ap.parse_args(argv)
    if args.deep and args.steps == 5:
        args.steps = 50
    if args.smoke:
        args.layers, args.steps, args.device = 2, 2, "cpu"
    if args.save_scales and not args.ascale:
        ap.error("--save-scales needs --ascale")
    out_path = args.out or ("GATE_int8_cuda.json" if args.deep else None)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics(conv_tf32=True)
        torch.cuda.reset_peak_memory_stats(device)
    gates.reset_launches()

    tcfg = model_config(args.layers, smoke=args.smoke, learnable=args.deep)
    dims = SMOKE_LATENT if args.smoke else FLAGSHIP_LATENT
    gen = torch.Generator(device=device).manual_seed(gates.WEIGHTS_SEED)
    with gates.Timer(device) as tm:
        pipe = build_pipeline(gen, device=device, tcfg=tcfg,
                              vcfg=VAEConfig.tiny(latent_channels=16) if args.smoke else None)
    pipe.vae.enable_tiling()
    inp = gate_inputs(torch.Generator(device=device).manual_seed(2), tcfg, dims,
                      rect_mask=args.deep)
    provenance = {"tool": "videopainter_tpu_torch/tools/gate_int8_flagship.py",
                  "argv": list(argv if argv is not None else sys.argv[1:]),
                  "layers": args.layers, "steps": args.steps, "margin": args.ascale_margin,
                  "calibration": "the whole dynamic-int8 CFG trajectory (both halves, every "
                                 "step) through the models' calibrate=True tap; seeded random "
                                 "weights",
                  "dims": f"B={dims[0]} T={dims[1]} H={dims[2]} W={dims[3]} "
                          f"joint_seq={tcfg.max_text_seq_length}+video",
                  "card": gates.environment(device)["card"]}
    result = run_gate(pipe.transformer, pipe.branch, pipe.vae, inp, steps=args.steps,
                      pv=args.pv, ascale=args.ascale, margin=args.ascale_margin,
                      capture=args.deep, pixel=args.deep,
                      save_scales=args.save_scales, provenance=provenance)
    result.pop("_scales", None)
    result["build_wall_s"] = tm.s
    gates.finish(result, device, argv)
    gates.check_finite(result)
    gates.emit(result)
    if out_path:
        if not args.deep and os.path.exists(out_path):
            record = gates.read_artifact(out_path)
            record[f"quick_{result['mode']}"] = result
            result = record
        gates.write_artifact(out_path, result)
        print(f"wrote {out_path}", flush=True)
    if args.save_scales:
        print(f"wrote {args.save_scales}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
