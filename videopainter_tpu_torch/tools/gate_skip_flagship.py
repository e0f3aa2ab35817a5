"""Quality gate of the step-skip serving mode at flagship width, on the card.

Counterpart of the JAX package's `tools/gate_skip_flagship.py`. A skipped
step (`DenoiseConfig.skip_steps`) reuses the previous step's pre-CFG model
output, so it interacts with the scheduler (the DPM x0 carry, dynamic CFG,
the replace_gt re-noise): the gate runs the port's real denoise loop
(`pipelines.common.make_denoise_fn`: DPM, dynamic CFG 6.0, replace_gt,
sequential CFG, mode "dual") end to end:

 1. bf16, every step                  -> the reference, one per (seed, geom)
 2. the serving mode, every step      -> int8 W8A8 + int8 attention, with the
                                         static scales of --scales when given
 3. the serving mode with a schedule  -> one run per --schedules entry

and the legs that decide a schedule: latent PSNR against the reference and
against the serving-full run; decoded-pixel PSNR / SSIM (tiled VAE decode);
LPIPS and CLIP temporal consistency of the decoded frames, each anchored by
white noise at exactly the 35 dB bar added to the reference pixels (the
perceptual weights are the seeded ones under tests/goldens, so only the
control gives their scale); and the robustness matrix: the first schedule
over --seeds x --mask-geoms, each pair against its own bf16 reference, with
its latent and pixel PSNR. `ANYL_SKIP_cuda.json` (smoke_chip_anyl
--compare-full) is merged in when present.

`--ref-cache PATH` keeps every finished full-step trajectory in an .npz under
the whole configuration that made it (layers, width, steps, latent dims,
seed, geom, serving mode and scales), so a run split across calls reuses a
trajectory only for the very configuration it came from. A PSNR of
bit-identical outputs is null with `"identical": true`; the artifact is
strict JSON and is refused when the robustness schedule is not one of the
schedules or a robustness config lacks its pixel PSNR.

The weights are random: the gate measures skip-error propagation through the
model's arithmetic and the scheduler, not quality on real content. It runs on
the card; `--smoke` (tiny widths, 2 layers, 6 steps, schedule 2:6:2) and
`--device cpu` are its only CPU routes.

    python -m videopainter_tpu_torch.tools.gate_skip_flagship --scales calib_ascales_cuda.npz \\
        --schedules 4:48:5 4:48:4 4:48:3 10:46:2 --seeds 3 --mask-geoms rect tall \\
        --ref-cache build/skip_refs.npz            # writes GATE_skip_cuda.json
    python -m videopainter_tpu_torch.tools.gate_skip_flagship --smoke --out /tmp/skip.json
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import torch

from .. import resolve_device, set_numerics
from ..config import SchedulerConfig, VAEConfig
from ..flagship import build_pipeline
from ..pipelines.common import DenoiseConfig, DenoiseInputs, make_denoise_fn, parse_skip_steps, \
    prepare_rope
from ..quantize import attach_static_ascale, load_ascales, quantize_transformer_int8
from ..schedulers import CogVideoXDPMScheduler
from . import gates
from .gate_int8_flagship import FLAGSHIP_LATENT, SMOKE_LATENT, model_config

ANYL_ARTIFACT = "ANYL_SKIP_cuda.json"
SDE_SEED = 7        # the generator of the DPM steps' noise, reseeded for every run
DEC_NOTE = ("random-weight VAE decoder: pixel PSNR follows the latent PSNR through random "
            "convolutions; it is not a real decoder's sensitivity")


def make_inputs(tcfg, latent_dims, seed: int, geom: str, *, device,
                dtype=torch.bfloat16) -> DenoiseInputs:
    """The loop's inputs of one (seed, geom) config, drawn from a generator
    seeded 2 + 1000 * seed: latents, masked-video latents, prompt embeddings
    [negative; positive], the initial noise and the clean video latents that
    replace_gt re-noises; zero image latents; the hole of `geom`."""
    b, t, h, w = latent_dims
    gen = torch.Generator(device=device).manual_seed(2 + 1000 * seed)
    c = tcfg.out_channels
    lat = lambda: torch.randn((b, t, h, w, c), generator=gen, device=device).to(dtype)
    latents, masked = lat(), lat()
    embeds = torch.randn((2 * b, tcfg.max_text_seq_length, tcfg.text_embed_dim),
                         generator=gen, device=device).to(dtype)
    noise, video_latents = lat(), lat()
    mask = torch.from_numpy(gates.MASK_GEOMS[geom](t, h, w)).to(device)[None]
    return DenoiseInputs(latents=latents, image_latents=torch.zeros_like(latents),
                         masked_video_latents=masked,
                         mask=mask.expand(b, -1, -1, -1).to(dtype).contiguous(),
                         prompt_embeds=embeds, noise=noise, video_latents=video_latents)


def denoise_config(steps: int, use_flash, skip: Optional[Tuple[int, ...]] = None
                   ) -> DenoiseConfig:
    """The serving loop of the gate: DPM, dynamic CFG 6.0, replace_gt,
    mask_add, sequential CFG, mode "dual"."""
    return DenoiseConfig(num_inference_steps=steps, do_cfg=True, use_dynamic_cfg=True,
                         guidance_scale=6.0, conditioning_scale=1.0, replace_gt=True,
                         mask_add=True, mask_background=False, add_first=False, wo_text=False,
                         id_pool_resample=False, use_flash=use_flash, sequential_cfg=True,
                         skip_steps=skip, mode="dual")


def run_loop(transformer, branch, scheduler, inputs: DenoiseInputs, rope, *, steps: int,
             use_flash, skip=None) -> Tuple[torch.Tensor, float]:
    """(final latents fp32, wall seconds) of one run of the denoise loop, its
    SDE noise drawn from a generator seeded SDE_SEED (or `inputs.dpm_noises`)."""
    timesteps = scheduler.timesteps(steps)
    fn = make_denoise_fn(transformer, branch, scheduler,
                         denoise_config(steps, use_flash, skip), timesteps)
    device = inputs.latents.device
    gen = torch.Generator(device=device).manual_seed(SDE_SEED)
    with gates.Timer(device) as tm:
        lat, _, _ = fn(inputs, rope, gen)
    return lat.float(), tm.s


def scales_id(path: Optional[str]) -> str:
    if not path:
        return "none"
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def validate(result: Dict) -> None:
    """Refuse an artifact a consumer cannot apply its checks to."""
    rob = result.get("robustness")
    if rob is None or rob.get("schedule") not in result.get("schedules", {}):
        raise ValueError(f"robustness schedule {rob and rob.get('schedule')!r} is not one of "
                         f"the schedules {sorted(result.get('schedules', {}))}")
    for r in rob["configs"]:
        if "pixel_psnr_db" not in r or "latent_psnr_vs_bf16_db" not in r:
            raise ValueError(f"robustness config {r} lacks its latent or pixel PSNR")
    for spec, e in result["schedules"].items():
        if "pixel_psnr_db" not in e:
            raise ValueError(f"schedule {spec} lacks its pixel PSNR")
    gates.check_finite(result)


def references(transformer, branch, scheduler, *, steps: int, configs: List[Tuple[int, str]],
               latent_dims, cache: Optional[gates.RefCache] = None) -> Dict:
    """The bf16 full-step reference of every (seed, geom) config (from
    `cache` where it holds the same configuration), on bf16 modules:
    {"inputs", "rope", "ident", "refs", "wall_s", "cached"}."""
    tcfg = transformer.cfg
    device = next(transformer.parameters()).device
    b, t, h, w = latent_dims
    rope = prepare_rope(tcfg, h * 8, w * 8, t, 8, device=device)
    st = {"inputs": {c: make_inputs(tcfg, latent_dims, *c, device=device) for c in configs},
          "rope": (rope[0].to(torch.bfloat16), rope[1].to(torch.bfloat16)),
          "ident": dict(layers=tcfg.num_layers, width=tcfg.inner_dim, steps=steps,
                        dims="x".join(map(str, latent_dims)), weights=gates.WEIGHTS_SEED),
          "cache": cache or gates.RefCache(None), "refs": {}, "wall_s": {}, "cached": {}}
    for c in configs:
        st["refs"][c], st["wall_s"][c], st["cached"][c] = full_run(
            transformer, branch, scheduler, st, "bf16_full", "bf16", c, True, steps)
    return st


def full_run(transformer, branch, scheduler, st: Dict, kind: str, mode: str, c, use_flash,
             steps: int):
    """(final latents, wall seconds, whether cached) of a full-step run of
    config `c`, kept in the cache under its whole configuration."""
    device = st["inputs"][c].latents.device
    key = gates.RefCache.key(kind=kind, mode=mode, seed=c[0], geom=c[1], **st["ident"])
    hit = st["cache"].get(key)
    if hit is not None:
        gates.emit({kind: {"seed": c[0], "geom": c[1], "cached": True, "wall_s": hit[1]}})
        return torch.from_numpy(hit[0]).to(device), hit[1], True
    lat, wall = run_loop(transformer, branch, scheduler, st["inputs"][c], st["rope"],
                         steps=steps, use_flash=use_flash)
    st["cache"].put(key, gates.to_numpy(lat), wall)
    gates.emit({kind: {"seed": c[0], "geom": c[1], "cached": False, "wall_s": wall}})
    return lat, wall, False


def run_gate(transformer, branch, vae, scheduler, *, steps: int, schedules: List[str],
             configs: List[Tuple[int, str]], latent_dims, scales: Optional[Dict] = None,
             scales_tag: str = "none", bf16: bool = False,
             perceptual: Optional[gates.Perceptual] = None,
             cache: Optional[gates.RefCache] = None, refs: Optional[Dict] = None) -> Dict:
    """The whole gate on built bf16 modules (quantized in place unless
    `bf16`). `configs`: (seed, geom) pairs, the first the primary config
    that carries the per-schedule legs; `scales`: static activation scales
    ({"transformer": ..., "branch": ...}) or None for dynamic int8; `refs`:
    `references(...)` made before, else made here. Returns the artifact's
    body."""
    tcfg = transformer.cfg
    device = next(transformer.parameters()).device
    legs = gates.LegLaunches()
    st = refs or references(transformer, branch, scheduler, steps=steps, configs=configs,
                            latent_dims=latent_dims, cache=cache)
    legs.mark("bf16_references")
    inputs, rope, refs, t_ref = st["inputs"], st["rope"], st["refs"], st["wall_s"]
    primary = configs[0]

    mode, use_flash = "bf16", True
    if not bf16:
        quantize_transformer_int8(transformer, free_source=True)
        quantize_transformer_int8(branch, free_source=True)
        gc.collect()
        mode, use_flash = "int8", "int8"
        if scales is not None:
            for name, m in (("transformer", transformer), ("branch", branch)):
                if name not in scales:
                    raise KeyError(f"the scales have no {name!r} entry: {sorted(scales)}")
                attach_static_ascale(m, scales[name])
            mode = "int8+ascale"
    serv, t_serv, serv_cached = full_run(transformer, branch, scheduler, st, "serving_full",
                                         f"{mode}:{scales_tag}", primary, use_flash, steps)
    legs.mark("serving_full")

    result = {"gate": (f"step-skip cache on the {mode} serving path against the bf16 "
                       f"full-step trajectory, {tcfg.num_layers} layers, the real denoise "
                       "loop (DPM, dynamic CFG 6.0, replace_gt, sequential CFG)"),
              "steps": steps, "layers": tcfg.num_layers,
              "latent_dims": list(latent_dims),
              "weights": "seeded random weights (no checkpoint in the repository): measures "
                         "skip-error propagation through the model and the scheduler",
              "serving_mode": mode, "scales": scales_tag,
              "configs": [{"seed": c[0], "geom": c[1]} for c in configs],
              "traj_wall_s": {"bf16_full": t_ref[primary], "serving_full": t_serv},
              "cached": {"bf16_full": [st["cached"][c] for c in configs],
                         "serving_full": serv_cached},
              "schedules": {}}
    gates.put_psnr(result, "serving_full_latent_psnr_vs_bf16_db", serv, refs[primary])
    gates.emit({k: v for k, v in result.items() if k != "schedules"})

    finals = {}
    for spec in schedules:
        skip = parse_skip_steps(spec, steps)
        got, wall = run_loop(transformer, branch, scheduler, inputs[primary], rope,
                             steps=steps, use_flash=use_flash, skip=skip)
        e = {"skipped_steps": len(skip), "evaluated_steps": steps - len(skip),
             "traj_wall_s": wall}
        gates.put_psnr(e, "latent_psnr_vs_bf16_db", got, refs[primary])
        gates.put_psnr(e, "latent_psnr_vs_serving_full_db", got, serv)
        result["schedules"][spec] = e
        finals[spec] = got
        legs.mark(f"schedule {spec}")
        gates.emit({spec: e})

    headline = schedules[0]
    rob_finals, robust = {}, []
    skip = parse_skip_steps(headline, steps)
    for c in configs[1:]:
        got, wall = run_loop(transformer, branch, scheduler, inputs[c], rope, steps=steps,
                             use_flash=use_flash, skip=skip)
        r = {"seed": c[0], "geom": c[1], "traj_wall_s": wall}
        gates.put_psnr(r, "latent_psnr_vs_bf16_db", got, refs[c])
        robust.append(r)
        rob_finals[c] = got
        legs.mark(f"robustness s{c[0]} {c[1]}")
        gates.emit({"robustness": r})
    result["robustness"] = {
        "schedule": headline,
        "note": "each (seed, geom) config against its own bf16 full-step reference; latent "
                "and pixel PSNR held to the same 35 dB bar as the primary config",
        "configs": robust}

    # decoded pixels and the perceptual legs
    with gates.Timer(device) as tm:
        px_ref = gates.decode01(vae, refs[primary])
        if perceptual is not None:
            result["perceptual_anchor"] = dict(
                perceptual.anchor(px_ref[0]),
                note="white noise at the 35 dB PSNR bar on the reference pixels; a schedule "
                     "passes the perceptual leg when lpips_vs_bf16 <= this lpips. The "
                     "feature weights are seeded (tests/goldens): the control gives their "
                     "scale, not comparable to pretrained LPIPS")
            gates.emit({"perceptual_anchor": result["perceptual_anchor"]})
        for spec, got in finals.items():
            px_got = gates.decode01(vae, got)
            e = gates.put_pixel_metrics(result["schedules"][spec], px_got, px_ref)
            e["pixel_decoder_weights"] = DEC_NOTE
            if perceptual is not None:
                e["lpips_vs_bf16"] = perceptual.lpips_mean(px_got[0], px_ref[0])
                e["temporal_consistency"] = perceptual.temporal_consistency(px_got[0])
                e["perceptual_pass"] = bool(
                    e["lpips_vs_bf16"] <= result["perceptual_anchor"]["lpips"])
            gates.emit({spec: e})
        for r in robust:
            c = (r["seed"], r["geom"])
            gates.put_pixel_metrics(r, gates.decode01(vae, rob_finals[c]),
                                    gates.decode01(vae, refs[c]), ssim=False)
    legs.mark("decode_and_perceptual")
    result["pixel_wall_s"] = tm.s
    result["pixel_note"] = ("every schedule's and robustness config's final latents against "
                            "their bf16 full-step reference, all through the tiled VAE decode "
                            "(random weights)")
    result["launches_by_leg"] = legs.legs
    return result


def merge_anyl(result: Dict, path: str) -> Dict:
    """The any-length leg of `smoke_chip_anyl --compare-full`, when its
    artifact exists (read strictly: a malformed one raises)."""
    if os.path.exists(path):
        result["anyl"] = gates.read_artifact(path)
        result["anyl"]["measured_by"] = ("videopainter_tpu_torch/tools/smoke_chip_anyl.py "
                                         "--compare-full")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=42)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--schedules", nargs="+", default=["10:46:2"],
                    help='skip schedules "start:end:stride" (pipelines.common.parse_skip_steps)')
    ap.add_argument("--scales", default="",
                    help="static activation scales .npz (save_ascales); '' = dynamic int8")
    ap.add_argument("--bf16", action="store_true",
                    help="gate skipping on the bf16 path (no quantization error)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="noise seeds of the robustness leg (seed 0 x the first geom is "
                         "the primary config)")
    ap.add_argument("--mask-geoms", nargs="+", default=["rect"], choices=sorted(gates.MASK_GEOMS))
    ap.add_argument("--no-perceptual", action="store_true")
    ap.add_argument("--ref-cache", default=None,
                    help="npz keeping the full-step trajectories under their configuration")
    ap.add_argument("--anyl", default=str(gates.REPO / ANYL_ARTIFACT),
                    help="any-length leg to merge when the file exists")
    ap.add_argument("--out", default="GATE_skip_cuda.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny widths, 2 layers, 6 steps, schedule 2:6:2, on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.layers, args.steps, args.schedules, args.device = 2, 6, ["2:6:2"], "cpu"
    if args.scales and args.bf16:
        ap.error("--scales applies to the int8 serving mode, not --bf16")
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics(conv_tf32=True)
        torch.cuda.reset_peak_memory_stats(device)
    gates.reset_launches()

    tcfg = model_config(args.layers, smoke=args.smoke, learnable=False)
    dims = SMOKE_LATENT if args.smoke else FLAGSHIP_LATENT
    with gates.Timer(device) as tm:
        pipe = build_pipeline(torch.Generator(device=device).manual_seed(gates.WEIGHTS_SEED),
                              device=device, tcfg=tcfg,
                              vcfg=VAEConfig.tiny(latent_channels=16) if args.smoke else None)
        pipe.vae.enable_tiling()
        perceptual = None if args.no_perceptual else gates.Perceptual(device)
    scales = load_ascales(args.scales) if args.scales else None
    configs = [(s, g) for s in range(max(args.seeds, 1)) for g in args.mask_geoms]
    result = run_gate(pipe.transformer, pipe.branch, pipe.vae,
                      CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference()),
                      steps=args.steps, schedules=args.schedules, configs=configs,
                      latent_dims=dims, scales=scales, scales_tag=scales_id(args.scales),
                      bf16=args.bf16, perceptual=perceptual,
                      cache=gates.RefCache(args.ref_cache))
    result["scales_file"] = os.path.basename(args.scales) if args.scales else None
    result["build_wall_s"] = tm.s
    merge_anyl(result, args.anyl)
    gates.finish(result, device, argv)
    validate(result)
    gates.write_artifact(args.out, result)
    print(json.dumps(result, indent=1, allow_nan=False), flush=True)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
