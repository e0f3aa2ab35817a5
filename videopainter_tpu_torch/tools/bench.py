"""Benchmark of the single-clip flagship on the card: 49 frames at 480x720,
50 dual-stream steps, in clips per minute.

Counterpart of the JAX package's `bench.py`, which stays the JAX bench.
Prints JSON lines {"metric", "value", "unit", "vs_baseline", "detail"}; the
LAST line is the artifact (`BENCH_cuda.json` holds one).

One rung (`--layers N`, or `--tiny`), `measure_rung`: the 2-layer branch and
the DiT at CogVideoX-5b-I2V width cut to N layers, with seeded random weights
(`flagship.build_models`, seed `gates.WEIGHTS_SEED`: the weights the gate
tools calibrated their scales on), the serving options applied in place
(`--fuse-qkv`; `--int8`: W8A8 through `quantize_transformer_int8(free_source=
True)`; `--int8-scales`: calibrated static activation scales, or
`--int8-ascale`: a uniform one), then the JAX bench's synthetic step timed:

- batched CFG (B = 2): pred = u + 6 (c - u), latents * 0.99 - 0.01 pred in
  fp32; or `--seq-cfg`: two B = 1 forwards and `combine`;
- attention `"int8pv"` (`--int8-pv`), `"int8"` (`--int8-attn`), else the
  bf16 flash kernel (exact attention only under `--tiny`);
- 1 warm-up step (`first_step_s`), then 3 steps (2 under `--tiny`), the
  device synchronised before each clock reading;
- `--skip-spec start:end:stride`: the skipped steps counted by
  `pipelines.common.parse_skip_steps`, and `combine` alone timed 10 times as
  the cached step;
- the VAE leg: the DiT freed, the default VAE with tiling decodes a
  1 x 13 x 60 x 90 x 16 latent ([B, T, h, w, C]) once warm, once timed.

clip time = (steps - skipped) x step + skipped x cached step + decode, and
the value is 60 / clip time. `layers_measured` is the depth that ran; below
42 the step is scaled to 42 layers as the JAX bench does
(`step_ms_extrapolated_42L`), at 42 nothing is extrapolated.

Auto ladder (no `--layers`), `auto_main`: a probe of the card in a
subprocess (an error line with value 0 when it fails), then the rungs, each
a subprocess of this module whose last JSON line is its result (an OOM or a
timeout is recorded as `ok: false`): the quality-gated serving rungs first
(`gated_serving_rungs`), then `bf16_batched_42L`, `bf16_seqcfg_42L`, 21, 8
and 4 layers. The first rung that lands is the headline and is printed at
once; the comparison rungs are attached to it (`bf16_parity_mode`,
`int8_proj_only_mode`, `int8_dynamic_mode` or `int8_static_ascale_mode`),
each at 42 layers without the VAE leg, reprinting the line after each, while
`--budget` lasts. A skip headline also carries `int8_static_ascale_mode`
derived from its own step (all 50 steps evaluated).

The metric keeps the JAX bench's name and unit. `vs_baseline` is the
headline's clips/min over the same run's `bf16_parity_mode` clips/min (1.0
when the headline is that rung itself); it is null until that rung lands,
and the line is reprinted when it does. The JAX bench divides by 0.125
clips/min/chip, a TPU target (`bench.py:23`); no TPU figure is a baseline
here.

Differences from the JAX bench's line and options:
- `compile_s` is `first_step_s` (no compilation: the first step's wall);
- `flash_blocks`, a TPU block-sweep note, is dropped (B4's blocks are swept
  by `tools.sweep_int8_blocks`);
- `peak_memory_gib`, `launches` (by kernel, `_kernels.LAUNCHES`) and
  `environment` (`gates.environment`) are added;
- no `--no-resident`: the port's DiT has no resident-padding choice, which
  was a TPU layout measure (`videopainter_tpu/models/dit.py:391-396`);
- a bf16 headline is never replaced by the ungated int8 rung
  (`int8_full_fast_mode` stays a comparison): the headline is a gated mode
  or bf16;
- `gated_serving_rungs` reads the `_cuda` gate artifacts and applies
  ADVICE.md's two findings (see its docstring).

    python -m videopainter_tpu_torch.tools.bench                  # the ladder, on the card
    python -m videopainter_tpu_torch.tools.bench --layers 42 --int8 --int8-attn \\
        --int8-scales calib_ascales_cuda.npz --skip-spec 4:48:5    # one rung
    python -m videopainter_tpu_torch.tools.bench --tiny           # tiny widths, on the CPU
"""

from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import resolve_device, set_numerics
from ..config import TransformerConfig, VAEConfig
from ..flagship import build_models
from . import gates
# combine: the sequential-CFG update, and the cached step of a skipped step
from .gate_int8_flagship import FLAGSHIP_LATENT, SMOKE_LATENT, combine, gate_inputs

METRIC = "clips/min/chip (49f x 480x720, 50-step dual-stream inpaint)"
UNIT = "clips/min/chip"
FULL_LAYERS = 42
VAE_LATENT = (1, 13, 60, 90, 16)
GATE_INT8 = "GATE_int8_cuda.json"
GATE_SKIP = "GATE_skip_cuda.json"
SCALES = "calib_ascales_cuda.npz"
# the comparison modes a headline carries
MODES = ("bf16_parity_mode", "int8_proj_only_mode", "int8_dynamic_mode",
         "int8_static_ascale_mode", "int8_full_fast_mode")
ATTACH_EST_S = 300.0   # the budget a 42-layer comparison rung needs (build, 4 steps)
SERVING_NOTE = ("int8 W8A8 block projections + int8-QK^T flash attention; flagship-width "
                "quality gate against the bf16 trajectory: tools.gate_int8_flagship "
                f"({GATE_INT8})")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="backbone layers to build; 0 = the auto ladder")
    ap.add_argument("--seq-cfg", action="store_true",
                    help="sequential CFG: two B = 1 forwards instead of one B = 2 forward")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths, exact attention, on the CPU")
    ap.add_argument("--skip-vae", action="store_true")
    ap.add_argument("--fuse-qkv", action="store_true",
                    help="fold q / k / v into one projection (ops.fuse_qkv_projections)")
    ap.add_argument("--int8", action="store_true", help="W8A8 block projections")
    ap.add_argument("--int8-attn", action="store_true", help="int8-QK^T flash attention")
    ap.add_argument("--int8-pv", action="store_true",
                    help="int8-QK^T and int8 P.V flash attention")
    ap.add_argument("--int8-ascale", type=float, default=0.0,
                    help="a uniform static activation scale on the int8 linears (perf A/B)")
    ap.add_argument("--int8-scales", default=None,
                    help="calibrated per-layer static activation scales (.npz, "
                         "quantize.load_ascales)")
    ap.add_argument("--skip-spec", default=None,
                    help='step-skip schedule "start:end:stride" (pipelines.common.'
                         'parse_skip_steps); skipped steps cost the cached step')
    ap.add_argument("--budget", type=float, default=3300.0,
                    help="auto ladder: wall seconds after which comparison rungs are skipped")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.tiny:
        args.device = "cpu"
    return args


def model_config(args) -> TransformerConfig:
    if args.tiny:
        return TransformerConfig.tiny(in_channels=32, out_channels=16, sample_height=8,
                                      sample_width=12)
    return TransformerConfig.cogvideox_5b_i2v(num_layers=args.layers)


def apply_options(models: Dict, args) -> Dict:
    """The serving options of `args` applied to {"transformer", "branch"} in
    place: fused q / k / v, W8A8 (the bf16 weights freed as they go), static
    activation scales."""
    from ..ops.attention import fuse_qkv_projections
    from ..quantize import attach_static_ascale, load_ascales, quantize_transformer_int8

    for m in models.values():
        if args.fuse_qkv:
            fuse_qkv_projections(m)
        if args.int8:
            quantize_transformer_int8(m, free_source=True)
    if args.int8 and args.int8_scales:
        scales = load_ascales(args.int8_scales)
        for k, m in models.items():
            if k in scales:
                attach_static_ascale(m, scales[k])
    elif args.int8 and args.int8_ascale:
        for m in models.values():
            attach_static_ascale(m, args.int8_ascale)
    gc.collect()
    return models


def use_flash_mode(args):
    return "int8pv" if args.int8_pv else "int8" if args.int8_attn else (not args.tiny)


def make_step(transformer, branch, inp: Dict, use_flash, seq_cfg: bool) -> Callable:
    """step(latents, t) -> latents: the JAX bench's denoise step on `inp`
    (`gate_int8_flagship.gate_inputs`' keys)."""
    def forward(latents, masked, image_latents, mask, embeds_b, ts):
        model_in = torch.cat([latents, image_latents], dim=-1)
        cond = torch.cat([masked, mask[..., None]], dim=-1)
        samples = branch(latents, embeds_b, cond, ts, rope=inp["rope"], use_flash=use_flash)
        return transformer(model_in, embeds_b, ts, rope=inp["rope"],
                           branch_block_samples=samples, branch_block_masks=mask,
                           use_flash=use_flash).sample

    masked, image, mask, embeds = (inp["masked"], inp["image_latents"], inp["mask"],
                                   inp["embeds"])
    b = masked.shape[0]

    @torch.no_grad()
    def batched(latents, t):
        two = lambda x: torch.cat([x, x], dim=0)
        ts = torch.full((2 * b,), t, dtype=torch.long, device=latents.device)
        out = forward(two(latents), two(masked), two(image), two(mask), embeds, ts)
        u, c = out.float().chunk(2, dim=0)
        pred = u + 6.0 * (c - u)
        return (latents.float() * 0.99 - 0.01 * pred).to(latents.dtype)

    @torch.no_grad()
    def sequential(latents, t):
        ts = torch.full((b,), t, dtype=torch.long, device=latents.device)
        u = forward(latents, masked, image, mask, embeds[:b], ts)
        c = forward(latents, masked, image, mask, embeds[b:], ts)
        return combine(latents, u, c)

    return sequential if seq_cfg else batched


def build_vae(device: torch.device, seed: int = 3):
    """The default VAE with tiling, seeded random bf16 weights."""
    from ..models import AutoencoderKLCogVideoX
    vae = AutoencoderKLCogVideoX(VAEConfig(), device="meta", dtype=torch.bfloat16)
    vae = vae.to_empty(device=device).init_random_(
        torch.Generator(device=device).manual_seed(seed))
    vae.enable_tiling()
    return vae


def _randn(shape, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def measure_rung(models: Dict, inp: Dict, args, *,
                 build_vae: Optional[Callable[[], torch.nn.Module]] = None,
                 argv=None) -> Dict:
    """One rung on built models ({"transformer", "branch"}, with `args`'
    options applied) and `inp`: the result line. The launch counts are zeroed
    at the start. With the VAE leg (`build_vae` given, neither `--skip-vae`
    nor `--tiny`), `models` and `inp` are emptied to free the DiT first."""
    transformer, branch = models["transformer"], models["branch"]
    tcfg = transformer.cfg
    device = inp["latents"].device
    full_layers = tcfg.num_layers if args.tiny else FULL_LAYERS
    step = make_step(transformer, branch, inp, use_flash_mode(args), args.seq_cfg)
    del transformer, branch
    gates.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with gates.Timer(device) as tm:
        cur = step(inp["latents"], 500)
    first_step_s = tm.s
    reps = 2 if args.tiny else 3
    with gates.Timer(device) as tm:
        for i in range(reps):
            cur = step(cur, 500 - i)
    step_s = tm.s / reps
    full_step_s = step_s * (full_layers + 2) / (tcfg.num_layers + 2)

    n_skip, cached_s = 0, 0.0
    if args.skip_spec:
        from ..pipelines.common import parse_skip_steps
        n_skip = len(parse_skip_steps(args.skip_spec, args.steps))
        u, c = _randn(cur.shape, 5, device), _randn(cur.shape, 6, device)
        combine(cur, u, c)
        with gates.Timer(device) as tm:
            x = cur
            for _ in range(10):
                x = combine(x, u, c)
        cached_s = tm.s / 10
    launches = gates.launches()

    decode_s = 0.0
    if build_vae is not None and not args.skip_vae and not args.tiny:
        del step, cur
        models.clear()
        inp.clear()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        vae = build_vae()
        z = _randn(VAE_LATENT, 4, device)
        vae.decode(z)
        with gates.Timer(device) as tm:
            vae.decode(z)
        decode_s = tm.s
        del vae

    clip_s = (args.steps - n_skip) * full_step_s + n_skip * cached_s + decode_s
    return {
        "metric": METRIC, "value": 60.0 / clip_s, "unit": UNIT, "vs_baseline": None,
        "detail": {
            "step_ms_measured": step_s * 1e3,
            "layers_measured": tcfg.num_layers,
            "cfg_mode": "sequential" if args.seq_cfg else "batched",
            "int8": args.int8, "int8_attn": args.int8_attn,
            "int8_scales": os.path.basename(args.int8_scales) if args.int8_scales else None,
            "skip_spec": args.skip_spec,
            "skipped_steps": n_skip or None,
            "cached_step_ms": cached_s * 1e3 if n_skip else None,
            "step_ms_extrapolated_42L": full_step_s * 1e3,
            "vae_decode_s": decode_s,
            "vae_decode_fps": 49.0 / decode_s if decode_s else None,
            "clip_s": clip_s,
            "first_step_s": first_step_s,
            "peak_memory_gib": gates.peak_memory_gib(device),
            "launches": launches,
            "environment": gates.environment(device, argv),
        },
    }


# -- the quality-gated headline ----------------------------------------------------------------

def gated_serving_rungs(root) -> Tuple[List[Tuple[str, List[str]]], Dict]:
    """Serving rungs whose quality gate is on record under `root`, fastest
    first, and a note of what was read.

    The JAX bench's rule (`bench.py:109-226`) on the port's artifacts
    (`GATE_int8_cuda.json`, `calib_ascales_cuda.npz`, `GATE_skip_cuda.json`):
    int8 is eligible when its latent PSNR against bf16 and, when recorded,
    its pixel PSNR clear 35 dB; static scales when theirs does too and the
    scales file exists; a skip schedule when the skip gate ran on
    int8+ascale and the schedule clears 35 dB in latent and pixel PSNR, its
    LPIPS stays under the white-noise control's, every robustness config of
    it clears the bar, and it skips no more steps than the robustness-gated
    schedule. The most skipping eligible schedule leads. ADVICE.md's two
    findings on that rule are applied: a robustness config whose pixel PSNR
    is recorded below 35 dB disqualifies its schedule, and a robustness
    section whose schedule is not among `schedules` drops the skip rung and
    records `skip_gate_error`. No artifact or no gate passed: [] (bf16 is
    the headline; an ungated quantized mode never is)."""
    root = Path(root)
    min_db = gates.MIN_PSNR_DB
    scales_path = root / SCALES
    try:
        gate = gates.read_artifact(root / GATE_INT8)
    except FileNotFoundError:
        return [], {"status": "missing", "note": f"{GATE_INT8} absent: bf16 headline"}
    except (OSError, ValueError) as e:   # a malformed artifact never headlines int8
        return [], {"status": "unreadable",
                    "note": f"{GATE_INT8} unreadable ({e!r}): bf16 headline; regenerate "
                            "with tools.gate_int8_flagship"}
    latent = gate.get("latent", {}).get("psnr_db", 0.0)
    pixel = gate.get("pixel", {}).get("psnr_db")
    info = {"status": "ok", "path": GATE_INT8, "steps": gate.get("steps"),
            "layers": gate.get("layers"), "latent_psnr_db": latent, "pixel_psnr_db": pixel,
            "min_psnr_db": min_db}
    int8_ok = latent >= min_db and (pixel is None or pixel >= min_db)
    sa_psnr = (gate.get("static_ascale") or {}).get("latent_psnr_vs_bf16_db", 0.0)
    ascale_ok = int8_ok and sa_psnr >= min_db and scales_path.exists()
    rungs = []
    if ascale_ok:
        try:
            best = _best_skip_schedule(gates.read_artifact(root / GATE_SKIP), min_db)
            if best:
                spec, entry, pix, rob, anchor = best
                info["skip_gate"] = {"path": GATE_SKIP, "schedule": spec,
                                     "skipped_steps": entry.get("skipped_steps"),
                                     "latent_psnr_db": entry.get("latent_psnr_vs_bf16_db"),
                                     "pixel_psnr_db": pix}
                if "lpips_vs_bf16" in entry:
                    info["skip_gate"]["lpips_vs_bf16"] = entry["lpips_vs_bf16"]
                    info["skip_gate"]["lpips_noise35_control"] = anchor.get("lpips")
                if rob.get("schedule") == spec and rob.get("configs"):
                    info["skip_gate"]["robustness_min_latent_psnr_db"] = min(
                        r.get("latent_psnr_vs_bf16_db", 0.0) for r in rob["configs"])
                rungs.append(("int8_ascale_skip_42L",
                              ["--layers", "42", "--int8", "--int8-attn", "--int8-scales",
                               str(scales_path), "--skip-spec", spec]))
        except FileNotFoundError:
            pass   # no skip gate on record: int8+ascale stays the fastest rung
        except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
            # a malformed gate must not drop the rung quietly
            info["skip_gate_error"] = repr(e)
    if ascale_ok:
        info["static_ascale_psnr_db"] = sa_psnr
        rungs.append(("int8_ascale_serving_42L",
                      ["--layers", "42", "--int8", "--int8-attn", "--int8-scales",
                       str(scales_path)]))
    if int8_ok:
        rungs.append(("int8_serving_42L", ["--layers", "42", "--int8", "--int8-attn"]))
    if not rungs:
        info["status"] = "gate below threshold"
    return rungs, info


def _best_skip_schedule(sgate: Dict, min_db: float):
    """(spec, entry, pixel dB, robustness, anchor) of the eligible schedule
    that skips most, or None; raises on a robustness schedule that is not
    among the schedules."""
    if sgate.get("serving_mode") != "int8+ascale":
        return None
    schedules = sgate.get("schedules") or {}
    anchor = sgate.get("perceptual_anchor") or {}
    rob = sgate.get("robustness") or {}
    if rob.get("configs") and rob.get("schedule") not in schedules:
        raise ValueError(f"robustness schedule {rob.get('schedule')!r} is not among the "
                         f"schedules {sorted(schedules)}")
    best = None
    for spec, e in schedules.items():
        pix = e.get("pixel_psnr_db")
        if pix is None and (sgate.get("pixel") or {}).get("schedule") == spec:
            pix = sgate["pixel"].get("psnr_db")
        if "lpips_vs_bf16" in e and "lpips" in anchor and e["lpips_vs_bf16"] > anchor["lpips"]:
            continue
        if rob.get("schedule") == spec and any(
                r.get("latent_psnr_vs_bf16_db", 0.0) < min_db
                or (r.get("pixel_psnr_db") is not None and r["pixel_psnr_db"] < min_db)
                for r in rob.get("configs", [])):
            continue
        if rob.get("configs") and \
                e["skipped_steps"] > schedules[rob["schedule"]]["skipped_steps"]:
            continue
        if (e.get("latent_psnr_vs_bf16_db", 0.0) >= min_db and pix is not None
                and pix >= min_db
                and (best is None or e["skipped_steps"] > best[1]["skipped_steps"])):
            best = (spec, e, pix)
    return None if best is None else (*best, rob, anchor)


# -- the auto ladder -----------------------------------------------------------------------------

PROBE = ("import torch; assert torch.cuda.is_available(), 'no CUDA device'; "
         "print('OK', torch.cuda.get_device_name(0))")


def _link_baseline(headline: Dict, headline_name: str) -> None:
    """vs_baseline of the headline and of each attached mode: clips/min over
    the bf16_parity_mode's (the headline's own when it is that rung)."""
    d = headline["detail"]
    base = (headline["value"] if headline_name == "bf16_batched_42L"
            else (d.get("bf16_parity_mode") or {}).get("clips_per_min_per_chip"))
    headline["vs_baseline"] = headline["value"] / base if base else None
    for key in MODES:
        if key in d:
            d[key]["vs_baseline"] = d[key]["clips_per_min_per_chip"] / base if base else None


def auto_main(args) -> int:
    """The ladder: probe, headline, comparison rungs (see the module note)."""
    t_start = time.time()
    rung_log: List[Dict] = []

    def remaining():
        return args.budget - (time.time() - t_start)

    try:
        probe = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                               timeout=min(600.0, args.budget))
        probe_err, probe_ok = probe.stderr[-800:], probe.returncode == 0 and "OK" in probe.stdout
    except subprocess.TimeoutExpired:
        probe_err, probe_ok = "backend probe timed out", False
    if not probe_ok:
        gates.emit({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": None,
                    "error": "cuda unavailable: the backend probe failed",
                    "detail": {"probe_stderr": probe_err}})
        return 1

    def run_rung(name, extra, timeout):
        argv = (["--steps", str(args.steps), "--device", args.device] + extra
                + (["--skip-vae"] if args.skip_vae else [])
                + (["--fuse-qkv"] if args.fuse_qkv else []))
        t0 = time.time()
        out, failure = gates.run_module_rung("videopainter_tpu_torch.tools.bench", argv,
                                             timeout)
        rung_log.append({"rung": name, **failure, "wall_s": time.time() - t0,
                         "ok": out is not None})
        return out

    gated, gate_info = gated_serving_rungs(gates.REPO)
    # the rungs run from the root of the checkout: its files by their relative paths
    gated = [(name, [os.path.relpath(a, gates.REPO) if os.path.isabs(a) else a for a in extra])
             for name, extra in gated]
    ladder = gated + [("bf16_batched_42L", ["--layers", "42"]),
                      ("bf16_seqcfg_42L", ["--layers", "42", "--seq-cfg"]),
                      ("bf16_21L", ["--layers", "21"]), ("bf16_8L", ["--layers", "8"]),
                      ("bf16_4L", ["--layers", "4"])]
    headline = headline_name = None
    for name, extra in ladder:
        headline = run_rung(name, extra, timeout=max(remaining(), 600.0))
        if headline:
            headline_name = name
            break
        if remaining() < 300:
            break
    if headline is None:
        gates.emit({"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": None,
                    "error": "all bench ladder rungs failed within budget",
                    "detail": {"rungs": rung_log}})
        return 1
    d = headline["detail"]
    d["headline_rung"] = headline_name
    if headline_name == "int8_ascale_skip_42L":
        d["serving_config"] = (SERVING_NOTE + f" + static calibrated activation scales "
                               f"({SCALES}) + step-skip cache ({GATE_SKIP})")
    elif headline_name == "int8_ascale_serving_42L":
        d["serving_config"] = SERVING_NOTE + f" + static calibrated activation scales ({SCALES})"
    elif headline_name == "int8_serving_42L":
        d["serving_config"] = SERVING_NOTE
    d["quality_gate"] = gate_info
    d["rungs"] = rung_log
    vae_s = d.get("vae_decode_s") or 0.0
    if headline_name == "int8_ascale_skip_42L":
        # the same measured step with no step skipped is the int8+ascale mode
        clip = args.steps * d["step_ms_measured"] / 1e3 + vae_s
        d["int8_static_ascale_mode"] = {
            "step_ms_measured": d["step_ms_measured"], "layers_measured": d["layers_measured"],
            "cfg_mode": d["cfg_mode"], "clips_per_min_per_chip": 60.0 / clip,
            "note": "the skip rung's measured step, all 50 steps evaluated (derived)"}
    _link_baseline(headline, headline_name)
    gates.emit(headline)   # the headline is on record now

    def attach(key, name, extra, note):
        if remaining() < ATTACH_EST_S:
            rung_log.append({"rung": name, "ok": False, "skipped": "budget exhausted"})
            return
        fast = run_rung(name, ["--layers", "42", "--skip-vae"] + extra, timeout=remaining())
        if fast:
            fd = fast["detail"]
            clip = args.steps * fd["step_ms_measured"] / 1e3 + vae_s
            d[key] = {"step_ms_measured": fd["step_ms_measured"],
                      "layers_measured": fd["layers_measured"], "cfg_mode": fd["cfg_mode"],
                      "clips_per_min_per_chip": 60.0 / clip,
                      "peak_memory_gib": fd.get("peak_memory_gib"),
                      "launches": fd.get("launches"), "note": note}
        _link_baseline(headline, headline_name)
        gates.emit(headline)

    if headline_name in ("int8_ascale_skip_42L", "int8_ascale_serving_42L",
                         "int8_serving_42L"):
        attach("bf16_parity_mode", "bf16_batched_42L", [],
               "full-precision bf16 path (golden-parity mode)")
        attach("int8_proj_only_mode", "int8_proj_42L", ["--int8"],
               "W8A8 projections with bf16 attention")
        if headline_name != "int8_serving_42L":
            attach("int8_dynamic_mode", "int8_serving_42L", ["--int8", "--int8-attn"],
                   "the serving config with per-token dynamic activation quantization")
        else:
            attach("int8_static_ascale_mode", "int8_ascale_42L",
                   ["--int8", "--int8-attn", "--int8-ascale", "0.02"],
                   "the serving config with a uniform static activation scale (perf A/B; "
                   "the graph is that of calibrated scales)")
    else:
        attach("int8_full_fast_mode", "int8_serving_42L", ["--int8", "--int8-attn"],
               SERVING_NOTE + " (no gate on record: a comparison, never the headline)")
    d["total_wall_s"] = time.time() - t_start
    gates.emit(headline)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.layers == 0 and not args.tiny:
        return auto_main(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics(conv_tf32=True)
    tcfg = model_config(args)
    transformer, branch = build_models(
        torch.Generator(device=device).manual_seed(gates.WEIGHTS_SEED), device=device,
        tcfg=tcfg)
    models = apply_options({"transformer": transformer, "branch": branch}, args)
    del transformer, branch
    inp = gate_inputs(torch.Generator(device=device).manual_seed(2), tcfg,
                      SMOKE_LATENT if args.tiny else FLAGSHIP_LATENT, rect_mask=False)
    result = measure_rung(models, inp, args, build_vae=lambda: build_vae(device), argv=argv)
    gates.check_finite(result)
    gates.emit(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
