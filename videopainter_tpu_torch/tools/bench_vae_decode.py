"""Tiled VAE decode on the card over (tile size, latent frame batch) combos.

Counterpart of the JAX package's `tools/bench_vae_decode.py`. The default
decode mirrors the reference (240 x 360-pixel tiles, 2 latent frames a
batch: autoencoder_kl_cogvideox.py:1144-1158, :1279): 3 x 3 tiles whose
overlaps recompute 2.25 x the pixels. Each combo (`COMBOS`, set through
`enable_tiling(tile_sample_min_height, tile_sample_min_width)` and
`num_latent_frames_batch_size`) decodes the seeded 1 x 13 x 60 x 90 x 16
latent ([B, T, h, w, C]) once warm and once timed with the default VAE's
seeded random weights: seconds, frames per second (4 T - 3 frames), and the
PSNR against the default combo over the common top-left crop with range 4
(outputs in about [-1, 1]; tile seams blend differently, so outputs are
close, not equal). A tile larger than the sample overshoots it, and an even
latent count decodes to a frame count that depends on the frame batch (the
reference's tiled decode has no final crop, :1354-1356): the output's shape
is recorded, and the PSNR taken over the common frames too. The fastest combo is printed last. This tool changes no
default.

    python -m videopainter_tpu_torch.tools.bench_vae_decode [--frames 13] [--combos N]
    python -m videopainter_tpu_torch.tools.bench_vae_decode --smoke   # tiny VAE, CPU

It runs on the card; `--smoke` (VAEConfig.tiny, a 3 x 8 x 12 latent, on the
CPU) and `--device cpu` are its only CPU routes.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, set_numerics
from ..config import VAEConfig
from . import gates

# (name, tile_sample_min_height, tile_sample_min_width, latent frame batch); None tiles
# are the VAE's default (half the sample size: 240 x 360 at 480 x 720)
COMBOS = [("default 240x360 fbs2", None, None, 2),
          ("240x360 fbs4", None, None, 4),
          ("320x480 fbs2", 320, 480, 2),
          ("320x480 fbs4", 320, 480, 4),
          ("480x360 fbs2", 480, 360, 2),
          ("240x360 fbs7", None, None, 7)]
# the smoke's tiny VAE (64 x 96 samples): the default tiles are 32 x 48
SMOKE_COMBOS = [("default 32x48 fbs2", None, None, 2), ("32x32 fbs1", 32, 32, 1)]


def set_combo(vae, tile_h: Optional[int], tile_w: Optional[int], fbs: int) -> None:
    """Tiling at (tile_h, tile_w) sample pixels (None: the VAE's default)
    and `fbs` latent frames a decode batch."""
    vae.enable_tiling(tile_sample_min_height=tile_h or vae.cfg.sample_height // 2,
                      tile_sample_min_width=tile_w or vae.cfg.sample_width // 2)
    vae.num_latent_frames_batch_size = fbs


def psnr_range4(got: np.ndarray, ref: np.ndarray) -> Optional[float]:
    """PSNR over range 4 on the common leading frames and top-left crop;
    None when identical."""
    t, h, w = (min(got.shape[i], ref.shape[i]) for i in (1, 2, 3))
    mse = float(np.mean((got[:, :t, :h, :w].astype(np.float64)
                         - ref[:, :t, :h, :w].astype(np.float64)) ** 2))
    return 10 * math.log10(4.0 / mse) if mse > 0 else None


@torch.no_grad()
def sweep(vae, z: torch.Tensor, combos: Sequence[Tuple[str, Optional[int], Optional[int], int]]
          ) -> Dict:
    """Each combo's decode on `vae` (its tiling set in place): {"rows":
    [{"config", "decode_s", "fps", "psnr_vs_default"} or {"config", "error"}],
    "best": the fastest row}. The first combo is the PSNR reference."""
    device = z.device
    frames = 4 * z.shape[1] - 3
    ref, rows = None, []
    for name, th, tw, fbs in combos:
        set_combo(vae, th, tw, fbs)
        try:
            vae.decode(z)
            with gates.Timer(device) as tm:
                y = vae.decode(z)
        except torch.OutOfMemoryError as e:   # record it and go on
            rows.append({"config": name, "error": str(e)[:200]})
            gates.emit(rows[-1])
            continue
        yf = y.float().cpu().numpy()
        del y
        row = {"config": name, "decode_s": tm.s, "fps": frames / tm.s,
               "out_shape": list(yf.shape)}
        if ref is None:
            ref = yf
            row["psnr_vs_default"], row["identical"] = None, True
        else:
            row["psnr_vs_default"] = psnr_range4(yf, ref)
            if row["psnr_vs_default"] is None:
                row["identical"] = True
        rows.append(row)
        gates.emit(row)
    timed = [r for r in rows if "decode_s" in r]
    return {"rows": rows, "best": min(timed, key=lambda r: r["decode_s"]) if timed else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=13, help="latent frames")
    ap.add_argument("--combos", type=int, default=len(COMBOS), help="the first N combos")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="tiny VAE, on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.device = "cpu"
    device = resolve_device(args.device)
    if device.type == "cuda":
        set_numerics(conv_tf32=True)
        torch.cuda.reset_peak_memory_stats(device)
    from .bench import build_vae
    if args.smoke:
        from ..models import AutoencoderKLCogVideoX
        cfg = VAEConfig.tiny()
        vae = AutoencoderKLCogVideoX(cfg).init_random_(
            torch.Generator(device=device).manual_seed(3))
        z = torch.randn((1, 3, 8, 12, cfg.latent_channels),
                        generator=torch.Generator(device=device).manual_seed(4))
        combos = SMOKE_COMBOS
    else:
        vae = build_vae(device)
        z = torch.randn((1, args.frames, 60, 90, vae.cfg.latent_channels),
                        generator=torch.Generator(device=device).manual_seed(4),
                        device=device).to(torch.bfloat16)
        combos = COMBOS[:args.combos]
    result = sweep(vae, z, combos)
    result["latent"] = list(z.shape)
    gates.finish(result, device, argv)
    gates.emit(result)
    gates.emit({"best": result["best"]})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
