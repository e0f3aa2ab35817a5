"""Block-size sweep of the int8 flash attention entry point on the card.

Counterpart of the JAX package's `tools/sweep_int8_blocks.py`. Times
`ops.flash_attention_int8.flash_attention_int8` (B4, `csrc/flash_int8_wgmma.cu`,
with its quantization prologue: the K mean and the per-block scales, which
the denoise step pays too) at each (blk_q, blk_k) quantization block pair,
against the bf16 flash kernel (B1, `ops.flash_attention.flash_attention`)
on the same seeded operands [1, bh, seq, 64]: ms, TOP/s (4 bh seq^2 64
operations a call), the ratio to B1 and the relative L1 against B1's output.
`--pv` also sweeps the int8 P.V mode. Every candidate is a multiple of B4's
128-row / 128-key tiles; a block its tiles do not divide raises ValueError,
printed as FAILED. This tool changes no default.

    python -m videopainter_tpu_torch.tools.sweep_int8_blocks [--iters 10] [--pv]
    python -m videopainter_tpu_torch.tools.sweep_int8_blocks --smoke   # CPU, 256 tokens

It runs on the card; `--smoke` (2 heads of 256 tokens, blocks 128 x 256, on
the CPU, where B4 runs its plain version) and `--device cpu` are its only CPU
routes.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.flash_attention import flash_attention
from ..ops.flash_attention_int8 import flash_attention_int8
from . import gates

CANDIDATES = [(512, 2048), (1024, 2048), (512, 4096), (1024, 4096), (2048, 2048),
              (256, 4096)]
SMOKE_CANDIDATES = [(128, 256)]
SMOKE_SHAPE = dict(bh=2, seq=256)


def timeit(fn: Callable[[], torch.Tensor], iters: int, device: torch.device) -> float:
    """Mean seconds of `fn` over `iters` calls after one warm call, the
    device synchronised around them."""
    fn()
    with gates.Timer(device) as tm:
        for _ in range(iters):
            fn()
    return tm.s / iters


def operands(bh: int, seq: int, device: torch.device, seed: int = 0,
             dtype=torch.bfloat16) -> Tuple[torch.Tensor, ...]:
    """q, k, v [1, bh, seq, 64], N(0, 0.5^2), from a numpy seed (as the JAX tool)."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(1, bh, seq, 64).astype(np.float32) * 0.5)
                 .to(device, dtype) for _ in range(3))


def rel_l1(out: torch.Tensor, ref: torch.Tensor) -> float:
    o, r = out.double(), ref.double()
    return float((o - r).abs().mean() / (r.abs().mean() + 1e-9))


def sweep(q, k, v, candidates: Sequence[Tuple[int, int]], modes: Sequence[bool], iters: int
          ) -> Dict:
    """{"bf16": {"ms", "tops"}, "rows": [{"mode", "blk_q", "blk_k", "ms", "tops",
    "x_bf16", "rel_l1"} or {..., "failed"}], "best": {mode: the fastest row}}."""
    device = q.device
    ops = 4.0 * q.shape[1] * q.shape[2] * k.shape[2] * q.shape[3]
    with torch.no_grad():
        t0 = timeit(lambda: flash_attention(q, k, v), iters, device)
        ref = flash_attention(q, k, v).float()
        print(f"bf16 B1                  : {t0 * 1e3:8.3f} ms  {ops / t0 / 1e12:6.1f} TFLOP/s",
              flush=True)
        rows: List[Dict] = []
        for int8_pv in modes:
            tag = "int8-qk-pv" if int8_pv else "int8-qk   "
            for bq, bk in candidates:
                row = {"mode": "int8pv" if int8_pv else "int8", "blk_q": bq, "blk_k": bk}
                fn = lambda: flash_attention_int8(q, k, v, blk_q=bq, blk_k=bk, int8_pv=int8_pv)
                try:
                    t = timeit(fn, iters, device)
                except ValueError as e:
                    row["failed"] = f"{type(e).__name__}: {str(e)[:120]}"
                    print(f"{tag} {bq}x{bk}: FAILED ({row['failed']})", flush=True)
                    rows.append(row)
                    continue
                row.update(ms=t * 1e3, tops=ops / t / 1e12, x_bf16=t0 / t,
                           rel_l1=rel_l1(fn().float(), ref))
                print(f"{tag} {bq}x{bk}: {row['ms']:8.3f} ms  {row['tops']:6.1f} TOP/s  "
                      f"({row['x_bf16']:.2f}x bf16)  rel-L1 {row['rel_l1']:.4f}", flush=True)
                rows.append(row)
    best = {}
    for row in rows:
        if "ms" in row and (row["mode"] not in best or row["ms"] < best[row["mode"]]["ms"]):
            best[row["mode"]] = row
    return {"bf16": {"ms": t0 * 1e3, "tops": ops / t0 / 1e12}, "rows": rows, "best": best}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bh", type=int, default=48)
    ap.add_argument("--seq", type=int, default=17776)
    ap.add_argument("--pv", action="store_true", help="also sweep int8 P.V")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="2 heads of 256 tokens, blocks 128 x 256, on the CPU")
    args = ap.parse_args(argv)
    candidates = CANDIDATES
    if args.smoke:
        args.device, args.bh, args.seq, args.iters = "cpu", SMOKE_SHAPE["bh"], \
            SMOKE_SHAPE["seq"], 1
        candidates = SMOKE_CANDIDATES
    device = resolve_device(args.device)
    gates.reset_launches()
    q, k, v = operands(args.bh, args.seq, device,
                       dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    result = sweep(q, k, v, candidates, [False] + ([True] if args.pv else []), args.iters)
    result.update(shape=[1, args.bh, args.seq, 64], iters=args.iters)
    gates.finish(result, device, argv)
    for mode, row in result["best"].items():
        print(f"best {mode}: {row['blk_q']}x{row['blk_k']} {row['ms']:.3f} ms", flush=True)
    gates.emit(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
