"""Microbenchmark: int8 (SageAttention-style) flash attention against bf16,
on the card.

Counterpart of the JAX package's `tools/bench_int8_attn.py`. Times the
forward flash kernels at the flagship shape (96 batch-heads x 17,776 tokens x
d = 64 by default) in three variants:

  - bf16:        the bf16 kernel (`ops/flash_attention.py`)
  - int8-qk:     Q / K quantized to int8 per tensor, Q.K^T on the int8 tensor
                 cores, softmax and P.V unchanged (fp32 / bf16)
  - int8-qk-pv:  additionally P quantized to int8 (fixed scale 127, P is in
                 (0, 1]) and V int8, P.V accumulated in int32

The int8 variants run the uniform-scale entry of `csrc/flash_int8_fwd.cu`
(`ops.flash_attention_int8.int8_flash_uniform`). Prints each variant's time
and rate, the int8-qk variant's error against bf16, and the card's name and
power limit.

    python -m videopainter_tpu_torch.tools.bench_int8_attn [--iters 20] [--bh 96] [--seq 17776]
"""

from __future__ import annotations

import argparse

import torch

from .. import card_line
from ..ops.flash_attention import flash_fwd_cuda
from ..ops.flash_attention_int8 import int8_flash_uniform


def quantize_per_tensor(x: torch.Tensor):
    """Symmetric per-tensor int8: (round(x / s) as int8, s = max|x| / 127)."""
    s = x.float().abs().max().item() / 127.0
    return torch.round(x.float() / s).to(torch.int8), s


def time_ms(fn, iters: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bh", type=int, default=96)
    ap.add_argument("--seq", type=int, default=17776)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8_attn needs an NVIDIA GPU")

    bh, s, d = args.bh, args.seq, 64
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda").mul_(0.5)
               .to(torch.bfloat16) for _ in range(3))
    sm_scale = d ** -0.5
    flops = 4.0 * bh * s * s * d   # Q.K^T and P.V

    def report(name, ms, base=None):
        ratio = "" if base is None else f" ({base / ms:.2f}x)"
        print(f"{name:<11}: {ms:8.2f} ms  {flops / ms / 1e9:6.1f} TOP/s{ratio}", flush=True)

    t_bf16 = time_ms(lambda: flash_fwd_cuda(q[None], k[None], v[None], sm_scale, s, None,
                                            False), args.iters)
    report("bf16", t_bf16)

    q_i8, sq = quantize_per_tensor(q)
    k_i8, sk = quantize_per_tensor(k)
    deq = sq * sk
    t_i8 = time_ms(lambda: int8_flash_uniform(q_i8, k_i8, v, sm_scale, deq, s), args.iters)
    report("int8-qk", t_i8, t_bf16)

    v_i8, _ = quantize_per_tensor(v)   # the output stays scaled by v's scale, as in the
    t_pv = time_ms(lambda: int8_flash_uniform(q_i8, k_i8, v_i8, sm_scale, deq, s,   # JAX tool
                                              int8_pv=True), args.iters)
    report("int8-qk-pv", t_pv, t_bf16)

    ref = flash_fwd_cuda(q[None], k[None], v[None], sm_scale, s, None, False)[0][0].float()
    out = int8_flash_uniform(q_i8, k_i8, v, sm_scale, deq, s).float()
    err = ((out - ref).abs().mean() / (ref.abs().mean() + 1e-9)).item()
    cos = torch.nn.functional.cosine_similarity(out.flatten(), ref.flatten(), dim=0).item()
    print(f"int8-qk numerics: rel-L1 {err:.4f}, cos {cos:.6f}")
    print(card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
