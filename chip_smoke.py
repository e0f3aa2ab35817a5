#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # everything below, on one card

Phases (each fails the run loudly, exit code != 0):
 0. build the hand-written kernel from `videopainter_tpu_torch/csrc/`
    and print ptxas' report;
 1. hold each kernel against its plain PyTorch version on the card: small
    ragged shapes, kv_len, the paged mask, the logsumexp, and the flagship
    shape the main path gives it, where the kernel, its plain version and
    the PyTorch library call computing the same function are timed;
 2. the main path at full CogVideoX-5b-I2V width: the flagship dual-stream
    inpaint pipeline (42-layer DiT, 2-layer branch, default VAE) with seeded
    random bf16 weights, on a 49x480x720 clip, CFG 6 with dynamic CFG,
    replace_gt, mask_add, use_flash, 2 DPM steps, then the VAE decode; the
    launch counts are zeroed just before the call and read just after;
 3. the same pipeline at a small size, kernel path against the exact
    attention path on the card.

Prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero without a result when CUDA
is missing or the port's package is not beside this script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet, SXM)
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s
FLASH_REL_TOL = 2.0 ** -6   # |kernel - plain| over max|plain|: two bf16 ulps at the
                            # largest output (both round it to bf16; the kernel also
                            # rounds P to bf16 before P.V). With N(0,1) inputs the
                            # outputs are far below 1 (about 0.012 rms at 17,776 keys),
                            # so an absolute limit would not scale with them.
LSE_TOL = 1e-3             # same fp32 scores, another summation order
SMALL_PSNR_DB = 30.0       # kernel path vs exact-attention path, bf16, 2 steps


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(b, h, s_q, n_keys, d):
    """Least time for one call and what sets it: its tensor-core operations
    over the bf16 peak, or its bytes (q, k, v read once, o written once)
    over the HBM rate, whichever is larger. n_keys = the keys the mask keeps."""
    ops_ms = 4.0 * b * h * s_q * n_keys * d / H100_BF16_FLOPS * 1e3
    bytes_ms = 2.0 * b * h * d * (2 * s_q + 2 * n_keys) / H100_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def flash_err(out, ref):
    """(max |out - ref|, its limit FLASH_REL_TOL * max |ref|)."""
    import torch
    torch.cuda.synchronize()
    ref = ref.float()
    err = (out.float() - ref).abs().max().item()
    return err, FLASH_REL_TOL * ref.abs().max().item()


def phase_kernels(torch, fa):
    """Phase 1: flash_fwd against flash_attention_reference on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, h, s_q, s_k, d=64, layout="bshd"):
        def mk(s):
            if layout == "bshd":  # heads split from a [B, S, H*D] projection by a view
                return torch.randn((b, s, h, d), generator=gen, device="cuda",
                                   dtype=torch.float32).to(torch.bfloat16).transpose(1, 2)
            return torch.randn((b, h, s, d), generator=gen, device="cuda",
                               dtype=torch.float32).to(torch.bfloat16)
        return mk(s_q), mk(s_k), mk(s_k)

    cases = [("ragged 129x1111", dict(b=2, h=3, s_q=129, s_k=1111, layout="bhsd"), {}),
             ("kv_len 513 of 700", dict(b=1, h=4, s_q=300, s_k=700), dict(kv_len=513)),
             ("paged 2x400, kv_len 333", dict(b=2, h=2, s_q=257, s_k=800),
              dict(kv_len=333, kv_page_len=400)),
             ("with_lse 200x300", dict(b=2, h=2, s_q=200, s_k=300), dict(lse=True))]
    worst = 0.0
    for name, shp, kw in cases:
        q, k, v = qkv(**shp)
        lse = kw.pop("lse", False)
        out, l_k = fa.flash_fwd_cuda(q, k, v, 64 ** -0.5, kw.get("kv_len", k.shape[2]),
                                     kw.get("kv_page_len"), lse)
        ref, l_r = fa.flash_attention_reference(q, k, v, 64 ** -0.5, with_lse=True, **kw)
        err, tol = flash_err(out, ref)
        msg = f"flash_fwd {name}: max_abs_err {err:.3e} (tol {tol:.3e})"
        if lse:
            lerr = (l_k - l_r).abs().max().item()
            msg += f", lse max_abs_err {lerr:.3e} (tol {LSE_TOL})"
            if not lerr <= LSE_TOL:
                raise AssertionError(msg)
        log(msg)
        if not err <= tol:
            raise AssertionError(msg)
        worst = max(worst, err)

    # the flagship call as the main path makes it: CFG batch 2 x 48 heads,
    # 226 + 17,550 tokens, d = 64, heads as strided views of [B, S, H, D]
    b, h, s, d = 2, 48, 17776, 64
    q, k, v = qkv(b, h, s, s)
    out, _ = fa.flash_fwd_cuda(q, k, v, d ** -0.5, s, None, False)
    ref = fa.flash_attention_reference(q, k, v, d ** -0.5)
    err, tol = flash_err(out, ref)
    finite = bool(torch.isfinite(out).all())
    log(f"flash_fwd flagship [{b}x{h}, {s}, {d}] bf16: max_abs_err {err:.3e} "
        f"(tol {tol:.3e}), finite {finite}")
    if not (err <= tol and finite):
        raise AssertionError("flash_fwd disagrees with its plain version at the flagship shape")
    worst = max(worst, err)
    del ref
    ms = cuda_time_ms(lambda: fa.flash_fwd_cuda(q, k, v, d ** -0.5, s, None, False), 10)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_reference(q, k, v, d ** -0.5), 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_time_ms(lambda: sdpa(q, k, v), 10)
    bound, bound_by = flash_bound_ms(b, h, s, s, d)
    log(f"flash_fwd flagship: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"sdpa {library_ms:.3f} ms, bound {bound:.3f} ms ({bound_by}); "
        f"{4.0 * b * h * s * s * d / ms / 1e9:.1f} TFLOP/s")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_by": bound_by}


def phase_pipeline(torch, kernels):
    """Phase 2: the full-width flagship pipeline; returns the launch counts."""
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.flagship import FLAGSHIP_CALL, build_pipeline, random_clip

    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    tcfg = TransformerConfig.cogvideox_5b_i2v()
    pipe = build_pipeline(gen, tcfg=tcfg, branch_layers=2, vcfg=VAEConfig())
    vae = pipe.vae
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.transformer, pipe.branch, vae)
                   for p in m.parameters())
    log(f"full width: {tcfg.num_layers}-layer DiT, 2-layer branch, "
        f"{tcfg.num_attention_heads}x{tcfg.attention_head_dim} heads, VAE "
        f"{VAEConfig().block_out_channels}; {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")
    f, hgt, wid = 49, 480, 720
    clip = random_clip(gen, frames=f, height=hgt, width=wid)

    stamps = {}
    enc_s, dec_s = [], []

    def timed(fn, bucket):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            bucket.append(time.perf_counter() - s)
            return r
        return run

    vae.encode = timed(vae.encode, enc_s)
    vae.decode = timed(vae.decode, dec_s)

    def progress(i, n):
        torch.cuda.synchronize()
        stamps[i] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    start = time.perf_counter()
    out = pipe(**clip, num_inference_steps=2, generator=gen, output_type="pt",
               progress_fn=progress, **FLAGSHIP_CALL)
    torch.cuda.synchronize()
    total = time.perf_counter() - start
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    expected = (tcfg.num_layers + 2) * 2
    shape_ok = tuple(out.shape) == (1, f, hgt, wid, 3)
    finite = bool(torch.isfinite(out).all())
    denoise_start = start + sum(enc_s)
    steps = [stamps[1] - denoise_start, stamps[2] - stamps[1]]
    log(f"pipeline: out {tuple(out.shape)} finite {finite}; flash_fwd launches "
        f"{launches['flash_fwd']} (expected {expected} = 44 layers x 2 steps)")
    log(f"pipeline wall times: VAE encode {sum(enc_s):.3f} s ({len(enc_s)} calls: "
        + ", ".join(f"{x:.3f}" for x in enc_s) + f"), denoise step 1 {steps[0]:.3f} s, "
        f"step 2 {steps[1]:.3f} s, VAE decode {sum(dec_s):.3f} s, total {total:.3f} s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    if not (shape_ok and finite):
        raise AssertionError(f"pipeline output {tuple(out.shape)} finite={finite}")
    if launches["flash_fwd"] != expected:
        raise AssertionError(f"flash_fwd launched {launches['flash_fwd']} times, "
                             f"expected {expected}")
    return launches


def phase_small(torch):
    """Phase 3: a small pipeline (head dim 64) on the card, the kernel path
    against the exact-attention path on the same weights and noise."""
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.flagship import FLAGSHIP_CALL, build_pipeline, random_clip

    gen = torch.Generator(device="cuda").manual_seed(7)
    tcfg = TransformerConfig.tiny(in_channels=32, out_channels=16, attention_head_dim=64,
                                  sample_height=8, sample_width=12)
    pipe = build_pipeline(gen, tcfg=tcfg, vcfg=VAEConfig.tiny(latent_channels=16))
    clip = random_clip(gen, frames=9, height=64, width=96, text_len=5, text_dim=12)
    noise = torch.randn((1, 3, 8, 12, 16), generator=gen, device="cuda")
    dpm = torch.randn((2, 1, 3, 8, 12, 16), generator=gen, device="cuda")
    outs = {}
    for flash in (True, False):
        kw = dict(FLAGSHIP_CALL, use_flash=flash)
        outs[flash] = pipe(**clip, num_inference_steps=2, vae_sample_mode="mode",
                           init_noise=noise, dpm_noises=dpm, output_type="pt", **kw).float()
    mse = (outs[True] - outs[False]).square().mean().item()
    psnr = 10 * math.log10(4.0 / max(mse, 1e-20))  # range [-1, 1]
    finite = bool(torch.isfinite(outs[True]).all())
    log(f"small pipeline: kernel path vs exact path PSNR {psnr:.1f} dB "
        f"(min {SMALL_PSNR_DB}), finite {finite}")
    if not (finite and psnr >= SMALL_PSNR_DB):
        raise AssertionError("small pipeline: kernel path disagrees with the exact path")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import videopainter_tpu_torch as vp
        from videopainter_tpu_torch import _kernels as kernels
        from videopainter_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this script: {e}",
              file=sys.stderr)
        return 2
    vp.set_numerics(conv_tf32=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    kernels.load("flash_fwd.cu", fa._SIGNATURES)
    log(f"built kernels in {time.perf_counter() - t:.1f} s")
    for src, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")

    stats = phase_kernels(torch, fa)
    launches = phase_pipeline(torch, kernels)
    phase_small(torch)

    row = {"name": "flash_fwd", "route": "cuda",
           "source": "videopainter_tpu_torch/csrc/flash_fwd.cu",
           "replaces": "videopainter_tpu/ops/flash_attention.py:68",
           "launches": launches["flash_fwd"], "max_abs_err": stats["max_abs_err"],
           **stats}
    print(json.dumps({"kernels": [row]}), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"nvidia-smi unavailable: {e}"
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
