#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # everything below, on one card

Phases (each fails the run loudly, exit code != 0):
 0. build the hand-written kernels from `videopainter_tpu_torch/csrc/` (one
    nvcc per source, side by side) and print ptxas' report;
 1. hold each kernel against its plain PyTorch version on the card. The bf16
    flash forward: small ragged shapes, kv_len, the paged mask, the
    logsumexp, and the flagship shape, where the kernel, its plain version
    and the PyTorch library call computing the same function are timed. The
    bf16 flash backward (dQ and dK/dV kernels): ragged shapes, S_q != S_k,
    kv_len, the paged mask with a whole tile masked, strided head views, a
    dO the wrapper has to copy, and the two flagship shapes of a training
    step (17,776 queries with 17,776 and 35,552 keys), timed beside the plain
    version and the library's backward (SDPA forward + backward minus its
    forward). The int8 flash forward: ragged, kv_len, paged, twice the keys, with and
    without int8 P.V, at quantization blocks 128/128 and the defaults, and
    the two flagship shapes (17,776 queries with 17,776 and 35,552 keys),
    where kernel, quantization prologue and plain version are timed, with the
    bf16 kernel and SDPA on the same inputs for orientation. Its
    uniform-scale precursor: one small and the 17,776 shape;
 2. the single-clip path at full CogVideoX-5b-I2V width: the flagship
    dual-stream inpaint pipeline (42-layer DiT, 2-layer branch, default VAE)
    with seeded random bf16 weights, on a 49x480x720 clip, CFG 6 with dynamic
    CFG, replace_gt, mask_add, use_flash, 2 DPM steps, then the VAE decode;
    the launch counts are zeroed just before the call and read just after;
 3. the any-length path at the same width in its int8 serving mode: merged
    rank-256 adapter, W8A8 block projections, int8 flash attention with ID
    resampling (twice the keys), compressed int8 capture; 81 frames in 2
    windows of 49, 2 DPM steps per window, one VAE decode; counts zeroed
    before and read after;
 4. both pipelines at a small size on the card: the bf16 kernel path against
    the exact attention path (single clip and any-length), and the int8
    kernel path against the same pipeline on the int8 kernel's plain version;
 5. training at the same full width: two optimizer steps of branch SFT (42-
    layer frozen backbone, 2-layer float32 branch, batch 1, 49x480x720,
    per-block checkpointing, AdamW) through the flash forward and backward
    kernels; counts zeroed before and read after, and held to what the code
    predicts; finite losses, moved parameters, no gradient on frozen weights;
 6. one ID-LoRA step at full width on a backbone cut to 4 layers (rank 256,
    ID resampling: 35,552 keys in forward and backward);
 7. a small training step on the card, the kernels against exact attention.

Prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero without a result when CUDA
is missing or the port's package is not beside this script.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

H100_BF16_FLOPS = 989e12   # dense bf16 tensor-core peak (NVIDIA data sheet, SXM)
H100_INT8_OPS = 1979e12    # dense int8 tensor-core peak
H100_HBM_BYTES = 3.35e12   # HBM3 bytes/s
FLASH_REL_TOL = 2.0 ** -6   # |kernel - plain| over max|plain|: two bf16 ulps at the
                            # largest output (both round it to bf16; the kernel also
                            # rounds P to bf16 before P.V). With N(0,1) inputs the
                            # outputs are far below 1 (about 0.012 rms at 17,776 keys),
                            # so an absolute limit would not scale with them.
LSE_TOL = 1e-3             # same fp32 scores, another summation order
INT8PV_REL_L1 = 0.03       # int8 P.V mode, mean|kernel - plain| over mean|plain|. The
                            # kernel rounds P * 127 against the running max of each
                            # 64-key tile, the plain version (as the TPU kernel) of each
                            # blk_k block; with N(0,1) inputs and thousands of keys most
                            # P * 127 lie below 1, so their rounding is most of this
                            # mode's error against exact attention (2.5-3.5 %), and the
                            # two roundings differ by a like amount (1-2 % measured).
INT8PV_VS_EXACT = 1.25     # and the kernel's error against exact attention stays
                            # within this factor of the plain version's
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


def bwd_bound_ms(n_products, b, h, s_q, n_keys, d, n_out_rows):
    """Least time for one backward kernel: `n_products` score-sized products
    (dQ: S, dP, dS.K = 3; dK/dV: S, dP, P^T.dO, dS^T.Q = 4) over the bf16 peak,
    or its bytes (q, k, v, dO, lse, delta read once, the gradients written
    once) over the HBM rate."""
    ops_ms = 2.0 * n_products * b * h * s_q * n_keys * d / H100_BF16_FLOPS * 1e3
    nbytes = b * h * (2 * d * (2 * s_q + 2 * n_keys + n_out_rows) + 8 * s_q)
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def phase_bwd_kernels(torch, fa):
    """Phase 1, backward: flash_dq and flash_dkv against
    flash_attention_backward_reference on the card. Returns the two rows'
    numbers."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    d = 64

    def mk(b, h, s, layout="bshd"):
        if layout == "bshd":   # heads split from a [B, S, H*D] projection by a view
            return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
                torch.bfloat16).transpose(1, 2)
        if layout == "bhds":   # a transposed last dim: the wrapper has to copy it
            return torch.randn((b, h, d, s), generator=gen, device="cuda").to(
                torch.bfloat16).transpose(2, 3)
        return torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)

    def run(q, k, v, dout, kw):
        kv_len = kw.get("kv_len", k.shape[2])
        out, lse = fa.flash_fwd_cuda(q, k, v, d ** -0.5, kv_len, kw.get("kv_page_len"), True)
        grads = fa.flash_bwd_cuda(q, k, v, out, lse, dout, d ** -0.5, kv_len,
                                  kw.get("kv_page_len"))
        torch.cuda.synchronize()
        return out, lse, grads

    def compare(name, grads, refs):
        errs = {}
        for g_name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
            err, tol = flash_err(got, ref)
            finite = bool(torch.isfinite(got).all())
            msg = (f"flash_bwd {name}: {g_name} max_abs_err {err:.3e} (tol {tol:.3e} = "
                   f"2^-6 max|plain|), finite {finite}")
            log(msg)
            if not (err <= tol and finite):
                raise AssertionError(msg)
            errs[g_name] = err
        return errs

    cases = [("ragged 129x1111, contiguous heads", (2, 3, 129, 1111), "bhsd", "bhsd", {}),
             ("300x700, kv_len 513, strided head views", (1, 4, 300, 700), "bshd", "bshd",
              dict(kv_len=513)),
             ("paged 2x400, kv_len 333, dO with a transposed last dim", (2, 2, 257, 800),
              "bshd", "bhds", dict(kv_len=333, kv_page_len=400)),
             ("paged 3x400, kv_len 130: whole tiles masked", (1, 2, 200, 1200), "bshd", "bhsd",
              dict(kv_len=130, kv_page_len=400)),
             ("keys 2x300, strided dO", (2, 2, 300, 600), "bshd", "bshd", {})]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for name, (b, h, s_q, s_k), layout, do_layout, kw in cases:
        q, k, v = mk(b, h, s_q, layout), mk(b, h, s_k, layout), mk(b, h, s_k, layout)
        dout = mk(b, h, s_q, do_layout)
        out, lse, grads = run(q, k, v, dout, kw)
        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, d ** -0.5, **kw)
        for g_name, err in compare(name, grads, refs).items():
            worst[g_name] = max(worst[g_name], err)
        if "kv_len" in kw:   # masked keys: their rows of dK and dV are exactly 0
            col = torch.arange(s_k, device="cuda")
            dead = ~fa._kv_valid(col, kw["kv_len"], kw.get("kv_page_len"), s_k)
            if grads[1][:, :, dead].abs().max().item() or grads[2][:, :, dead].abs().max().item():
                raise AssertionError(f"flash_bwd {name}: a masked key got a gradient")

    # the flagship calls of one training step: batch 1 x 48 heads, 17,776
    # queries; 17,776 keys (branch SFT) and 35,552 (the LoRA step's ID resample)
    b, h, s = 1, 48, 17776
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = {}
    for s_k in (s, 2 * s):
        q, k, v, dout = mk(b, h, s), mk(b, h, s_k), mk(b, h, s_k), mk(b, h, s)
        out, lse, grads = run(q, k, v, dout, {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, d ** -0.5)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        errs = compare(f"flagship [{b}x{h}, {s}, {s_k} keys]", grads, refs)
        for g_name, err in errs.items():
            worst[g_name] = max(worst[g_name], err)
        del refs, grads
        delta = fa.flash_bwd_delta(out, dout)
        args = (q, k, v, dout, lse, delta, d ** -0.5, s_k, None)
        dq_ms = cuda_time_ms(lambda: fa.flash_dq_cuda(*args), 5)
        dkv_ms = cuda_time_ms(lambda: fa.flash_dkv_cuda(*args), 5)
        delta_ms = cuda_time_ms(lambda: fa.flash_bwd_delta(out, dout), 5)
        fwd_ms = cuda_time_ms(lambda: fa.flash_fwd_cuda(q, k, v, d ** -0.5, s_k, None, True), 5)
        # the library's backward: forward + backward of SDPA minus its forward
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(ql, kl, vl), (ql, kl, vl), dout)

        lib_both = cuda_time_ms(sdpa_fwd_bwd, 5)
        lib_fwd = cuda_time_ms(lambda: sdpa(q, k, v), 5)
        dq_bound, dq_by = bwd_bound_ms(3, b, h, s, s_k, d, s)
        dkv_bound, dkv_by = bwd_bound_ms(4, b, h, s, s_k, d, 2 * s_k)
        fwd_bound, _ = flash_bound_ms(b, h, s, s_k, d)
        shapes[s_k] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms, "delta_ms": delta_ms,
                       "fwd_with_lse_ms": fwd_ms, "plain_ms": plain_ms,
                       "library_bwd_ms": lib_both - lib_fwd, "library_fwd_ms": lib_fwd,
                       "dq_bound_ms": dq_bound, "dkv_bound_ms": dkv_bound,
                       "fwd_bound_ms": fwd_bound, "dq_by": dq_by, "dkv_by": dkv_by}
        log(f"flash_bwd flagship {s_k} keys: dq {dq_ms:.3f} ms (bound {dq_bound:.3f} ms, "
            f"{dq_by}; {6.0 * b * h * s * s_k * d / dq_ms / 1e9:.1f} TFLOP/s), dkv "
            f"{dkv_ms:.3f} ms (bound {dkv_bound:.3f} ms, {dkv_by}; "
            f"{8.0 * b * h * s * s_k * d / dkv_ms / 1e9:.1f} TFLOP/s), delta {delta_ms:.3f} ms, "
            f"plain (dq, dk, dv together) {plain_ms:.1f} ms, SDPA backward (dq, dk, dv "
            f"together) {lib_both - lib_fwd:.3f} ms; forward with lse {fwd_ms:.3f} ms "
            f"(bound {fwd_bound:.3f} ms), SDPA forward {lib_fwd:.3f} ms")
        del q, k, v, dout, out, lse, delta, ql, kl, vl
    main_shape = shapes[s]   # the call each of the branch-SFT step's blocks makes
    common = {"plain_ms": main_shape["plain_ms"], "library_ms": main_shape["library_bwd_ms"],
              "plain_and_library_cover": "flash_dq + flash_dkv together",
              "shape": f"[{b}x{h}, {s} q, {s} keys, {d}] bf16",
              "by_shape": {str(k): v for k, v in shapes.items()}}
    b2 = {"max_abs_err": worst["dq"], "ms": main_shape["dq_ms"],
          "bound_ms": main_shape["dq_bound_ms"], "bound_by": main_shape["dq_by"], **common}
    b3 = {"max_abs_err": max(worst["dk"], worst["dv"]), "ms": main_shape["dkv_ms"],
          "bound_ms": main_shape["dkv_bound_ms"], "bound_by": main_shape["dkv_by"], **common}
    return b2, b3


def int8_bound_ms(bh, s_q, n_keys, d, int8_pv):
    """Least time for one int8 flash call: Q.K^T over the int8 peak plus P.V
    over the bf16 peak (the int8 peak with int8 P.V), or its bytes (int8 q and
    k, bf16 or int8 v, bf16 o, each once) over the HBM rate."""
    half = 2.0 * bh * s_q * n_keys * d
    ops_ms = (half / H100_INT8_OPS + half / (H100_INT8_OPS if int8_pv else H100_BF16_FLOPS)) * 1e3
    nbytes = bh * d * (s_q + n_keys + (1 if int8_pv else 2) * n_keys + 2 * s_q)
    bytes_ms = nbytes / H100_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rel_l1(a, b):
    return ((a.float() - b.float()).abs().mean() / b.float().abs().mean()).item()


def phase_int8_kernels(torch, fa, fa8):
    """Phase 1, int8: flash_int8_fwd and its uniform precursor against their
    plain versions on the card. Returns the two rows' numbers."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mk(b, h, s, d=64):  # heads split from a [B, S, H*D] projection by a view
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    def check(name, q, k, v, blk, pv, kw, exact=True):
        """One case: the kernel (through the wrapper) against the plain version."""
        out = fa8.flash_attention_int8(q, k, v, blk_q=blk[0], blk_k=blk[1], int8_pv=pv, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fa8.flash_attention_int8_reference(q, k, v, blk_q=blk[0], blk_k=blk[1],
                                                 int8_pv=pv, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, tol = flash_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        mode = "int8pv" if pv else "int8"
        if pv:
            rel = rel_l1(out, ref)
            msg = (f"flash_int8_fwd {name} {mode} blk {blk}: rel_l1 {rel:.4f} "
                   f"(limit {INT8PV_REL_L1}), max_abs_err {err:.3e}")
            ok = rel <= INT8PV_REL_L1
            if exact:
                ex = fa.flash_attention_reference(q, k, v, **kw)
                r_k, r_p = rel_l1(out, ex), rel_l1(ref, ex)
                msg += f"; vs exact: kernel {r_k:.4f}, plain {r_p:.4f} (limit {INT8PV_VS_EXACT}x)"
                ok = ok and r_k <= INT8PV_VS_EXACT * r_p
        else:
            msg = (f"flash_int8_fwd {name} {mode} blk {blk}: max_abs_err {err:.3e} "
                   f"(tol {tol:.3e})")
            ok = err <= tol
        log(msg + f", finite {finite}")
        if not (ok and finite):
            raise AssertionError(msg)
        return err, plain_ms

    cases = [("ragged 129x1111", (2, 3, 129, 1111), {}),
             ("kv_len 513 of 700", (1, 4, 300, 700), dict(kv_len=513)),
             ("paged 2x400, kv_len 333", (2, 2, 257, 800), dict(kv_len=333, kv_page_len=400)),
             ("paged 3x400, kv_len 130: whole tiles masked", (1, 2, 200, 1200),
              dict(kv_len=130, kv_page_len=400)),
             ("keys 2x300", (2, 2, 300, 600), {}),
             ("ragged blocks 1500x5000", (1, 2, 1500, 5000), {})]
    worst = 0.0
    for name, (b, h, s_q, s_k), kw in cases:
        for pv in (False, True):
            for blk in ((128, 128), (512, 2048)):
                q, k, v = mk(b, h, s_q), mk(b, h, s_k) + 0.7, mk(b, h, s_k)
                err, _ = check(name, q, k, v, blk, pv, kw)
                if not pv:
                    worst = max(worst, err)

    # the two flagship calls: CFG batch 2 x 48 heads, 17,776 queries; the
    # branch attends to 17,776 keys, the DiT's ID resample to twice as many
    b, h, s, d = 2, 48, 17776, 64
    shapes = {}
    for s_k in (s, 2 * s):
        q, k, v = mk(b, h, s), mk(b, h, s_k), mk(b, h, s_k)
        row = {}
        for pv in (False, True):
            mode = "int8pv" if pv else "int8"
            err, plain_ms = check(f"flagship [{b}x{h}, {s}, {s_k} keys]", q, k, v, (512, 2048),
                                  pv, {}, exact=False)
            if not pv:
                worst = max(worst, err)
            qq = fa8.quantize_qkv(q, k, v, blk_q=512, blk_k=2048, int8_pv=pv)
            ms = cuda_time_ms(lambda: fa8.flash_int8_fwd_cuda(qq, d ** -0.5, s_k, None, 512,
                                                              2048, pv), 10)
            pro_ms = cuda_time_ms(lambda: fa8.quantize_qkv(q, k, v, blk_q=512, blk_k=2048,
                                                           int8_pv=pv), 5)
            del qq
            bound, by = int8_bound_ms(b * h, s, s_k, d, pv)
            row[mode] = {"ms": ms, "prologue_ms": pro_ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by}
            log(f"flash_int8_fwd flagship {s_k} keys {mode}: kernel {ms:.3f} ms, prologue "
                f"{pro_ms:.3f} ms, plain {plain_ms:.1f} ms, bound {bound:.3f} ms ({by}); "
                f"{4.0 * b * h * s * s_k * d / ms / 1e9:.1f} TOP/s")
        row["b1_ms"] = cuda_time_ms(lambda: fa.flash_fwd_cuda(q, k, v, d ** -0.5, s_k, None,
                                                              False), 10)
        row["sdpa_bf16_ms"] = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10)
        log(f"  orientation, same bf16 inputs: bf16 kernel {row['b1_ms']:.3f} ms, "
            f"SDPA {row['sdpa_bf16_ms']:.3f} ms (no PyTorch call computes int8 attention)")
        shapes[s_k] = row
        del q, k, v

    # the uniform-scale precursor: [N, S, 64] int8 operands
    def uniform_case(n, s_len, kv_len):
        qi, ki, vi = (torch.randint(-127, 128, (n, s_len, d), generator=gen, device="cuda",
                                    dtype=torch.int8) for _ in range(3))
        vb = torch.randn((n, s_len, d), generator=gen, device="cuda").to(torch.bfloat16)
        deq = 3.0 / (127 * 127)   # scores of a few units, as quantized N(0,1) data give
        res = {}
        for pv, v in ((False, vb), (True, vi)):
            out = fa8.int8_flash_uniform(qi, ki, v, d ** -0.5, deq, kv_len, int8_pv=pv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = fa8.int8_flash_uniform_reference(qi, ki, v, d ** -0.5, deq, kv_len, int8_pv=pv)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err, tol = flash_err(out, ref)
            rel = rel_l1(out, ref)
            mode = "int8pv" if pv else "int8"
            msg = (f"flash_int8_uniform_fwd [{n}, {s_len}, {d}] kv_len {kv_len} {mode}: "
                   f"max_abs_err {err:.3e} (tol {tol:.3e}), rel_l1 {rel:.4f} "
                   f"(limit {INT8PV_REL_L1})")
            log(msg)
            if not (bool(torch.isfinite(out).all())
                    and (rel <= INT8PV_REL_L1 if pv else err <= tol)):
                raise AssertionError(msg)
            ms = cuda_time_ms(lambda: fa8.int8_flash_uniform(qi, ki, v, d ** -0.5, deq, kv_len,
                                                             int8_pv=pv), 5)
            res[mode] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
        return res

    uniform_case(6, 1000, 901)
    uni = uniform_case(b * h, s, s)
    ub, uby = int8_bound_ms(b * h, s, s, d, False)
    log(f"flash_int8_uniform_fwd [{b * h}, {s}, {d}]: int8 {uni['int8']['ms']:.3f} ms, int8pv "
        f"{uni['int8pv']['ms']:.3f} ms, plain {uni['int8']['plain_ms']:.1f} ms, bound "
        f"{ub:.3f} ms ({uby})")
    main_shape = shapes[2 * s]["int8"]   # the call the DiT's 42 layers make
    b4 = {"max_abs_err": worst, "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
          "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
          "library_ms": None, "shape": f"[{b}x{h}, {s} q, {2 * s} keys, {d}] int8",
          "by_shape": {str(k): v for k, v in shapes.items()}}
    b5 = {"max_abs_err": uni["int8"]["max_abs_err"], "ms": uni["int8"]["ms"],
          "plain_ms": uni["int8"]["plain_ms"], "bound_ms": ub, "bound_by": uby,
          "library_ms": None, "shape": f"[{b * h}, {s}, {d}] int8",
          "int8pv_ms": uni["int8pv"]["ms"]}
    return b4, b5


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


def phase_anyl_int8(torch, kernels):
    """Phase 3: the any-length int8 flagship at full width; returns the launch
    counts of that run."""
    from videopainter_tpu_torch.flagship import (ANYL_FRAMES, ANYL_INT8_CALL,
                                                 build_anyl_int8_pipeline, random_clip)
    from videopainter_tpu_torch.ops.basic import Int8Linear
    from videopainter_tpu_torch.pipelines import inpaint_anyl

    gen = torch.Generator(device="cuda").manual_seed(4321)
    t0 = time.perf_counter()
    pipe = build_anyl_int8_pipeline(gen)
    torch.cuda.synchronize()
    tcfg = pipe.transformer.cfg
    n_int8 = sum(isinstance(m, Int8Linear) for m in pipe.transformer.modules())
    log(f"any-length int8: {tcfg.num_layers}-layer DiT (id_pool_resample_learnable "
        f"{tcfg.id_pool_resample_learnable}), {n_int8} int8 linears in the DiT, rank-256 "
        f"adapter merged; built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    f, hgt, wid = ANYL_FRAMES, 480, 720
    clip = random_clip(gen, frames=f, height=hgt, width=wid)

    events = []   # (kind, end time, seconds)

    def timed(fn, kind):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            events.append((kind, time.perf_counter(), time.perf_counter() - s0))
            return r
        return run

    pipe.vae.encode = timed(pipe.vae.encode, "encode")
    pipe.vae.decode = timed(pipe.vae.decode, "decode")
    captured = []
    make = inpaint_anyl.make_denoise_fn

    def make_measured(*a, **kw):
        denoise = make(*a, **kw)

        def run(*da, **dkw):
            latents, hs, mask = denoise(*da, **dkw)
            tensors = list(hs.values()) if isinstance(hs, dict) else [] if hs is None else [hs]
            captured.append(sum(t.numel() * t.element_size() for t in tensors))
            return latents, hs, mask
        return run

    def progress(i, n):
        torch.cuda.synchronize()
        last = events[-1][1] if events else start
        events.append((f"step {i}", time.perf_counter(), time.perf_counter() - last))

    inpaint_anyl.make_denoise_fn = make_measured
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        start = time.perf_counter()
        out = pipe(**clip, num_inference_steps=2, generator=gen, output_type="pt",
                   progress_fn=progress, **ANYL_INT8_CALL)
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        launches = dict(kernels.LAUNCHES)
    finally:
        inpaint_anyl.make_denoise_fn = make
    peak = torch.cuda.max_memory_allocated()

    expected = (tcfg.num_layers + 2) * 2 * 2
    shape_ok = tuple(out.shape) == (1, f, hgt, wid, 3)
    finite = bool(torch.isfinite(out).all())
    log(f"any-length int8: out {tuple(out.shape)} finite {finite}; flash_int8_fwd launches "
        f"{launches['flash_int8_fwd']} (expected {expected} = 44 layers x 2 steps x 2 "
        f"windows), flash_fwd launches {launches['flash_fwd']} (expected 0)")
    log("any-length int8 wall times: " + ", ".join(f"{k} {s:.3f} s" for k, _, s in events)
        + f"; total {total:.3f} s; captured state per window "
        + ", ".join(f"{c / 2**20:.1f} MiB" for c in captured)
        + f"; peak memory {peak / 2**30:.2f} GiB")
    if not (shape_ok and finite):
        raise AssertionError(f"any-length output {tuple(out.shape)} finite={finite}")
    if launches["flash_int8_fwd"] != expected or launches["flash_fwd"] != 0:
        raise AssertionError(f"any-length int8 launches {launches}, expected "
                             f"{expected} flash_int8_fwd and 0 flash_fwd")
    if not captured[0] > 0 or captured[-1] != 0:
        raise AssertionError(f"captured state per window {captured}: the first window "
                             "must capture, the last must not")
    return launches


def timed_calls(torch, fn, bucket):
    """`fn` with each call's wall time (synchronised) appended to `bucket`."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        bucket.append(time.perf_counter() - s0)
        return r
    return run


def phase_train(torch, kernels):
    """Phase 5: two optimizer steps of branch SFT at full CogVideoX-5b-I2V
    width (42-layer frozen bf16 backbone, 2-layer float32 branch initialised
    from it, default VAE, batch 1, 49x480x720, 226-token embeddings, mask_add,
    per-block checkpointing, AdamW) with the flash forward and backward
    kernels. Returns the launch counts of the two steps."""
    from videopainter_tpu_torch.flagship import build_training
    from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                                 make_branch_train_step)

    gen = torch.Generator(device="cuda").manual_seed(99)
    t0 = time.perf_counter()
    t = build_training(gen)   # AdamW at the reference's 1e-5
    transformer, branch, vae = t["transformer"], t["branch"], t["vae"]
    cfg = BranchTrainConfig(mask_add=True, use_flash=True, remat=True)
    state = init_branch_train_state(t["trainable"], t["optimizer"])
    step = make_branch_train_step(transformer, branch, vae, t["scheduler"], t["optimizer"], cfg)
    torch.cuda.synchronize()
    n_layers, n_branch = transformer.cfg.num_layers, branch.cfg.num_layers
    n_train = sum(p.numel() for p in branch.parameters())
    log(f"training, full width: {n_layers}-layer bf16 backbone (frozen), {n_branch}-layer "
        f"branch with {n_train / 1e9:.3f} B float32 parameters (trainable), AdamW, per-block "
        f"checkpoints; built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    before = {n: p.detach().clone() for n, p in branch.named_parameters()}
    enc_s = []
    vae.encode = timed_calls(torch, vae.encode, enc_s)

    n_steps = 2
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    walls, metrics = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        state, m = step(state, t["batch"], gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - s0)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    # every block runs its forward once; every block that a trainable parameter
    # reaches is recomputed once and has one backward. The backbone's block 0
    # is not among them: the first branch sample is added after it.
    with_backward = n_branch + n_layers - 1
    expected = {"flash_fwd": n_steps * (n_branch + n_layers + with_backward),
                "flash_dq": n_steps * with_backward, "flash_dkv": n_steps * with_backward,
                "flash_int8_fwd": 0, "flash_int8_uniform_fwd": 0}
    enc_per_step = len(enc_s) // n_steps
    for i, (w, m) in enumerate(zip(walls, metrics)):
        enc = sum(enc_s[i * enc_per_step:(i + 1) * enc_per_step])
        log(f"training step {i + 1}: {w:.3f} s wall (VAE encodes {enc:.3f} s of it, "
            f"{enc_per_step} calls), " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    log(f"training launches over {n_steps} steps: {launches} (expected {expected}); peak "
        f"memory {peak / 2**30:.2f} GiB")
    if launches != expected:
        raise AssertionError(f"training launches {launches}, expected {expected}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"training metrics not finite: {m}")
        if not m["gradient_norm_before_clip"] > 0:
            raise AssertionError(f"gradient norm {m['gradient_norm_before_clip']}")
    if state.step != n_steps:
        raise AssertionError(f"state.step {state.step} after {n_steps} steps")
    moved = sum((p.detach() - before[n]).abs().sum().item() for n, p in branch.named_parameters())
    proj = [lin.weight.abs().max().item() for lin in branch.branch_blocks]
    log(f"training: parameters moved by {moved:.4g} (sum |delta|); zero-initialised branch "
        f"projections now max |w| " + ", ".join(f"{x:.3g}" for x in proj))
    if not (moved > 0 and all(x > 0 for x in proj)):
        raise AssertionError("the branch did not move, or its zero-initialised projections "
                             "received no gradient")
    frozen_bad = [n for mod in (transformer, vae) for n, p in mod.named_parameters()
                  if p.grad is not None or p.requires_grad]
    if frozen_bad:
        raise AssertionError(f"frozen parameters with a gradient: {frozen_bad[:5]}")
    return launches


def phase_train_lora(torch, kernels):
    """Phase 6: one ID-LoRA step at full width on a backbone cut to 4 layers
    (2-layer frozen branch, rank-256 float32 adapter, id_pool_resample: twice
    the keys in the backbone's attention, forward and backward)."""
    from videopainter_tpu_torch.config import TransformerConfig
    from videopainter_tpu_torch.flagship import LORA_ALPHA, LORA_RANK, build_training
    from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                                 make_lora_train_step)

    gen = torch.Generator(device="cuda").manual_seed(98)
    depth = 4
    tcfg = TransformerConfig.cogvideox_5b_i2v(num_layers=depth, id_pool_resample_learnable=True)
    t = build_training(gen, mode="lora", tcfg=tcfg)
    cfg = BranchTrainConfig(mask_add=True, use_flash=True, remat=True, id_pool_resample=True,
                            lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
    state = init_branch_train_state(t["trainable"], t["optimizer"])
    step = make_lora_train_step(t["transformer"], t["branch"], t["vae"], t["scheduler"],
                                t["optimizer"], cfg)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    s0 = time.perf_counter()
    state, m = step(state, t["batch"], gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - s0
    launches = dict(kernels.LAUNCHES)
    m = {k: float(v) for k, v in m.items()}
    # the frozen branch runs without grad (2 forwards); every backbone block
    # holds trainable A / B: forward, recompute and backward each
    expected = {"flash_fwd": 2 + 2 * depth, "flash_dq": depth, "flash_dkv": depth,
                "flash_int8_fwd": 0, "flash_int8_uniform_fwd": 0}
    b_max = {tgt: ab["lora_B"].abs().max().item() for tgt, ab in state.trainable.items()}
    log(f"LoRA step, full width, backbone cut to {depth} of 42 layers, rank {LORA_RANK}, "
        f"35,552 keys: {wall:.3f} s wall, " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
        + f"; launches {launches} (expected {expected}); max |lora_B| after the step {b_max}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != expected:
        raise AssertionError(f"LoRA step launches {launches}, expected {expected}")
    if not (all(math.isfinite(v) for v in m.values()) and m["gradient_norm_before_clip"] > 0):
        raise AssertionError(f"LoRA step metrics {m}")
    if not all(x > 0 for x in b_max.values()):
        raise AssertionError(f"no gradient reached lora_B: {b_max}")


# small training step, flash kernels vs exact attention, bf16: relative loss
# difference and cosine of the two gradients (an H100 reads 3e-5 and 0.99999)
TRAIN_LOSS_REL = 1e-3
TRAIN_GRAD_COSINE = 0.9999


def phase_small_train(torch):
    """Phase 7: a small stack (head dim 64) on the card, one branch-SFT grad
    step with the flash kernels against the same step with exact attention, on
    the same weights and prepared tensors."""
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.flagship import build_training
    from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                                 make_branch_train_step)

    class GradTap:
        """Stands in for the optimizer: keeps the gradients, changes nothing."""
        def init(self, params, names=None):
            return {}

        def update_(self, params, grads, state):
            self.grads = torch.cat([g.float().flatten() for g in grads])
            return state

    gen = torch.Generator(device="cuda").manual_seed(97)
    tcfg = TransformerConfig.tiny(in_channels=32, out_channels=16, attention_head_dim=64,
                                  sample_height=8, sample_width=12)
    t = build_training(gen, tcfg=tcfg, vcfg=VAEConfig.tiny(latent_channels=16), frames=9,
                       height=64, width=96, text_len=5)
    for lin in t["branch"].branch_blocks:   # non-zero projections: every block gets gradient
        torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
    res = {}
    prep = rope = None
    for flash in (True, False):
        cfg = BranchTrainConfig(height=64, width=96, mask_add=True, use_flash=flash, remat=True)
        tap = GradTap()
        state = init_branch_train_state(t["trainable"], tap)
        step = make_branch_train_step(t["transformer"], t["branch"], t["vae"], t["scheduler"],
                                      tap, cfg)
        if prep is None:
            prep = step.prepare(t["batch"], gen)
            rope = step.rope(prep)
        _, m = step.grad_step(state, *prep, t["batch"]["prompt_embeds"], rope)
        res[flash] = (float(m["total_loss"]), tap.grads)
    rel = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    cos = torch.nn.functional.cosine_similarity(res[True][1], res[False][1], dim=0).item()
    finite = bool(torch.isfinite(res[True][1]).all())
    log(f"small training step, flash kernels vs exact attention: loss {res[True][0]:.6f} vs "
        f"{res[False][0]:.6f} (relative {rel:.2e}, limit {TRAIN_LOSS_REL}), gradient cosine "
        f"{cos:.6f} (min {TRAIN_GRAD_COSINE}), finite {finite}")
    if not (finite and rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COSINE):
        raise AssertionError("small training step: the kernel path disagrees with exact "
                             "attention")


def psnr_db(a, b):
    mse = (a - b).square().mean().item()
    return 10 * math.log10(4.0 / max(mse, 1e-20))  # range [-1, 1]


def phase_small_anyl(torch):
    """Phase 4, any-length: a small pipeline (head dim 64, 2 windows) on the
    card. (a) the bf16 kernel path (twice the keys under ID resampling)
    against the exact-attention path; (b) the int8 kernel path on the W8A8
    model against the same pipeline with the int8 kernel's plain version put
    in its place."""
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.flagship import (ANYL_INT8_CALL, build_anyl_int8_pipeline,
                                                 random_clip)
    from videopainter_tpu_torch.ops import attention, flash_attention_int8 as fa8

    tcfg = TransformerConfig.tiny(in_channels=32, out_channels=16, attention_head_dim=64,
                                  sample_height=8, sample_width=12,
                                  id_pool_resample_learnable=True)
    call = dict(ANYL_INT8_CALL, num_frames=9, stride=4, num_inference_steps=2,
                vae_sample_mode="mode", output_type="pt")

    def run(int8, **kw):
        gen = torch.Generator(device="cuda").manual_seed(11)   # same weights, clip and noise
        pipe = build_anyl_int8_pipeline(gen, tcfg=tcfg, vcfg=VAEConfig.tiny(latent_channels=16),
                                        lora_rank=4, int8=int8)
        clip = random_clip(gen, frames=13, height=64, width=96, text_len=5, text_dim=12)
        inits = [torch.randn((1, 3, 8, 12, 16), generator=gen, device="cuda") for _ in range(2)]
        dpms = [torch.randn((2, 1, 3, 8, 12, 16), generator=gen, device="cuda") for _ in range(2)]
        return pipe(**clip, init_noises=inits, dpm_noises_list=dpms, **dict(call, **kw)).float()

    exact = run(False, use_flash=False, capture_int8=False)
    flash = run(False, use_flash=True, capture_int8=False)
    psnr = psnr_db(flash, exact)
    finite = bool(torch.isfinite(flash).all())
    log(f"small any-length pipeline, bf16 kernel (2 S keys) vs exact path: PSNR {psnr:.1f} dB "
        f"(min {SMALL_PSNR_DB}), finite {finite}")
    if not (finite and psnr >= SMALL_PSNR_DB):
        raise AssertionError("small any-length pipeline: bf16 kernel path disagrees with exact")

    kernel = run(True)
    wrapper = attention.flash_attention_int8
    attention.flash_attention_int8 = fa8.flash_attention_int8_reference
    try:
        plain = run(True)
    finally:
        attention.flash_attention_int8 = wrapper
    psnr = psnr_db(kernel, plain)
    finite = bool(torch.isfinite(kernel).all())
    log(f"small any-length pipeline, W8A8 + int8 kernel vs the same on the kernel's plain "
        f"version: PSNR {psnr:.1f} dB (min {SMALL_PSNR_DB}), finite {finite}; int8 path vs "
        f"exact bf16 path: PSNR {psnr_db(kernel, exact):.1f} dB (no limit)")
    if not (finite and psnr >= SMALL_PSNR_DB):
        raise AssertionError("small any-length pipeline: int8 kernel path disagrees with "
                             "its plain version")


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
    psnr = psnr_db(outs[True], outs[False])
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
        from videopainter_tpu_torch.ops import flash_attention_int8 as fa8
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this script: {e}",
              file=sys.stderr)
        return 2
    vp.set_numerics(conv_tf32=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t_all = t = time.perf_counter()
    sources = ((fa._SOURCE, fa._SIGNATURES), (fa._BWD_SOURCE, fa._BWD_SIGNATURES),
               ("flash_int8_fwd.cu", fa8._SIGNATURES))
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, side by side
        for fut in [pool.submit(kernels.load, *src) for src in sources]:
            fut.result()
    log(f"built {len(sources)} kernel sources in {time.perf_counter() - t:.1f} s")
    for src, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")

    def free():   # a finished phase's models and buffers go back to the allocator
        gc.collect()
        torch.cuda.empty_cache()

    stats = phase_kernels(torch, fa)
    b2, b3 = phase_bwd_kernels(torch, fa)
    b4, b5 = phase_int8_kernels(torch, fa, fa8)
    free()
    launches = phase_pipeline(torch, kernels)
    free()
    anyl_launches = phase_anyl_int8(torch, kernels)
    free()
    train_launches = phase_train(torch, kernels)
    free()
    phase_train_lora(torch, kernels)
    free()
    phase_small(torch)
    phase_small_anyl(torch)
    phase_small_train(torch)

    # the uniform-scale precursor is driven by its tool, the port's
    # `tools/bench_int8_attn`: its main path, at a depth cut to 2 iterations
    from videopainter_tpu_torch.tools import bench_int8_attn
    kernels.reset_launches()
    bench_int8_attn.main(["--iters", "2"])
    tool_launches = dict(kernels.LAUNCHES)
    if tool_launches["flash_int8_uniform_fwd"] < 1:
        raise AssertionError(f"the int8 tool launched no uniform kernel: {tool_launches}")

    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_all:.1f} s, "
        "the kernels' build included")
    int8_src = "videopainter_tpu_torch/csrc/flash_int8_fwd.cu"
    rows = [{"name": "flash_fwd", "route": "cuda",
             "source": "videopainter_tpu_torch/csrc/flash_fwd.cu",
             "replaces": "videopainter_tpu/ops/flash_attention.py:68",
             "launches": launches["flash_fwd"],
             "launches_training": train_launches["flash_fwd"], **stats},
            {"name": "flash_dq", "route": "cuda",
             "source": "videopainter_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "videopainter_tpu/ops/flash_attention.py:164",
             "launches": train_launches["flash_dq"], **b2},
            {"name": "flash_dkv", "route": "cuda",
             "source": "videopainter_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "videopainter_tpu/ops/flash_attention.py:194",
             "launches": train_launches["flash_dkv"], **b3},
            {"name": "flash_int8_fwd", "route": "cuda", "source": int8_src,
             "replaces": "videopainter_tpu/ops/flash_attention_int8.py:44",
             "launches": anyl_launches["flash_int8_fwd"], **b4},
            {"name": "flash_int8_uniform_fwd", "route": "cuda", "source": int8_src,
             "replaces": "tools/bench_int8_attn.py:37",
             "launches": tool_launches["flash_int8_uniform_fwd"], **b5}]
    print(json.dumps({"kernels": rows}), flush=True)
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
