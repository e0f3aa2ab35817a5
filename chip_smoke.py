#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py    # everything below, on one card

Phases (each fails the run loudly, exit code != 0):
 0. build the hand-written kernels from `videopainter_tpu_torch/csrc/` (one
    nvcc per source, all eight side by side), print ptxas' report
    (registers, spills, setmaxnreg, wgmma serialisation), the HGMMA (bf16)
    and IGMMA (int8) wgmma counts of each wgmma kernel, and the I2F / F2I
    conversions of each int8 library, in all and inside its key loop;
 1. hold each kernel against its plain PyTorch version on the card. The bf16
    flash forward (the wgmma kernel): small ragged shapes, kv_len, the paged
    mask, the logsumexp, TMA edges (S_q in 1 / 17 / 64, S_k in 1 / 65 / 129,
    B*H = 1), and the flagship shape, where the kernel, its plain version and
    the PyTorch library call computing the same function are timed. The bf16
    flash backward (the wgmma dQ and dK/dV kernels): ragged shapes, S_q !=
    S_k, kv_len, the paged mask with a whole tile masked, strided head views,
    a dO the wrapper has to copy, the TMA edges, and the two flagship shapes
    of a training step (17,776 queries with 17,776 and 35,552 keys), timed
    beside the plain version and the library's backward (SDPA forward +
    backward minus its forward). The int8 flash forward (the wgmma kernel):
    ragged, kv_len, paged, twice the keys, the TMA edges (at blocks 128/128),
    a later tile that raises every row's max (the kernel's exact fallback),
    with and without int8 P.V, at quantization blocks 128/128 and the
    defaults, and the two flagship shapes (17,776 queries with 17,776 and
    35,552 keys), where the kernel (both modes), the quantization prologue
    and the plain version are timed, with the bf16 kernel and SDPA on the
    same inputs. Its uniform-scale precursor (the Hopper kernel), in both
    modes: a masked tail, a third tile that raises every row's max, scores at
    the extreme 64 * 127^2, and the int8 tool's call [96, 17,776, 64], timed
    against the SageAttention kernel with uniform scale tables. Attention's
    prep (csrc/qk_norm_rope.cu, no Pallas counterpart): the forward against
    its plain version at the served shape, the backward
    against fp32 autograd at the training shape, both timed beside their
    bytes bounds and the plain version. The VAE's GroupNorm + SiLU
    (csrc/group_norm_silu.cu, no Pallas counterpart): four encoder shapes,
    one of them the channel / frame view, against the plain version and
    float64 statistics, timed beside the bytes bound, the plain version and
    F.group_norm + F.silu. AdaLN (csrc/adaln.cu, no Pallas counterpart): the
    forward against its plain version at cell 1's, the 1.5 cell's and the
    training call's shapes, the backward against fp32 autograd at the
    training shape, both timed beside their bytes bounds and the plain
    version;
 2. the single-clip path at full CogVideoX-5b-I2V width from a prompt: T5-
    v1.1-XXL at its published width (seeded random weights, a word-hash
    tokenizer) encodes it and the empty negative prompt, then the flagship
    dual-stream inpaint pipeline (42-layer DiT, 2-layer branch, default VAE)
    with seeded random bf16 weights, on a 49x480x720 clip, CFG 6 with dynamic
    CFG, replace_gt, mask_add, use_flash, 2 DPM steps, then the VAE decode;
    the launch counts are zeroed just before the call and read just after;
    the same call given the embeddings must give the same video;
 3. the any-length path at the same width in its int8 serving mode: merged
    rank-256 adapter, W8A8 block projections, int8 flash attention with ID
    resampling (twice the keys), compressed int8 capture; 81 frames in 2
    windows of 49, 2 DPM steps per window, each window's final frames
    decoded by the streaming decoder (caches spilled to host memory), held
    against the one-shot decode of the same latents; counts zeroed before
    and read after;
 4. both pipelines at a small size on the card: the bf16 kernel path against
    the exact attention path (single clip and any-length), and the int8
    kernel path against the same pipeline on the int8 kernel's plain version;
 5. training at the same full width: two optimizer steps of branch SFT (42-
    layer frozen backbone, 2-layer float32 branch, batch 1, 49x480x720,
    per-block checkpointing, AdamW) through the flash forward and backward
    kernels, driven by the training tool's `measure`
    (`videopainter_tpu_torch.tools.smoke_chip_train`); counts zeroed before
    and read after, and held to what the code predicts; finite losses, moved
    parameters, no gradient on frozen weights;
 6. one ID-LoRA step at full width on a backbone cut to 4 layers (rank 256,
    ID resampling: 35,552 keys in forward and backward);
 7. a small training step on the card, the kernels against exact attention;
 8. the inference CLI (`videopainter_tpu_torch.infer.inpaint`) from disk at
    full width: phase 2's models and a seeded rank-256 adapter written as
    diffusers checkpoints (the 42-layer DiT in bf16 shards), read back by
    `build_pipeline` bit for bit, then the CLI's compute on an 81-frame
    480x720 clip with a moving mask (frame 0 pre-inpainted at T=1 over 30
    steps, 2 windows x 2 steps, CFG 6, ID resampling: the bf16 flash forward
    over 35,552 keys), bit-equal to the direct pipeline calls; counts zeroed
    before and read after; `main(argv)` on a CSV, masks and an mp4 where cv2
    imports;
 9. the variants at full width on phase 2's backbone and VAE: self-guidance
    (49x480x720, 2 steps, two 42-layer passes a step) and the SFT any-length
    baseline (81 frames, 2 windows x 2 steps), launches held to the code's;
10. the small variant and generation pipelines on the card against exact
    attention, the CLI's int8 modes at a tiny width against the int8 kernel's
    plain version, a fused to_qkv model against the unfused one;
11. the evaluation path (`videopainter_tpu_torch.evaluate`) at full width:
    a DAVIS-layout corpus at 480x720 (bear: 81 frames with a moving hole,
    boat: 49), LPIPS-squeeze and InceptionI3d at published size (the
    goldens' state dicts), CLIP ViT-L/14 from seeded random weights; phase
    8's pipeline rebuilt from its checkpoint, bound to use_flash=True, run by
    `run_inpainting_eval` with the sweep's anyl prev-clip weight 0.3 in
    windows of 49 at overlap 17 (so that bear makes two whole windows; the
    sweep's default overlap is 8), 2 steps a window, B1's launches held to
    the code's count (and again on the prev-clip pair path); a resume that
    runs no pipeline; the card's metrics against the CPU path on the saved
    composite frames (float64 metrics to 1e-9, the learned extractors to
    1e-6 or 1e-5, limits that the same comparison with TF32 left on must
    fail);
    the edit evaluation; then
    the eval CLI and its sweep at a tiny width on the card (exact attention),
    the CLI's rows held to a direct harness call's;
12. the interactive demo (`segmentation`, `native`, `app`): the
    connected-components kernel against its plain version (exact) on
    [8, 1, 1024, 1024] masks at p = 0.1 / 0.41 / 0.7, all-zero, all-one,
    1 x 1 and 1 x W masks, and against scipy on a serpentine and a spiral,
    timed beside its bytes bound; Hiera-L SAM2 at 1024 (seeded weights) held
    to the CPU on 2 frames in full fp32 (a TF32 control must fail the
    limit); an `AppSession` on a 49x480x720 clip (two objects, a negative
    click, `track()`: 49 image-encoder runs), its inpaint on phase 8's
    checkpoint bound to use_flash=True (88 B1 launches), and the automatic
    mask generator on frame 0 (two connected-components launches a kept
    mask);
13. parallel/ on the one card: (a) the ring's arithmetic in one process at
    the flagship shapes: the joint [2x48, 226 + 17,550, 64] attention as each
    rank of a seq-2 and a seq-3 ring computes it (B1 with lse on the text
    block and every video shard, fp32 merges) against one B1 call, and the
    ring backward at [1x48, 17,776, 64] (per-block B2 / B3 with the merged
    lse, dK / dV summed over the ranks) against one B2 + B3 call, launches
    held to n (1 + n), times beside the single call; (b) world 2 in two
    processes on the card over gloo (`parallel.launch.run_local`), at full
    width with the backbone cut to PAR_DEPTH layers, each against the same
    computation in one process: the single-clip pipeline under model=2
    (bf16, use_flash, 2 DPM steps, latents; the row-parallel bias on every
    rank must fail the limit), the DiT under seq=2 with ring attention, a
    W8A8 + int8-attention DiT forward under model=2 (the local amax must
    fail the limit), two branch-SFT steps under data=2 with ZeRO-2 (the
    parameters bit-equal on both ranks after each step) and one under seq=2
    with the ring (B2 / B3 per ring block); every rank's launches held to
    the code's counts; (c) `train(mesh=make_mesh(1, 1, 1))` on a one-rank
    NCCL group, one step bit-equal to the meshless step;
14. the gate tools (`videopainter_tpu_torch.tools`: gate_int8_flagship,
    gate_skip_flagship, smoke_chip_anyl) at full width, steps cut, on one
    seeded 42-layer model with the learnable ID resample: the int8 gate's
    trajectories (3 steps: bf16, dynamic int8 calibrating static scales,
    static int8) and capture legs, the skip gate's real denoise loop (6
    steps: bf16 reference, int8 with those scales, schedule 2:6:2) with its
    pixel and perceptual legs, the any-length tool's skip-against-full run
    (73 frames, 2 windows x 3 steps, step 1 skipped); strict JSON, finite,
    B1 / B4 launches as predicted, int8 latent PSNR >= 35 dB, the capture
    consumption control above 0;
15. the measurement tools (`videopainter_tpu_torch.tools`: bench,
    smoke_chip_train, sweep_int8_blocks, bench_vae_decode) at full width:
    the bench's gated-headline rule on the committed `_cuda` gate artifacts
    (int8_ascale_skip_42L with 4:48:5) and its renamed-schedule control (the
    skip rung dropped), the bench's step at 42 layers in the gated serving
    mode (W8A8, int8 attention, calibrated static scales, 4:48:5, the tiled
    VAE decode) and in bf16 (batched CFG, 4 steps each, launches held
    exactly), the training tool at 42 layers (phase 5), the int8 block sweep
    on two block pairs in both modes and the decode sweep on two combos.

Prints a `kernels` JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero without a result when CUDA
is missing or the port's package is not beside this script.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
                            # wgmma kernels round P * 127 against the running max of each
                            # 128-key tile, the plain version (as the TPU kernel) of each
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


# TMA edges: a box larger than the tensor, a ragged tile of one row past a
# whole tile, one row; B*H = 1
TMA_EDGES = [(s_q, s_k) for s_q in (1, 17, 64) for s_k in (1, 65, 129)]
ONE_KEY_ATOL = 1e-5        # with one key, softmax does not depend on its score: exact
                           # dQ and dK are 0, the plain version's are rounding noise (5e-7)


def in_turns(torch, fns, iters):
    """Time (other, new, new, other) on the same inputs, in turns on one card;
    returns (mean of the new, mean of the other, the four readings) in ms."""
    old, new = fns
    t = [cuda_time_ms(f, iters) for f in (old, new, new, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def phase_kernels(torch, fa):
    """Phase 1: flash_fwd (csrc/flash_fwd_wgmma.cu) against
    flash_attention_reference on the card, and its time at the flagship
    shape."""
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
    cases += [(f"TMA edge {s_q}x{s_k}, B*H 1", dict(b=1, h=1, s_q=s_q, s_k=s_k), dict(lse=True))
              for s_q, s_k in TMA_EDGES]
    worst = 0.0
    for name, shp, kw in cases:
        q, k, v = qkv(**shp)
        lse = kw.pop("lse", False)
        ref, l_r = fa.flash_attention_reference(q, k, v, 64 ** -0.5, with_lse=True, **kw)
        out, l_k = fa.flash_fwd_cuda(q, k, v, 64 ** -0.5, kw.get("kv_len", k.shape[2]),
                                     kw.get("kv_page_len"), lse)
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
    flop = 4.0 * b * h * s * s * d
    log(f"flash_fwd flagship: kernel {ms:.3f} ms ({flop / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * bound / ms:.1f} % of bound), plain {plain_ms:.3f} ms, sdpa "
        f"{library_ms:.3f} ms, bound {bound:.3f} ms ({bound_by})")
    del q, k, v, out

    # the inference CLI's two other calls, with operands built as
    # ops/attention.joint_attention builds them: (a) ID resampling, q a view
    # of the [B, S, H*D] projection, K / V contiguous from torch.cat of the
    # projected keys and their masked copy (2 S keys); (b) the first-frame
    # pass at T = 1 (226 + 1,350 tokens), heads as views
    def proj():
        return torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)

    def heads(t):
        return t.view(t.shape[0], t.shape[1], h, d).transpose(1, 2)

    q_flat, k_flat, v_flat = proj(), proj(), proj()
    keep = (torch.rand((b, s, 1), generator=gen, device="cuda") < 0.25).to(torch.bfloat16)
    resample = (heads(q_flat), torch.cat([heads(k_flat), heads(k_flat * keep)], dim=2),
                torch.cat([heads(v_flat), heads(v_flat * keep)], dim=2))
    del q_flat, k_flat, v_flat
    extra = {}
    for name, (q, k, v) in (("ID resample", resample), ("first frame T=1",
                                                        qkv(b, h, 226 + 1350, 226 + 1350))):
        s_q, s_k = q.shape[2], k.shape[2]
        out, _ = fa.flash_fwd_cuda(q, k, v, d ** -0.5, s_k, None, False)
        err, tol = flash_err(out, fa.flash_attention_reference(q, k, v, d ** -0.5))
        finite = bool(torch.isfinite(out).all())
        call_ms = cuda_time_ms(lambda: fa.flash_fwd_cuda(q, k, v, d ** -0.5, s_k, None, False),
                               3)
        call_bound, _ = flash_bound_ms(b, h, s_q, s_k, d)
        log(f"flash_fwd {name} [{b}x{h}, {s_q} q, {s_k} keys] bf16: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), finite {finite}; kernel {call_ms:.3f} ms "
            f"({100 * call_bound / call_ms:.1f} % of bound {call_bound:.3f} ms)")
        if not (err <= tol and finite):
            raise AssertionError(f"flash_fwd disagrees with its plain version ({name})")
        worst = max(worst, err)
        extra[f"ms_{'resample' if s_k == 2 * s else 'first_frame'}"] = call_ms
        del q, k, v, out
    del resample
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by, **extra}


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

    def compare(name, grads, refs, names=("dq", "dk", "dv"), one_key=False):
        errs = {}
        for g_name, got, ref in zip(names, grads, refs):
            err, tol = flash_err(got, ref)
            if one_key and g_name[:2] in ("dq", "dk"):
                tol = max(tol, ONE_KEY_ATOL)
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
    cases += [(f"TMA edge {s_q}x{s_k}, B*H 1", (1, 1, s_q, s_k), "bshd", "bshd", {})
              for s_q, s_k in TMA_EDGES]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for name, (b, h, s_q, s_k), layout, do_layout, kw in cases:
        q, k, v = mk(b, h, s_q, layout), mk(b, h, s_k, layout), mk(b, h, s_k, layout)
        dout = mk(b, h, s_q, do_layout)
        out, lse, grads = run(q, k, v, dout, kw)
        refs = fa.flash_attention_backward_reference(q, k, v, out, lse, dout, d ** -0.5, **kw)
        for g_name, err in compare(name, grads, refs, one_key=s_k == 1).items():
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
        shapes[s_k] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms,
                       "delta_ms": delta_ms, "fwd_with_lse_ms": fwd_ms, "plain_ms": plain_ms,
                       "library_bwd_ms": lib_both - lib_fwd, "library_fwd_ms": lib_fwd,
                       "dq_bound_ms": dq_bound, "dkv_bound_ms": dkv_bound,
                       "fwd_bound_ms": fwd_bound, "dq_by": dq_by, "dkv_by": dkv_by}
        log(f"flash_bwd flagship {s_k} keys: dq {dq_ms:.3f} ms (bound {dq_bound:.3f} ms, "
            f"{dq_by}; {6.0 * b * h * s * s_k * d / dq_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * dq_bound / dq_ms:.1f} % of bound), dkv "
            f"{dkv_ms:.3f} ms (bound {dkv_bound:.3f} ms, {dkv_by}; "
            f"{8.0 * b * h * s * s_k * d / dkv_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * dkv_bound / dkv_ms:.1f} % of bound), delta {delta_ms:.3f} ms, plain "
            f"(dq, dk, dv together) {plain_ms:.1f} ms, SDPA backward (dq, dk, dv together) "
            f"{lib_both - lib_fwd:.3f} ms; forward with lse {fwd_ms:.3f} ms (bound "
            f"{fwd_bound:.3f} ms), SDPA forward {lib_fwd:.3f} ms")
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


def exp2_ms(n):
    """Time of n exponentials at 16 per SM per clock (132 SMs at the 1.98 GHz
    boost clock): an explanation beside the int8 kernel, not its bound."""
    return n / (132 * 16 * 1.98e9) * 1e3


def rel_l1(a, b):
    return ((a.float() - b.float()).abs().mean() / b.float().abs().mean()).item()


def phase_int8_kernels(torch, fa, fa8):
    """Phase 1, int8: flash_int8_fwd against its plain version on the card.
    Returns its row's numbers."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mk(b, h, s, d=64):  # heads split from a [B, S, H*D] projection by a view
        return torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16).transpose(1, 2)

    def check(name, q, k, v, blk, pv, kw, exact=True):
        """One case: the kernel (through the wrapper) against the plain version.
        Returns the kernel's error and the plain version's time."""
        out = fa8.flash_attention_int8(q, k, v, blk_q=blk[0], blk_k=blk[1], int8_pv=pv, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = fa8.flash_attention_int8_reference(q, k, v, blk_q=blk[0], blk_k=blk[1],
                                                 int8_pv=pv, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ex = fa.flash_attention_reference(q, k, v, **kw) if pv and exact else None
        mode = "int8pv" if pv else "int8"
        err, tol = flash_err(out, ref)
        finite = bool(torch.isfinite(out).all())
        if pv:
            rel = rel_l1(out, ref)
            msg = (f"flash_int8_fwd {name} {mode} blk {blk}: rel_l1 {rel:.4f} "
                   f"(limit {INT8PV_REL_L1}), max_abs_err {err:.3e}")
            ok = rel <= INT8PV_REL_L1
            if ex is not None:
                r_k, r_p = rel_l1(out, ex), rel_l1(ref, ex)
                msg += (f"; vs exact: kernel {r_k:.4f}, plain {r_p:.4f} "
                        f"(limit {INT8PV_VS_EXACT}x)")
                ok = ok and r_k <= INT8PV_VS_EXACT * r_p
        else:
            msg = f"flash_int8_fwd {name} {mode} blk {blk}: max_abs_err {err:.3e} (tol {tol:.3e})"
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
    edges = [(f"TMA edge {s_q}x{s_k}, B*H 1", (1, 1, s_q, s_k), {}) for s_q, s_k in TMA_EDGES]
    worst = 0.0
    for name, (b, h, s_q, s_k), kw in cases + edges:
        for pv in (False, True):
            for blk in ((128, 128),) if name.startswith("TMA") else ((128, 128), (512, 2048)):
                q, k, v = mk(b, h, s_q), mk(b, h, s_k) + 0.7, mk(b, h, s_k)
                err, _ = check(name, q, k, v, blk, pv, kw)
                if not pv:
                    worst = max(worst, err)

    # keys 300..309 (the third 128-key tile) raise every row's max by about 16
    # (log2 units): the int8 mode's softmax without a max pass must fall back
    # to the exact one there
    c = torch.randn((64,), generator=gen, device="cuda")
    c = c / c.norm()
    q, k, v = mk(1, 2, 300) + 3 * c.to(torch.bfloat16), mk(1, 2, 700) + 0.7, mk(1, 2, 700)
    k[:, :, 300:310] += (30 * c).to(torch.bfloat16)
    for pv in (False, True):
        for blk in ((128, 128), (512, 2048)):
            err, _ = check("a later tile raises the max", q, k, v, blk, pv, {})
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
            args = (qq, d ** -0.5, s_k, None, 512, 2048, pv)
            ms = cuda_time_ms(lambda: fa8.flash_int8_fwd_cuda(*args), 10)
            pro_ms = cuda_time_ms(lambda: fa8.quantize_qkv(q, k, v, blk_q=512, blk_k=2048,
                                                           int8_pv=pv), 5)
            del qq, args
            bound, by = int8_bound_ms(b * h, s, s_k, d, pv)
            row[mode] = {"ms": ms, "prologue_ms": pro_ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            log(f"flash_int8_fwd flagship {s_k} keys {mode}: kernel {ms:.3f} ms "
                f"({4.0 * b * h * s * s_k * d / ms / 1e9:.1f} TOP/s, {100 * bound / ms:.1f} % "
                f"of bound), prologue {pro_ms:.3f} ms, plain {plain_ms:.1f} ms, bound "
                f"{bound:.3f} ms ({by}); exp2 count {b * h * s * s_k:.3e}, "
                f"{exp2_ms(b * h * s * s_k):.3f} ms at 16 per SM per clock")
        # the bf16 kernel on the same bf16 inputs, in turns with the int8 kernel
        # (the latter's operands quantized once, as above)
        qq = fa8.quantize_qkv(q, k, v, blk_q=512, blk_k=2048, int8_pv=False)
        int8_ms, row["b1_ms"], b1_turns = in_turns(torch, (
            lambda: fa.flash_fwd_cuda(q, k, v, d ** -0.5, s_k, None, False),
            lambda: fa8.flash_int8_fwd_cuda(qq, d ** -0.5, s_k, None, 512, 2048, False)), 10)
        del qq
        row["sdpa_bf16_ms"] = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), 10)
        log(f"  same bf16 inputs: bf16 kernel {row['b1_ms']:.3f} ms against int8 {int8_ms:.3f} ms "
            f"(in turns: " + ", ".join(f"{x:.3f}" for x in b1_turns) + f"), SDPA "
            f"{row['sdpa_bf16_ms']:.3f} ms (no PyTorch call computes int8 attention)")
        # held at the DiT's call (twice the keys); at 17,776 keys the two are
        # within the run-to-run spread of each other, and the line reports them
        if s_k == 2 * s and not int8_ms <= row["b1_ms"]:
            raise AssertionError(f"flash_int8_fwd int8 {s_k} keys: {int8_ms:.3f} ms is slower "
                                 f"than the bf16 kernel's {row['b1_ms']:.3f} ms in turns")
        shapes[s_k] = row
        del q, k, v

    main_shape = shapes[2 * s]["int8"]   # the call the DiT's 42 layers make
    b4 = {"max_abs_err": worst, "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
          "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
          "library_ms": None, "shape": f"[{b}x{h}, {s} q, {2 * s} keys, {d}] int8",
          "by_shape": {str(k): v for k, v in shapes.items()}}
    return b4


UNIFORM_PV_REL_L1 = 0.017   # B5's int8 P.V mode against its plain version: the kernel
                            # rounds P * 127 against each 128-key tile's running max, the
                            # plain version (as the TPU kernel) against each 2048-key block's


QK_PREP_SERVED = (2, 17776, 48)   # a served call: CFG batch 2, 226 + 17,550 tokens, 48 heads
QK_PREP_TRAIN = (1, 17776, 48)    # a training call: batch 1
QK_PREP_TEXT = 226


def qk_prep_operands(torch, batch, seq, heads, seed):
    """q and k as a served or training call hands them to the prep: bf16
    chunks of a to_qkv product (row stride 3 H 64), the flagship's rotary
    tables (49 frames at 480x720), bf16 norm weights near 1 and biases near
    0. Returns (q, k, norms, rope)."""
    from videopainter_tpu_torch.config import TransformerConfig
    from videopainter_tpu_torch.pipelines.common import prepare_rope
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, seq, 3 * heads * 64), generator=gen, device="cuda")
    x = (x * 2 + 0.3).to(torch.bfloat16)
    q, k, _ = x.chunk(3, dim=-1)
    norms = [((1 + 0.05 * torch.randn(64, generator=gen, device="cuda")).to(torch.bfloat16),
              (0.05 * torch.randn(64, generator=gen, device="cuda")).to(torch.bfloat16), 1e-6)
             for _ in range(2)]
    rope = prepare_rope(TransformerConfig.cogvideox_5b_i2v(), 480, 720, 13, device="cuda")
    if rope[0].shape[0] != seq - QK_PREP_TEXT:
        raise AssertionError(f"rope rows {rope[0].shape[0]} for {seq - QK_PREP_TEXT} video tokens")
    return q, k, norms, rope


def phase_qk_prep(torch, kernels):
    """Phase 1f: attention's prep kernels (csrc/qk_norm_rope.cu), no Pallas
    counterpart. The forward against its plain version (the eager
    composition) at the served shape [2, 17,776, 48, 64] (text 226): at most
    one bf16 ulp of the largest value apart, with the share of values that
    differ at all; the backward against fp32 autograd through the plain
    version at the training shape [1, 17,776, 48, 64] (relative L2 1e-3 for
    dx against the reference rounded to bf16, for dweight and dbias against
    fp32). Timed: the forward at both shapes beside its bytes bound (a bf16
    value read and written once: 4 B) and the plain version (in turns: plain,
    kernel, kernel, plain); the backward beside its bound (x and dy read, dx
    written: 6 B a value, plus the saved fp32 mean and rstd) and the plain
    version's autograd backward. Returns the kernels-line numbers."""
    import torch.nn.functional as F
    from videopainter_tpu_torch.ops import qk_prep
    t0 = time.perf_counter()
    q, k, norms, rope = qk_prep_operands(torch, *QK_PREP_SERVED, seed=1601)
    kw = dict(heads=QK_PREP_SERVED[2], norm_q=norms[0], norm_k=norms[1], rope=rope,
              text_len=QK_PREP_TEXT)
    with torch.no_grad():
        got = qk_prep.qk_norm_rope(q, k, **kw)
        torch.cuda.synchronize()
        log(f"qk_norm_rope: first call (build and launch) {time.perf_counter() - t0:.3f} s")
        ref = qk_prep.qk_norm_rope_reference(q, k, **kw)
        torch.cuda.synchronize()
        readings = []
        for name, g, r in zip("qk", got, ref):
            diff = (g.float() - r.float()).abs()
            top = r.float().abs().max().item()
            readings.append((name, diff.max().item(), top, (diff > 0).float().mean().item()))
        log("qk_norm_rope forward against its plain version at the served shape: " + "; ".join(
            f"{n}: max |kernel - plain| {e:.3e} (largest value {t:.3f}, one bf16 ulp there "
            f"{2.0 ** (math.floor(math.log2(t)) - 7):.3e}), values that differ {f * 100:.4f} %"
            for n, e, t, f in readings))
        for n, e, t, _ in readings:
            if e > 2.0 ** (math.floor(math.log2(t)) - 7):
                raise AssertionError(f"qk_norm_rope {n}: max |kernel - plain| {e} exceeds one "
                                     f"bf16 ulp of the largest value {t}")
        del got, ref

        def served_bytes(batch, seq, heads):
            return 2 * batch * seq * heads * 64 * (2 + 2)   # q and k, bf16 read and written

        n_iter = 20
        ms_new, ms_plain, turns = in_turns(
            torch, (lambda: qk_prep.qk_norm_rope_reference(q, k, **kw),
                    lambda: qk_prep.qk_norm_rope(q, k, **kw)), n_iter)
        bound_ms = served_bytes(*QK_PREP_SERVED) / H100_HBM_BYTES * 1e3
    del q, k
    # the training shape: the forward that keeps the statistics, then the backward
    q, k, norms, rope = qk_prep_operands(torch, *QK_PREP_TRAIN, seed=1602)
    heads = QK_PREP_TRAIN[2]
    kw_t = dict(heads=heads, rope=rope, text_len=QK_PREP_TEXT)
    p32 = [[t.float().requires_grad_() for t in n[:2]] for n in norms]
    fp_norms = [(*p, 1e-6) for p in p32]
    xs = [q, k]
    fwd_train_ms = cuda_time_ms(lambda: qk_prep.qk_norm_rope_fwd_cuda(
        xs, fp_norms, save_stats=True, **kw_t), n_iter)
    ys, stats = qk_prep.qk_norm_rope_fwd_cuda(xs, fp_norms, save_stats=True, **kw_t)
    gen = torch.Generator(device="cuda").manual_seed(1603)
    dys = [torch.randn(y.shape, generator=gen, device="cuda").to(torch.bfloat16) for y in ys]

    def bwd():
        return qk_prep.qk_norm_rope_bwd_cuda(xs, dys, fp_norms, stats, want_params=[True, True],
                                             **kw_t)

    dxs, dparams = bwd()
    bwd_ms = cuda_time_ms(bwd, n_iter)
    rx = [x.detach().float().requires_grad_() for x in xs]
    rp = [[t.detach().clone().requires_grad_() for t in p] for p in p32]
    ref = qk_prep.qk_norm_rope_reference(rx[0], rx[1], norm_q=(*rp[0], 1e-6),
                                         norm_k=(*rp[1], 1e-6), **kw_t)
    leaves = [rx[0], rx[1], *rp[0], *rp[1]]
    rgrads = torch.autograd.grad(ref, leaves, [d.float() for d in dys], retain_graph=True)
    got = [*dxs, *dparams[0], *dparams[1]]
    errs = []
    for i, (g, r) in enumerate(zip(got, rgrads)):
        r = r.to(torch.bfloat16).float() if i < 2 else r
        errs.append(((g.float() - r).norm() / r.norm()).item())
    log("qk_norm_rope backward against fp32 autograd through the plain version at the training "
        "shape, relative L2: " + ", ".join(
            f"{n} {e:.3e}" for n, e in zip(("dq", "dk", "dwq", "dbq", "dwk", "dbk"), errs)))
    if max(errs) > 1e-3:
        raise AssertionError(f"qk_norm_rope backward relative L2 {errs} above 1e-3")
    # the plain version's backward as training ran it: bf16 in, autograd through the
    # eager composition
    bx = [x.detach().requires_grad_() for x in xs]
    plain_out = qk_prep.qk_norm_rope_reference(bx[0], bx[1], norm_q=(*p32[0], 1e-6),
                                               norm_k=(*p32[1], 1e-6), **kw_t)
    plain_leaves = [*bx, *p32[0], *p32[1]]
    plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(plain_out, plain_leaves, dys,
                                                            retain_graph=True), 5)
    del rgrads, ref, plain_out
    n_val = 2 * math.prod(QK_PREP_TRAIN) * 64
    rows = 2 * math.prod(QK_PREP_TRAIN)
    train_bound_ms = served_bytes(*QK_PREP_TRAIN) / H100_HBM_BYTES * 1e3
    fwd_stats_bound_ms = (n_val * 4 + rows * 8) / H100_HBM_BYTES * 1e3
    bwd_bound_ms = (n_val * 6 + rows * 8) / H100_HBM_BYTES * 1e3
    log(f"qk_norm_rope {list(QK_PREP_SERVED)} x 64 (q and k, text {QK_PREP_TEXT}): kernel "
        f"{ms_new:.4f} ms against its bytes bound {bound_ms:.4f} ms "
        f"({served_bytes(*QK_PREP_SERVED) / 1e6:.0f} MB at 3.35 TB/s: {bound_ms / ms_new * 100:.1f} "
        f"% of it, {served_bytes(*QK_PREP_SERVED) / ms_new / 1e6:.0f} GB/s); plain version "
        f"{ms_plain:.3f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns) + "); "
        f"training shape {list(QK_PREP_TRAIN)}: forward with statistics {fwd_train_ms:.4f} ms "
        f"(bound {fwd_stats_bound_ms:.4f}), backward with dweight / dbias {bwd_ms:.4f} ms "
        f"(bound {bwd_bound_ms:.4f}: {bwd_bound_ms / bwd_ms * 100:.1f} %), plain version's "
        f"autograd backward {plain_bwd_ms:.3f} ms")
    return {"max_abs_err": max(e for _, e, _, _ in readings), "ms": ms_new, "plain_ms": ms_plain,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": [*QK_PREP_SERVED, 64], "ms_train_fwd": fwd_train_ms,
            "bound_ms_train_fwd": fwd_stats_bound_ms, "train_bound_ms_no_stats": train_bound_ms,
            "ms_bwd": bwd_ms, "bound_ms_bwd": bwd_bound_ms, "plain_ms_bwd": plain_bwd_ms,
            "bwd_rel_l2": errs}


GN_SHAPES = [   # (name, [B, C, T, H, W], groups, as `_per_frame_conv2d`'s channel / frame view)
    ("down0", (1, 128, 9, 480, 720), 32, False),        # down block 0's largest call
    ("down1_view", (1, 128, 5, 240, 360), 32, True),    # down block 1's first, after Downsample3D
    ("c512", (1, 512, 13, 60, 90), 32, False),
    ("one_frame", (1, 128, 1, 480, 720), 32, False),    # the first-frame encode's
]
GN_TARGET = 0.60   # the share of its bytes bound the pair reaches at down0 (bf16, SiLU)


def gn_operands(torch, shape, permuted, seed):
    """bf16 activations with an offset and a spread per channel (as the VAE's
    norms see them), contiguous or as `_per_frame_conv2d`'s view ([B, T, C, H,
    W] storage); bf16 weights near 1 and biases near 0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, t, h, w = shape
    per_c = lambda scale, add: (torch.rand(c, generator=gen, device="cuda") * scale + add)
    spread, off = per_c(2.5, 0.5), per_c(2.0, -1.0)
    if permuted:
        x = torch.randn((b, t, c, h, w), generator=gen, device="cuda")
        x = (x * spread[:, None, None] + off[:, None, None]).to(torch.bfloat16)
        x = x.permute(0, 2, 1, 3, 4)
    else:
        x = torch.randn(shape, generator=gen, device="cuda")
        x = (x * spread[:, None, None, None] + off[:, None, None, None]).to(torch.bfloat16)
    weight = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    return x, weight, bias


def phase_group_norm(torch, kernels):
    """Phase 1g: the VAE's GroupNorm + SiLU (csrc/group_norm_silu.cu), no
    Pallas counterpart, at the encoder's shapes (`GN_SHAPES`), bf16 with the
    SiLU. Each call against the function in float64 rounded where the plain
    version rounds: within two bf16 spacings at the largest of |value|,
    |affine value| and 1/256 of the terms the affine adds (the statistics can
    flip the affine's rounding once, the SiLU's slope is at most 1.1, and
    where the terms cancel an fp32 affine keeps its error of them); against
    the plain version relative L2 2^-9 (its fp32 Welford statistics are about
    1e-5 off at these sizes); the mean and rstd against float64 (1e-5 of
    |mean| + std, 1e-4 relative); two launches. Timed in turns with the plain version (plain, kernel, kernel,
    plain), beside the bytes bound (x read twice, y written once: 6 B a
    value) and `F.silu(F.group_norm(x))` on the bf16 input as `library_ms`.
    Returns the kernels-line numbers."""
    import torch.nn.functional as F
    from videopainter_tpu_torch.ops import group_norm as gn
    rows, worst = {}, 0.0
    for name, shape, groups, permuted in GN_SHAPES:
        x, w, b = gn_operands(torch, shape, permuted, seed=1801)
        if permuted == x.is_contiguous():
            raise AssertionError(f"{name}: the operand's layout is not the one asked for")
        with torch.no_grad():
            t0 = time.perf_counter()
            before = dict(kernels.LAUNCHES)
            y, mean, rstd = gn.group_norm_silu_cuda(x, groups, w, b, eps=1e-6, silu=True,
                                                    stats=True)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if any(kernels.LAUNCHES[k] != before[k] + 1 for k in VAE_NORM_KEYS):
                raise AssertionError(f"{name}: launches {kernels.LAUNCHES}, before {before}")
            x64 = x.double().reshape(shape[0], groups, -1)
            m64 = x64.mean(-1)
            r64 = torch.rsqrt(x64.var(-1, unbiased=False) + 1e-6)
            del x64
            mean_err = ((mean.double() - m64).abs() / (m64.abs() + 1 / r64)).max().item()
            rstd_err = ((rstd.double() - r64).abs() / r64).max().item()
            # the function in float64, rounded where the plain version rounds
            cg = shape[1] // groups
            a = (r64.repeat_interleave(cg, dim=1)[..., None, None, None]
                 * w.double()[:, None, None, None])
            sh = (b.double()[:, None, None, None]
                  - m64.repeat_interleave(cg, dim=1)[..., None, None, None] * a)
            aff = (x.double() * a + sh).to(x.dtype)
            ref = F.silu(aff.double()).to(x.dtype).float()
            aff = aff.float()
            # the scale of a value: |ref|, |affine|, or 1/256 of the terms the fp32 affine adds
            # (|x a| + |s|), where they cancel and any fp32 affine keeps an error of them
            scale = x.float().abs().mul_(a.abs().float()).add_(sh.abs().float()).div_(256)
            scale = torch.maximum(torch.maximum(ref.abs(), aff.abs()), scale)
            _, e = torch.frexp(scale.clamp_min(1e-30))
            del scale
            spacing = torch.ldexp(torch.ones_like(aff), e - 8)
            del e
            diff = (y.float() - ref).abs()
            gaps = diff / spacing
            at = int(gaps.argmax())
            gap = gaps.flatten()[at].item()
            share = (diff > 0).float().mean().item()
            worst_at = (f"kernel {y.flatten()[at].item():.6g}, float64 {ref.flatten()[at].item():.6g}"
                        f", affine {aff.flatten()[at].item():.6g}, x {x.flatten()[at].item():.6g}"
                        f", spacing {spacing.flatten()[at].item():.3g}")
            del gaps, diff
            plain = gn.group_norm_silu_reference(x, groups, w, b, eps=1e-6, silu=True)
            plain_gap = ((plain.float() - ref).abs() / spacing).max().item()
            plain_l2 = ((y.float() - plain.float()).norm() / plain.float().norm()).item()
            del aff, ref, spacing, plain
            log(f"group_norm_silu {name} {list(shape)} g{groups} "
                f"{'view' if permuted else 'contiguous'}: first call {first_s:.3f} s; against "
                f"float64 largest gap {gap:.3f} bf16 spacings ({worst_at}), {share * 100:.4f} % of "
                f"values differ (the plain version's largest {plain_gap:.3f}); against the plain "
                f"version relative L2 {plain_l2:.2e}; mean error {mean_err:.2e} of |mean| + std, "
                f"rstd {rstd_err:.2e}")
            if gap > 2.0 or plain_l2 > 2 ** -9 or mean_err > 1e-5 or rstd_err > 1e-4:
                raise AssertionError(f"group_norm_silu {name}: gap {gap}, against plain "
                                     f"{plain_l2}, mean {mean_err}, rstd {rstd_err}")
            worst = max(worst, gap)
            del y, mean, rstd
            n_iter = 10
            ms, plain_ms, turns = in_turns(
                torch, (lambda: gn.group_norm_silu_reference(x, groups, w, b, eps=1e-6,
                                                             silu=True),
                        lambda: gn.group_norm_silu(x, groups, w, b, eps=1e-6, silu=True)),
                n_iter)
            library_ms = cuda_time_ms(lambda: F.silu(F.group_norm(x, groups, w, b, 1e-6)),
                                      n_iter)
        nbytes = 6 * x.numel()
        bound_ms = nbytes / H100_HBM_BYTES * 1e3
        rows[name] = {"shape": list(shape), "groups": groups, "view": permuted, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                      "share_of_bound": bound_ms / ms, "max_ulp_gap": gap}
        log(f"group_norm_silu {name}: kernels {ms:.4f} ms against its bytes bound "
            f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at 3.35 TB/s: {bound_ms / ms * 100:.1f} % "
            f"of it, {nbytes / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms (in turns: "
            + ", ".join(f"{t:.4f}" for t in turns) + f"); F.group_norm + F.silu on bf16 "
            f"{library_ms:.3f} ms")
        del x
    head = rows["down0"]
    log(f"group_norm_silu targets: down0 at {head['share_of_bound'] * 100:.1f} % of its bytes "
        f"bound (target {GN_TARGET * 100:.0f} %: "
        f"{'met' if head['share_of_bound'] >= GN_TARGET else 'missed'})")
    return {"max_ulp_gap": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": rows}


ADALN_SHAPES = [   # (name, batch, video rows, text rows): the rows a LayerNormZero call sees
    ("served", 2, 17776, 226),     # cell 1's CFG batch (17,550 video rows a clip; 17,776 the joint)
    ("served15", 2, 44880, 226),   # the 1.5 cell's: 45,106 joint tokens
    ("train", 1, 17550, 226),      # a training call: batch 1
]
ADALN_DIM = 3072
ADALN_TARGET = 0.70   # the share of its bytes bound the forward reaches at the served shape


def adaln_operands(torch, batch, rows, text, seed):
    """bf16 rows with an offset and a spread each (a block's residual
    stream), the fp32 modulation as `mod.chunk(6)` views, bf16 norm weights
    near 1 and biases near 0. Returns (x, enc, (shift, scale, enc_shift,
    enc_scale), weight, bias)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rows_of(n):
        x = torch.randn((batch, n, ADALN_DIM), generator=gen, device="cuda")
        spread = torch.rand((batch, n, 1), generator=gen, device="cuda") * 2.5 + 0.5
        return (x * spread + torch.rand((batch, n, 1), generator=gen, device="cuda") - 0.5).to(
            torch.bfloat16)

    x, enc = rows_of(rows), rows_of(text)
    mod = 0.5 * torch.randn((batch, 6 * ADALN_DIM), generator=gen, device="cuda")
    shift, scale, _, enc_shift, enc_scale, _ = mod.chunk(6, dim=-1)
    w = (1 + 0.1 * torch.randn(ADALN_DIM, generator=gen, device="cuda")).to(torch.bfloat16)
    b = (0.1 * torch.randn(ADALN_DIM, generator=gen, device="cuda")).to(torch.bfloat16)
    return x, enc, (shift, scale, enc_shift, enc_scale), w, b


def row_ulp_gap(torch, got, ref):
    """The largest |got - ref| in bf16 ulps of each row's largest |ref|."""
    r = ref.float()
    _, e = torch.frexp(r.abs().amax(-1, keepdim=True).clamp_min(1e-30))
    return ((got.float() - r).abs() / torch.ldexp(torch.ones_like(r[..., :1]), e - 8)).max().item()


def adaln_reference_grads(torch, A, xs, mods, w, b, dys):
    """fp32 autograd through the plain version: (dx of each stream, d_shift,
    d_scale of each, dweight, dbias). dx, dweight and dbias on fp32 copies of
    the rows; the modulation's on the rows as they are, since its d_scale is
    a sum of dy times the normed row rounded to the rows' dtype (what the
    forward multiplied by 1 + scale), which an fp32 copy does not round."""
    out = []
    for rows_dtype in (torch.float32, None):
        rx = [t.detach().to(rows_dtype or t.dtype).requires_grad_() for t in xs]
        rm = [t.detach().clone().requires_grad_() for t in mods]
        rw, rb = (t.detach().clone().requires_grad_() for t in (w, b))
        ref = A.adaln_reference(rx[0], rm[0], rm[1], rw, rb, eps=1e-5, enc=rx[1],
                                enc_shift=rm[2], enc_scale=rm[3])
        out.append(torch.autograd.grad(ref, [*rx, *rm, rw, rb], [d.float() for d in dys]))
    full, as_run = out
    return [*full[:2], *as_run[2:6], *full[6:]]


def phase_adaln(torch, kernels):
    """Phase 1h: AdaLN's kernels (csrc/adaln.cu), no Pallas counterpart. The
    forward against its plain version (the eager chain) at cell 1's shape
    [2, 17,776, 3,072] + [2, 226, 3,072], the 1.5 cell's [2, 44,880] + [2,
    226] and the training call's [1, 17,550] + [1, 226] (bf16, bf16 weights):
    within one bf16 ulp of each row's largest value; one launch a call. The
    backward against fp32 autograd through the plain version at the training
    shape (relative L2 1e-3 for dx against the reference rounded to bf16, for
    d_shift, d_scale, dweight and dbias against fp32; `adaln_reference_grads`).
    Timed: the forward at
    each shape beside its bytes bound (a bf16 value read and written once: 4 B,
    plus 8 B a row of statistics where kept) and the plain version (in turns:
    plain, kernel, kernel, plain); the backward with every gradient beside
    its bound (x and dy read, dx written: 6 B a value, plus the statistics)
    and the plain version's autograd backward. Returns the kernels-line
    numbers."""
    from videopainter_tpu_torch.ops import adaln as A
    rows_out, worst = {}, 0.0
    for name, batch, rows, text in ADALN_SHAPES:
        x, enc, (sh, sc, esh, esc), w, b = adaln_operands(torch, batch, rows, text, seed=2001)
        kw = dict(eps=1e-5, enc=enc, enc_shift=esh, enc_scale=esc)
        with torch.no_grad():
            t0 = time.perf_counter()
            before = kernels.LAUNCHES["adaln_fwd"]
            got = A.adaln(x, sh, sc, w, b, **kw)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            if kernels.LAUNCHES["adaln_fwd"] != before + 1:
                raise AssertionError(f"adaln {name}: {kernels.LAUNCHES['adaln_fwd'] - before} "
                                     "launches for one call")
            ref = A.adaln_reference(x, sh, sc, w, b, **kw)
            gaps = [row_ulp_gap(torch, g, r) for g, r in zip(got, ref)]
            share = sum((g != r).sum().item() for g, r in zip(got, ref)) / (x.numel() + enc.numel())
            del got, ref
            n_iter = 20
            ms, plain_ms, turns = in_turns(
                torch, (lambda: A.adaln_reference(x, sh, sc, w, b, **kw),
                        lambda: A.adaln(x, sh, sc, w, b, **kw)), n_iter)
            streams = [(x, sh, sc), (enc, esh, esc)]
            stats_ms = cuda_time_ms(lambda: A.adaln_fwd_cuda(streams, w, b, eps=1e-5,
                                                             save_stats=True), n_iter)
        n_val = x.numel() + enc.numel()
        n_rows = batch * (rows + text)
        bound_ms = 4 * n_val / H100_HBM_BYTES * 1e3
        stats_bound_ms = (4 * n_val + 8 * n_rows) / H100_HBM_BYTES * 1e3
        worst = max(worst, *gaps)
        rows_out[name] = {"shape": [batch, rows, text, ADALN_DIM], "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
                          "ms_with_stats": stats_ms, "bound_ms_with_stats": stats_bound_ms,
                          "max_row_ulp_gap": max(gaps)}
        log(f"adaln {name} [{batch}, {rows} + {text}, {ADALN_DIM}] bf16: first call (build and "
            f"launch) {first_s:.3f} s; against its plain version largest gap "
            f"{gaps[0]:.3f} / {gaps[1]:.3f} bf16 ulp of the row's max (video / text rows), "
            f"{share * 100:.4f} % of values differ; kernel {ms:.4f} ms against its bytes bound "
            f"{bound_ms:.4f} ms ({4 * n_val / 1e6:.0f} MB at 3.35 TB/s: "
            f"{bound_ms / ms * 100:.1f} % of it, {4 * n_val / ms / 1e6:.0f} GB/s); with the "
            f"statistics kept {stats_ms:.4f} ms (bound {stats_bound_ms:.4f}); plain version "
            f"{plain_ms:.3f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns) + ")")
        if max(gaps) > 1.0:
            raise AssertionError(f"adaln {name}: kernel against plain {gaps} bf16 ulps of the "
                                 "row's max, above 1")
        if name != "train":
            del x, enc
            continue
        # the backward at the training shape, every gradient wanted (a branch block)
        gen = torch.Generator(device="cuda").manual_seed(2002)
        dys = [torch.randn(t.shape, generator=gen, device="cuda").to(torch.bfloat16)
               for t in (x, enc)]
        w32, b32 = w.float(), b.float()
        _, stats = A.adaln_fwd_cuda(streams, w32, b32, eps=1e-5, save_stats=True)

        def bwd():
            return A.adaln_bwd_cuda(streams, dys, stats, w32, b32, want_params=True)

        dxs, (mod_grads, dw, db) = bwd()
        bwd_ms = cuda_time_ms(bwd, n_iter)
        bwd_dx_ms = cuda_time_ms(lambda: A.adaln_bwd_cuda(streams, dys, stats, w32, b32,
                                                          want_params=False), n_iter)
        rgrads = adaln_reference_grads(torch, A, (x, enc), (sh, sc, esh, esc), w32, b32, dys)
        got = [*dxs, *mod_grads[0], *mod_grads[1], dw, db]
        errs = []
        for i, (g, r) in enumerate(zip(got, rgrads)):
            r = r.to(torch.bfloat16).float() if i < 2 else r
            errs.append(((g.float() - r).norm() / r.norm()).item())
        del rgrads
        log("adaln backward against fp32 autograd through the plain version at the training "
            "shape, relative L2: " + ", ".join(
                f"{n} {e:.3e}" for n, e in zip(("dx", "d_enc", "d_shift", "d_scale",
                                                 "d_enc_shift", "d_enc_scale", "dweight",
                                                 "dbias"), errs)))
        if max(errs) > 1e-3:
            raise AssertionError(f"adaln backward relative L2 {errs} above 1e-3")
        # the plain version's backward as training ran it: autograd through the eager chain
        bx = [t.detach().requires_grad_() for t in (x, enc)]
        bm = [t.detach().clone().requires_grad_() for t in (sh, sc, esh, esc)]
        bw, bb = (t.detach().clone().requires_grad_() for t in (w32, b32))
        plain_out = A.adaln_reference(bx[0], bm[0], bm[1], bw, bb, eps=1e-5, enc=bx[1],
                                      enc_shift=bm[2], enc_scale=bm[3])
        plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
            plain_out, [*bx, *bm, bw, bb], dys, retain_graph=True), 5)
        del plain_out
        bwd_bound_ms = (6 * n_val + 8 * n_rows) / H100_HBM_BYTES * 1e3
        rows_out[name].update(ms_bwd=bwd_ms, ms_bwd_dx_only=bwd_dx_ms, bound_ms_bwd=bwd_bound_ms,
                              plain_ms_bwd=plain_bwd_ms, bwd_rel_l2=errs)
        log(f"adaln backward [{batch}, {rows} + {text}, {ADALN_DIM}]: every gradient {bwd_ms:.4f} "
            f"ms, dx alone {bwd_dx_ms:.4f} ms, against its bytes bound {bwd_bound_ms:.4f} ms "
            f"({bwd_bound_ms / bwd_ms * 100:.1f} % / {bwd_bound_ms / bwd_dx_ms * 100:.1f} % of "
            f"it); plain version's autograd backward {plain_bwd_ms:.3f} ms")
        del x, enc, dys, dxs, stats
    head = rows_out["served"]
    log(f"adaln targets: the served forward at {head['share_of_bound'] * 100:.1f} % of its bytes "
        f"bound, {head['ms']:.4f} ms (target {ADALN_TARGET * 100:.0f} %, "
        f"{head['bound_ms'] / ADALN_TARGET:.3f} ms: "
        f"{'met' if head['share_of_bound'] >= ADALN_TARGET else 'missed'})")
    return {"max_row_ulp_gap": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "shape": head["shape"], "shapes": rows_out}


def phase_uniform_kernels(torch, fa8):
    """Phase 1, the uniform-scale int8 kernel (csrc/flash_int8_uniform_wgmma.cu)
    against its plain version in both modes: a masked tail of S not a multiple
    of 128, a third tile that raises every row's max by about 16 (log2 units,
    the bf16 mode's fallback), scores at the extreme |s| = 64 * 127^2, and
    the tool's shape [96, 17,776, 64], where it is timed in turns against the
    SageAttention kernel (B4) on the same int8 operands with uniform scale
    tables. Returns its row."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    d = 64
    sm = d ** -0.5

    def per_tensor(x):   # the tool's quantization: one scale max|x| / 127
        sc = x.abs().max().item() / 127.0
        return torch.round(x / sc).to(torch.int8), sc

    def operands(n, s_len, q_shift=None, k_rows=None):
        q = torch.randn((n, s_len, d), generator=gen, device="cuda")
        k = torch.randn((n, s_len, d), generator=gen, device="cuda") + 0.7
        v = torch.randn((n, s_len, d), generator=gen, device="cuda")
        if q_shift is not None:
            q += q_shift
            k[:, k_rows] += 10 * q_shift
        (qi, sq), (ki, sk), (vi, _) = per_tensor(q), per_tensor(k), per_tensor(v)
        return qi, ki, v.to(torch.bfloat16), vi, sq * sk

    def check(name, qi, ki, vb, vi, deq, kv_len, timed=False):
        res = {}
        for pv, v in ((False, vb), (True, vi)):
            mode = "int8-qk-pv" if pv else "int8-qk"
            out = fa8.int8_flash_uniform(qi, ki, v, sm, deq, kv_len, int8_pv=pv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = fa8.int8_flash_uniform_reference(qi, ki, v, sm, deq, kv_len, int8_pv=pv)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err, tol = flash_err(out, ref)
            finite = bool(torch.isfinite(out).all())
            msg = (f"flash_int8_uniform_fwd {name} kv_len {kv_len} {mode}: max_abs_err "
                   f"{err:.3e} (tol {tol:.3e})")
            ok = err <= tol
            if pv:
                rel = rel_l1(out, ref)
                # exact attention: the fp32 softmax and fp32 P.V on the same integers
                ex = fa8.int8_flash_uniform_reference(qi, ki, vi.float(), sm, deq, kv_len)
                r_k, r_p = rel_l1(out, ex), rel_l1(ref, ex)
                msg = (f"flash_int8_uniform_fwd {name} kv_len {kv_len} {mode}: rel_l1 "
                       f"{rel:.4f} (limit {UNIFORM_PV_REL_L1}); vs exact: kernel {r_k:.4f}, "
                       f"plain {r_p:.4f}")
                ok = rel <= UNIFORM_PV_REL_L1 and r_k <= r_p
                del ex
            log(msg + f", finite {finite}")
            if not (ok and finite):
                raise AssertionError(msg)
            res[mode] = {"max_abs_err": err, "plain_ms": plain_ms}
        return res

    worst = 0.0
    # a masked tail: S not a multiple of 128, kv_len inside the last tile but one
    r = check("[6, 1000, 64]", *operands(6, 1000), kv_len=901)
    worst = max(worst, r["int8-qk"]["max_abs_err"])
    # keys 256..265 (the third 128-key tile) raise every row's max by about 16 in
    # log2 units: the bf16 mode's softmax without a max pass must fall back there
    c = torch.randn((d,), generator=gen, device="cuda")
    c = 3 * c / c.norm()
    r = check("third tile raises the max", *operands(2, 700, c, slice(256, 266)), kv_len=700)
    worst = max(worst, r["int8-qk"]["max_abs_err"])
    # the extreme magnitude: rows of +-127 against keys of +-127 along the same
    # signs, so scores reach +-64 * 127^2 = +-1,032,256 (the shifted floats'
    # range) and f * s spans about 68 in log2 units
    sign = torch.where(torch.rand((d,), generator=gen, device="cuda") < 0.5, -1, 1)
    qi = torch.randint(-127, 128, (2, 500, d), generator=gen, device="cuda", dtype=torch.int8)
    ki = torch.randint(-127, 128, (2, 500, d), generator=gen, device="cuda", dtype=torch.int8)
    qi[:, ::2] = (127 * sign).to(torch.int8)
    ki[:, 3::7] = (127 * sign).to(torch.int8)
    ki[:, 5::7] = (-127 * sign).to(torch.int8)
    vi = torch.randint(-127, 128, (2, 500, d), generator=gen, device="cuda", dtype=torch.int8)
    vb = (vi.float() / 127).to(torch.bfloat16)
    s_max = (qi[0, 0].int() * ki[0, 3].int()).sum().item()
    log(f"extreme case: largest score {s_max} (64 * 127^2 = {64 * 127 ** 2})")
    if s_max != 64 * 127 ** 2:
        raise AssertionError("the extreme case does not reach 64 * 127^2")
    r = check("extreme scores", qi, ki, vb, vi, 3.0 / 127 ** 2, kv_len=500)
    worst = max(worst, r["int8-qk"]["max_abs_err"])

    # the tool's call: 96 batch-heads x 17,776 tokens, its operands (N(0, 0.25)
    # in bf16, quantized per tensor by the tool's own function)
    from videopainter_tpu_torch.tools.bench_int8_attn import quantize_per_tensor
    n, s = 96, 17776
    q, k, vb = (torch.randn((n, s, d), generator=gen, device="cuda").mul_(0.5)
                .to(torch.bfloat16) for _ in range(3))
    (qi, sq), (ki, sk), (vi, _) = map(quantize_per_tensor, (q, k, vb))
    deq = sq * sk
    del q, k
    flag = check(f"[{n}, {s}, {d}]", qi, ki, vb, vi, deq, kv_len=s)
    worst = max(worst, flag["int8-qk"]["max_abs_err"])
    row = {}
    for pv, v in ((False, vb), (True, vi)):
        mode = "int8-qk-pv" if pv else "int8-qk"
        # B4 on the same operands, its scale tables filled uniformly (sq = 1,
        # sk = deq, sv = 1): what the one-scale specialisation buys
        nb = -(-s // 2048)
        qq = fa8.QuantizedQKV(qi[None], ki[None], v[None],
                              torch.ones((1, n, -(-s // 512)), device="cuda"),
                              torch.full((1, n, nb), deq, device="cuda"),
                              torch.ones((1, n, nb), device="cuda") if pv else None)
        ms, ms_b4, b4_turns = in_turns(torch, (
            lambda: fa8.flash_int8_fwd_cuda(qq, sm, s, None, 512, 2048, pv),
            lambda: fa8.int8_flash_uniform(qi, ki, v, sm, deq, s, int8_pv=pv)), 10)
        b4_out = fa8.flash_int8_fwd_cuda(qq, sm, s, None, 512, 2048, pv)
        b5_out = fa8.int8_flash_uniform(qi, ki, v, sm, deq, s, int8_pv=pv)
        same = rel_l1(b5_out, b4_out)
        del qq, b4_out, b5_out
        bound, by = int8_bound_ms(n, s, s, d, pv)
        row[mode] = {"ms": ms, "b4_uniform_ms": ms_b4, "plain_ms": flag[mode]["plain_ms"],
                     "bound_ms": bound, "bound_by": by}
        log(f"flash_int8_uniform_fwd [{n}, {s}, {d}] {mode}: kernel {ms:.3f} ms "
            f"({4.0 * n * s * s * d / ms / 1e9:.1f} TOP/s, {100 * bound / ms:.1f} % of bound "
            f"{bound:.3f} ms, {by}); B4 with uniform tables {ms_b4:.3f} ms (in turns: "
            + ", ".join(f"{x:.3f}" for x in b4_turns) + f"; outputs differ by rel_l1 "
            f"{same:.2e}); plain {flag[mode]['plain_ms']:.1f} ms")
    qk = row["int8-qk"]
    log(f"flash_int8_uniform_fwd targets: int8-qk {qk['ms']:.3f} ms against B4's "
        f"{qk['b4_uniform_ms']:.3f} (target: no slower); int8-qk-pv "
        f"{row['int8-qk-pv']['ms']:.3f} ms against B4's "
        f"{row['int8-qk-pv']['b4_uniform_ms']:.3f}")
    return {"max_abs_err": worst, "ms": qk["ms"],
            "plain_ms": qk["plain_ms"], "bound_ms": qk["bound_ms"], "bound_by": qk["bound_by"],
            "library_ms": None, "shape": f"[{n}, {s}, {d}] int8", "by_mode": row}


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


def phase_pipeline(torch, kernels):
    """Phase 2: the full-width flagship pipeline driven by a prompt, encoded
    by T5-v1.1-XXL at its published width; then the same call given those
    embeddings, which must give the same video bit for bit. Returns the
    launch counts of the prompt-driven run."""
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.flagship import (FLAGSHIP_CALL, build_pipeline,
                                                 build_text_encoder, random_clip)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    te = build_text_encoder(4321)
    torch.cuda.synchronize()
    t5_params = sum(p.numel() for p in te.model.parameters())
    t5_bytes = sum(p.numel() * p.element_size() for p in te.model.parameters())
    log(f"T5-v1.1-XXL: {te.model.config.num_layers} layers, d_model {te.model.config.d_model}, "
        f"{te.model.config.num_heads} heads, d_ff {te.model.config.d_ff}; {t5_params / 1e9:.3f} "
        f"B parameters, {t5_bytes / 1e9:.3f} GB bf16, built in {time.perf_counter() - t0:.1f} s")
    prompt = ("a white swan gliding across a calm lake at sunrise, mist over the water, "
              "reeds along the shore")
    enc_ms = []
    for text in (prompt, "", prompt, "", prompt, ""):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        emb = te.encode(text)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - s0) * 1e3)
    pos, neg = te.encode_with_negative(prompt)
    log(f"T5 encode at {te.max_length} tokens: " + ", ".join(f"{x:.2f}" for x in enc_ms)
        + f" ms (prompt, empty prompt, in turns; the first call's includes the libraries' "
        f"set-up); embeddings {tuple(emb.shape)} {emb.dtype}, finite "
        f"{bool(torch.isfinite(pos).all() and torch.isfinite(neg).all())}, |prompt| rms "
        f"{pos.float().square().mean().sqrt().item():.4f}")
    if not (torch.isfinite(pos).all() and torch.isfinite(neg).all()) or torch.equal(pos, neg):
        raise AssertionError("T5 embeddings are not finite, or the prompt's equal the empty one's")

    t0 = time.perf_counter()
    tcfg = TransformerConfig.cogvideox_5b_i2v()
    pipe = build_pipeline(gen, tcfg=tcfg, branch_layers=2, vcfg=VAEConfig())
    pipe.text_encoder = te
    vae = pipe.vae
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.transformer, pipe.branch, vae)
                   for p in m.parameters())
    log(f"full width: {tcfg.num_layers}-layer DiT, 2-layer branch, "
        f"{tcfg.num_attention_heads}x{tcfg.attention_head_dim} heads, VAE "
        f"{VAEConfig().block_out_channels}; {n_params / 1e9:.3f} B params bf16, "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident with T5")
    f, hgt, wid = 49, 480, 720
    clip = random_clip(gen, frames=f, height=hgt, width=wid)
    del clip["prompt_embeds"], clip["negative_prompt_embeds"]

    stamps = {}
    enc_s, dec_s, t5_s = [], [], []
    vae.encode = timed_calls(torch, vae.encode, enc_s)
    vae.decode = timed_calls(torch, vae.decode, dec_s)
    te.encode = timed_calls(torch, te.encode, t5_s)

    def progress(i, n):
        torch.cuda.synchronize()
        stamps[i] = time.perf_counter()

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the two runs must pick the same algorithms
    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        gen.manual_seed(99)
        start = time.perf_counter()
        out = pipe(**clip, prompt=prompt, negative_prompt="", num_inference_steps=2,
                   generator=gen, output_type="pt", progress_fn=progress, **FLAGSHIP_CALL)
        torch.cuda.synchronize()
        total = time.perf_counter() - start
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        gen.manual_seed(99)
        given = pipe(**clip, prompt_embeds=pos, negative_prompt_embeds=neg,
                     num_inference_steps=2, generator=gen, output_type="pt", **FLAGSHIP_CALL)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = cudnn_det

    expected = (tcfg.num_layers + 2) * 2
    shape_ok = tuple(out.shape) == (1, f, hgt, wid, 3)
    finite = bool(torch.isfinite(out).all())
    same = torch.equal(out, given)
    denoise_start = start + sum(enc_s[:len(enc_s) // 2]) + sum(t5_s[:2])
    steps = [stamps[1] - denoise_start, stamps[2] - stamps[1]]
    log(f"pipeline from a prompt: out {tuple(out.shape)} finite {finite}; flash_fwd launches "
        f"{launches['flash_fwd']}, qk_norm_rope launches {launches['qk_norm_rope']} (expected "
        f"{expected} each = 44 layers x 2 steps); equal to the "
        f"run given the same embeddings: {same} (max |diff| "
        f"{(out.float() - given.float()).abs().max().item():.3e})")
    log(f"pipeline wall times: T5 encodes {sum(t5_s[:2]):.3f} s (prompt and negative prompt), "
        f"VAE encode {sum(enc_s[:len(enc_s) // 2]):.3f} s, denoise step 1 {steps[0]:.3f} s, "
        f"step 2 {steps[1]:.3f} s, VAE decode {dec_s[0]:.3f} s, total {total:.3f} s; peak "
        f"memory {peak / 2**30:.2f} GiB with T5 resident ({t5_bytes / 2**30:.2f} GiB of it: the "
        f"pipeline keeps its text encoder through the denoise)")
    if not (shape_ok and finite):
        raise AssertionError(f"pipeline output {tuple(out.shape)} finite={finite}")
    if not same:
        raise AssertionError("the prompt-driven run differs from the run given its embeddings")
    if launches["flash_fwd"] != expected or launches["qk_norm_rope"] != expected:
        raise AssertionError(f"flash_fwd / qk_norm_rope launched {launches['flash_fwd']} / "
                             f"{launches['qk_norm_rope']} times, expected {expected}")
    adaln_expected = (2 * (tcfg.num_layers + 2) + 1) * 2   # norm1, norm2 a block; norm_out
    log(f"adaln_fwd launches {launches['adaln_fwd']} (expected {adaln_expected} = (2 x 44 "
        f"blocks + norm_out) x 2 steps), adaln_bwd {launches['adaln_bwd']}")
    if launches["adaln_fwd"] != adaln_expected or launches["adaln_bwd"]:
        raise AssertionError(f"adaln launched {launches['adaln_fwd']} / {launches['adaln_bwd']} "
                             f"times, expected {adaln_expected} / 0")
    del vae.encode, vae.decode   # the timing wrappers
    pipe.text_encoder = None   # T5 goes; phases 9 and 8 reuse the pipeline's models
    return launches, pipe


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [] if tree is None else [tree]


STREAM_PSNR_DB = 60.0   # streamed against one-shot frames, should cuDNN pick another algorithm


IMPORTS = ("cv2", "pandas", "safetensors", "transformers")


def optional_imports():
    """{name: version or None} of the optional readers and libraries."""
    import importlib
    out = {}
    for name in IMPORTS:
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "?")
        except ImportError:
            out[name] = None
    return out


def write_checkpoint(root, transformer, branch, vae, lora=None, shard_bytes=None):
    """The diffusers layout the inference CLI reads, written by the port's
    exports: <root>/model/transformer (in its own dtype, sharded at
    `shard_bytes`), <root>/model/vae, <root>/branch, and with `lora` the
    adapter's pytorch_lora_weights.safetensors in <root>/lora. Returns the
    bytes written."""
    import os
    from videopainter_tpu_torch.training import checkpoint as ckpt

    n = ckpt.export_transformer_pretrained(
        transformer, transformer.cfg.to_dict(), os.path.join(root, "model", "transformer"),
        dtype=transformer.proj_out.weight.dtype, max_shard_bytes=shard_bytes)
    n += ckpt.export_vae_pretrained(vae, vae.cfg.to_dict(), os.path.join(root, "model", "vae"))
    n += ckpt.export_branch_pretrained(branch, branch.cfg.to_dict(), os.path.join(root, "branch"))
    if lora is not None:
        n += ckpt.export_lora_weights(lora, os.path.join(root, "lora"))
    return n


def write_tiny_checkpoint(torch, root, gen, tcfg, vae, embeds, dtype, lora=False):
    """The tiny checkpoint of the small CLI phases (10, 11) in `root`: a DiT
    of `tcfg` and its branch in `dtype` from `gen` (the branch's projections
    non-zero, so that it acts), `vae`, with `lora` a random ID adapter, and
    `embeds` as embeds.npy."""
    import os
    import numpy as np
    from videopainter_tpu_torch.config import BranchConfig
    from videopainter_tpu_torch.flagship import random_lora
    from videopainter_tpu_torch.models import CogVideoXBranch, CogVideoXTransformer3D

    def build(ctor):
        return ctor(device="meta", dtype=dtype).to_empty(device="cuda").init_random_(gen)

    dit = build(lambda **kw: CogVideoXTransformer3D(tcfg, **kw))
    br = build(lambda **kw: CogVideoXBranch(BranchConfig.from_transformer(tcfg), **kw))
    for lin in br.branch_blocks:
        torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
    write_checkpoint(root, dit, br, vae, random_lora(gen, dit) if lora else None)
    np.save(os.path.join(root, "embeds.npy"), embeds.cpu().numpy())


def moving_masks(frames, height, width):
    """uint8 masks [T, H, W]: a rectangular hole (half of each side) that
    moves right by 2 pixels a frame."""
    import numpy as np
    masks = np.zeros((frames, height, width), np.uint8)
    for t in range(frames):
        x0 = width // 8 + 2 * t
        masks[t, height // 4:3 * height // 4, x0:x0 + width // 2] = 1
    return masks


def moving_mask_clip(torch, generator, frames, height, width):
    """uint8 frames [T, H, W, 3] and `moving_masks`, as numpy."""
    video = torch.randint(0, 256, (frames, height, width, 3), generator=generator,
                          device=generator.device, dtype=torch.uint8).cpu().numpy()
    return video, moving_masks(frames, height, width)


CLI_STEPS, CLI_FIRST_FRAME_STEPS = 2, 30   # the hook's default (infer/first_frame.py)
CKPT_SHARD_BYTES = 5 * 10 ** 9


def phase_cli(torch, kernels, pipe, root):
    """Phase 8: the inference CLI from disk at full width. Writes phase 2's
    models (42-layer bf16 DiT in shards, the VAE, the 2-layer branch) and a
    seeded rank-256 adapter as diffusers checkpoints, builds the pipeline
    with `infer.inpaint.build_pipeline` (the loaded state dicts held bit for
    bit to the saved ones, the adapter merged into both alike), runs the
    CLI's compute on an 81-frame 480x720 clip with a moving mask (first frame
    pre-inpainted at T=1, 2 windows x 2 steps, ID resampling: B1 over 35,552
    keys), holds it bit for bit to a direct call of the any-length pipeline,
    and where cv2 imports runs `main(argv)` on files the phase writes.
    Consumes `pipe`'s models. Writes the checkpoint into `root`, which the
    caller removes (phase 11 reads it). Returns the launch counts of the CLI's
    compute."""
    import csv
    import os
    import shutil
    import numpy as np
    from videopainter_tpu_torch.convert import load_safetensors_dir
    from videopainter_tpu_torch.flagship import LORA_RANK, random_lora
    from videopainter_tpu_torch.infer import inpaint as cli
    from videopainter_tpu_torch.infer.first_frame import make_self_first_frame_inpaint
    from videopainter_tpu_torch.models.lora import (LORA_ALPHA, convert_peft_lora_state_dict,
                                                    merge_lora)

    imports = optional_imports()
    log("optional imports: " + ", ".join(f"{k} {v or 'missing'}" for k, v in imports.items()))
    gen = torch.Generator(device="cuda").manual_seed(808)
    tcfg = pipe.transformer.cfg
    try:
        lora = random_lora(gen, pipe.transformer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = write_checkpoint(root, pipe.transformer, pipe.branch, pipe.vae, lora,
                                  shard_bytes=CKPT_SHARD_BYTES)
        write_s = time.perf_counter() - t0
        del lora
        shards = sorted(os.listdir(os.path.join(root, "model", "transformer")))
        embeds = torch.randn((1, tcfg.max_text_seq_length, tcfg.text_embed_dim), generator=gen,
                             device="cuda").cpu().numpy()
        np.save(os.path.join(root, "embeds.npy"), embeds)
        video_u8, masks = moving_mask_clip(torch, gen, 81, 480, 720)
        argv = ["--model_path", os.path.join(root, "model"),
                "--inpainting_branch", os.path.join(root, "branch"),
                "--id_adapter", os.path.join(root, "lora"),
                "--meta_file_path", os.path.join(root, "meta.csv"),
                "--output_path", os.path.join(root, "out"),
                "--prompt_embeds", os.path.join(root, "embeds.npy"),
                "--use_flash", "--replace_gt", "--mask_add", "--num_frames", "49",
                "--overlap_frames", "17", "--num_inference_steps", str(CLI_STEPS),
                "--first_frame_inpaint", "self", "--long_video", "--seed", "0"]
        args = cli.get_args(argv)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = cli.load_pipeline(args)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"CLI checkpoint: {nbytes} bytes ({nbytes / 1e9:.3f} GB: transformer in "
            f"{len(shards) - 2} shards of at most {CKPT_SHARD_BYTES} bytes, VAE, branch, rank-"
            f"{LORA_RANK} adapter in float32) written in {write_s:.3f} s "
            f"({nbytes / write_s / 1e9:.3f} GB/s); build_pipeline read and placed it in "
            f"{load_s:.3f} s ({nbytes / load_s / 1e9:.3f} GB/s)")
        # the saved weights, with the adapter merged as build_pipeline merges it
        adapter = convert_peft_lora_state_dict(load_safetensors_dir(os.path.join(root, "lora")),
                                               tcfg.num_layers, rank=LORA_RANK)
        merge_lora(pipe.transformer, {t: {k: v.to(torch.bfloat16) for k, v in ab.items()}
                                      for t, ab in adapter.items()},
                   alpha=LORA_ALPHA, rank=LORA_RANK)
        del adapter
        differ = [f"{name}.{k}" for name in ("transformer", "branch", "vae")
                  for k, v in getattr(pipe, name).state_dict().items()
                  if not torch.equal(getattr(loaded, name).state_dict()[k], v)]
        log(f"loaded state dicts equal to the saved ones bit for bit (the adapter merged into "
            f"both): {not differ}")
        if differ:
            raise AssertionError(f"loaded weights differ from the saved ones: {differ[:5]}")
        pipe.transformer = pipe.branch = pipe.vae = None
        free_cuda(torch)

        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True   # the CLI's run and the direct call
        try:
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out01, _, _ = cli.run_inpaint(loaded, args, video_u8, masks, "")
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()

            # the same work as direct calls, written out here: the first-frame
            # hook, then the any-length pipeline with the CLI's arguments
            masks_f = masks.astype(np.float32)
            emb = torch.from_numpy(embeds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = make_self_first_frame_inpaint(
                loaded, seed=0, use_flash=True, dtype=torch.bfloat16, prompt_embeds=emb)(
                video_u8[0].astype(np.float32) / 255 * (1 - masks_f[0][..., None]),
                masks_f[0], "")
            first_s = time.perf_counter() - t0
            enc_s, dec_s = [], []
            loaded.vae.encode = timed_calls(torch, loaded.vae.encode, enc_s)
            loaded.vae.decode = timed_calls(torch, loaded.vae.decode, dec_s)
            stamps = []

            def progress(i, n):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())

            t0 = time.perf_counter()
            direct = loaded(
                image=torch.from_numpy(np.ascontiguousarray(first, np.float32)).cuda()[None] * 2 - 1,
                video=torch.from_numpy(video_u8.astype(np.float32) / 255).cuda()[None] * 2 - 1,
                masks=torch.from_numpy(masks_f).cuda()[None], num_frames=49, stride=32,
                num_inference_steps=CLI_STEPS, guidance_scale=6.0, use_dynamic_cfg=True,
                replace_gt=True, mask_add=True, prev_clip_weight=0.0, id_pool_resample=True,
                use_flash=True, sequential_cfg=False, skip_steps=None, capture_int8=False,
                generator=torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16,
                prompt_embeds=emb, negative_prompt_embeds=torch.zeros_like(emb),
                progress_fn=progress)
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t0
            steps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
            del loaded.vae.encode, loaded.vae.decode   # the timing wrappers
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
        direct01 = (np.asarray(direct)[0] / 2 + 0.5).clip(0, 1)
        same = np.array_equal(out01, direct01)
        per_layer = tcfg.num_layers + loaded.branch.cfg.num_layers
        expected = per_layer * (CLI_FIRST_FRAME_STEPS + 2 * CLI_STEPS)
        finite = bool(np.isfinite(out01).all())
        log(f"CLI compute (run_inpaint, {tcfg.num_layers}-layer DiT from disk, 81x480x720, "
            f"first frame at T=1 over {CLI_FIRST_FRAME_STEPS} steps, 2 windows x {CLI_STEPS} "
            f"steps, CFG 6, ID resampling over {2 * 17776} keys): out {out01.shape} finite "
            f"{finite}, {cli_s:.3f} s wall, peak memory {peak / 2**30:.2f} GiB; flash_fwd "
            f"launches {launches['flash_fwd']} (expected {expected} = {per_layer} layers x "
            f"({CLI_FIRST_FRAME_STEPS} + 2 x {CLI_STEPS}) steps); equal to the direct calls "
            f"bit for bit: {same} (max |diff| {np.abs(out01 - direct01).max():.3e})")
        log(f"direct calls: first-frame pass (T=1, {CLI_FIRST_FRAME_STEPS} steps, its VAE "
            f"encodes and decode) {first_s:.3f} s; any-length call {direct_s:.3f} s: s per "
            f"denoise step (the first of each window includes its 3 tiled VAE encodes, "
            + ", ".join(f"{x:.3f} s" for x in enc_s) + ") " + ", ".join(f"{x:.3f}" for x in steps)
            + ", tiled VAE decode of the 81 frames " + ", ".join(f"{x:.3f} s" for x in dec_s))
        if not (finite and out01.shape == (81, 480, 720, 3)):
            raise AssertionError(f"CLI output {out01.shape} finite={finite}")
        if not same:
            raise AssertionError("the CLI's compute differs from the direct pipeline call")
        expect_all = dict.fromkeys(launches, 0)
        expect_all["flash_fwd"] = expected
        if attention_launches(launches) != attention_launches(expect_all):
            raise AssertionError(f"CLI launches {launches}, expected {expect_all}")

        if imports["cv2"] is not None:
            import cv2
            del loaded, direct
            free_cuda(torch)
            vpath = os.path.join(root, "clip.mp4")
            vw = cv2.VideoWriter(vpath, cv2.VideoWriter_fourcc(*"mp4v"), 8, (720, 480))
            for f in video_u8:
                vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            vw.release()
            np.savez(os.path.join(root, "all_masks.npz"), **{"0": masks})
            with open(os.path.join(root, "meta.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["path", "fps", "start_frame", "end_frame", "mask_id", "caption"])
                w.writerow([vpath, 8, 0, 0, 0, "a synthetic clip"])
            t0 = time.perf_counter()
            frames = cli.main(argv)
            main_s = time.perf_counter() - t0
            cap = cv2.VideoCapture(os.path.join(root, "out", "video_0.mp4"))
            n_read, shape = 0, None
            while True:
                ok, fr = cap.read()
                if not ok:
                    break
                n_read, shape = n_read + 1, fr.shape
            cap.release()
            log(f"CLI main(argv) on a CSV, all_masks.npz and an mp4: {main_s:.3f} s (the "
                f"build from disk included); out {frames.shape}, side-by-side mp4 of {n_read} "
                f"frames of {shape}")
            if not (np.isfinite(frames).all() and n_read == 81 and shape == (480, 3 * 720, 3)):
                raise AssertionError("the CLI's side-by-side video is not 81 frames of "
                                     "480 x 2160")
        else:
            log("CLI main(argv): cv2 is missing, so the file I/O is not run (the compute above "
                "ran all the same)")
    finally:
        shutil.rmtree(os.path.join(root, "out"), ignore_errors=True)
    return launches


# -- phase 11: evaluation ----------------------------------------------------------------

EVAL_STEPS = 2                 # DPM steps a window (the cut; 50 in use)
EVAL_HW = (480, 720)           # frame size of the corpus
EVAL_WINDOW = (49, 32)         # frames a window, stride: overlap 17, so that bear's 81
                               # frames make two whole windows with the prev-clip blend
                               # (the sweep's own --anyl_overlap_frames is 8, stride 41)
EVAL_PREV_CLIP_WEIGHT = 0.3    # the sweep's anyl config (evaluate/sweep.py)
EVAL_VIDEOS = (("bear", 81), ("boat", 49))
EVAL_CAPTION = "a synthetic clip of drifting colours"
FLOAT64_REL = 1e-9             # float64 metrics, card against CPU (other summation orders)
# The learned extractors, card against CPU: max |card - CPU| over max |CPU|
# of each output. On an H100 (boat's composite frames) full fp32, as the
# extractors run (TF32 off), reads LPIPS 1.1e-7, I3D 2.1e-7, CLIP image
# 8.1e-7 and text 1.3e-6; the TF32 control (the same comparison with
# `full_fp32` left undone) 9.2e-6, 6.1e-4, 3.8e-4 and 9.9e-4. Each limit lies
# between the two, and the control must exceed it, or the check could not
# tell TF32 from fp32. LPIPS's control is lower: the composite equals the
# ground truth outside the hole, where TF32 rounds both inputs alike.
LEARNED_REL = {"lpips": 1e-6, "i3d": 1e-5, "clip_image": 1e-5, "clip_text": 1e-5}
CLIP_L14 = dict(   # CLIP ViT-L/14 (openai/clip-vit-large-patch14's published widths)
    projection_dim=768,
    text_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                     num_attention_heads=12, vocab_size=49408, max_position_embeddings=77,
                     projection_dim=768),
    vision_config=dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24,
                       num_attention_heads=16, patch_size=14, image_size=224,
                       projection_dim=768))


def require_modules(phase, names):
    """Import each module or fail the phase, naming the one missing."""
    import importlib
    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as e:
            raise RuntimeError(f"{phase} needs the {name!r} module: {e}") from e


def smooth_clip(torch, generator, frames, height, width):
    """uint8 frames [T, H, W, 3]: a random low-frequency colour field that
    drifts from frame to frame, with a little pixel noise (so that JPEG,
    SSIM and the extractors see structure rather than white noise)."""
    import torch.nn.functional as F
    dev = generator.device
    base = torch.rand((1, 3, height // 32, width // 32), generator=generator, device=dev)
    drift = torch.randn((frames, 3, height // 32, width // 32), generator=generator,
                        device=dev).mul(0.04).cumsum(0)
    field = F.interpolate((base + drift).clamp(0, 1), size=(height, width), mode="bilinear",
                          align_corners=False)
    noise = torch.randn(field.shape, generator=generator, device=dev) * (4 / 255)
    return ((field + noise).clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def write_davis(root, name, video, masks):
    """DAVIS layout: JPEGImages/480p/<name>/%05d.jpg, Annotations/480p/<name>/%05d.png."""
    import os
    import cv2
    jd = os.path.join(root, "JPEGImages", "480p", name)
    ad = os.path.join(root, "Annotations", "480p", name)
    os.makedirs(jd, exist_ok=True)
    os.makedirs(ad, exist_ok=True)
    for i, (f, m) in enumerate(zip(video, masks)):
        cv2.imwrite(os.path.join(jd, f"{i:05d}.jpg"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(ad, f"{i:05d}.png"), m * 255)


def write_extractors(torch, root, seed):
    """The extractors' files at published size: LPIPS-squeeze (the golden's
    `sd::` entries) as .npz, InceptionI3d (the golden's, 400 classes) as .pt,
    CLIP ViT-L/14 from seeded random weights with `save_pretrained`, beside
    clip_tiny's tokenizer files and the ViT-L/14 preprocessor (clip_tiny's at
    224 pixels). Returns (lpips path, i3d path, clip dir)."""
    import json
    import os
    import shutil
    import numpy as np
    from transformers import CLIPConfig, CLIPModel
    g = np.load("tests/goldens/lpips.npz")
    lpips_path = os.path.join(root, "lpips_squeeze.npz")
    np.savez(lpips_path, **{k[4:]: g[k] for k in g.files if k.startswith("sd::")})
    g = np.load("tests/goldens/i3d.npz")
    i3d_path = os.path.join(root, "rgb_imagenet.pt")
    torch.save({k[4:]: torch.from_numpy(np.array(g[k])) for k in g.files
                if k.startswith("sd::")}, i3d_path)
    clip_dir = os.path.join(root, "clip-vit-large-patch14")
    torch.manual_seed(seed)
    with torch.device("cuda"):
        clip = CLIPModel(CLIPConfig(**CLIP_L14))
    n_params = sum(p.numel() for p in clip.parameters())
    clip.save_pretrained(clip_dir)
    del clip
    tiny = "tests/goldens/clip_tiny"
    for f in ("merges.txt", "vocab.json", "special_tokens_map.json", "tokenizer_config.json"):
        shutil.copy(os.path.join(tiny, f), clip_dir)
    with open(os.path.join(tiny, "preprocessor_config.json")) as f:
        pre = json.load(f)
    pre["size"], pre["crop_size"] = {"shortest_edge": 224}, {"height": 224, "width": 224}
    with open(os.path.join(clip_dir, "preprocessor_config.json"), "w") as f:
        json.dump(pre, f)
    return lpips_path, i3d_path, clip_dir, n_params


def max_rel(a, b):
    """max |a - b| over max |b| (b the CPU's)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


LEARNED_FRAMES = {"lpips": 8, "i3d": 16, "clip_image": 4}   # the CPU's side is slow


def learned_outputs(lpips, i3d, clip, pred, gt):
    """The learned extractors' outputs on the first frames of [T, H, W, 3]
    stacks in [0, 1]: LPIPS distances, the I3D features, the CLIP image
    embeddings and the caption's CLIP text embedding, on the host."""
    n = LEARNED_FRAMES
    return {"lpips": lpips.batch(pred[:n["lpips"]], gt[:n["lpips"]]).cpu(),
            "i3d": i3d(pred[:n["i3d"]]).cpu(),
            "clip_image": clip.image_embeds(pred[:n["clip_image"]]).cpu(),
            "clip_text": clip.text_embed(EVAL_CAPTION).cpu()}


def tf32_control(torch):
    """A stand-in for `evaluate.lpips.full_fp32` that leaves TF32 ON for
    convolutions and matmuls: what the extractors would compute if their
    switch to full fp32 stopped working."""
    import contextlib

    @contextlib.contextmanager
    def tf32_on():
        flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return tf32_on


def learned_errors(torch, card, cpu, pred, gt):
    """Each learned extractor on the card against the CPU on the same frames
    (`card`, `cpu`: (LpipsExtractor, I3DExtractor, ClipExtractor); `pred`,
    `gt`: [T, H, W, 3] float32 in [0, 1], numpy): max |card - CPU| over max
    |CPU|, in full fp32 as the extractors run and with the TF32 control.
    Returns (errors, control errors), dicts by output."""
    from videopainter_tpu_torch.evaluate import extractors as ex
    from videopainter_tpu_torch.evaluate import lpips as lp
    on_card = [torch.from_numpy(x).cuda() for x in (pred, gt)]
    want = learned_outputs(*cpu, pred, gt)
    errs = {k: max_rel(v, want[k]) for k, v in learned_outputs(*card, *on_card).items()}
    sound = lp.full_fp32
    lp.full_fp32 = ex.full_fp32 = tf32_control(torch)
    try:
        control = {k: max_rel(v, want[k])
                   for k, v in learned_outputs(*card, *on_card).items()}
    finally:
        lp.full_fp32 = ex.full_fp32 = sound
    return errs, control


def phase_eval(torch, kernels, root):
    """Phase 11: the evaluation path at full width. Writes a DAVIS-layout
    corpus (bear: 81 frames with a moving hole, boat: 49) at 480x720 and the
    extractors at published size; builds phase 8's pipeline from its
    checkpoint in `root` (bf16, branch, rank-256 ID adapter merged) through
    `build_pipeline`, binds `use_flash=True`, and runs `run_inpainting_eval`
    with the sweep's anyl prev-clip weight 0.3 (49-frame windows at overlap
    17, so that bear makes two whole windows, where the sweep's default
    overlap of 8 would leave one; replace_gt, mask_add, CFG 6, seed 42; 2
    steps a window) and
    the metrics on the card; B1's launches held to the code's count. Then the
    prev-clip pair path on bear (the same model without the learnable
    resample), a resume that runs no pipeline, the card's metrics against
    the CPU path on boat's saved composite frames (the learned extractors
    also with TF32 left on, a control that must fail their limit), and the
    edit evaluation of bear. Returns the launch counts of the harness run."""
    import dataclasses
    import functools
    import os
    import numpy as np
    from videopainter_tpu_torch.evaluate import cli as evcli
    from videopainter_tpu_torch.evaluate import extractors as ex
    from videopainter_tpu_torch.evaluate import metrics as M
    from videopainter_tpu_torch.evaluate.datasets import DavisTestDataset
    from videopainter_tpu_torch.evaluate.eval_edit import EditEvalConfig, run_edit_eval
    from videopainter_tpu_torch.evaluate.harness import (EvalConfig, load_frames_dir,
                                                         read_rows, run_inpainting_eval)
    from videopainter_tpu_torch.evaluate.lpips import LpipsExtractor
    from videopainter_tpu_torch.infer.inpaint import build_pipeline
    from videopainter_tpu_torch.models.text_encoder import load_prompt_embeds

    require_modules("phase 11", ("cv2", "transformers", "scipy"))
    sync = torch.cuda.synchronize
    hgt, wid = EVAL_HW
    gen = torch.Generator(device="cuda").manual_seed(1111)
    davis = os.path.join(root, "davis")
    t0 = time.perf_counter()
    clips = {}
    for name, frames in EVAL_VIDEOS:
        clips[name] = (smooth_clip(torch, gen, frames, hgt, wid), moving_masks(frames, hgt, wid))
        write_davis(davis, name, *clips[name])
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lpips_path, i3d_path, clip_dir, clip_params = write_extractors(torch, root, 1112)
    files_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = evcli.build_metrics(lpips_path, i3d_path, clip_dir, device="cuda")
    sync()
    extractors_s = time.perf_counter() - t0
    log(f"eval corpus (DAVIS layout, {hgt}x{wid} JPEG + PNG: "
        + ", ".join(f"{n} {t}" for n, t in EVAL_VIDEOS) + " frames) written in "
        f"{corpus_s:.3f} s; extractors written in {files_s:.3f} s (CLIP ViT-L/14 "
        f"{clip_params / 1e6:.1f} M parameters) and loaded on the card in {extractors_s:.3f} s")

    t0 = time.perf_counter()
    loaded = build_pipeline(os.path.join(root, "model"), os.path.join(root, "branch"),
                            id_adapter=os.path.join(root, "lora"), dtype_str="bfloat16",
                            device="cuda")
    sync()
    log(f"phase 8's checkpoint read by build_pipeline in {time.perf_counter() - t0:.3f} s")
    stamps = []

    def progress(i, n):
        sync()
        stamps.append(time.perf_counter())

    pipe = functools.partial(loaded, use_flash=True, dtype=torch.bfloat16, progress_fn=progress)
    emb = load_prompt_embeds(os.path.join(root, "embeds.npy")).cuda()

    def encode(_caption):
        return emb, torch.zeros_like(emb)

    cfg = EvalConfig(output_dir=os.path.join(root, "eval_full"), num_inference_steps=EVAL_STEPS,
                     num_frames=EVAL_WINDOW[0], stride=EVAL_WINDOW[1], guidance_scale=6.0,
                     replace_gt=True,
                     mask_add=True, prev_clip_weight=EVAL_PREV_CLIP_WEIGHT, seed=42)
    marks = []

    def marked(samples):   # metric seconds at each request: the previous video's are done
        for sample in samples:
            marks.append((sample["name"], dict(metrics.seconds), len(stamps),
                          time.perf_counter()))
            yield sample

    tcfg = loaded.transformer.cfg
    per_layer = tcfg.num_layers + loaded.branch.cfg.num_layers
    # B1 calls a step: one per layer (CFG batched). bear's window 1 blends the
    # previous window's states: on this learnable-resample model each DiT layer
    # makes ONE call over [keys ‖ masked previous keys] (35,552), not a pair
    expected = {"boat": 1 * EVAL_STEPS * per_layer, "bear": 2 * EVAL_STEPS * per_layer}
    def dataset():
        return DavisTestDataset(root=davis, height=hgt, width=wid)

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    summary = run_inpainting_eval(pipe, marked(dataset()), cfg,
                                  metrics=metrics, encode_prompt_fn=encode, device="cuda",
                                  caption_fn=lambda video, masks: EVAL_CAPTION)
    sync()
    eval_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    marks.append(("end", dict(metrics.seconds), len(stamps), time.perf_counter()))
    rows = {r["name"]: r for r in read_rows(os.path.join(cfg.output_dir, "results.csv"))}
    want = dict.fromkeys(launches, 0)
    want["flash_fwd"] = sum(expected.values())
    log(f"eval harness at {hgt}x{wid} (bear 2 windows, boat 1; {EVAL_STEPS} steps a window, "
        f"prev-clip weight {EVAL_PREV_CLIP_WEIGHT}, B1 through use_flash): {eval_s:.3f} s wall, "
        f"peak memory {peak / 2**30:.2f} GiB; flash_fwd launches {launches['flash_fwd']} "
        f"(expected {want['flash_fwd']} = {per_layer} layers x {EVAL_STEPS} steps x 3 windows)")
    for (name, sec0, st0, _), (_, sec1, st1, _) in zip(marks[:-1], marks[1:]):
        n = dict(EVAL_VIDEOS)[name]
        r = rows[name]
        steps = [b - a for a, b in zip(stamps[st0:st1 - 1], stamps[st0 + 1:st1])]
        per = {k: (sec1.get(k, 0.0) - sec0.get(k, 0.0)) / n * 1e3 for k in sec1}
        log(f"  {name}: {n} frames, pipeline {r['time_per_frame_s'] * n:.3f} s "
            f"({r['time_per_frame_s']:.4f} s a frame; s between its denoise steps "
            + ", ".join(f"{x:.3f}" for x in steps) + "), metrics on the card in ms a frame: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items())) + "; psnr "
            f"{r['psnr']:.4f}, ssim {r['ssim']:.6f}, lpips {r['lpips']:.6f}, masked_psnr "
            f"{r['masked_psnr']:.4f}, clip_score {r['clip_score']:.4f}, temporal_consistency "
            f"{r['temporal_consistency']:.6f}")
    log("  corpus: " + ", ".join(f"{k} {v:.6g}" for k, v in summary.items()))
    finite = all(np.isfinite(v) for k, v in summary.items())
    if not finite or set(rows) != {"bear", "boat", "__average__"}:
        raise AssertionError(f"eval summary {summary}, rows {sorted(rows)}")
    if attention_launches(launches) != attention_launches(want):
        raise AssertionError(f"eval launches {launches}, expected {want}")

    # the prev-clip pair: the same weights without the learnable resample, as a
    # model without the ID adapter runs window 1 (two B1 calls a DiT layer)
    bear = next(s for s in dataset() if s["name"] == "bear")
    loaded.transformer.cfg = dataclasses.replace(tcfg, id_pool_resample_learnable=False)
    pair_want = dict.fromkeys(launches, 0)
    pair_want["flash_fwd"] = EVAL_STEPS * per_layer + EVAL_STEPS * (2 * tcfg.num_layers
                                                                   + loaded.branch.cfg.num_layers)
    try:
        kernels.reset_launches()
        del stamps[:]
        t0 = time.perf_counter()
        pair = run_inpainting_eval(pipe, [bear], dataclasses.replace(
            cfg, output_dir=os.path.join(root, "eval_pair")), encode_prompt_fn=encode,
            device="cuda")
        sync()
        pair_s = time.perf_counter() - t0
        pair_launches = dict(kernels.LAUNCHES)
    finally:
        loaded.transformer.cfg = tcfg
    steps = [b - a for a, b in zip(stamps[:-1], stamps[1:])]
    log(f"prev-clip pair path (bear, no learnable resample): {pair_s:.3f} s wall, s between "
        "denoise steps " + ", ".join(f"{x:.3f}" for x in steps) + f"; flash_fwd launches "
        f"{pair_launches['flash_fwd']} (expected {pair_want['flash_fwd']} = {per_layer} x "
        f"{EVAL_STEPS} in window 0 + ({2 * tcfg.num_layers} + {loaded.branch.cfg.num_layers}) "
        f"x {EVAL_STEPS} in window 1); psnr {pair['psnr']:.4f}, masked_psnr "
        f"{pair['masked_psnr']:.4f}")
    if attention_launches(pair_launches) != attention_launches(pair_want) or not all(np.isfinite(v) for v in pair.values()):
        raise AssertionError(f"pair path: launches {pair_launches}, expected {pair_want}; "
                             f"{pair}")

    # resume: every video is done, so no pipeline runs and the averages come back
    kernels.reset_launches()
    t0 = time.perf_counter()
    again = run_inpainting_eval(pipe, dataset(), cfg, metrics=M.MetricsCalculator(),
                                encode_prompt_fn=encode, device="cuda")
    resume_s = time.perf_counter() - t0
    same = all(abs(again[k] - summary[k]) <= 1e-12 * abs(summary[k]) for k in again)
    log(f"resume over the same directory: {resume_s:.3f} s, flash_fwd launches "
        f"{kernels.LAUNCHES['flash_fwd']}, averages equal: {same} (no fvid: nothing "
        f"accumulated, as in the JAX harness)")
    if kernels.LAUNCHES["flash_fwd"] or not same or set(again) != set(summary) - {"fvid"}:
        raise AssertionError(f"resume ran the pipeline or changed the averages: {again}")
    del loaded, pipe
    free_cuda(torch)

    # the card's metrics against the CPU path, on boat's saved composite frames
    boat_video, boat_masks = clips["boat"]
    comp = load_frames_dir(os.path.join(cfg.output_dir, "comp_frames", "boat"), hgt, wid)
    pred = comp.astype(np.float32) / 255
    gt = boat_video.astype(np.float32) / 255
    mf = boat_masks.astype(np.float32)
    dev_t = [torch.from_numpy(x).cuda() for x in (pred, gt, mf)]
    plain = M.MetricsCalculator()
    n_f64 = 6   # frames (the CPU's float64 conv2d is slow)
    t_cpu = time.perf_counter()
    card_rows = plain.video_frame_metrics(*(x[:n_f64] for x in dev_t[:2]),
                                          masks=dev_t[2][:n_f64])
    cpu_rows = plain.video_frame_metrics(torch.from_numpy(pred[:n_f64]),
                                         torch.from_numpy(gt[:n_f64]),
                                         masks=torch.from_numpy(mf[:n_f64]))
    f64_err = max(abs(c[k] - h[k]) / abs(h[k]) for c, h in zip(card_rows, cpu_rows)
                  for k in h if np.isfinite(h[k]) and h[k] != 0)
    ssim_card = M.frame_ssim(dev_t[0][:1], dev_t[1][:1])   # warm
    sync()
    t0 = time.perf_counter()
    ssim_card = float(M.frame_ssim(dev_t[0][:1], dev_t[1][:1])[0])
    sync()
    ssim_card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ssim_host = M.ssim_reference(pred[0], gt[0])
    ssim_host_s = time.perf_counter() - t0
    ssim_err = abs(ssim_card - ssim_host) / abs(ssim_host)
    cpu = (LpipsExtractor(lpips_path, device="cpu"), ex.I3DExtractor(i3d_path, device="cpu"),
           ex.ClipExtractor(clip_dir, device="cpu"))
    # build_metrics holds the ClipExtractor's bound methods; its text tower too is compared
    card = (metrics.lpips_fn, metrics.video_feature_fn, metrics.image_embed_fn.batch.__self__)
    errs, control = learned_errors(torch, card, cpu, pred, gt)
    cpu_s = time.perf_counter() - t_cpu
    log(f"card against CPU on boat's saved frames ({cpu_s:.3f} s): float64 metrics (psnr, "
        f"ssim, mse, mae, global and masked, {n_f64} frames) max relative error {f64_err:.3e} "
        f"(limit {FLOAT64_REL:g}); one frame's SSIM on the card {ssim_card_ms:.3f} ms, by the "
        f"plain numpy / scipy version on the host {ssim_host_s:.3f} s (relative difference "
        f"{ssim_err:.3e}); learned extractors ({LEARNED_FRAMES} frames, the caption's text "
        "embedding), max |card - CPU| over max |CPU|, full fp32 / TF32 control (limit): "
        + ", ".join(f"{k} {errs[k]:.3e} / {control[k]:.3e} ({LEARNED_REL[k]:g})" for k in errs)
        + f"; FVID {summary['fvid']:.6g}")
    if f64_err > FLOAT64_REL or ssim_err > FLOAT64_REL:
        raise AssertionError(f"float64 metrics: card against CPU {f64_err}, SSIM against the "
                             f"host plain version {ssim_err}")
    if any(v > LEARNED_REL[k] for k, v in errs.items()) or not np.isfinite(summary["fvid"]):
        raise AssertionError(f"learned extractors, card against CPU: {errs}; "
                             f"fvid {summary['fvid']}")
    if any(v <= LEARNED_REL[k] for k, v in control.items()):
        raise AssertionError(f"the TF32 control passes the learned extractors' limits "
                             f"{LEARNED_REL}: {control}; the check cannot tell TF32 from fp32")
    del cpu, card

    # the edit evaluation of bear's output against its source, at full size
    bear_video, bear_masks = clips["bear"]
    edited = load_frames_dir(os.path.join(cfg.output_dir, "comp_frames", "bear"), hgt, wid)
    t0 = time.perf_counter()
    edit = run_edit_eval([{"name": "bear", "edited": torch.from_numpy(edited).cuda() / 255,
                           "source": torch.from_numpy(bear_video).cuda() / 255,
                           "masks": torch.from_numpy(bear_masks).cuda().float(),
                           "edited_caption": "a red balloon over the hole"}],
                         EditEvalConfig(output_dir=os.path.join(root, "edit_eval")),
                         metrics=metrics, device="cuda")
    sync()
    log(f"edit eval of bear ({len(edited)} frames at {hgt}x{wid}) in "
        f"{time.perf_counter() - t0:.3f} s: "
        + ", ".join(f"{k} {v:.6g}" for k, v in edit.items()))
    if set(edit) != {"background_psnr", "background_ssim", "clip_score", "masked_clip_score",
                     "temporal_consistency", "time_s"} or any(np.isnan(v)
                                                              for v in edit.values()):
        raise AssertionError(f"edit eval {edit}")
    return launches


def phase_eval_cli_small(torch, kernels):
    """Phase 11 (small): the eval CLI and its sweep on the card at a tiny
    width (head dim 64), exact attention as the JAX CLI has it (no flash
    launch; the prep and the VAE's GroupNorm run their kernels): `evaluate.cli.main(argv)`
    on tiny checkpoints and a small DAVIS corpus, its results.csv held to a
    direct harness call's rows, a resume, then `evaluate.sweep.main` over
    replace_gt true / false."""
    import csv
    import os
    import shutil
    import tempfile
    import numpy as np
    from videopainter_tpu_torch.config import TransformerConfig, VAEConfig
    from videopainter_tpu_torch.evaluate import cli as evcli
    from videopainter_tpu_torch.evaluate import sweep
    from videopainter_tpu_torch.evaluate.datasets import DavisTestDataset
    from videopainter_tpu_torch.evaluate.harness import (EvalConfig, read_rows,
                                                         run_inpainting_eval)
    from videopainter_tpu_torch.infer.inpaint import build_pipeline
    from videopainter_tpu_torch.models import AutoencoderKLCogVideoX

    require_modules("phase 11", ("cv2",))
    gen = torch.Generator(device="cuda").manual_seed(1113)
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="eval_small_", dir="build")
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the CLI's run and the direct call
    try:
        vae = AutoencoderKLCogVideoX(VAEConfig.tiny(latent_channels=16), device="meta",
                                     dtype=torch.float32).to_empty(device="cuda").init_random_(gen)
        emb = torch.randn((1, 5, 12), generator=gen, device="cuda")
        # head dim 64: attention's prep kernel takes no other
        tcfg = TransformerConfig.tiny(in_channels=32, out_channels=16, attention_head_dim=64,
                                      sample_height=8, sample_width=12)
        write_tiny_checkpoint(torch, root, gen, tcfg, vae, emb, torch.float32)
        del vae
        davis = os.path.join(root, "davis")
        for name in ("bear", "boat"):
            write_davis(davis, name, smooth_clip(torch, gen, 9, 64, 96), moving_masks(9, 64, 96))
        common = ["--model_path", os.path.join(root, "model"),
                  "--inpainting_branch", os.path.join(root, "branch"),
                  "--height", "64", "--width", "96", "--num_frames", "9",
                  "--num_inference_steps", "2", "--mask_add", "--dtype", "float32",
                  "--prompt_embeds_file", os.path.join(root, "embeds.npy"),
                  "--device", "cuda"]
        argv = common + ["--dataset", "davis", "--video_root", davis, "--dilate_size", "1",
                         "--replace_gt", "--save_addr", os.path.join(root, "eval_cli")]
        kernels.reset_launches()
        t0 = time.perf_counter()
        avg = evcli.main(argv)
        cli_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        rows = read_rows(os.path.join(root, "eval_cli", "results.csv"))
        pipeline = build_pipeline(os.path.join(root, "model"), os.path.join(root, "branch"),
                                  dtype_str="float32", device="cuda")
        direct = run_inpainting_eval(
            lambda **kw: pipeline(dtype=torch.float32, **kw),
            DavisTestDataset(root=davis, height=64, width=96, dilate_iterations=1),
            EvalConfig(output_dir=os.path.join(root, "eval_direct"), num_inference_steps=2,
                       num_frames=9, replace_gt=True, mask_add=True),
            encode_prompt_fn=lambda c: (emb, torch.zeros_like(emb)), device="cuda")
        drows = read_rows(os.path.join(root, "eval_direct", "results.csv"))
        diffs = [abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for a, b in zip(rows, drows)
                 for k in b if k not in ("name", "time_per_frame_s")]
        rows_equal = ([r["name"] for r in rows] == [r["name"] for r in drows]
                      and all(list(a) == list(b) for a, b in zip(rows, drows))
                      and max(diffs) <= 1e-6)
        again = evcli.main(argv)
        resumed = set(again) == set(avg) and all(
            abs(again[k] - avg[k]) <= 1e-12 * abs(avg[k]) for k in avg)
        log(f"small eval CLI on the card (exact attention, 2 videos of 9x64x96): "
            f"{cli_s:.3f} s, columns {list(rows[0])}, rows {[r['name'] for r in rows]}; equal "
            f"to a direct harness call's rows: {rows_equal} (max relative difference "
            f"{max(diffs):.3e}, limit 1e-6); resume gives the same averages: {resumed}; "
            f"launches {launches}")
        if not (rows_equal and resumed) or any(attention_launches(launches).values()):
            raise AssertionError("the small eval CLI disagrees with the direct harness call, "
                                 "its resume, or launched a kernel on the exact path")
        if not all(np.isfinite(v) for r in rows for k, v in r.items() if k != "name"):
            raise AssertionError(f"non-finite eval rows {rows}")

        sw = common + ["--configs", "davis", "--davis_root", davis, "--dilate_sizes", "0",
                       "--replace_gt_values", "true", "false",
                       "--save_addr", os.path.join(root, "sweep")]
        t0 = time.perf_counter()
        srows = sweep.main(sw)
        with open(os.path.join(root, "sweep", "sweep_summary.csv"), newline="") as f:
            recs = list(csv.DictReader(f))
        cells = [os.path.isfile(os.path.join(root, "sweep", "davis", f"dilate0_rg{rg}",
                                             "results.csv")) for rg in (1, 0)]
        log(f"small sweep on the card: {len(srows)} cells in {time.perf_counter() - t0:.3f} s, "
            f"results.csv per cell {cells}, summary rows "
            + "; ".join(f"rg{r['replace_gt']} psnr {float(r['psnr']):.4f}" for r in recs))
        if len(srows) != 2 or not all(cells) or [r["replace_gt"] for r in recs] != ["1", "0"]:
            raise AssertionError("the sweep's layout or summary is wrong")
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
        shutil.rmtree(root, ignore_errors=True)


# -- phase 12: the interactive demo ------------------------------------------------------

CC_SHAPE = (8, 1, 1024, 1024)     # SAM2's image size, a batch of masks
# shapes whose rows do not fill whole 1024-pixel tiles: the demo's frames
# (a tile spans rows, the last one partial) and an odd height and width
CC_GENERAL_SHAPES = ((8, 1, 480, 720), (8, 1, 331, 1000))
CC_PROBS = (0.1, 0.41, 0.7)       # sparse specks, near 8-connected percolation, one giant
DEMO_SIZE = "large"               # Hiera-L, the published SAM2 checkpoint's widths
DEMO_STEPS = 2                    # DPM steps of the inpaint (the cut; 50 in use)
DEMO_AMG_POINTS = 16              # points per side of the automatic mask generator
DEMO_MIN_REGION = 100             # its min_mask_region_area: two CC launches a kept mask
DEMO_AMG_NMS = 1.0                # its box NMS threshold: every candidate is kept
# SAM2 mask logits, card against CPU: max |card - CPU| over max |CPU| on the
# first 2 frames, both in full fp32. The same comparison with TF32 left on
# (10-bit mantissa products through 48 Hiera blocks) must exceed it, or the
# check could not tell TF32 from fp32.
SAM2_REL = 1e-4


def serpentine(n):
    """Every other row full, joined alternately at the right and left ends:
    one component whose path is about n * n / 2 pixels long."""
    import numpy as np
    m = np.zeros((n, n), np.uint8)
    m[0::2] = 1
    m[1::4, -1] = 1
    m[3::4, 0] = 1
    return m


def spiral(n):
    """A square spiral of 1-pixel walls one pixel apart, walked inwards."""
    import numpy as np
    m = np.zeros((n, n), np.uint8)
    top, left, bottom, right = 0, 0, n - 1, n - 1
    while top + 2 <= bottom and left + 2 <= right:
        m[top, left:right + 1] = 1
        m[top:bottom + 1, right] = 1
        m[bottom, left:right + 1] = 1
        m[top + 2:bottom + 1, left] = 1
        m[top + 2, left:left + 3] = 1    # step into the next ring
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return m


def scipy_labels(mask):
    """scipy.ndimage.label with the 3x3 structure, and each pixel's area, on
    the host; [H, W] uint8 -> (labels, areas)."""
    import numpy as np
    from scipy import ndimage
    lab, _ = ndimage.label(mask, structure=np.ones((3, 3), int))
    areas = np.bincount(lab.ravel())[lab]
    areas[lab == 0] = 0
    return lab, areas


def same_partition(labels, ref):
    """Same foreground and a one-to-one map between the two numberings."""
    import numpy as np
    fg = ref > 0
    if not np.array_equal(labels > 0, fg):
        return False
    pairs = np.unique(np.stack([labels[fg], ref[fg]]), axis=1)
    return len(pairs[0]) == len(np.unique(pairs[0])) == len(np.unique(pairs[1]))


def phase_cc(torch, kernels):
    """Phase 12a: the connected-components kernel against its plain version
    (exact: labels and areas are integers) on random [8, 1, 1024, 1024] masks
    and on random masks at CC_GENERAL_SHAPES (tiles spanning rows, a partial
    last tile), each at p = 0.1, 0.41, 0.7; all-zero and all-one masks,
    1 x 1 and 1 x W masks;
    against scipy (same partition, equal areas) on a serpentine and a spiral
    at 1024^2, whose diameters are too long for the plain version; timed at
    [8, 1, 1024, 1024] beside its bytes bound, the plain version and scipy on
    the host. Returns the kernels-line numbers."""
    import numpy as np
    from videopainter_tpu_torch import native
    require_modules("phase 12", ("scipy",))
    gen = torch.Generator(device="cuda").manual_seed(1212)
    t0 = time.perf_counter()
    native.connected_components_cuda(torch.ones((1, 1, 8, 8), dtype=torch.uint8, device="cuda"))
    torch.cuda.synchronize()
    log(f"connected_components: first call (build and launch) {time.perf_counter() - t0:.3f} s")
    cases = {f"random p={p}": (torch.rand(CC_SHAPE, generator=gen, device="cuda") < p
                               ).to(torch.uint8) for p in CC_PROBS}
    for shape in CC_GENERAL_SHAPES:
        for p in CC_PROBS:
            cases[f"random p={p} at {shape[2]}x{shape[3]}"] = (
                torch.rand(shape, generator=gen, device="cuda") < p).to(torch.uint8)
    cases["all zero"] = torch.zeros(CC_SHAPE, dtype=torch.uint8, device="cuda")
    cases["all one"] = torch.ones(CC_SHAPE, dtype=torch.uint8, device="cuda")
    cases["1 x 1"] = torch.ones((2, 1, 1, 1), dtype=torch.uint8, device="cuda")
    cases["1 x W"] = (torch.rand((4, 1, 1, 1024), generator=gen, device="cuda") < 0.6
                      ).to(torch.uint8)
    max_err, readings, plain_ms = 0, [], {}
    for name, m in cases.items():
        labels, areas = native.connected_components_cuda(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref_labels, ref_areas = native.connected_components_reference(m)
        torch.cuda.synchronize()
        plain_ms[name] = (time.perf_counter() - t0) * 1e3
        err = max((labels - ref_labels).abs().max().item(), (areas - ref_areas).abs().max().item())
        max_err = max(max_err, err)
        n_comp = int(ref_labels.flatten(1).amax(1).sum())
        readings.append(f"{name} {tuple(m.shape)}: {n_comp} components, max |kernel - plain| "
                        f"{err}, plain version {plain_ms[name]:.1f} ms")
        if err:
            raise AssertionError(f"connected_components disagrees with its plain version on "
                                 f"{name}: max |difference| {err}")
    for name, mask in (("serpentine", serpentine(1024)), ("spiral", spiral(1024))):
        labels, areas = native.connected_components_cuda(
            torch.from_numpy(mask).cuda()[None, None])
        labels, areas = labels[0, 0].cpu().numpy(), areas[0, 0].cpu().numpy()
        ref_labels, ref_areas = scipy_labels(mask)
        ok = same_partition(labels, ref_labels) and np.array_equal(areas, ref_areas)
        readings.append(f"{name} 1024^2: {int(ref_labels.max())} components of "
                        f"{int(ref_areas.max())} pixels at most, scipy's partition and areas: "
                        f"{ok}")
        if not ok:
            raise AssertionError(f"connected_components disagrees with scipy on the {name}")
    log("connected_components against its plain version (exact) and scipy: "
        + "; ".join(readings))

    ms_by_p = {}
    for p in CC_PROBS:
        m = cases[f"random p={p}"]
        ms_by_p[p] = cuda_time_ms(lambda m=m: native.connected_components_cuda(m), 10)
    host = cases["random p=0.41"].cpu().numpy()
    t0 = time.perf_counter()
    for i in range(host.shape[0]):
        scipy_labels(host[i, 0])
    scipy_ms = (time.perf_counter() - t0) * 1e3
    n_px = math.prod(CC_SHAPE)
    bound_ms = 9.0 * n_px / H100_HBM_BYTES * 1e3   # 1 B read, 4 + 4 B written a pixel
    ms = ms_by_p[0.41]
    log(f"connected_components {list(CC_SHAPE)}: kernel " + ", ".join(
        f"p={p} {t:.3f} ms" for p, t in ms_by_p.items()) + f"; bytes bound {bound_ms:.4f} ms "
        f"({9 * n_px / 1e6:.1f} MB at 3.35 TB/s; p=0.41 at {bound_ms / ms * 100:.2f} % of it); "
        f"plain version " + ", ".join(f"p={p} {plain_ms[f'random p={p}']:.1f} ms"
                                      for p in CC_PROBS)
        + f"; scipy.ndimage.label on the host {scipy_ms:.1f} ms (p=0.41, 8 masks)")
    return {"max_abs_err": max_err, "ms": ms, "ms_by_p": {str(p): t for p, t in ms_by_p.items()},
            "plain_ms": plain_ms["random p=0.41"], "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "scipy_host_ms": scipy_ms, "shape": list(CC_SHAPE)}


def build_sam2(torch, seed):
    """Hiera-L SAM2 at 1024 through `build_sam2_video_predictor`, seeded
    random weights (no checkpoint is in the repository), on the card. The
    object-score head's last bias is set to +10, so that the object gate
    passes and the masks are the decoder's (with random weights the gate's
    sign is a coin toss, and a gated frame is -1024 everywhere)."""
    from videopainter_tpu_torch.ops.basic import init_random_
    from videopainter_tpu_torch.segmentation import build_sam2_video_predictor
    torch.manual_seed(seed)   # the prompt encoder's Gaussian matrix (a buffer)
    pred = build_sam2_video_predictor(DEMO_SIZE, None, image_size=1024, device="cuda")
    init_random_(pred, torch.Generator(device="cuda").manual_seed(seed))
    with torch.no_grad():
        pred.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(10.0)
    return pred.eval()


def sam2_first_frames(pred, frames, clicks):
    """The predictor on the first 2 frames: the clicks on frame 0, then the
    propagation. Returns (mask logits of frames 0 and 1, the top FPN level of
    frame 0) on the host."""
    import numpy as np
    s = pred.cfg.image_size
    h, w = frames.shape[1:3]
    state = pred.init_state(frames[:2])
    for x, y, positive in clicks:
        pred.add_new_points(state, 0, np.array([[x * s / w, y * s / h]], np.float32),
                            np.array([1 if positive else 0], np.int32))
    logits = dict(pred.propagate_in_video(state))
    return np.stack([logits[0], logits[1]]), state.features[0]["backbone_fpn"][-1].cpu().numpy()


DEMO_CLICKS = {0: [(360.0, 240.0, True), (200.0, 120.0, False)], 1: [(560.0, 360.0, True)]}


def amg_cc_against_plain(torch, calls, chunk=128):
    """The kernel's (mask, labels, areas) calls of an AMG pass held to the
    plain version, a batch of masks at a time; returns the max |difference|."""
    from videopainter_tpu_torch import native
    err = 0
    for i in range(0, len(calls), chunk):
        part = calls[i:i + chunk]
        ref_labels, ref_areas = native.connected_components_reference(
            torch.cat([m for m, _, _ in part]))
        err = max(err, (torch.cat([lab for _, lab, _ in part]) - ref_labels).abs().max().item(),
                  (torch.cat([a for _, _, a in part]) - ref_areas).abs().max().item())
    return err


def phase_demo(torch, kernels, pipe, emb):
    """Phase 12b: the interactive demo at full width. Hiera-L SAM2 at 1024
    (`build_sam2_video_predictor`, seeded weights) held against the CPU on
    the first 2 frames (full fp32; a TF32 control must fail the limit); an
    `AppSession` on a 49x480x720 clip: two objects, one refined by a negative
    click, `track()` (the image encoder must run 49 times: one feature cache
    for both), then `inpaint` at 2 steps on `pipe` (a functools.partial of
    the any-length pipeline; B1: 44 launches a step) with the prompt
    embeddings `emb`; then the automatic mask generator on frame 0 (16 x 16
    points, thresholds 0, box NMS 1.0 so that every candidate is kept,
    min_mask_region_area 100: two connected-components launches a kept
    mask, each held to the plain version). Returns the launches of the
    inpaint ("app") and of the generator ("amg"), and the phase's times."""
    import numpy as np
    from videopainter_tpu_torch import native
    from videopainter_tpu_torch.app.app import AppSession
    from videopainter_tpu_torch.segmentation import SAM2VideoPredictor
    from videopainter_tpu_torch.segmentation.image_predictor import (
        AutoMaskConfig, SAM2AutomaticMaskGenerator, SAM2ImagePredictor)
    from videopainter_tpu_torch.utils import numerics
    require_modules("phase 12", ("cv2",))
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    pred = build_sam2(torch, 1213)
    sync()
    n_params = sum(p.numel() for p in pred.parameters())
    log(f"SAM2 {DEMO_SIZE} at 1024 built and seeded on the card in "
        f"{time.perf_counter() - t0:.3f} s: {n_params / 1e6:.1f} M parameters")
    frames = smooth_clip(torch, torch.Generator(device="cuda").manual_seed(1214), 49, 480, 720)

    # the card against the CPU on the first 2 frames, fp32 both; then the TF32 control
    with torch.device("meta"):
        cpu = SAM2VideoPredictor(pred.cfg)
    cpu = cpu.to_empty(device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in pred.state_dict().items()})
    cpu.eval()
    t0 = time.perf_counter()
    want_logits, want_feat = sam2_first_frames(cpu, frames, DEMO_CLICKS[0])
    cpu_s = time.perf_counter() - t0
    del cpu
    got_logits, got_feat = sam2_first_frames(pred, frames, DEMO_CLICKS[0])
    errs = {"logits": max_rel(got_logits, want_logits), "features": max_rel(got_feat, want_feat)}
    sound = numerics.full_fp32
    numerics.full_fp32 = tf32_control(torch)
    try:
        ctl_logits, ctl_feat = sam2_first_frames(pred, frames, DEMO_CLICKS[0])
    finally:
        numerics.full_fp32 = sound
    control = {"logits": max_rel(ctl_logits, want_logits),
               "features": max_rel(ctl_feat, want_feat)}
    log(f"SAM2 card against CPU (2 frames, the CPU's side {cpu_s:.3f} s), max |card - CPU| "
        f"over max |CPU|, full fp32 / TF32 control (limit {SAM2_REL:g}): mask logits "
        f"{errs['logits']:.3e} / {control['logits']:.3e}, top FPN level {errs['features']:.3e} "
        f"/ {control['features']:.3e}; max |logit| {np.abs(want_logits).max():.4f}, "
        f"foreground share {float((want_logits > 0).mean()):.4f}")
    if errs["logits"] > SAM2_REL:
        raise AssertionError(f"SAM2 on the card against the CPU: {errs}")
    if control["logits"] <= SAM2_REL:
        raise AssertionError(f"the TF32 control passes the SAM2 limit {SAM2_REL}: {control}; "
                             "the check cannot tell TF32 from fp32")

    # the session: clicks, tracking (encoder and memory attention timed by hooks)
    spans = {"encoder": [], "memory_attention": []}

    def timing(mod, key):
        def pre(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[key].append([ev])

        def post(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans[key][-1].append(ev)
        return [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    hooks = timing(pred.image_encoder, "encoder") + timing(pred.memory_attention,
                                                           "memory_attention")

    def encode(_prompt):
        return emb, torch.zeros_like(emb)

    session = AppSession(predictor=pred, pipe=pipe, encode_prompt_fn=encode, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    session.load_video(frames)
    for obj, clicks in DEMO_CLICKS.items():
        for x, y, positive in clicks:
            session.click(0, x, y, positive=positive, obj_id=obj)
    sync()
    click_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    union = session.track()
    sync()
    track_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    track_launches = dict(kernels.LAUNCHES)
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    n_enc = len(ms["encoder"])
    coverage = {oid: float(m.mean()) for oid, m in session.obj_masks.items()}
    log(f"app session (49x480x720, 2 objects, 3 clicks): clicks {click_s:.3f} s, track "
        f"{track_s:.3f} s; image encoder runs {n_enc} (expected 49: one cache for both "
        f"objects), {np.mean(ms['encoder']):.3f} ms a frame; memory attention "
        f"{len(ms['memory_attention'])} runs, {np.mean(ms['memory_attention']):.3f} ms a frame; "
        f"mask coverage by object {coverage}, union {float(union.mean()):.4f} (random weights: "
        f"reported, not judged); launches {track_launches}")
    if n_enc != 49 or any(track_launches.values()) or union.shape != (49, 480, 720):
        raise AssertionError(f"tracking: {n_enc} encoder runs, launches {track_launches}, "
                             f"masks {union.shape}")

    # the inpaint: B1 once a layer a step (CFG batched)
    per_step = pipe.func.transformer.cfg.num_layers + pipe.func.branch.cfg.num_layers
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["flash_fwd"] = per_step * DEMO_STEPS
    steps = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = session.inpaint("a synthetic clip", num_inference_steps=DEMO_STEPS, seed=42,
                          progress_fn=lambda i, n: (sync(), steps.append(time.perf_counter())))
    sync()
    inpaint_s = time.perf_counter() - t0
    app_launches = dict(kernels.LAUNCHES)
    log(f"app inpaint (49x480x720, {DEMO_STEPS} steps, CFG 6, replace_gt, mask_add, B1 through "
        f"use_flash): {inpaint_s:.3f} s, steps ending at " + ", ".join(
            f"{s - t0:.3f}" for s in steps) + f" s; flash_fwd launches {app_launches['flash_fwd']}"
        f" (expected {want['flash_fwd']} = {per_step} layers x {DEMO_STEPS} steps); output "
        f"{out.shape} {out.dtype}, side by side {session.side_by_side().shape}")
    if attention_launches(app_launches) != attention_launches(want) or out.shape != (49, 480, 720, 3):
        raise AssertionError(f"app inpaint launches {app_launches}, expected {want}")

    # the automatic mask generator on frame 0: two CC launches a kept mask.
    # box_nms_thresh 1.0 keeps every candidate (random weights give nearly
    # one box to all of them), so the repair runs on hundreds of masks; each
    # of the kernel's calls is held to its plain version afterwards
    amg = SAM2AutomaticMaskGenerator(SAM2ImagePredictor(pred), AutoMaskConfig(
        points_per_side=DEMO_AMG_POINTS, pred_iou_thresh=0.0, stability_score_thresh=0.0,
        box_nms_thresh=DEMO_AMG_NMS, min_mask_region_area=DEMO_MIN_REGION))
    kept, calls = [], []
    repair, components = amg._postprocess_small_regions, native.get_connected_components

    def counted(masks, *a):
        kept.append(len(masks))
        return repair(masks, *a)

    def recorded(mask):
        labels, areas = components(mask)
        calls.append((mask.clone(), labels, areas))
        return labels, areas

    amg._postprocess_small_regions = counted
    native.get_connected_components = recorded
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        anns = amg.generate(frames[0])
        sync()
        amg_s = time.perf_counter() - t0
        amg_launches = dict(kernels.LAUNCHES)
    finally:
        native.get_connected_components = components
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want["connected_components"] = 2 * kept[0]
    peak = torch.cuda.max_memory_allocated()
    cc_err = amg_cc_against_plain(torch, calls)
    log(f"automatic mask generator (frame 0, {DEMO_AMG_POINTS}x{DEMO_AMG_POINTS} points, "
        f"thresholds 0, box NMS {DEMO_AMG_NMS}, min region {DEMO_MIN_REGION}): {amg_s:.3f} s, "
        f"{kept[0]} masks kept by NMS, {len(anns)} after the repair's NMS; "
        f"connected_components launches {amg_launches['connected_components']} (expected 2 x "
        f"{kept[0]}), each call's labels and areas against the plain version: max "
        f"|difference| {cc_err} over {len(calls)} masks {tuple(calls[0][0].shape)}; areas "
        f"{sorted(a['area'] for a in anns)[-5:]} (the largest 5); peak memory of the demo "
        f"{peak / 2**30:.2f} GiB")
    if amg_launches != want or len(calls) != want["connected_components"] or not anns:
        raise AssertionError(f"AMG launches {amg_launches}, expected {want}; {len(calls)} "
                             f"recorded calls, {len(anns)} masks")
    if cc_err:
        raise AssertionError(f"connected_components disagrees with its plain version on the "
                             f"AMG's masks: max |difference| {cc_err}")
    del pred, session, amg, calls
    return {"app": app_launches, "amg": amg_launches, "track_s": track_s,
            "inpaint_s": inpaint_s, "amg_s": amg_s, "peak_gib": peak / 2**30}


def int8_load_memory(torch, root):
    """What `utils.compact_params` gains after the CLI's `--int8` load
    (`infer.inpaint.load_pipeline`: build_pipeline, W8A8 with the bf16
    weights freed) on phase 8's checkpoint: the allocator's allocated /
    reserved / peak GiB after each step, with an empty_cache before
    compaction as the control. The CLI does not compact: on the card the
    control releases as much as compaction does."""
    import os
    from videopainter_tpu_torch.infer.inpaint import build_pipeline
    from videopainter_tpu_torch.quantize import quantize_transformer_int8
    from videopainter_tpu_torch.utils import compact_params
    rows = []

    def read(step):
        torch.cuda.synchronize()
        rows.append((step, *(f() / 2**30 for f in (torch.cuda.memory_allocated,
                                                   torch.cuda.memory_reserved,
                                                   torch.cuda.max_memory_allocated))))

    torch.cuda.reset_peak_memory_stats()
    pipe = build_pipeline(os.path.join(root, "model"), os.path.join(root, "branch"),
                          id_adapter=os.path.join(root, "lora"), dtype_str="bfloat16",
                          device="cuda")
    read("bf16 load")
    models = [m for m in (pipe.transformer, pipe.branch) if m is not None]
    for m in models:
        quantize_transformer_int8(m, free_source=True)
    read("W8A8")
    torch.cuda.empty_cache()
    read("W8A8 + empty_cache (control)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moved = compact_params(*models)
    read("compact_params")
    compact_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    read("compact_params + empty_cache")
    log(f"the CLI's --int8 load on phase 8's checkpoint, GiB allocated / reserved / peak since "
        f"the last reset: " + "; ".join(f"{step} {a:.3f} / {r:.3f} / {m:.3f}"
                                        for step, a, r, m in rows)
        + f"; compact_params moved {moved / 2**30:.3f} GiB in {compact_s:.3f} s")
    del pipe, models
    free_cuda(torch)


def phase_demo_from_checkpoint(torch, kernels, root):
    """Phase 12: the CC kernel (12a), compact_params after the CLI's --int8
    load of phase 8's checkpoint, then the demo (12b) with phase 8's
    checkpoint read by `build_pipeline` and bound to use_flash=True (the app
    passes none: the exact path's score matrix would not fit) and bf16."""
    import functools
    import os
    from videopainter_tpu_torch.infer.inpaint import build_pipeline
    from videopainter_tpu_torch.models.text_encoder import load_prompt_embeds
    cc = phase_cc(torch, kernels)
    free_cuda(torch)
    int8_load_memory(torch, root)
    t0 = time.perf_counter()
    loaded = build_pipeline(os.path.join(root, "model"), os.path.join(root, "branch"),
                            id_adapter=os.path.join(root, "lora"), dtype_str="bfloat16",
                            device="cuda")
    torch.cuda.synchronize()
    log(f"phase 8's checkpoint read by build_pipeline in {time.perf_counter() - t0:.3f} s")
    pipe = functools.partial(loaded, use_flash=True, dtype=torch.bfloat16)
    emb = load_prompt_embeds(os.path.join(root, "embeds.npy")).cuda()
    demo = phase_demo(torch, kernels, pipe, emb)
    del loaded, pipe
    free_cuda(torch)
    return cc, demo


def free_cuda(torch):
    gc.collect()
    torch.cuda.empty_cache()


def t2v_view(transformer):
    """Phase 2's backbone as CogVideoX-5b T2V (in_channels 16, the SFT
    baseline's base): its modules shared, the patch embed reading the first
    16 of its 32 input channels (the noisy latents' slot)."""
    import dataclasses
    from videopainter_tpu_torch.pipelines import share_transformer
    return share_transformer(transformer, transformer.patch_embed.proj.weight[:, :16],
                             dataclasses.replace(transformer.cfg, in_channels=16))


def phase_variants(torch, kernels, pipe):
    """Phase 9: the variants at full width on phase 2's backbone and VAE: the
    self-guidance baseline (49x480x720, 2 steps, guidance 1.0: two 42-layer
    passes a step, the guidance pass capturing every layer's states) and the
    SFT any-length baseline (phase 2's blocks under a patch embed widened by
    `init_sft_from_transformer`; 81 frames, 2 windows x 2 steps, CFG 6).
    Returns the launch counts of the two runs."""
    from videopainter_tpu_torch.flagship import FLAGSHIP_CALL, random_clip
    from videopainter_tpu_torch.pipelines import (CogVideoXI2VInpaintAnyLPipeline,
                                                  CogVideoXSelfGuidanceInpaintPipeline,
                                                  init_sft_from_transformer)

    gen = torch.Generator(device="cuda").manual_seed(909)
    n_layers = pipe.transformer.cfg.num_layers
    captures = []

    def on_forward(module, args, out):
        if out.hidden_states_list is not None:
            captures.append(out.hidden_states_list.numel()
                            * out.hidden_states_list.element_size())

    def run(name, p, clip, **kw):
        stamps = []

        def progress(i, n):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = p(**clip, generator=gen, output_type="pt", progress_fn=progress,
                dtype=torch.bfloat16, use_flash=True, **kw)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        steps = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
        finite = bool(torch.isfinite(out).all())
        log(f"{name}: out {tuple(out.shape)} finite {finite}; s per step (the first of each "
            f"window includes its VAE encodes) " + ", ".join(f"{x:.3f}" for x in steps)
            + f"; total {total:.3f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; flash_fwd launches "
            f"{launches['flash_fwd']}")
        if not finite:
            raise AssertionError(f"{name}: output not finite")
        return launches

    sched = pipe.scheduler
    sg = CogVideoXSelfGuidanceInpaintPipeline(pipe.transformer, pipe.vae, sched)
    clip = random_clip(gen, frames=49)
    hook = pipe.transformer.register_forward_hook(on_forward)
    try:
        sg_launches = run("self-guidance, 49x480x720, 2 steps, guidance 1.0", sg, clip,
                          num_inference_steps=2, guidance_scale=1.0)
    finally:
        hook.remove()
    log(f"self-guidance capture per step: {captures[0]} bytes ({captures[0] / 2**30:.3f} GiB, "
        f"{n_layers} layers x [1, 17776, 3072] bf16), {len(captures)} captures")
    expected = {"flash_fwd": 2 * 2 * n_layers}
    del clip, sg
    free_cuda(torch)

    sft = init_sft_from_transformer(t2v_view(pipe.transformer))
    assert sft.transformer_blocks is pipe.transformer.transformer_blocks
    anyl = CogVideoXI2VInpaintAnyLPipeline(sft, pipe.vae, sched)
    clip = random_clip(gen, frames=81)
    sft_launches = run("SFT any-length, 81x480x720, 2 windows x 2 steps, CFG 6", anyl, clip,
                       num_inference_steps=2, num_frames=49, stride=32,
                       **{k: FLAGSHIP_CALL[k] for k in ("guidance_scale", "use_dynamic_cfg",
                                                         "replace_gt", "mask_add")})
    del clip, anyl, sft
    free_cuda(torch)
    total = {k: sg_launches[k] + sft_launches[k] for k in sg_launches}
    want = dict.fromkeys(total, 0)
    want["flash_fwd"] = expected["flash_fwd"] + 2 * 2 * n_layers
    log(f"variant launches: self-guidance {sg_launches['flash_fwd']} (expected "
        f"{expected['flash_fwd']} = 2 passes x 2 steps x {n_layers}), SFT any-length "
        f"{sft_launches['flash_fwd']} (expected {2 * 2 * n_layers} = 2 windows x 2 steps x "
        f"{n_layers})")
    if attention_launches(total) != attention_launches(want):
        raise AssertionError(f"variant launches {total}, expected {want}")
    return total


def phase_small_variants(torch, kernels):
    """Phase 10: small variant and generation pipelines (head dim 64) on the
    card, the bf16 kernel path against the exact path; the CLI's compute at a
    tiny width from tiny checkpoints with `--int8 --int8_attn` and with
    `--int8_pv`, against the same CLI on the int8 kernel's plain version; a
    fused to_qkv model against the unfused one, bf16 and W8A8."""
    import copy
    import os
    import shutil
    import tempfile
    from videopainter_tpu_torch import pipelines as P
    from videopainter_tpu_torch.config import (BranchConfig, SchedulerConfig,
                                               TransformerConfig, VAEConfig)
    from videopainter_tpu_torch.infer import inpaint as cli
    from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                               CogVideoXTransformer3D)
    from videopainter_tpu_torch.ops import attention, fuse_qkv_projections
    from videopainter_tpu_torch.ops import flash_attention_int8 as fa8
    from videopainter_tpu_torch.quantize import quantize_transformer_int8
    from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

    gen = torch.Generator(device="cuda").manual_seed(1010)
    small = dict(out_channels=16, attention_head_dim=64, sample_height=8, sample_width=12)
    t2v_cfg = TransformerConfig.tiny(in_channels=16, **small)
    i2v_cfg = TransformerConfig.tiny(in_channels=32, **small)

    def build(ctor, dtype=torch.bfloat16):
        return ctor(device="meta", dtype=dtype).to_empty(device="cuda").init_random_(gen)

    vae = build(lambda **kw: AutoencoderKLCogVideoX(VAEConfig.tiny(latent_channels=16), **kw))
    sched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())
    t2v = build(lambda **kw: CogVideoXTransformer3D(t2v_cfg, **kw))
    i2v = build(lambda **kw: CogVideoXTransformer3D(i2v_cfg, **kw))
    sft = build(lambda **kw: P.make_sft_inpaint_transformer(t2v_cfg, **kw))
    branch = build(lambda **kw: CogVideoXBranch(BranchConfig.from_transformer(t2v_cfg), **kw))
    branch.init_from_transformer(t2v)
    for lin in branch.branch_blocks:   # non-zero projections: the branch acts
        torch.nn.init.normal_(lin.weight, std=0.02, generator=gen)
    pipes = {"t2v dual": P.CogVideoXDualInpaintPipeline(t2v, branch, vae, sched),
             "plain": P.CogVideoXInpaintPipeline(t2v, vae, sched),
             "image2video": P.CogVideoXImageToVideoInpaintPipeline(i2v, vae, sched),
             "sft": P.CogVideoXSFTInpaintPipeline(sft, vae, sched),
             "t2v generation": P.CogVideoXPipeline(t2v, vae, sched),
             "i2v generation": P.CogVideoXImageToVideoPipeline(i2v, vae, sched),
             "v2v generation": P.CogVideoXVideoToVideoPipeline(t2v, vae, sched)}
    video = torch.rand((1, 9, 64, 96, 3), generator=gen, device="cuda") * 2 - 1
    masks = torch.zeros((1, 9, 64, 96), device="cuda")
    masks[:, :, 16:48, 24:72] = 1
    embeds = torch.randn((1, 5, 12), generator=gen, device="cuda")
    noise = torch.randn((1, 3, 8, 12, 16), generator=gen, device="cuda")
    dpm = torch.randn((2, 1, 3, 8, 12, 16), generator=gen, device="cuda")
    base = dict(prompt_embeds=embeds, negative_prompt_embeds=torch.zeros_like(embeds),
                num_inference_steps=2, guidance_scale=6.0, use_dynamic_cfg=True,
                vae_sample_mode="mode", init_noise=noise, dpm_noises=dpm, output_type="pt",
                dtype=torch.bfloat16)
    total = 0
    for name, p in pipes.items():
        kw = dict(base)
        if name.startswith(("t2v gen", "i2v gen")):
            kw.update(num_frames=9, height=64, width=96)
        elif name.startswith("v2v"):
            kw.update(video=video, num_inference_steps=4, strength=0.5)
        else:
            kw.update(video=video, masks=masks, mask_add=True, replace_gt=True)
        if name in ("image2video", "i2v generation"):
            kw["image"] = video[:, 0]
        kernels.reset_launches()
        outs = {flash: p(use_flash=flash, **kw).float() for flash in (True, False)}
        # one call a layer a step (CFG batched); 2 steps (V2V: 4 at strength 0.5)
        per_step = p.transformer.cfg.num_layers + (p.branch.cfg.num_layers if p.branch else 0)
        want = dict.fromkeys(kernels.LAUNCHES, 0)
        want["flash_fwd"] = 2 * per_step
        got = dict(kernels.LAUNCHES)
        total += got["flash_fwd"]
        psnr = psnr_db(outs[True], outs[False])
        finite = bool(torch.isfinite(outs[True]).all())
        log(f"small {name}: kernel path vs exact path PSNR {psnr:.1f} dB (min "
            f"{SMALL_PSNR_DB}), finite {finite}; flash_fwd launches {got['flash_fwd']} "
            f"(expected {want['flash_fwd']} = 2 steps x {per_step} layers)")
        if not (finite and psnr >= SMALL_PSNR_DB):
            raise AssertionError(f"small {name}: the kernel path disagrees with the exact path")
        if attention_launches(got) != attention_launches(want):
            raise AssertionError(f"small {name}: launches {got}, expected {want}")
    log(f"flash_fwd launches of the small variants: {total}")

    # the fused to_qkv slot: the dual pipeline fused against unfused, bf16 then W8A8
    unfused = P.CogVideoXI2VDualInpaintPipeline(i2v, build(lambda **kw: CogVideoXBranch(
        BranchConfig.from_transformer(i2v_cfg), **kw)), vae, sched)
    fused = P.CogVideoXI2VDualInpaintPipeline(
        fuse_qkv_projections(copy.deepcopy(unfused.transformer)),
        fuse_qkv_projections(copy.deepcopy(unfused.branch)), vae, sched)
    kw = dict(base, video=video, masks=masks, image=video[:, 0] * (1 - masks[:, 0, ..., None]),
              mask_add=True, replace_gt=True)
    for mode, flash in (("bf16", True), ("W8A8", "int8")):
        if mode == "W8A8":
            for p in (unfused, fused):
                quantize_transformer_int8(p.transformer, free_source=True)
                quantize_transformer_int8(p.branch, free_source=True)
        a, b = unfused(use_flash=flash, **kw).float(), fused(use_flash=flash, **kw).float()
        psnr = psnr_db(b, a)
        log(f"small fused to_qkv vs unfused, {mode}: PSNR {psnr:.1f} dB (min {SMALL_PSNR_DB}), "
            f"equal {torch.equal(a, b)}, max |diff| {(a - b).abs().max().item():.3e}")
        if not (bool(torch.isfinite(b).all()) and psnr >= SMALL_PSNR_DB):
            raise AssertionError(f"fused to_qkv disagrees with the unfused model ({mode})")
    del unfused, fused

    # the CLI's compute at a tiny width from checkpoints on disk, int8 modes
    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli_small_", dir="build")
    try:
        rs_cfg = TransformerConfig.tiny(in_channels=32, id_pool_resample_learnable=True, **small)
        write_tiny_checkpoint(torch, root, gen, rs_cfg, vae, embeds, torch.bfloat16, lora=True)
        video_u8, mask_u8 = moving_mask_clip(torch, gen, 17, 64, 96)
        argv = ["--model_path", os.path.join(root, "model"),
                "--inpainting_branch", os.path.join(root, "branch"),
                "--id_adapter", os.path.join(root, "lora"), "--meta_file_path", "unused.csv",
                "--prompt_embeds", os.path.join(root, "embeds.npy"), "--height", "64",
                "--width", "96", "--num_frames", "9", "--overlap_frames", "1",
                "--num_inference_steps", "2", "--replace_gt", "--mask_add", "--int8"]
        def cli_frames(args):
            out = cli.run_inpaint(cli.load_pipeline(args), args, video_u8, mask_u8, "")[0]
            return torch.from_numpy(out * 2 - 1)

        # the bf16 weights with exact attention: the yardstick that shows the
        # comparisons below can tell the int8 path from another
        exact = cli_frames(cli.get_args([a for a in argv if a != "--int8"]))
        # 2 windows (17 frames, 9 a window, overlap 1) x 2 steps, one call a
        # layer (ID resampling: 2 S keys in the same call)
        want8 = 2 * 2 * (rs_cfg.num_layers + BranchConfig.from_transformer(rs_cfg).num_layers)
        wrapper = attention.flash_attention_int8
        for flags in (["--int8_attn"], ["--int8_pv"]):
            args = cli.get_args(argv + flags)
            outs, n8 = [], []
            for plain in (False, True):
                attention.flash_attention_int8 = (fa8.flash_attention_int8_reference if plain
                                                  else wrapper)
                try:
                    kernels.reset_launches()
                    outs.append(cli_frames(args))
                    n8.append(kernels.LAUNCHES["flash_int8_fwd"])
                finally:
                    attention.flash_attention_int8 = wrapper
            psnr = psnr_db(*outs)
            log(f"small CLI {' '.join(['--int8'] + flags)}: int8 kernel vs its plain version "
                f"PSNR {psnr:.1f} dB (min {SMALL_PSNR_DB}), equal {torch.equal(*outs)}; "
                f"flash_int8_fwd launches {n8[0]} (expected {want8}), on the plain version "
                f"{n8[1]} (expected 0); against bf16 weights with exact attention: kernel "
                f"{psnr_db(outs[0], exact):.1f} dB, plain version {psnr_db(outs[1], exact):.1f} "
                "dB (no limit)")
            if not (bool(torch.isfinite(outs[0]).all()) and psnr >= SMALL_PSNR_DB):
                raise AssertionError(f"small CLI {flags}: the int8 kernel path disagrees with "
                                     "its plain version")
            if n8 != [want8, 0]:
                raise AssertionError(f"small CLI {flags}: flash_int8_fwd launches {n8}, "
                                     f"expected [{want8}, 0]")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_anyl_int8(torch, kernels):
    """Phase 3: the any-length int8 flagship at full width, its frames decoded
    window by window by the VAE's streaming decoder with the conv caches
    spilled to host memory between chunks; the streamed frames held against
    the one-shot decode of the same latents. Returns the launch counts of
    the pipeline run."""
    from videopainter_tpu_torch.flagship import (ANYL_FRAMES, ANYL_INT8_CALL,
                                                 build_anyl_int8_pipeline, random_clip)
    from videopainter_tpu_torch.models.vae import VAEStreamDecoder
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
    # the streaming decoder, measured: each feed's latents, frames and time,
    # and the time its cache copies to and from host memory took
    fed, copy_s, spilled = [], [0.0], [0]
    feed, spill, restore = (VAEStreamDecoder.feed, VAEStreamDecoder._spill,
                            VAEStreamDecoder._restore)

    def timed_copy(fn):
        def run(*a):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            copy_s[0] += time.perf_counter() - s0
            return r
        return run

    def measured_feed(self, z):
        copy_s[0] = 0.0
        fed.append(z.clone())
        frames = timed(lambda: feed(self, z), f"stream decode {z.shape[1]} latents")()
        spilled[0] = sum(t.numel() * t.element_size() for c in self.caches.values()
                         for t in _tensors(c))
        events[-1] = (events[-1][0] + f" -> {0 if frames is None else frames.shape[1]} frames "
                      f"(cache copies {copy_s[0]:.3f} s, {spilled[0] / 2**20:.0f} MiB spilled)",
                      *events[-1][1:])
        return frames

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
    VAEStreamDecoder.feed = measured_feed
    VAEStreamDecoder._spill = staticmethod(timed_copy(spill))
    VAEStreamDecoder._restore = staticmethod(timed_copy(restore))
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # stream and one-shot: the same algorithms
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
        peak = torch.cuda.max_memory_allocated()
        # the one-shot decode of the latents the stream was fed
        oneshot = torch.clamp(pipe.vae.decode(torch.cat(fed, dim=1)), -1, 1)
        torch.cuda.synchronize()
    finally:
        inpaint_anyl.make_denoise_fn = make
        VAEStreamDecoder.feed = feed
        VAEStreamDecoder._spill, VAEStreamDecoder._restore = (staticmethod(spill),
                                                              staticmethod(restore))
        torch.backends.cudnn.deterministic = cudnn_det
    same = torch.equal(out, oneshot)
    stream_psnr = psnr_db(out.float(), oneshot.float())
    diff = (out.float() - oneshot.float()).abs().max().item()
    del oneshot

    expected = (tcfg.num_layers + 2) * 2 * 2
    shape_ok = tuple(out.shape) == (1, f, hgt, wid, 3)
    finite = bool(torch.isfinite(out).all())
    log(f"any-length int8: out {tuple(out.shape)} finite {finite}; flash_int8_fwd launches "
        f"{launches['flash_int8_fwd']} (expected {expected} = 44 layers x 2 steps x 2 "
        f"windows), flash_fwd launches {launches['flash_fwd']} (expected 0)")
    log("any-length int8 wall times: " + ", ".join(f"{k} {s:.3f} s" for k, _, s in events)
        + f"; total {total:.3f} s; captured state per window "
        + ", ".join(f"{c / 2**20:.1f} MiB" for c in captured)
        + f"; peak memory {peak / 2**30:.2f} GiB (streamed decode, caches spilled)")
    log(f"any-length stream decode: {len(fed)} feeds of " + ", ".join(str(z.shape[1]) for z in fed)
        + f" latent frames; streamed frames equal to the one-shot decode of the same latents: "
        f"{same} (max |diff| {diff:.3e}, PSNR {stream_psnr:.1f} dB, min {STREAM_PSNR_DB} if "
        f"not equal)")
    if not (shape_ok and finite):
        raise AssertionError(f"any-length output {tuple(out.shape)} finite={finite}")
    if len(fed) != 2 or not (same or stream_psnr >= STREAM_PSNR_DB):
        raise AssertionError("the streamed decode disagrees with the one-shot decode")
    if launches["flash_int8_fwd"] != expected or launches["flash_fwd"] != 0:
        raise AssertionError(f"any-length int8 launches {launches}, expected "
                             f"{expected} flash_int8_fwd and 0 flash_fwd")
    if not captured[0] > 0 or captured[-1] != 0:
        raise AssertionError(f"captured state per window {captured}: the first window "
                             "must capture, the last must not")
    return launches


def phase_train(torch, kernels):
    """Phase 5: two optimizer steps of branch SFT at full CogVideoX-5b-I2V
    width (42-layer frozen bf16 backbone, 2-layer float32 branch initialised
    from it, default VAE, batch 1, 49x480x720, 226-token embeddings, mask_add,
    per-block checkpointing, AdamW) with the flash forward and backward
    kernels, through the training tool's `measure`
    (`videopainter_tpu_torch.tools.smoke_chip_train`: its first step and one
    timed step). Returns the launch counts of the two steps."""
    from videopainter_tpu_torch.tools import smoke_chip_train as sct

    gen = torch.Generator(device="cuda").manual_seed(99)
    t0 = time.perf_counter()
    args = sct.parse_args(["--layers", "42", "--steps", "1"])   # AdamW at the reference's 1e-5
    t = sct.build(args, gen, torch.device("cuda"))
    transformer, branch, vae = t["transformer"], t["branch"], t["vae"]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_layers, n_branch = transformer.cfg.num_layers, branch.cfg.num_layers
    n_train = sum(p.numel() for p in branch.parameters())
    log(f"training, full width: {n_layers}-layer bf16 backbone (frozen), {n_branch}-layer "
        f"branch with {n_train / 1e9:.3f} B float32 parameters (trainable), AdamW, per-block "
        f"checkpoints; built in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    before = {n: p.detach().clone() for n, p in branch.named_parameters()}
    enc_s = []
    vae.encode = timed_calls(torch, vae.encode, enc_s)
    from videopainter_tpu_torch.ops.basic import GroupNorm
    encoder_norms = sum(isinstance(m, GroupNorm) for m in vae.encoder.modules())
    encoder_calls = []
    hook = vae.encoder.register_forward_hook(lambda *a: encoder_calls.append(1))

    n_steps = args.steps + 1
    kernels.reset_launches()
    rec, state, metrics = sct.measure(t, args, argv=["chip_smoke.py phase 5"], init_s=init_s)
    launches = dict(kernels.LAUNCHES)
    hook.remove()
    walls = [rec["first_step_s"]] + rec["step_walls_s"]

    # every block runs its forward once; every block that a trainable parameter
    # reaches is recomputed once and has one backward. The backbone's block 0
    # is not among them: the first branch sample is added after it.
    with_backward = n_branch + n_layers - 1
    expected = {**dict.fromkeys(kernels.LAUNCHES, 0),
                "flash_fwd": n_steps * (n_branch + n_layers + with_backward),
                "flash_dq": n_steps * with_backward, "flash_dkv": n_steps * with_backward,
                "qk_norm_rope": n_steps * (n_branch + n_layers + with_backward),
                "qk_norm_rope_bwd": n_steps * with_backward,
                # two norms a block, and the DiT's norm_out (outside the checkpoints)
                "adaln_fwd": n_steps * (2 * (n_branch + n_layers + with_backward) + 1),
                "adaln_bwd": n_steps * (2 * with_backward + 1),
                # the encoder's GroupNorms: two launches a norm of every forward
                **dict.fromkeys(VAE_NORM_KEYS, len(encoder_calls) * encoder_norms)}
    enc_per_step = len(enc_s) // n_steps
    for i, (w, m) in enumerate(zip(walls, metrics)):
        enc = sum(enc_s[i * enc_per_step:(i + 1) * enc_per_step])
        log(f"training step {i + 1}: {w:.3f} s wall (VAE encodes {enc:.3f} s of it, "
            f"{enc_per_step} calls), " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    log(f"training launches over {n_steps} steps: {launches} (expected {expected}; "
        f"{len(encoder_calls)} encoder forwards of {encoder_norms} GroupNorms); peak "
        f"memory {rec['peak_memory_gib']:.2f} GiB")
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
    check_record(rec)
    return launches


def check_record(rec):
    """A tool's record: finite numbers, strict JSON both ways."""
    from videopainter_tpu_torch.tools import gates
    gates.check_finite(rec)
    json.loads(json.dumps(rec, allow_nan=False))


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
    expected = {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": 2 + 2 * depth,
                "flash_dq": depth, "flash_dkv": depth}
    b_max = {tgt: ab["lora_B"].abs().max().item() for tgt, ab in state.trainable.items()}
    log(f"LoRA step, full width, backbone cut to {depth} of 42 layers, rank {LORA_RANK}, "
        f"35,552 keys: {wall:.3f} s wall, " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
        + f"; launches {launches} (expected {expected}); max |lora_B| after the step {b_max}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if attention_launches(launches) != attention_launches(expected):
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


# ---------------------------------------------------------------------------------------------
# phase 13: parallel/ (mesh, tensor and sequence parallelism, ZeRO-2) on the one card

PAR_DEPTH = 4              # backbone layers of phase 13b (of 42): two processes share one card
PAR_PSNR_DB = 55.0         # bf16 TP pipeline latents / ring DiT sample vs one process, over
                           # max|one process|: the row-parallel sums round partial products
                           # to bf16 (TP: 65.2 dB), the ring merges blocks in fp32 (68.3 dB);
                           # the row-parallel bias added on every rank (biases of std
                           # PAR_BIAS_STD) must fall below it
PAR_BIAS_STD = 0.5
PAR_INT8_REL_L1 = 1e-5     # W8A8 + int8 attention under model=2 vs one process, mean |diff|
                           # over mean |one process|: the int32 products and every scale are
                           # equal, and a row-parallel linear sums its int32 partial products
                           # before the scales (an fp32 sum flipped enough bf16 roundings,
                           # each then a whole int8 step at the next layer, to read 3.6e-4)


def par_psnr(a, b):
    """10 log10(max|b|^2 / mse) of two float arrays (numpy)."""
    import numpy as np
    mse = float(np.square(a.astype(np.float64) - b).mean())
    return 10 * math.log10(float(np.abs(b).max()) ** 2 / max(mse, 1e-30))


def par_rel_l1(a, b):
    import numpy as np
    return float(np.abs(a.astype(np.float64) - b).mean() / np.abs(b).mean())


def phase_ring_decomposition(torch, fa, kernels):
    """Phase 13a: the ring's arithmetic at the flagship shapes in one process,
    no communication. Forward: the joint [2x48, 226 + 17,550, 64] attention as
    each rank of a seq-2 and a seq-3 ring computes it (text block, then every
    video shard through B1 with lse, merged in fp32) against one B1 call on
    the whole sequence. Backward at the training shape [1x48, 17,776, 64]:
    every rank's per-block B2 / B3 with the merged lse, dK / dV summed over
    the ranks, against one B2 + B3 call. Returns the launches and times."""
    from videopainter_tpu_torch.parallel.ring_attention import (ring_backward_decomposition,
                                                                 ring_forward_decomposition)

    text, s_vid, h, d = 226, 17550, 48, 64
    gen = torch.Generator(device="cuda").manual_seed(13)

    def mk(b):   # heads split from a [B, S, H*D] projection by a view, as the model does
        return torch.randn((b, text + s_vid, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)

    out = {"launches": {}, "times": {}}
    q, k, v = mk(2), mk(2), mk(2)
    ref, ref_lse = fa.flash_attention_with_lse(q, k, v)
    single_ms = cuda_time_ms(lambda: fa.flash_attention_with_lse(q, k, v), 3)
    for n in (2, 3):
        kernels.reset_launches()
        worst = (0.0, 0.0)
        for r in range(n):
            o, lse = ring_forward_decomposition(q, k, v, text, n, r)
            rows = torch.cat([torch.arange(text), text + torch.arange(r * s_vid // n,
                                                                     (r + 1) * s_vid // n)])
            rows = rows.to("cuda")
            err, lim = flash_err(o, ref[:, :, rows])
            lse_err = (lse - ref_lse[:, :, rows]).abs().max().item()
            if err > lim or lse_err > LSE_TOL:
                raise AssertionError(f"ring of {n}, rank {r}: out error {err:.3g} (limit "
                                     f"{lim:.3g}), lse error {lse_err:.3g} (limit {LSE_TOL})")
            worst = (max(worst[0], err / lim), max(worst[1], lse_err))
        got = dict(kernels.LAUNCHES)
        want = {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": n * (1 + n)}
        if got != want:
            raise AssertionError(f"ring of {n} forward launches {got}, expected {want}")
        rank_ms = cuda_time_ms(lambda: ring_forward_decomposition(q, k, v, text, n, 0), 3)
        out["launches"][f"fwd_seq{n}"] = got["flash_fwd"]
        out["times"][f"fwd_seq{n}"] = (rank_ms, n * rank_ms, single_ms)
        log(f"13a ring forward, seq {n}, [2x48, 226 + 17,550, 64]: every rank within "
            f"FLASH_REL_TOL / LSE_TOL (worst {worst[0]:.3f} of the out limit, lse "
            f"{worst[1]:.3g}); {got['flash_fwd']} B1 launches (n (1 + n) = {n * (1 + n)}); "
            f"B1 blocks + merges {rank_ms:.3f} ms a rank, {n * rank_ms:.3f} ms over the "
            f"{n} ranks, against one B1 call with lse {single_ms:.3f} ms "
            f"({n * rank_ms / single_ms:.3f}x the compute)")
    del q, k, v, ref, ref_lse

    q, k, v, dout = mk(1), mk(1), mk(1), mk(1)
    scale = d ** -0.5

    def single():
        o, l = fa.flash_attention_with_lse(q, k, v)
        return fa.flash_bwd_cuda(q, k, v, o, l, dout, scale, q.shape[2], None)
    refs = single()
    single_ms = cuda_time_ms(single, 3)
    for n in (2, 3):
        kernels.reset_launches()
        grads = ring_backward_decomposition(q, k, v, dout, text, n)
        got = dict(kernels.LAUNCHES)
        want = {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": n * (1 + n),
                "flash_dq": n * (1 + n), "flash_dkv": n * (1 + n)}
        if got != want:
            raise AssertionError(f"ring of {n} backward launches {got}, expected {want}")
        errs = []
        for name, g, rf in zip(("dq", "dk", "dv"), grads, refs):
            err, lim = flash_err(g, rf)
            if err > lim:
                raise AssertionError(f"ring of {n} backward {name}: error {err:.3g} "
                                     f"(limit {lim:.3g})")
            errs.append(err / lim)
        all_ms = cuda_time_ms(lambda: ring_backward_decomposition(q, k, v, dout, text, n), 2)
        out["launches"][f"bwd_seq{n}"] = got
        out["times"][f"bwd_seq{n}"] = (all_ms / n, all_ms, single_ms)
        log(f"13a ring backward, seq {n}, [1x48, 17,776, 64]: dQ / dK / dV within "
            f"FLASH_REL_TOL of one B2 + B3 call (worst {max(errs):.3f} of the limit); "
            f"launches {n * (1 + n)} each of B1, B2, B3; every rank's forward and backward "
            f"{all_ms:.3f} ms in all, against one forward with lse + B2 + B3 "
            f"{single_ms:.3f} ms ({all_ms / single_ms:.3f}x)")
    return out


def par_models(seed, *, depth=PAR_DEPTH, branch=True, vae=True, bias_std=0.0,
               quantize=False, branch_dtype=None):
    from videopainter_tpu_torch.config import BranchConfig, TransformerConfig, VAEConfig

    tcfg = TransformerConfig.cogvideox_5b_i2v(num_layers=depth)
    m = {"tcfg": tcfg.to_dict(), "seed": seed, "dtype": "bfloat16", "bias_std": bias_std,
         "quantize": quantize,
         "bcfg": BranchConfig.from_transformer(tcfg, num_layers=2).to_dict() if branch else None,
         "vcfg": VAEConfig().to_dict() if vae else None}
    if branch_dtype:
        m["branch_dtype"] = branch_dtype
    return m


CLIP = {"seed": 131, "frames": 49, "height": 480, "width": 720, "text_len": 226,
        "text_dim": 4096}


def phase_parallel_ranks(torch, kernels):
    """Phase 13b: world 2 on the one card, two processes over gloo
    (`parallel.launch.run_local`; CUDA tensors, staged through host memory
    where gloo needs it), each at full CogVideoX-5b-I2V width with the
    backbone cut to PAR_DEPTH layers, each held to the same computation in one
    process: the single-clip pipeline under model=2 (bf16, use_flash, 2 DPM
    steps, latents), the DiT under seq=2 with the ring, a W8A8 + int8
    attention DiT forward under model=2 (B4 on 24 local heads), two
    branch-SFT steps under data=2 (ZeRO-2) and one under seq=2 with the ring;
    with the two controls that must fail their limits. Returns the launches
    of the ranks (summed) and the checks' numbers."""
    import numpy as np

    from videopainter_tpu_torch.config import SchedulerConfig
    from videopainter_tpu_torch.parallel import run_local, workers

    base = {"device": "cuda"}
    pipe = dict(base, models=par_models(21, bias_std=PAR_BIAS_STD), clip=CLIP,
                call={"num_inference_steps": 2, "guidance_scale": 6.0, "use_dynamic_cfg": True,
                      "replace_gt": True, "mask_add": True, "use_flash": True,
                      "output_type": "latent", "generator_seed": 5})
    dit = dict(base, models=par_models(22, branch=False, vae=False), use_flash=True,
               inputs={"seed": 7, "hidden_shape": (1, 13, 60, 90, 32),
                       "text_shape": (1, 226, 4096), "timestep": np.array([500])})
    dit8 = dict(dit, models=par_models(23, branch=False, vae=False, quantize=True),
                use_flash="int8")
    tsched = ("ddim", SchedulerConfig(prediction_type="v_prediction").to_dict())
    bcfg = {"mask_add": True, "use_flash": True, "remat": True}
    train = dict(base, models=par_models(24, branch_dtype="float32"), scheduler=tsched,
                 bcfg=bcfg, optimizer={"lr": 1e-5}, generator_seed=3,
                 batch=dict(CLIP, seed=132, b=2), steps=2, batch_dtype="bfloat16")
    ring_train = dict(train, batch=dict(CLIP, seed=133, b=1), steps=1, seq="ring")

    s0 = time.perf_counter()
    refs = {"pipe": workers.pipeline_rank(pipe)["out"], "dit": workers.dit_rank(dit)["sample"],
            "dit8": workers.dit_rank(dit8)["sample"], "train": workers.train_rank(train),
            "ring_train": workers.train_rank(dict(ring_train, seq=None))}
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - s0
    cases = [("pipeline_rank", dict(pipe, mesh=(1, 1, 2))),
             ("pipeline_rank", dict(pipe, mesh=(1, 1, 2), control="bias_every_rank")),
             ("dit_rank", dict(dit, mesh=(1, 2, 1), seq="ring")),
             ("dit_rank", dict(dit8, mesh=(1, 1, 2))),
             ("dit_rank", dict(dit8, mesh=(1, 1, 2), control="local_amax")),
             ("train_rank", dict(train, mesh=(2, 1, 1))),
             ("train_rank", dict(ring_train, mesh=(1, 2, 1)))]
    s0 = time.perf_counter()
    res = run_local(2, workers.cases_rank, cases, timeout=420, threads=0)
    ranks_s = time.perf_counter() - s0
    log(f"13b, full width with the backbone cut to {PAR_DEPTH} of 42 layers (two processes "
        f"share the card): one-process references {ref_s:.1f} s; world 2 over gloo "
        f"{ranks_s:.1f} s (routes {res[0][0]['routes']})")

    checks = {}
    for r, rank in enumerate(res):
        tp, broken, ring, i8, i8_broken, dp, sp = rank
        checks[f"tp_pipe_db_{r}"] = par_psnr(tp["out"], refs["pipe"])
        checks[f"tp_pipe_control_db_{r}"] = par_psnr(broken["out"], refs["pipe"])
        checks[f"ring_dit_db_{r}"] = par_psnr(ring["sample"], refs["dit"])
        checks[f"int8_tp_rel_l1_{r}"] = par_rel_l1(i8["sample"], refs["dit8"])
        checks[f"int8_tp_control_rel_l1_{r}"] = par_rel_l1(i8_broken["sample"], refs["dit8"])
    log("13b TP pipeline (model=2, 2 DPM steps, latents) against one process: "
        + ", ".join(f"rank {r} {checks[f'tp_pipe_db_{r}']:.2f} dB" for r in (0, 1))
        + f" (limit {PAR_PSNR_DB} dB); control, row-parallel bias on every rank: "
        + ", ".join(f"{checks[f'tp_pipe_control_db_{r}']:.2f} dB" for r in (0, 1)))
    log("13b DiT, seq=2 ring: " + ", ".join(f"rank {r} {checks[f'ring_dit_db_{r}']:.2f} dB"
                                             for r in (0, 1)) + f" (limit {PAR_PSNR_DB} dB)")
    log("13b W8A8 + int8 attention, model=2 (24 local heads): rel L1 "
        + ", ".join(f"{checks[f'int8_tp_rel_l1_{r}']:.3g}" for r in (0, 1))
        + f" (limit {PAR_INT8_REL_L1}); control, local amax: "
        + ", ".join(f"{checks[f'int8_tp_control_rel_l1_{r}']:.3g}" for r in (0, 1)))
    for r in (0, 1):
        if not checks[f"tp_pipe_db_{r}"] >= PAR_PSNR_DB > checks[f"tp_pipe_control_db_{r}"]:
            raise AssertionError(f"TP pipeline or its control outside the limit: {checks}")
        if not checks[f"ring_dit_db_{r}"] >= PAR_PSNR_DB:
            raise AssertionError(f"ring DiT below the limit: {checks}")
        if not (checks[f"int8_tp_rel_l1_{r}"] <= PAR_INT8_REL_L1
                < checks[f"int8_tp_control_rel_l1_{r}"]):
            raise AssertionError(f"int8 TP or its control outside the limit: {checks}")

    # training: losses and the first step's synced gradient against one process
    for name, ref, got in (("data=2 ZeRO-2", refs["train"], [x[5] for x in res]),
                           ("seq=2 ring", refs["ring_train"], [x[6] for x in res])):
        rel = max(abs(g["metrics"][i]["total_loss"] - m["total_loss"]) / abs(m["total_loss"])
                  for g in got for i, m in enumerate(ref["metrics"]))
        a, b = torch.from_numpy(got[0]["grad"]), torch.from_numpy(ref["grad"])
        cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=0).item()
        same = all(x == y for x, y in zip(got[0]["checksums"], got[1]["checksums"]))
        log(f"13b training, {name}: losses " + ", ".join(
            f"{g['metrics'][-1]['total_loss']:.6f}" for g in got)
            + f" against {ref['metrics'][-1]['total_loss']:.6f} (worst relative {rel:.2e}, "
            f"limit {TRAIN_LOSS_REL}), gradient cosine {cos:.6f} (min {TRAIN_GRAD_COSINE}), "
            f"parameters bit-equal on both ranks after each step: {same}; optimizer state "
            f"elements a rank {got[0]['opt_numel']:,} / {got[1]['opt_numel']:,} against "
            f"{ref['opt_numel']:,} in one process")
        if not (rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COSINE and same):
            raise AssertionError(f"13b training {name} disagrees with one process")
        checks[f"train_{name}"] = (rel, cos, got[0]["opt_numel"] / ref["opt_numel"])
    dp = [x[5] for x in res]
    if not dp[0]["opt_numel"] == dp[1]["opt_numel"] < 0.75 * refs["train"]["opt_numel"]:
        raise AssertionError("ZeRO-2: the ranks do not split AdamW's moments")

    # launches of every rank, held to the code's counts (per rank)
    L, nb = PAR_DEPTH, 2
    with_bwd = nb + L - 1
    want = {
        0: {"flash_fwd": 2 * (nb + L)},                 # 2 steps, CFG batched
        1: {"flash_fwd": 2 * (nb + L)},
        2: {"flash_fwd": 3 * L},                        # text block + 2 shards a layer
        3: {"flash_int8_fwd": L}, 4: {"flash_int8_fwd": L},
        5: {"flash_fwd": 2 * (nb + L + with_bwd), "flash_dq": 2 * with_bwd,
            "flash_dkv": 2 * with_bwd},
        6: {"flash_fwd": 3 * (nb + L + with_bwd), "flash_dq": 3 * with_bwd,
            "flash_dkv": 3 * with_bwd}}
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    for rank in res:
        for i, case in enumerate(rank):
            expected = {**dict.fromkeys(kernels.LAUNCHES, 0), **want[i]}
            if attention_launches(case["launches"]) != attention_launches(expected):
                raise AssertionError(f"13b case {cases[i][0]} {i}: launches "
                                     f"{case['launches']}, expected {expected}")
            if i not in (1, 4):   # the controls are checks, not the path
                for k2, v2 in case["launches"].items():
                    total[k2] += v2
    log(f"13b launches over both ranks (controls excluded): {total}; comm of rank 0 by "
        f"case: " + "; ".join(f"{i}: " + ", ".join(f"{k} {v['calls']} calls "
                                                   f"{v['bytes'] / 2**20:.1f} MiB"
                                                   for k, v in c["comm"].items() if v["calls"])
                             for i, c in enumerate(res[0])))
    return total, checks


def phase_nccl_world1(torch, kernels):
    """Phase 13c: the multi-card training loop at world size 1 on NCCL:
    `train(mesh=make_mesh(1, 1, 1))` for one branch-SFT step at full width
    (backbone cut to 2 layers), bit-equal to the same step without a mesh.
    Returns its launches."""
    import torch.distributed as dist

    from videopainter_tpu_torch.config import SchedulerConfig
    from videopainter_tpu_torch.parallel import workers

    spec = {"device": "cuda", "models": par_models(31, depth=2, branch_dtype="float32"),
            "scheduler": ("ddim", SchedulerConfig(prediction_type="v_prediction").to_dict()),
            "bcfg": {"mask_add": True, "use_flash": True, "remat": True},
            "batch": dict(CLIP, seed=134, b=1), "batch_dtype": "bfloat16"}
    out_dir = tempfile.mkdtemp(prefix="nccl_world1_", dir="build")
    try:
        trainer = lambda d: dict(output_dir=d, max_train_steps=1, learning_rate=1e-5,
                                 checkpointing_steps=100, validating_steps=100, log_every=1,
                                 resume_from_checkpoint=None, seed=3)
        plain = workers.trainer_rank(dict(spec, trainer=trainer(os.path.join(out_dir, "a"))))
        try:   # make_mesh(1, 1, 1) starts a one-rank NCCL group on the card
            meshed = workers.trainer_rank(dict(spec, trainer=trainer(os.path.join(out_dir, "b")),
                                               mesh=(1, 1, 1)))
            backend = dist.get_backend()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    equal = plain["checksum"] == meshed["checksum"] and all(
        np_equal(plain["params"][k], meshed["params"][k]) for k in plain["params"])
    log(f"13c train(mesh=make_mesh(1, 1, 1)) on {backend}, full width with the backbone cut "
        f"to 2 of 42 layers: one step, parameters bit-equal to "
        f"the meshless step: {equal}; all-reduce calls {meshed['comm']['all_reduce']['calls']}; "
        f"launches {meshed['launches']}")
    if backend != "nccl" or not equal or meshed["comm"]["all_reduce"]["calls"] < 1:
        raise AssertionError("13c: the world-1 NCCL step differs from the meshless one")
    return meshed["launches"]


# ---------------------------------------------------------------------------------------------
# phase 14: the quality-gate tools at full width, steps cut

GATE_STEPS = 3           # the int8 gate's trajectories (50 in --deep)
GATE_SKIP_STEPS = 6      # the skip gate's loop (50 in use)
GATE_SKIP_SCHEDULE = "2:6:2"   # skips steps 3 and 5 of 6
GATE_ANYL = dict(frames=73, stride=24, steps=3, skip="1")   # 2 windows; at 2 steps a
                         # window has nothing to skip (step 0 and the capture step always run)
GATE_MIN_PSNR_DB = 35.0  # the int8 latent PSNR bar (the JAX package's bench.py:119)


def phase_gates(torch, kernels):
    """Phase 14: the functions of the three gate tools
    (`videopainter_tpu_torch.tools`) at full width on one seeded bf16 model
    with the learnable ID resample: the int8 gate's bf16 trajectory and the
    skip gate's bf16 reference, then the W8A8 quantization in place, the
    int8 gate's calibrated, static and capture legs, the skip gate's
    serving-full and skip runs with the calibrated scales and its pixel and
    perceptual legs, and the any-length tool's skip-against-full comparison
    on the same quantized models. Every record must be strict JSON with
    finite numbers; the B1 / B4 launches must equal what the steps predict;
    the int8 latent PSNR at least GATE_MIN_PSNR_DB; the consumption control
    above 0. Returns the launch counts."""
    from videopainter_tpu_torch.config import SchedulerConfig
    from videopainter_tpu_torch.flagship import build_pipeline
    from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintAnyLPipeline
    from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler
    from videopainter_tpu_torch.tools import gate_int8_flagship as g8
    from videopainter_tpu_torch.tools import gate_skip_flagship as gs
    from videopainter_tpu_torch.tools import gates
    from videopainter_tpu_torch.tools import smoke_chip_anyl as ga

    t0 = time.perf_counter()
    tcfg = g8.model_config(42, smoke=False, learnable=True)
    pipe = build_pipeline(torch.Generator(device="cuda").manual_seed(gates.WEIGHTS_SEED),
                          tcfg=tcfg)
    pipe.vae.enable_tiling()
    sched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())
    perceptual = gates.Perceptual(torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"gates: {tcfg.num_layers}-layer model (learnable ID resample) and the perceptual "
        f"extractors built in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    walls = {}
    inp = g8.gate_inputs(torch.Generator(device="cuda").manual_seed(2), tcfg,
                         g8.FLAGSHIP_LATENT, rect_mask=True)
    s0 = time.perf_counter()
    ref8 = g8.bf16_reference(pipe.transformer, pipe.branch, inp, GATE_STEPS)
    configs = [(0, "rect")]
    refs = gs.references(pipe.transformer, pipe.branch, sched, steps=GATE_SKIP_STEPS,
                         configs=configs, latent_dims=g8.FLAGSHIP_LATENT)
    walls["bf16 legs"] = time.perf_counter() - s0
    s0 = time.perf_counter()
    r8 = g8.run_gate(pipe.transformer, pipe.branch, pipe.vae, inp, steps=GATE_STEPS,
                     ascale=True, capture=True, ref=ref8)
    walls["int8 gate"] = time.perf_counter() - s0
    scales = r8.pop("_scales")
    s0 = time.perf_counter()
    rs = gs.run_gate(pipe.transformer, pipe.branch, pipe.vae, sched, steps=GATE_SKIP_STEPS,
                     schedules=[GATE_SKIP_SCHEDULE], configs=configs,
                     latent_dims=g8.FLAGSHIP_LATENT, scales=scales, scales_tag="phase14",
                     perceptual=perceptual, refs=refs)
    gs.validate(rs)
    walls["skip gate"] = time.perf_counter() - s0
    s0 = time.perf_counter()
    anyl = CogVideoXI2VDualInpaintAnyLPipeline(pipe.transformer, pipe.branch, pipe.vae, sched,
                                               device="cuda")
    clip = ga.make_clip(GATE_ANYL["frames"], 480, 720, tcfg, device=torch.device("cuda"))
    ra = ga.compare_full(anyl, clip, steps=GATE_ANYL["steps"], stride=GATE_ANYL["stride"],
                         skip_spec=GATE_ANYL["skip"], mode="int8+int8attn+ascale+resample",
                         num_frames=49, resample=True, use_flash="int8", capture_int8=True,
                         stream_decode=False)
    walls["any-length tool"] = time.perf_counter() - s0
    torch.cuda.synchronize()
    launches = gates.launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    records = {"int8 gate": r8, "skip gate": rs, "any-length": ra}
    for name, rec in records.items():
        gates.finish(rec, torch.device("cuda"), argv=["chip_smoke.py phase 14"])
        gates.check_finite(rec)
        json.loads(json.dumps(rec, allow_nan=False))   # strict JSON both ways
    for line in (json.dumps(r8["latent"]), json.dumps(r8["static_ascale"]),
                 json.dumps(r8["capture_int8"]), json.dumps(rs["schedules"]),
                 json.dumps(rs.get("perceptual_anchor")),
                 json.dumps({k: ra[k] for k in ("pixel_psnr_skip_vs_full_db", "wall_s")})):
        log(f"gates: {line}")
    n = tcfg.num_layers + 2                 # B1 / B4 launches of one forward
    skipped = len(gs.parse_skip_steps(GATE_SKIP_SCHEDULE, GATE_SKIP_STEPS))
    a_skip = len(gs.parse_skip_steps(GATE_ANYL["skip"], GATE_ANYL["steps"]))
    want = {"flash_fwd": 2 * n * (GATE_STEPS + GATE_SKIP_STEPS),
            "flash_int8_fwd": n * (2 * GATE_STEPS * 2 + 5              # dynamic, static, capture
                                   + 2 * GATE_SKIP_STEPS + 2 * (GATE_SKIP_STEPS - skipped)
                                   + 2 * 2 * GATE_ANYL["steps"]       # 2 windows, full
                                   + 2 * 2 * (GATE_ANYL["steps"] - a_skip))}
    log(f"gates: launches {launches} (predicted B1 {want['flash_fwd']}, B4 "
        f"{want['flash_int8_fwd']}); by leg: int8 gate {r8['launches_by_leg']}, skip gate "
        f"{rs['launches_by_leg']}; wall " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; peak memory {peak:.2f} GiB")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"gate launches {launches}, predicted {want}")
    psnr = r8["latent"]["psnr_db"]
    if psnr is not None and psnr < GATE_MIN_PSNR_DB:
        raise AssertionError(f"int8 latent PSNR {psnr:.2f} dB < {GATE_MIN_PSNR_DB}")
    if not r8["capture_int8"]["consumption_control_maxdiff"] > 0:
        raise AssertionError("the propagation leg consumed nothing of the captured state")
    if not ra["finite"] or ra["windows"] != 2:
        raise AssertionError(f"any-length tool: finite {ra['finite']}, windows {ra['windows']}")
    return launches


TOOLS_SWEEP_BLOCKS = [(512, 2048), (1024, 2048)]   # the int8 block sweep's two candidates
TOOLS_SWEEP_ITERS = 2
# B4's rel L1 against B1 in the sweep, a [low, high) window per mode (phase 1 holds
# B4 to its plain version). The H100 reads int8 0.0042-0.0043 and int8pv 0.0125:
# the windows do not overlap, so a sweep that mixed its modes up fails.
TOOLS_SWEEP_REL_L1 = {"int8": (0.0, 0.008), "int8pv": (0.008, 0.03)}


def phase_tools(torch, kernels):
    """Phase 15: the measurement tools (`videopainter_tpu_torch.tools`) at full
    width. (a) `bench.gated_serving_rungs` on the committed `_cuda` gate
    artifacts must pick int8_ascale_skip_42L with 4:48:5, and a copy whose
    robustness schedule is renamed must drop the skip rung and record
    `skip_gate_error` (a control that must fail the rule). (b) `bench.measure_rung`
    at 42 layers: the gated headline (W8A8, int8 attention, calib_ascales_cuda.npz,
    4:48:5, the VAE decode), then bf16_batched_42L without the VAE; each
    rung's launches held exactly (4 steps of 44 attention calls), every
    number finite, layers_measured 42. (c) is phase 5 (the training tool's
    `measure` at 42 layers). (d) `sweep_int8_blocks.sweep` on two block
    pairs, both modes, at [1, 48, 17,776, 64]. (e) `bench_vae_decode.sweep`
    on the default combo and 320x480 fbs2. Returns (launches of the whole
    phase, the results)."""
    import numpy as np
    from videopainter_tpu_torch.flagship import build_models
    from videopainter_tpu_torch.tools import bench, bench_vae_decode, gates
    from videopainter_tpu_torch.tools import sweep_int8_blocks as sweep

    dev = torch.device("cuda")
    repo = Path(__file__).resolve().parent
    walls, out = {}, {}
    kernels.reset_launches()
    total = dict.fromkeys(kernels.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    # (a) the gated headline and its control
    s0 = time.perf_counter()
    rungs, info = bench.gated_serving_rungs(repo)
    head = rungs[0] if rungs else (None, [])
    spec = head[1][head[1].index("--skip-spec") + 1] if "--skip-spec" in head[1] else None
    log(f"tools: gated rungs {[r[0] for r in rungs]}, headline {head[0]} {spec}; skip gate "
        f"{json.dumps(info.get('skip_gate'))}")
    if (head[0], spec) != ("int8_ascale_skip_42L", "4:48:5") or "skip_gate_error" in info:
        raise AssertionError(f"gated headline {head[0]} {spec}, expected int8_ascale_skip_42L "
                             f"4:48:5: {info}")
    control = Path(tempfile.mkdtemp(prefix="gate_control_", dir="build"))
    try:
        for f in (bench.GATE_INT8, bench.SCALES, bench.GATE_SKIP):
            shutil.copy(repo / f, control / f)
        sk = json.loads((control / bench.GATE_SKIP).read_text())
        sk["robustness"]["schedule"] += "-renamed"
        (control / bench.GATE_SKIP).write_text(json.dumps(sk))
        c_rungs, c_info = bench.gated_serving_rungs(control)
    finally:
        shutil.rmtree(control, ignore_errors=True)
    log(f"tools: renamed-schedule control: rungs {[r[0] for r in c_rungs]}, skip_gate_error "
        f"{c_info.get('skip_gate_error')!r}")
    if any(r[0] == "int8_ascale_skip_42L" for r in c_rungs) or "skip_gate_error" not in c_info:
        raise AssertionError("a renamed robustness schedule must drop the skip rung")
    walls["a gate rule"] = time.perf_counter() - s0

    # (b) the two 42-layer rungs, each from its own seeded build
    n_calls = 4 * (42 + 2)   # 1 warm-up + 3 timed steps, one B = 2 call a block
    for name, argv, key in (
            ("int8_ascale_skip_42L", head[1], "flash_int8_fwd"),
            ("bf16_batched_42L", ["--layers", "42", "--skip-vae"], "flash_fwd")):
        s0 = time.perf_counter()
        args = bench.parse_args(argv)
        tcfg = bench.model_config(args)
        t, b = build_models(torch.Generator(device=dev).manual_seed(gates.WEIGHTS_SEED),
                            device=dev, tcfg=tcfg)
        models = bench.apply_options({"transformer": t, "branch": b}, args)
        del t, b
        inp = bench.gate_inputs(torch.Generator(device=dev).manual_seed(2), tcfg,
                                bench.FLAGSHIP_LATENT, rect_mask=False)
        kernels.reset_launches()
        res = bench.measure_rung(models, inp, args, build_vae=lambda: bench.build_vae(dev),
                                 argv=["chip_smoke.py phase 15", name])
        launches = dict(kernels.LAUNCHES)
        del models, inp
        free_cuda(torch)
        add(launches)
        d = res["detail"]
        walls[f"b {name}"] = time.perf_counter() - s0
        log(f"tools: {name}: {res['value']:.4f} clips/min, step {d['step_ms_measured']:.1f} ms "
            f"({d['cfg_mode']} CFG), first step {d['first_step_s']:.2f} s, skipped "
            f"{d['skipped_steps']}, cached step {d['cached_step_ms']} ms, VAE decode "
            f"{d['vae_decode_s']:.3f} s, clip {d['clip_s']:.2f} s, peak "
            f"{d['peak_memory_gib']:.2f} GiB; launches {launches} (predicted {key} {n_calls})")
        check_record(res)
        want = {**dict.fromkeys(kernels.LAUNCHES, 0), key: n_calls}
        if attention_launches(launches) != attention_launches(want) or \
                attention_launches(d["launches"]) != attention_launches(want):
            raise AssertionError(f"{name}: launches {launches}, predicted {want}")
        if d["layers_measured"] != 42:
            raise AssertionError(f"{name}: layers_measured {d['layers_measured']}")
        if name.startswith("int8") and not (d["skipped_steps"] == 35 and d["vae_decode_s"] > 0):
            raise AssertionError(f"{name}: skipped {d['skipped_steps']}, decode "
                                 f"{d['vae_decode_s']}")
        out[name] = res

    # (d) the int8 block sweep
    s0 = time.perf_counter()
    q, k, v = sweep.operands(48, 17776, dev)
    kernels.reset_launches()
    sw = sweep.sweep(q, k, v, TOOLS_SWEEP_BLOCKS, [False, True], TOOLS_SWEEP_ITERS)
    launches = dict(kernels.LAUNCHES)
    add(launches)
    del q, k, v
    per_call = TOOLS_SWEEP_ITERS + 2   # a warm call, the timed ones, the output compared
    want = {**dict.fromkeys(kernels.LAUNCHES, 0), "flash_fwd": per_call,
            "flash_int8_fwd": per_call * len(TOOLS_SWEEP_BLOCKS) * 2}
    log(f"tools: block sweep B1 {sw['bf16']['ms']:.3f} ms; " + "; ".join(
        f"{r['mode']} {r['blk_q']}x{r['blk_k']} {r.get('ms', float('nan')):.3f} ms rel L1 "
        f"{r.get('rel_l1', float('nan')):.4f}" for r in sw["rows"]) + f"; launches {launches}")
    check_record(sw)
    if launches != want:
        raise AssertionError(f"block sweep launches {launches}, predicted {want}")
    if any("ms" not in r or not (TOOLS_SWEEP_REL_L1[r["mode"]][0] <= r["rel_l1"]
                                 < TOOLS_SWEEP_REL_L1[r["mode"]][1]) for r in sw["rows"]):
        raise AssertionError(f"block sweep rows {sw['rows']}")
    walls["d block sweep"] = time.perf_counter() - s0
    out["sweep_int8_blocks"] = sw

    # (e) the decode sweep
    s0 = time.perf_counter()
    vae = bench.build_vae(dev)
    z = torch.randn(bench.VAE_LATENT, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).to(torch.bfloat16)
    vs = bench_vae_decode.sweep(vae, z, [bench_vae_decode.COMBOS[0], bench_vae_decode.COMBOS[2]])
    del vae, z
    log("tools: decode sweep " + "; ".join(
        f"{r['config']} {r.get('decode_s', float('nan')):.3f} s, PSNR {r.get('psnr_vs_default')}"
        for r in vs["rows"]))
    check_record(vs)
    rows = vs["rows"]
    if not (len(rows) == 2 and all("decode_s" in r for r in rows)
            and rows[1]["psnr_vs_default"] is not None
            and np.isfinite(rows[1]["psnr_vs_default"])):
        raise AssertionError(f"decode sweep rows {rows}")
    walls["e decode sweep"] = time.perf_counter() - s0
    out["bench_vae_decode"] = vs
    log("tools: phase 15 wall " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    return total, out


def np_equal(a, b):
    import numpy as np
    return a.shape == b.shape and bool(np.array_equal(a, b))


def sass_stats(kernels, sources):
    """{source: {"HGMMA", "IGMMA" (bf16 / int8 wgmma instructions), "I2F", "F2I"
    (conversions), "I2F_loop", "F2I_loop" (those between a function's first
    and last tensor-core instruction: its key loop), "max_reg" (the highest
    register named)}} of each library's SASS."""
    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    out = {}
    for src in sources:
        sass = subprocess.run([cuobjdump, "-sass", str(kernels._lib_path(src))],
                              capture_output=True, text=True, timeout=120).stdout
        st = dict.fromkeys(("HGMMA", "IGMMA", "I2F", "F2I", "I2F_loop", "F2I_loop"), 0)
        for func in sass.split("Function :")[1:]:
            ops = []   # mnemonics; I2FP / F2IP and their variants count as I2F / F2I
            for o in (line.split() for line in func.splitlines()):
                if len(o) > 2 and o[0].startswith("/*") and o[0].endswith("*/"):
                    op = (o[2] if o[1].startswith("@") else o[1]).split(".")[0]
                    ops.append(op[:3] if op[:3] in ("I2F", "F2I") else op)
            mma = [i for i, op in enumerate(ops) if op in ("HGMMA", "IGMMA", "HMMA", "IMMA")]
            for i, op in enumerate(ops):
                if op in st:
                    st[op] += 1
                    if op in ("I2F", "F2I") and mma and mma[0] < i < mma[-1]:
                        st[op + "_loop"] += 1
        st["max_reg"] = max((int(r) for r in re.findall(r"\bR(\d+)\b", sass)), default=-1)
        out[src] = st
    return out


PREP_KEYS = ("qk_norm_rope", "qk_norm_rope_bwd")
VAE_NORM_KEYS = ("group_norm_stats", "group_norm_apply")
ADALN_KEYS = ("adaln_fwd", "adaln_bwd")


def attention_launches(launches):
    """`launches` without attention's prep counters, the VAE's GroupNorm
    ones and AdaLN's. The phases that hold every kernel's count exactly
    compare these; the prep's own counts are held in phase 2 (one a
    joint_attention call) and phase 5 (forward and recompute, one backward a
    call that trains), since a variant's extra key pages (ID resampling, the
    previous window) add prep calls; the GroupNorm's in phase 1g (two a call)
    and phase 5 (two a norm of every encoder forward); AdaLN's in phase 1h
    (one a call), phase 2 (two a block and the DiT's norm_out, a step) and
    phase 5 (as the prep's, with norm_out's forward and backward a step)."""
    return {k: v for k, v in launches.items()
            if k not in PREP_KEYS + VAE_NORM_KEYS + ADALN_KEYS}


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
        from videopainter_tpu_torch import native
        from videopainter_tpu_torch.ops import qk_prep
        from videopainter_tpu_torch.ops import group_norm as gn
        from videopainter_tpu_torch.ops import adaln
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing beside this script: {e}",
              file=sys.stderr)
        return 2
    vp.set_numerics(conv_tf32=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t_all = t = time.perf_counter()
    sources = (*fa.SOURCES, *fa8.SOURCES, *native.SOURCES, *qk_prep.SOURCES, *gn.SOURCES,
               *adaln.SOURCES)
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, side by side
        for fut in [pool.submit(kernels.load, *src) for src in sources]:
            fut.result()
    log(f"built {len(sources)} kernel sources in {time.perf_counter() - t:.1f} s")
    for src, text in kernels.BUILD_LOGS.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "setmaxnreg",
                                       "serialized")):
                log(f"  {src}: {line.strip()}")
    int8_sources = (fa8._SOURCE, fa8._UNIFORM_SOURCE)
    sass = sass_stats(kernels, (fa._SOURCE, fa._DKV_SOURCE, fa._DQ_SOURCE, *int8_sources))
    log("SASS: " + ", ".join(
        f"{k} {s['HGMMA']} HGMMA, {s['IGMMA']} IGMMA, highest register R{s['max_reg']}"
        + (f", I2F {s['I2F']} ({s['I2F_loop']} in the key loop), F2I {s['F2I']} "
           f"({s['F2I_loop']} in the key loop)" if k in int8_sources else "")
        for k, s in sass.items()))
    wgmma_ok = (all(s["HGMMA"] for s in sass.values())
                and all(sass[k]["IGMMA"] for k in int8_sources))
    if not wgmma_ok:
        raise AssertionError(f"a wgmma kernel lacks its HGMMA / IGMMA instructions: {sass}")

    def free():   # a finished phase's models and buffers go back to the allocator
        gc.collect()
        torch.cuda.empty_cache()

    walls = {}

    def timed_phase(name, fn, *a):
        s0 = time.perf_counter()
        r = fn(*a)
        walls[name] = time.perf_counter() - s0
        return r

    walls["0 build"] = time.perf_counter() - t
    stats = timed_phase("1 bf16 forward", phase_kernels, torch, fa)
    b2, b3 = timed_phase("1 backward", phase_bwd_kernels, torch, fa)
    b4 = timed_phase("1 int8", phase_int8_kernels, torch, fa, fa8)
    b5 = timed_phase("1 uniform int8", phase_uniform_kernels, torch, fa8)
    prep = timed_phase("1 attention's prep", phase_qk_prep, torch, kernels)
    gnorm = timed_phase("1 VAE GroupNorm + SiLU", phase_group_norm, torch, kernels)
    ada = timed_phase("1 AdaLN", phase_adaln, torch, kernels)
    free()
    launches, pipe = timed_phase("2 single clip from a prompt", phase_pipeline, torch, kernels)
    free()
    variant_launches = timed_phase("9 variants at full width", phase_variants, torch,
                                   kernels, pipe)
    free()
    os.makedirs("build", exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="cli_ckpt_", dir="build")
    try:   # phase 8 writes the checkpoint that phase 11 evaluates
        cli_launches = timed_phase("8 inference CLI from disk", phase_cli, torch, kernels,
                                   pipe, ckpt_root)
        del pipe
        free()
        eval_launches = timed_phase("11 evaluation at full width", phase_eval, torch,
                                    kernels, ckpt_root)
        free()
        cc, demo = timed_phase("12 the demo at full width (new)", phase_demo_from_checkpoint,
                               torch, kernels, ckpt_root)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    free()
    anyl_launches = timed_phase("3 any-length int8, streamed decode", phase_anyl_int8,
                                torch, kernels)
    free()
    train_launches = timed_phase("5 training", phase_train, torch, kernels)
    free()
    timed_phase("6 LoRA step", phase_train_lora, torch, kernels)
    free()
    kernels.reset_launches()
    timed_phase("4 small single clip", phase_small, torch)
    timed_phase("4 small any-length", phase_small_anyl, torch)
    timed_phase("7 small training step", phase_small_train, torch)
    log(f"launches of phases 4 and 7: {kernels.LAUNCHES}")
    timed_phase("10 small variants, CLI int8, fused to_qkv", phase_small_variants,
                torch, kernels)
    timed_phase("11 small eval CLI and sweep", phase_eval_cli_small, torch, kernels)
    free()
    ring13 = timed_phase("13a ring decomposition", phase_ring_decomposition, torch, fa, kernels)
    free()
    par_launches, _ = timed_phase("13b world 2 over gloo", phase_parallel_ranks, torch,
                                  kernels)
    free()
    nccl_launches = timed_phase("13c NCCL at world size 1", phase_nccl_world1, torch, kernels)
    for k, v in nccl_launches.items():
        par_launches[k] += v
    free()

    gate_launches = timed_phase("14 gate tools at full width", phase_gates, torch, kernels)
    free()
    tools_launches, _ = timed_phase("15 measurement tools at full width", phase_tools, torch,
                                    kernels)
    free()

    # the uniform-scale precursor is driven by its tool, the port's
    # `tools/bench_int8_attn`: its main path, at a depth cut to 2 iterations
    from videopainter_tpu_torch.tools import bench_int8_attn
    kernels.reset_launches()
    bench_int8_attn.main(["--iters", "2"])
    tool_launches = dict(kernels.LAUNCHES)
    if tool_launches["flash_int8_uniform_fwd"] < 1:
        raise AssertionError(f"the int8 tool launched no uniform kernel: {tool_launches}")
    log(f"launches of the int8 tool: {tool_launches}")

    log("phase wall times: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_all:.1f} s, "
        "the kernels' build included")
    csrc = "videopainter_tpu_torch/csrc/"
    rows = [{"name": "flash_fwd", "route": "cuda",
             "source": "videopainter_tpu_torch/csrc/flash_fwd_wgmma.cu",
             "replaces": "videopainter_tpu/ops/flash_attention.py:68",
             "launches": launches["flash_fwd"],
             "launches_training": train_launches["flash_fwd"],
             "launches_cli": cli_launches["flash_fwd"],
             "launches_variants": variant_launches["flash_fwd"],
             "launches_eval": eval_launches["flash_fwd"],
             "launches_app": demo["app"]["flash_fwd"],
             "launches_parallel": par_launches["flash_fwd"],
             "launches_gates": gate_launches["flash_fwd"],
             "launches_tools": tools_launches["flash_fwd"],
             "launches_ring_decomposition": sum(
                 v if isinstance(v, int) else v["flash_fwd"]
                 for v in ring13["launches"].values()), **stats},
            {"name": "flash_dq", "route": "cuda", "source": csrc + fa._DQ_SOURCE,
             "replaces": "videopainter_tpu/ops/flash_attention.py:164",
             "launches": train_launches["flash_dq"],
             "launches_parallel": par_launches["flash_dq"],
             "launches_ring_decomposition": sum(v["flash_dq"] for k, v in
                                                ring13["launches"].items() if "bwd" in k),
             **b2},
            {"name": "flash_dkv", "route": "cuda",
             "source": "videopainter_tpu_torch/csrc/flash_dkv_wgmma.cu",
             "replaces": "videopainter_tpu/ops/flash_attention.py:194",
             "launches": train_launches["flash_dkv"],
             "launches_parallel": par_launches["flash_dkv"],
             "launches_ring_decomposition": sum(v["flash_dkv"] for k, v in
                                                ring13["launches"].items() if "bwd" in k),
             **b3},
            {"name": "flash_int8_fwd", "route": "cuda", "source": csrc + fa8._SOURCE,
             "replaces": "videopainter_tpu/ops/flash_attention_int8.py:44",
             "launches": anyl_launches["flash_int8_fwd"],
             "launches_parallel": par_launches["flash_int8_fwd"],
             "launches_gates": gate_launches["flash_int8_fwd"],
             "launches_tools": tools_launches["flash_int8_fwd"], **b4},
            {"name": "flash_int8_uniform_fwd", "route": "cuda",
             "source": csrc + fa8._UNIFORM_SOURCE,
             "replaces": "tools/bench_int8_attn.py:37",
             "launches": tool_launches["flash_int8_uniform_fwd"], **b5},
            {"name": "connected_components", "route": "cuda", "source": csrc + native._SOURCE,
             "replaces": "videopainter_tpu/native/__init__.py:63",
             "launches": demo["amg"]["connected_components"], **cc},
            {"name": "qk_norm_rope", "route": "cuda", "source": csrc + qk_prep._SOURCE,
             "replaces": "videopainter_tpu/ops/attention.py:173 (layer_norm and "
                         "_rope_video_slice, left to XLA's fusion)",
             "launches": launches["qk_norm_rope"],
             "launches_training": train_launches["qk_norm_rope"],
             "launches_bwd_training": train_launches["qk_norm_rope_bwd"], **prep},
            {"name": "group_norm_silu", "route": "cuda", "source": csrc + gn._SOURCE,
             "replaces": "videopainter_tpu/ops/basic.py:209 (group_norm and silu, left to "
                         "XLA's fusion)",
             "launches": launches["group_norm_stats"] + launches["group_norm_apply"],
             "launches_training": (train_launches["group_norm_stats"]
                                   + train_launches["group_norm_apply"]), **gnorm},
            {"name": "adaln", "route": "cuda", "source": csrc + adaln._SOURCE,
             "replaces": "videopainter_tpu/ops/norms.py:17 (layer_norm_zero and "
                         "ada_layer_norm, left to XLA's fusion)",
             "launches": launches["adaln_fwd"],
             "launches_training": train_launches["adaln_fwd"],
             "launches_bwd_training": train_launches["adaln_bwd"], **ada}]
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
