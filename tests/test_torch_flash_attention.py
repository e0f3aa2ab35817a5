"""The port's flash attention (videopainter_tpu_torch/ops/flash_attention.py)
against the JAX package's Pallas kernel run in interpret mode on the CPU.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is checked against that plain version on the card (the
`cuda`-marked test here, and chip_smoke.py). Inputs are float32 from a
numpy seed. Tolerance 2e-5 (as tests/test_flash_attention.py against exact
SDPA): both sides are fp32 online softmaxes over differently sized blocks,
so they differ by summation order only.
"""

import jax
import numpy as np
import pytest
import torch

import videopainter_tpu.ops.flash_attention as jfa
import videopainter_tpu_torch
from videopainter_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
TOL = 2e-5


def make_qkv(s_q, s_k, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for s in (s_q, s_k, s_k))


def jax_interpret(fn, *args, **kw):
    """One jitted program, fetched at once: an eager JAX op dispatched while an
    interpret-mode kernel still runs its host callbacks can block with the
    interpreter lock held."""
    arrays = [jax.numpy.asarray(a) for a in args]
    with jax.experimental.pallas.tpu.force_tpu_interpret_mode():
        out = jax.jit(lambda: fn(*arrays, blk_q=128, blk_k=128, **kw))()
        return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("s_q,s_k,kw", [
    (129, 1111, {}),                                  # ragged: neither a tile multiple
    (300, 700, {"kv_len": 513}),                      # valid keys < S_k
    (257, 800, {"kv_len": 333, "kv_page_len": 400}),  # paged mask, two pages
])
def test_flash_matches_jax_interpret(s_q, s_k, kw):
    q, k, v = make_qkv(s_q, s_k)
    ref = jax_interpret(jfa.flash_attention, q, k, v, **kw)
    out = tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [{}, {"kv_len": 250}])
def test_flash_lse_matches_jax_interpret(kw):
    q, k, v = make_qkv(200, 300)
    ref_out, ref_lse = jax_interpret(jfa.flash_attention_with_lse, q, k, v, **kw)
    out, lse = tfa.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=TOL, atol=TOL)


def test_flash_accepts_strided_head_views():
    """Heads split from [B, S, H*D] by a view give the same result as a
    contiguous [B, H, S, D] copy."""
    q, k, v = (torch.from_numpy(x) for x in make_qkv(70, 90))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(tfa.flash_attention(*views), tfa.flash_attention(q, k, v),
                               rtol=0, atol=0)


def test_flash_argument_errors():
    q, k, v = (torch.from_numpy(x) for x in make_qkv(16, 16))
    with pytest.raises(ValueError, match="kv_page_len requires kv_len"):
        tfa.flash_attention(q, k, v, kv_page_len=8)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=17)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in make_qkv(16, 16, d=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_fwd_cuda(q, k, v, 0.125, 16, None, False)
    with pytest.raises(RuntimeError, match="CUDA"):
        videopainter_tpu_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        videopainter_tpu_torch.resolve_device("cuda")
    assert videopainter_tpu_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (bf16 inputs). Tolerance
    2^-6 of the largest output: two bf16 ulps there, for both sides rounding
    the output to bf16 and the kernel rounding P to bf16 before P.V."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for s_q, s_k, kw in [(129, 1111, {}), (300, 700, {"kv_len": 513}),
                         (257, 800, {"kv_len": 333, "kv_page_len": 400})]:
        q, k, v = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                   for x in make_qkv(s_q, s_k, d=64))
        out = tfa.flash_attention(q, k, v, **kw)
        ref = tfa.flash_attention_reference(q, k, v, **kw)
        ref = ref.float()
        tol = 2.0 ** -6 * ref.abs().max().item()
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=tol)
