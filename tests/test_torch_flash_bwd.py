"""The port's flash-attention backward (videopainter_tpu_torch/ops/
flash_attention.py: the autograd Function, its plain backward) against
`jax.grad` of the JAX package's flash attention, whose backward is the two
Pallas kernels run in interpret mode on the CPU.

On the CPU the port's Function runs its plain PyTorch versions; the CUDA
kernels are held against those on the card (the `cuda`-marked test here, and
chip_smoke.py). Inputs are float32 from a numpy seed; both sides get the same
upstream gradient. Tolerance rtol 3e-4 / atol 3e-5, as
tests/test_flash_attention.py holds the Pallas backward against exact SDPA:
both are fp32 recomputations of P from the logsumexp over differently sized
blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videopainter_tpu.ops.flash_attention as jfa
from videopainter_tpu_torch.ops import flash_attention as tfa

RTOL, ATOL = 3e-4, 3e-5


def make_qkv(s_q, s_k, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for s in (s_q, s_k, s_k))
    g = rng.standard_normal((b, h, s_q, d)).astype(np.float32)
    return q, k, v, g


def jax_grads(q, k, v, g, **kw):
    """(dq, dk, dv) of sum(flash_attention(q, k, v) * g) through the Pallas
    backward kernels, as one jitted program fetched at once (an eager JAX op
    dispatched while an interpret-mode kernel still runs its host callbacks can
    block with the interpreter lock held)."""
    q, k, v, g = (jnp.asarray(a) for a in (q, k, v, g))

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, blk_q=128, blk_k=128, bwd_blk_k=128,
                                           **kw) * g)

    with jax.experimental.pallas.tpu.force_tpu_interpret_mode():
        out = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
        return [np.asarray(x) for x in out]


def torch_grads(q, k, v, g, **kw):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(q, k, v, **kw)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    return [x.numpy() for x in torch.autograd.grad(out, (q, k, v), torch.from_numpy(g))]


@pytest.mark.parametrize("s_q,s_k,kw", [
    (256, 256, {}),
    (300, 300, {}),
    (129, 520, {}),                                   # S_q != S_k, neither a tile multiple
    (256, 256, {"kv_len": 129}),                      # valid keys < S_k
    (128, 256, {"kv_len": 100, "kv_page_len": 128}),  # paged mask, two pages
])
def test_flash_gradients_match_pallas_backward(s_q, s_k, kw):
    q, k, v, g = make_qkv(s_q, s_k)
    want = jax_grads(q, k, v, g, **kw)
    got = torch_grads(q, k, v, g, **kw)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
    if "kv_len" in kw:   # masked keys get exactly zero gradient
        col = torch.arange(s_k)
        dead = ~tfa._kv_valid(col, kw["kv_len"], kw.get("kv_page_len"), s_k).numpy()
        assert dead.any()
        assert not got[1][:, :, dead].any() and not got[2][:, :, dead].any()


def test_flash_function_gradcheck_float64():
    """The Function's analytic backward against finite differences."""
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((1, 2, 5, 4)), dtype=torch.float64, requires_grad=True)
    k, v = (torch.tensor(rng.standard_normal((1, 2, 8, 4)), dtype=torch.float64,
                         requires_grad=True) for _ in range(2))
    for kw in ({}, {"kv_len": 6}, {"kv_len": 3, "kv_page_len": 4}):
        assert torch.autograd.gradcheck(lambda a, b, c: tfa.flash_attention(a, b, c, **kw),
                                        (q, k, v), eps=1e-6, atol=1e-6)


def test_flash_backward_strided_views_and_noncontiguous_dout():
    """Heads split from [B, S, H*D] by a view and an upstream gradient with a
    transposed last dim give the same gradients as contiguous tensors (up to
    the summation order of matmuls over differently strided operands: 1e-6)."""
    q, k, v, g = (torch.from_numpy(x) for x in make_qkv(70, 90))
    ref = torch_grads(q.numpy(), k.numpy(), v.numpy(), g.numpy())
    views = [x.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not views[0].is_contiguous() and g_t.stride(-1) != 1
    got = torch.autograd.grad(tfa.flash_attention(*views), views, g_t)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)


def test_flash_backward_reference_matches_exact_attention():
    """The plain backward against autograd through exact masked attention."""
    q, k, v, g = (torch.from_numpy(x) for x in make_qkv(50, 800, seed=4))
    kw = {"kv_len": 333, "kv_page_len": 400}
    q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
    col = torch.arange(800)
    s = (q @ k.transpose(-1, -2)) * 16 ** -0.5
    s = s.masked_fill(~tfa._kv_valid(col, 333, 400, 800), float("-inf"))
    want = torch.autograd.grad(torch.softmax(s, -1) @ v, (q, k, v), g)
    with torch.no_grad():
        out, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
        got = tfa.flash_attention_backward_reference(q, k, v, out, lse, g, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


def test_flash_routes_and_with_lse_is_forward_only():
    q, k, v, _ = (torch.from_numpy(x) for x in make_qkv(16, 16))
    assert tfa.flash_attention(q, k, v).grad_fn is None       # nothing requires grad
    q.requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None   # grad mode off
    out, lse = tfa.flash_attention_with_lse(q, k, v)
    assert not out.requires_grad and not lse.requires_grad


def test_flash_backward_cuda_wrappers_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in make_qkv(16, 16, d=64))
    lse = torch.zeros((2, 2, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfa.flash_bwd_cuda(q, k, v, q, lse, g, 0.125, 16, None)


@pytest.mark.cuda
def test_flash_backward_kernels_match_plain_on_card():
    """The dQ and dK/dV kernels (the wgmma kernels the Function launches)
    against the plain backward, bf16 inputs,
    at ragged, masked and TMA-edge shapes (B*H = 1, S_q in 1 / 17 / 64, S_k in
    1 / 65 / 129). Tolerance 2^-6 of each gradient's largest value: two bf16
    ulps there (both sides round P, dS and the result to bf16). With one key
    the exact dQ and dK are 0 (softmax does not depend on a lone score) and
    the plain version's are rounding noise: there the floor is 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cases = [(129, 1111, {}, 2), (300, 700, {"kv_len": 513}, 2),
             (257, 800, {"kv_len": 333, "kv_page_len": 400}, 2)]
    cases += [(s_q, s_k, {}, 1) for s_q in (1, 17, 64) for s_k in (1, 65, 129)]
    for s_q, s_k, kw, bh in cases:
        q, k, v, g = (torch.from_numpy(x).to("cuda", torch.bfloat16)
                      for x in make_qkv(s_q, s_k, b=bh, h=bh, d=64))
        q.requires_grad_(), k.requires_grad_(), v.requires_grad_()
        out = tfa.flash_attention(q, k, v, **kw)
        got = torch.autograd.grad(out, (q, k, v), g)
        with torch.no_grad():
            o, lse = tfa.flash_attention_with_lse(q, k, v, **kw)
            want = tfa.flash_attention_backward_reference(q, k, v, o, lse, g, **kw)
        floor = 1e-5 if s_k == 1 else 0.0
        for a, b in zip(got, want):
            tol = max(2.0 ** -6 * b.float().abs().max().item(), floor)
            torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
