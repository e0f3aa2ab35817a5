"""Attention's prep (`ops/qk_prep.py`): the per-head QK LayerNorm and RoPE as
one pass, its plain version, its autograd Function and its CUDA kernels.

CPU: the plain version equals the eager composition `joint_attention` ran
before (written out below as it was) bit for bit; it matches the JAX
package's `layer_norm` + `_rope_video_slice`; gradcheck in float64 through the
Function's plain route; `joint_attention` gives what it gave before in every
variant. The `cuda` tests hold the kernels to the plain version on the card.
JAX is imported inside the CPU tests only: the card has none.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.ops import attention as tattn
from videopainter_tpu_torch.ops import qk_prep
from videopainter_tpu_torch.ops.attention import Attention, joint_attention
from videopainter_tpu_torch.ops.qk_prep import qk_norm_rope, qk_norm_rope_reference

TEXT = 226   # the served prompt's tokens


# -- the eager composition as joint_attention ran it before the kernel --------------

def _old_layer_norm(x, w, b, eps):
    w = None if w is None else w.float()
    b = None if b is None else b.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def _old_rope(x, cos, sin):
    x32 = x.float()
    xr = x32.unflatten(-1, (-1, 2))
    x_rot = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).flatten(-2)
    return (x32 * cos + x_rot * sin).to(x.dtype)


def _old_rope_video_slice(x, rope, text_len):
    if rope is None:
        return x
    cos, sin = rope
    out = torch.empty_like(x)
    out[:, :text_len] = x[:, :text_len]
    out[:, text_len:] = _old_rope(x[:, text_len:], cos[:, None, :], sin[:, None, :])
    return out


def old_prep(q, k, *, heads, norm_q=None, norm_k=None, rope=None, text_len=0):
    def one(x, norm):
        y = x.view(x.shape[0], x.shape[1], heads, x.shape[2] // heads)
        if norm is not None:
            y = _old_layer_norm(y, norm[0], norm[1], norm[2])
        return _old_rope_video_slice(y, rope, text_len)
    return (None if q is None else one(q, norm_q)), one(k, norm_k)


# -- inputs ---------------------------------------------------------------------------

def rope_tables(rows, seed=0, dtype=torch.float32):
    """cos / sin [rows, 64] with each angle repeated in a pair, as the
    published tables are."""
    ang = np.random.default_rng(seed).uniform(-np.pi, np.pi, (rows, 32))
    ang = np.repeat(ang, 2, axis=1)
    return (torch.tensor(np.cos(ang), dtype=dtype), torch.tensor(np.sin(ang), dtype=dtype))


def norm_params(seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    w = torch.tensor(1 + 0.05 * rng.standard_normal(64), dtype=dtype, device=device)
    b = torch.tensor(0.05 * rng.standard_normal(64), dtype=dtype, device=device)
    return w, b


def qkv_chunks(b, s, heads, seed=0, dtype=torch.float32, device="cpu"):
    """q, k, v as `to_qkv(x).chunk(3)` gives them: views with a row stride of
    3 H 64. Values with an offset and a spread per row, as projections have."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, 3 * heads * 64)) * rng.uniform(0.5, 3, (b, s, 1)) + 0.3
    return torch.tensor(x, dtype=dtype, device=device).chunk(3, dim=-1)


CASES = {
    "q_and_k": dict(text_len=TEXT, rope=True, norm=True),
    "no_text": dict(text_len=0, rope=True, norm=True),
    "no_rope": dict(text_len=TEXT, rope=False, norm=True),
    "no_norm": dict(text_len=TEXT, rope=True, norm=False),
    "k_only_masked": dict(text_len=TEXT, rope=True, norm=True, k_only=True),
}


def case_args(case, dtype, s=TEXT + 24, heads=2, seed=0):
    c = CASES[case]
    q, k, _ = qkv_chunks(2, s, heads, seed, dtype)
    if c.get("k_only"):   # the resample path's masked keys: k times a token mask
        m = torch.tensor(np.random.default_rng(seed).random((2, s, 1)) > 0.5)
        q, k = None, k * m.to(k.dtype)
    kw = dict(heads=heads, text_len=c["text_len"])
    if c["rope"]:
        kw["rope"] = rope_tables(s - c["text_len"], seed)
    if c["norm"]:
        kw["norm_q"] = (*norm_params(seed + 1), 1e-6)
        kw["norm_k"] = (*norm_params(seed + 2), 1e-6)
    return q, k, kw


# -- CPU --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_old_eager_composition(case, dtype):
    q, k, kw = case_args(case, dtype)
    want_q, want_k = old_prep(q, k, **kw)
    for fn in (qk_norm_rope, qk_norm_rope_reference):
        got_q, got_k = fn(q, k, **kw)
        assert torch.equal(got_k, want_k)
        assert (got_q is None) == (q is None)
        if q is not None:
            assert torch.equal(got_q, want_q)
    # the Function's plain route gives the same values
    leaf_k = k.detach().requires_grad_(True)
    _, got_k = qk_norm_rope(q, leaf_k, **kw)
    assert type(got_k.grad_fn).__name__ == "QKNormRopeBackward"
    assert torch.equal(got_k.detach(), want_k)


def test_neither_norm_nor_rope_is_the_head_split_view():
    q, k, _ = qkv_chunks(1, 7, 2)
    got_q, got_k = qk_norm_rope(q, k, heads=2)
    assert got_q.shape == (1, 7, 2, 64) and got_q.data_ptr() == q.data_ptr()
    assert got_k._base is not None and got_k.data_ptr() == k.data_ptr()


def test_no_grad_path_keeps_no_graph():
    q, k, kw = case_args("q_and_k", torch.float32)
    with torch.no_grad():
        got_q, _ = qk_norm_rope(q.requires_grad_(), k, **kw)
    assert got_q.grad_fn is None


@pytest.mark.parametrize("text_len", [0, 3])
def test_plain_matches_jax(text_len):
    import jax.numpy as jnp

    from videopainter_tpu.ops.attention import _rope_video_slice as j_rope_slice
    from videopainter_tpu.ops.basic import layer_norm as j_layer_norm

    s, heads = text_len + 12, 2
    q, k, _ = qkv_chunks(2, s, heads, seed=4)
    rope = rope_tables(s - text_len, seed=4)
    norms = [(*norm_params(5), 1e-6), (*norm_params(6), 1e-6)]
    got = qk_norm_rope(q, k, heads=heads, norm_q=norms[0], norm_k=norms[1], rope=rope,
                       text_len=text_len)
    for x, (w, b, eps), y in zip((q, k), norms, got):
        xj = jnp.asarray(x.reshape(2, s, heads, 64).numpy()).transpose(0, 2, 1, 3)
        n = j_layer_norm({"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())},
                         xj, eps=eps)
        ref = j_rope_slice(n, tuple(jnp.asarray(t.numpy()) for t in rope), text_len)
        # same fp32 arithmetic in another order (test_torch_modules' 1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref).transpose(0, 2, 1, 3),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_q_norm", [True, False], ids=["both_normed", "k_rope_only"])
def test_function_gradcheck_float64(with_q_norm):
    rng = np.random.default_rng(7)
    s, text_len, heads = 5, 2, 2
    x = torch.tensor(rng.standard_normal((1, s, 3 * heads * 64)), dtype=torch.float64)
    q, k, _ = (t.detach().requires_grad_() for t in x.chunk(3, dim=-1))
    wq, bq = (t.double().requires_grad_() for t in norm_params(8))
    wk, bk = (t.double().requires_grad_() for t in norm_params(9))
    rope = rope_tables(s - text_len, seed=7, dtype=torch.float64)

    def fn(q, k, wq, bq, wk, bk):
        return qk_norm_rope(q, k, heads=heads, norm_q=(wq, bq, 1e-6) if with_q_norm else None,
                            norm_k=(wk, bk, 1e-6), rope=rope, text_len=text_len)

    inputs = (q, k, wq, bq, wk, bk)
    out = fn(*inputs)
    assert all(type(t.grad_fn).__name__ == "QKNormRopeBackward" for t in out)
    if with_q_norm:
        assert torch.autograd.gradcheck(fn, inputs)
    else:
        assert torch.autograd.gradcheck(lambda q, k, wk, bk: fn(q, k, wq, bq, wk, bk),
                                        (q, k, wk, bk))


@pytest.fixture(scope="module")
def layer():
    """One attention layer, 2 heads of 64, with non-trivial norms and biases."""
    torch.manual_seed(0)
    m = Attention(128, num_heads=2)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * (0.05 if p.ndim == 1 else 128 ** -0.5))
        for ln in (m.norm_q, m.norm_k):
            ln.weight.add_(1.0)
    rng = np.random.default_rng(1)
    x = {"h": torch.tensor(rng.standard_normal((2, 24, 128)), dtype=torch.float32),
         "e": torch.tensor(rng.standard_normal((2, 5, 128)), dtype=torch.float32),
         "mask": torch.tensor(rng.random((2, 29)) > 0.5),
         "prev": torch.tensor(rng.standard_normal((2, 29, 128)), dtype=torch.float32),
         "pmask": torch.tensor(rng.random((2, 29)) > 0.5),
         "rope": rope_tables(24, seed=1)}
    return m, x


VARIANTS = {
    "base": lambda x: {},
    "wo_text": lambda x: {},
    "resample": lambda x: dict(resample_mask=x["mask"]),
    "prev_blend": lambda x: dict(prev_hidden_states=x["prev"], prev_clip_weight=0.3),
    "prev_resample": lambda x: dict(prev_hidden_states=x["prev"], prev_clip_weight=0.4,
                                    prev_resample_mask=x["pmask"]),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_joint_attention_unchanged(layer, variant, monkeypatch):
    """joint_attention through the one prep call against the same call with
    the old eager composition in its place: equal outputs, and gradients to
    the input and the norms within fp32 reassociation."""
    m, x = layer
    wo_text = variant == "wo_text"

    def run():
        h = x["h"].clone().requires_grad_()
        out_h, out_e = joint_attention(m, h, None if wo_text else x["e"], rope=x["rope"],
                                       **VARIANTS[variant](x))
        loss = out_h.square().sum() + (0 if out_e is None else out_e.sum())
        grads = torch.autograd.grad(loss, [h, *m.norm_q.parameters(), *m.norm_k.parameters()])
        return out_h.detach(), None if out_e is None else out_e.detach(), grads

    new = run()
    monkeypatch.setattr(tattn, "qk_norm_rope", old_prep)
    old = run()
    assert torch.equal(new[0], old[0])
    assert (new[1] is None) == wo_text and (wo_text or torch.equal(new[1], old[1]))
    for g_new, g_old in zip(new[2], old[2]):
        torch.testing.assert_close(g_new, g_old, rtol=1e-5, atol=1e-6)


def test_cuda_checks_refuse_what_the_kernel_cannot_take():
    q, k, _ = qkv_chunks(1, 9, 2)
    with pytest.raises(ValueError, match="head dim"):
        qk_prep._check_cuda([q[..., :96]], 3, None, 0)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        qk_prep._check_cuda([q.half()], 2, None, 0)
    with pytest.raises(ValueError, match="multiples of 8"):
        qk_prep._check_cuda([torch.zeros(1, 9, 131)[..., 1:129]], 2, None, 0)
    with pytest.raises(ValueError, match="rope tables"):
        qk_prep._check_cuda([q, k], 2, rope_tables(9), 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        qk_norm_rope(q.to("meta"), k.to("meta"), heads=2, rope=(torch.zeros(9, 64, device="meta"),) * 2)


# -- on the card --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _ulp_bf16(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _ulp_gap(got, ref, x, norm, rope, text_len):
    """|got - ref| in bf16 ulps at the scale of the terms that make each value:
    |xhat w| + |b| for a normed value (the shift may cancel the scaled term),
    the pair's L2 of those on rotated rows (a rotation mixes the pair), and
    never below |ref|. Returns (largest gap on text rows, on video rows)."""
    b, s, h, d = ref.shape
    x32 = x.float().reshape(b, s, h, d)
    if norm is not None:
        xhat = F.layer_norm(x32, (d,))
        scale = (xhat * norm[0].float()).abs() + norm[1].float().abs()
    else:
        scale = x32.abs()
    if rope is not None:
        pair = scale.unflatten(-1, (-1, 2)).square().sum(-1, keepdim=True).sqrt()
        rot = pair.expand(*pair.shape[:-1], 2).flatten(-2)
        scale = torch.cat([scale[:, :text_len], rot[:, text_len:]], dim=1)
    gap = (got.float() - ref.float()).abs() / _ulp_bf16(torch.maximum(ref.float().abs(), scale))
    text, video = (gap[:, :text_len], gap[:, text_len:]) if rope is not None else (gap[:, :0], gap)
    return tuple(g.max().item() if g.numel() else 0.0 for g in (text, video))


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
def test_forward_kernel_matches_plain_on_card():
    """The forward kernel against the plain version on the card, bf16 at the
    served shape [2, 17,776, 48, 64] (text 226, one launch for q and k from a
    to_qkv chunk) and at ragged tiny shapes in both storage types; bf16 and
    fp32 weights; without norm or rope. The statistics' sum order is the one
    difference, so a normed value lies within one bf16 ulp at its scale
    (`_ulp_gap`): the text rows. A video row rotates pairs of such values, each
    of which may have rounded the other way, so its values lie within two
    ulps at the pair's scale (one for each member)."""
    dev = _card()
    shapes = [(2, TEXT + 17550, 48, TEXT, torch.bfloat16), (1, 37, 3, 5, torch.bfloat16),
              (3, 21, 5, 0, torch.float32), (2, 11, 7, 11, torch.bfloat16)]
    for bsz, s, heads, text_len, dtype in shapes:
        q, k, _ = qkv_chunks(bsz, s, heads, seed=s, dtype=dtype, device=dev)
        rope = tuple(t.to(dev) for t in rope_tables(s - text_len, seed=s))
        for pdtype in (torch.bfloat16, torch.float32):
            norms = [(*norm_params(1, pdtype, dev), 1e-6), (*norm_params(2, pdtype, dev), 1e-6)]
            for nq, nk, rp in ((norms[0], norms[1], rope), (None, None, rope),
                               (norms[0], norms[1], None), (None, norms[1], rope)):
                before = _kernels.LAUNCHES["qk_norm_rope"]
                got = qk_norm_rope(q, k, heads=heads, norm_q=nq, norm_k=nk, rope=rp,
                                   text_len=text_len)
                assert _kernels.LAUNCHES["qk_norm_rope"] == before + 1
                ref = qk_norm_rope_reference(q, k, heads=heads, norm_q=nq, norm_k=nk, rope=rp,
                                             text_len=text_len)
                torch.cuda.synchronize()
                for x, n, g, r in zip((q, k), (nq, nk), got, ref):
                    assert g.shape == r.shape and g.dtype == r.dtype and g.is_contiguous()
                    text, video = _ulp_gap(g, r, x, n, rp, text_len)
                    print(f"fwd {bsz}x{s}x{heads} text {text_len} {dtype} params {pdtype} "
                          f"norm {n is not None} rope {rp is not None}: largest gap "
                          f"{text:.3f} ulp (text rows), {video:.3f} ulp (video rows)")
                    assert text <= 1.0 and video <= (2.0 if rp is not None else 1.0)
            # k alone (a variant's extra page), with the stats kept
            ys, stats = qk_prep.qk_norm_rope_fwd_cuda([k], [norms[1]], heads=heads, rope=rope,
                                                      text_len=text_len, save_stats=True)
            assert torch.equal(ys[0], qk_norm_rope(None, k, heads=heads, norm_k=norms[1],
                                                   rope=rope, text_len=text_len)[1])
            mean, rstd = stats[0]
            x32 = k.float().reshape(bsz, s, heads, 64)
            torch.testing.assert_close(mean, x32.mean(-1), rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(rstd, torch.rsqrt(x32.var(-1, unbiased=False) + 1e-6),
                                       rtol=1e-4, atol=0)
        del q, k


@pytest.mark.cuda
def test_backward_kernel_matches_fp32_autograd_on_card():
    """The backward kernel against fp32 autograd through the plain version:
    relative L2 at most 1e-3 for dx (against the reference rounded to the
    storage type, as the kernel's dx is stored), dweight and dbias. Shapes:
    the training call [1, 17,776, 48, 64] and ragged tiny ones; the k-only
    call; weights that need no grad."""
    dev = _card()
    shapes = [(1, TEXT + 17550, 48, TEXT, torch.bfloat16), (2, 37, 3, 5, torch.bfloat16),
              (1, 29, 5, 0, torch.float32)]
    for bsz, s, heads, text_len, dtype in shapes:
        q0, k0, _ = qkv_chunks(bsz, s, heads, seed=s, dtype=dtype, device=dev)
        rope = tuple(t.to(dev) for t in rope_tables(s - text_len, seed=s))
        dy = [torch.randn((bsz, s, heads, 64), device=dev).to(dtype) for _ in range(2)]
        for train_params, with_q in ((True, True), (False, True), (True, False)):
            p32 = [norm_params(i, torch.float32, dev) for i in (1, 2)]
            params = [[t.clone().requires_grad_(train_params) for t in p] for p in p32]
            q = q0.detach().requires_grad_() if with_q else None
            k = k0.detach().requires_grad_()
            norms = [(*params[0], 1e-6), (*params[1], 1e-6)]
            before = dict(_kernels.LAUNCHES)
            got = qk_norm_rope(q, k, heads=heads, norm_q=norms[0], norm_k=norms[1], rope=rope,
                               text_len=text_len)
            xs = [t for t in (q, k) if t is not None]
            used = [p for i, p in enumerate(params) if with_q or i == 1]
            leaves = xs + ([t for p in used for t in p] if train_params else [])
            outs = [y for y in got if y is not None]
            grads = torch.autograd.grad(outs, leaves, dy[:len(outs)])
            assert _kernels.LAUNCHES["qk_norm_rope"] == before["qk_norm_rope"] + 1
            assert _kernels.LAUNCHES["qk_norm_rope_bwd"] == before["qk_norm_rope_bwd"] + 1
            # the reference: fp32 autograd through the plain version
            rx = [t.detach().float().requires_grad_() for t in xs]
            rp = [[t.detach().float().requires_grad_() for t in p] for p in used]
            rq = rx[0] if with_q else None
            rn = [(*rp[0], 1e-6), (*rp[-1], 1e-6)] if with_q else [None, (*rp[0], 1e-6)]
            ref = qk_norm_rope_reference(rq, rx[-1], heads=heads, norm_q=rn[0], norm_k=rn[1],
                                         rope=rope, text_len=text_len)
            rleaves = rx + ([t for p in rp for t in p] if train_params else [])
            rgrads = torch.autograd.grad([y for y in ref if y is not None], rleaves,
                                         [t.float() for t in dy[:len(outs)]])
            for i, (g, r) in enumerate(zip(grads, rgrads)):
                if i < len(xs):   # dx, stored in the input's dtype
                    assert g.dtype == dtype and g.shape == xs[i].shape
                    err = _rel_l2(g, r.to(dtype))
                else:
                    assert g.dtype == torch.float32
                    err = _rel_l2(g, r)
                print(f"bwd {bsz}x{s}x{heads} text {text_len} {dtype} with_q {with_q} "
                      f"train_params {train_params} grad {i}: rel L2 {err:.3e}")
                assert err <= 1e-3
        del q0, k0


@pytest.mark.cuda
def test_one_launch_per_joint_attention_call_on_card():
    """LAUNCHES["qk_norm_rope"] rises by one a joint_attention call's q/k
    prep, plus one for each extra page of keys (resample, previous window);
    with grad, the backward launches once a prep call."""
    dev = _card()
    torch.manual_seed(0)
    m = Attention(128, num_heads=2).to(dev, torch.bfloat16)
    h = torch.randn(2, 24, 128, device=dev, dtype=torch.bfloat16)
    e = torch.randn(2, 5, 128, device=dev, dtype=torch.bfloat16)
    rope = tuple(t.to(dev) for t in rope_tables(24))
    mask = torch.rand(2, 29, device=dev) > 0.5
    prev = torch.randn(2, 29, 128, device=dev, dtype=torch.bfloat16)
    cases = [({}, 1), (dict(resample_mask=mask), 2),
             (dict(prev_hidden_states=prev, prev_clip_weight=0.3), 2)]
    for kw, n in cases:
        with torch.no_grad():
            before = _kernels.LAUNCHES["qk_norm_rope"]
            joint_attention(m, h, e, rope=rope, use_flash=True, **kw)
            assert _kernels.LAUNCHES["qk_norm_rope"] == before + n
    before = dict(_kernels.LAUNCHES)
    out, _ = joint_attention(m, h.clone().requires_grad_(), e, rope=rope, use_flash=True)
    out.float().sum().backward()
    assert _kernels.LAUNCHES["qk_norm_rope"] == before["qk_norm_rope"] + 1
    assert _kernels.LAUNCHES["qk_norm_rope_bwd"] == before["qk_norm_rope_bwd"] + 1
    assert m.norm_q.weight.grad is not None and m.norm_k.bias.grad is not None
