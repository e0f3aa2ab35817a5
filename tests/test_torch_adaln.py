"""AdaLN (`ops/adaln.py`): LayerNormZero's and AdaLayerNorm's norm and
modulation as one pass, its plain version, its autograd Function and its CUDA
kernels.

CPU: the plain version equals the eager chain `ops/norms.py` ran before
(written out below as it was) bit for bit; it matches the JAX package's
`layer_norm_zero` / `ada_layer_norm`; gradcheck in float64 of the Function's
backward formula; the mocked CUDA route refuses what the kernel cannot take
and never falls back; a DiT block gives what it gave before. The `cuda` tests
hold the kernels to the plain version on the card. JAX is imported inside the
CPU tests only: the card has none.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.config import TransformerConfig
from videopainter_tpu_torch.models.dit import CogVideoXBlock
from videopainter_tpu_torch.ops import adaln as A
from videopainter_tpu_torch.ops import norms
from videopainter_tpu_torch.ops.adaln import adaln, adaln_reference
from videopainter_tpu_torch.ops.norms import AdaLayerNorm, LayerNormZero

TEXT = 226   # the served prompt's tokens


# -- the eager chain as ops/norms.py ran it before the kernel --------------------------

def _old_layer_norm(x, w, b, eps):
    w = None if w is None else w.float()
    b = None if b is None else b.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


def old_layer_norm_zero_forward(self, hidden_states, encoder_hidden_states, temb):
    mod = self.linear(F.silu(temb.float()))
    shift, scale, gate, enc_shift, enc_scale, enc_gate = mod.chunk(6, dim=-1)
    dt = hidden_states.dtype
    h = _old_layer_norm(hidden_states, self.norm.weight, self.norm.bias, self.norm.eps)
    h = (h.float() * (1 + scale[:, None, :]) + shift[:, None, :]).to(dt)
    if encoder_hidden_states is None:
        return h, None, gate[:, None, :].to(dt), None
    e = _old_layer_norm(encoder_hidden_states, self.norm.weight, self.norm.bias, self.norm.eps)
    e = (e.float() * (1 + enc_scale[:, None, :]) + enc_shift[:, None, :]).to(
        encoder_hidden_states.dtype)
    return h, e, gate[:, None, :].to(dt), enc_gate[:, None, :].to(dt)


def old_ada_layer_norm_forward(self, x, temb):
    mod = self.linear(F.silu(temb.float()))
    shift, scale = mod.chunk(2, dim=-1)
    y = _old_layer_norm(x, self.norm.weight, self.norm.bias, self.norm.eps)
    y = y.float() * (1 + scale[:, None, :]) + shift[:, None, :]
    return y.to(x.dtype)


# -- inputs ---------------------------------------------------------------------------

def activations(shape, seed, dtype=torch.float32, device="cpu"):
    """Values with an offset and a spread per row, as a block's residual
    stream has."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 3, shape[:-1] + (1,))
         + rng.uniform(-1, 1, shape[:-1] + (1,)))
    return torch.tensor(x, dtype=dtype, device=device)


def affine(d, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return (torch.tensor(1 + 0.1 * rng.standard_normal(d), dtype=dtype, device=device),
            torch.tensor(0.1 * rng.standard_normal(d), dtype=dtype, device=device))


def modulation(b, d, n, seed, device="cpu"):
    """n fp32 [B, D] chunks of one [B, n D] modulation, as `mod.chunk` gives
    them (views with a row stride of n D)."""
    rng = np.random.default_rng(seed)
    mod = torch.tensor(0.5 * rng.standard_normal((b, n * d)), dtype=torch.float32,
                       device=device)
    return mod.chunk(n, dim=-1)


def old_chain(x, shift, scale, w, b, eps, enc=None, enc_shift=None, enc_scale=None):
    def one(t, sh, sc):
        n = _old_layer_norm(t, w, b, eps)
        return (n.float() * (1 + sc[:, None, :]) + sh[:, None, :]).to(t.dtype)
    return one(x, shift, scale), (None if enc is None else one(enc, enc_shift, enc_scale))


CASES = {
    "video_and_text": dict(text=5, affine=True),
    "video_only": dict(text=None, affine=True),
    "no_affine": dict(text=5, affine=False),
    "empty_text": dict(text=0, affine=True),
    "strided_view": dict(text=5, affine=True, view=True),
}


def case_args(case, dtype, b=2, s=11, d=24, seed=0):
    """(x, shift, scale, weight, bias, kw) of a case. `view` takes x and the
    text rows as the any-length path's slices of one joint [B, S_text + S, D]
    tensor (batch stride (S_text + S) D)."""
    c = CASES[case]
    text = c["text"]
    if c.get("view"):
        joint = activations((b, text + s, d), seed, dtype)
        x, enc = joint[:, text:], joint[:, :text]
    else:
        x = activations((b, s, d), seed, dtype)
        enc = None if text is None else activations((b, text, d), seed + 1, dtype)
    w, bias = affine(d, seed + 2) if c["affine"] else (None, None)
    shift, scale, enc_shift, enc_scale = modulation(b, d, 4, seed + 3)
    kw = dict(eps=1e-5)
    if enc is not None:
        kw.update(enc=enc, enc_shift=enc_shift, enc_scale=enc_scale)
    return x, shift, scale, w, bias, kw


# -- CPU --------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_equals_old_eager_composition(case, dtype):
    x, shift, scale, w, b, kw = case_args(case, dtype)
    want = old_chain(x, shift, scale, w, b, **kw)
    for fn in (adaln, adaln_reference):
        got = fn(x, shift, scale, w, b, **kw)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if want[1] is not None:
            assert torch.equal(got[1], want[1])
    # the Function's plain route gives the same values
    leaf = x.detach().clone().requires_grad_()
    got = adaln(leaf, shift, scale, w, b, **kw)
    assert type(got[0].grad_fn).__name__ == "AdaLNFunctionBackward"
    assert torch.equal(got[0].detach(), want[0])
    if want[1] is not None:
        assert torch.equal(got[1].detach(), want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("module", ["layer_norm_zero", "layer_norm_zero_wo_text",
                                    "ada_layer_norm"])
def test_modules_equal_their_old_forward(module, dtype, monkeypatch):
    torch.manual_seed(0)
    d, cond = 24, 16
    m = (AdaLayerNorm(cond, 2 * d) if module == "ada_layer_norm"
         else LayerNormZero(cond, d))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn_like(p) * 0.3 + (1.0 if p is m.norm.weight else 0.0))
    x = activations((2, 9, d), 1, dtype)
    e = activations((2, 4, d), 2, dtype)
    temb = torch.tensor(np.random.default_rng(3).standard_normal((2, cond)), dtype=dtype)
    args = (x, temb) if module == "ada_layer_norm" else (
        x, None if module.endswith("wo_text") else e, temb)
    new = m(*args)
    old_fwd = (old_ada_layer_norm_forward if module == "ada_layer_norm"
               else old_layer_norm_zero_forward)
    monkeypatch.setattr(type(m), "forward", old_fwd)
    old = m(*args)
    for a, b in zip(new if isinstance(new, tuple) else (new,),
                    old if isinstance(old, tuple) else (old,)):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("case", ["video_and_text", "video_only"])
def test_plain_matches_jax(case):
    import jax.numpy as jnp

    from videopainter_tpu.ops import norms as jnorms

    rng = np.random.default_rng(4)
    b, s, t, d, cond = 2, 7, 3, 24, 16
    x = activations((b, s, d), 5)
    e = activations((b, t, d), 6) if case == "video_and_text" else None
    w, bias = affine(d, 7)
    temb = rng.standard_normal((b, cond)).astype(np.float32)
    lin_w = (0.3 * rng.standard_normal((cond, 6 * d))).astype(np.float32)   # [in, out]
    lin_b = (0.1 * rng.standard_normal(6 * d)).astype(np.float32)
    m = LayerNormZero(cond, d)
    with torch.no_grad():
        m.linear.weight.copy_(torch.tensor(lin_w.T))
        m.linear.bias.copy_(torch.tensor(lin_b))
        m.norm.weight.copy_(w)
        m.norm.bias.copy_(bias)
    got = m(x, e, torch.tensor(temb))
    p = {"linear": {"kernel": jnp.asarray(lin_w), "bias": jnp.asarray(lin_b)},
         "norm": {"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(bias.numpy())}}
    want = jnorms.layer_norm_zero(p, jnp.asarray(x.numpy()),
                                  None if e is None else jnp.asarray(e.numpy()),
                                  jnp.asarray(temb), eps=1e-5)
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # AdaLayerNorm (the DiT's norm_out) against ada_layer_norm
    a = AdaLayerNorm(cond, 2 * d)
    with torch.no_grad():
        a.linear.weight.copy_(torch.tensor(lin_w[:, :2 * d].T))
        a.linear.bias.copy_(torch.tensor(lin_b[:2 * d]))
        a.norm.weight.copy_(w)
        a.norm.bias.copy_(bias)
    pa = {"linear": {"kernel": jnp.asarray(lin_w[:, :2 * d]), "bias": jnp.asarray(lin_b[:2 * d])},
          "norm": p["norm"]}
    np.testing.assert_allclose(
        a(x, torch.tensor(temb)).detach().numpy(),
        np.asarray(jnorms.ada_layer_norm(pa, jnp.asarray(x.numpy()), jnp.asarray(temb),
                                         eps=1e-5)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["video_and_text", "video_only", "no_affine"])
def test_function_gradcheck_float64(case):
    """The Function's CPU backward, `adaln_backward_reference` (the backward
    kernel's formula), against float64 finite differences: dx, d_shift,
    d_scale of each stream, dweight and dbias."""
    c = CASES[case]
    rng = np.random.default_rng(8)
    b, s, t, d = 2, 5, 3, 16
    x = torch.tensor(rng.standard_normal((b, s, d)), dtype=torch.float64, requires_grad=True)
    e = torch.tensor(rng.standard_normal((b, t, d)), dtype=torch.float64, requires_grad=True)
    mod = torch.tensor(0.5 * rng.standard_normal((b, 4 * d)), dtype=torch.float64,
                       requires_grad=True)
    w = torch.tensor(1 + 0.1 * rng.standard_normal(d), dtype=torch.float64, requires_grad=True)
    bias = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float64, requires_grad=True)

    def fn(x, e, mod, w, bias):
        shift, scale, enc_shift, enc_scale = mod.chunk(4, dim=-1)
        if not c["affine"]:
            w = bias = None
        kw = {} if c["text"] is None else dict(enc=e, enc_shift=enc_shift, enc_scale=enc_scale)
        out = adaln(x, shift, scale, w, bias, eps=1e-5, **kw)
        return out if c["text"] is not None else out[0]

    inputs = (x, e, mod, w, bias)
    out = fn(*inputs)
    assert all(type(y.grad_fn).__name__ == "AdaLNFunctionBackward"
               for y in (out if isinstance(out, tuple) else (out,)))
    assert torch.autograd.gradcheck(fn, inputs)


@pytest.mark.parametrize("case", ["video_and_text", "strided_view", "no_affine"])
def test_function_grads_match_autograd_through_plain(case):
    """In fp32 the formula gives autograd's gradients through the plain
    version, within fp32 reassociation; only what is asked for is given."""
    x, shift, scale, w, b, kw = case_args(case, torch.float32, seed=9)
    dy = [activations(t.shape, 10 + i) for i, t in enumerate([x, kw.get("enc")]) if t is not None]

    def grads(fn, with_params):
        leaves = [x.detach().clone().requires_grad_()]
        mods = [t.detach().clone().requires_grad_(with_params) for t in (shift, scale)]
        aff = [None if t is None else t.detach().clone().requires_grad_(with_params)
               for t in (w, b)]
        kw2 = dict(kw)
        if "enc" in kw:
            leaves.append(kw["enc"].detach().clone().requires_grad_())
            kw2.update(enc=leaves[1], enc_shift=kw["enc_shift"], enc_scale=kw["enc_scale"])
        out = [y for y in fn(leaves[0], *mods, *aff, **kw2) if y is not None]
        wrt = leaves + ([*mods, *[t for t in aff if t is not None]] if with_params else [])
        return torch.autograd.grad(out, wrt, dy)

    for with_params in (True, False):
        got = grads(adaln, with_params)
        want = grads(adaln_reference, with_params)
        assert len(got) == len(want)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_no_grad_path_keeps_no_graph():
    x, shift, scale, w, b, kw = case_args("video_and_text", torch.float32)
    with torch.no_grad():
        y, e = adaln(x.requires_grad_(), shift, scale, w, b, **kw)
    assert y.grad_fn is None and e.grad_fn is None


def test_cuda_route_refuses_what_the_kernel_cannot_take_and_never_falls_back(monkeypatch):
    """A tensor the router takes for a CUDA one (the device check mocked): a
    width that is not a multiple of 8 or above 4096, rows that are not
    contiguous, another dtype or mismatched streams raise before any launch;
    a call the kernel takes goes to the kernel, which raises here (no card),
    with or without a gradient, rather than to the plain version."""
    monkeypatch.setattr(A, "_device_kind", lambda x: "cuda")
    x, shift, scale, w, b, kw = case_args("video_and_text", torch.float32, d=24)
    before = dict(_kernels.LAUNCHES)
    bad = [
        ("multiple of 8", lambda: adaln(activations((2, 5, 20), 0), *modulation(2, 20, 2, 1),
                                        None, None, eps=1e-5)),
        ("multiple of 8", lambda: adaln(activations((1, 3, 4104), 0), *modulation(1, 4104, 2, 1),
                                        None, None, eps=1e-5)),
        ("each row contiguous", lambda: adaln(activations((2, 5, 48), 0)[..., ::2], shift, scale,
                                              w, b, eps=1e-5)),
        ("each row contiguous", lambda: adaln(activations((2, 24, 5), 0).transpose(1, 2), shift,
                                              scale, w, b, eps=1e-5)),
        ("each row contiguous", lambda: adaln(activations((2, 5, 26), 0)[..., 1:25], shift,
                                              scale, w, b, eps=1e-5)),
        ("bfloat16 or float32", lambda: adaln(x.half(), shift, scale, w, b, eps=1e-5)),
        ("streams must match", lambda: adaln(x, shift, scale, w, b, eps=1e-5,
                                             enc=kw["enc"].bfloat16(), enc_shift=shift,
                                             enc_scale=scale)),
    ]
    for match, call in bad:
        with pytest.raises(ValueError, match=match):
            call()
        with pytest.raises(ValueError, match=match), torch.enable_grad():
            w.requires_grad_(True)
            call()
        w.requires_grad_(False)
    with pytest.raises(ValueError, match="modulation must be"):
        adaln(x, shift[:, :8], scale, w, b, eps=1e-5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with torch.no_grad():
            adaln(x, shift, scale, w, b, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        adaln(x.clone().requires_grad_(), shift, scale, w, b, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):   # the strided any-length view
        adaln(*case_args("strided_view", torch.bfloat16)[:5], eps=1e-5)
    assert _kernels.LAUNCHES == before
    monkeypatch.setattr(A, "_device_kind", lambda x: "meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        adaln(x, shift, scale, w, b, eps=1e-5)


def _tiny_block(dtype):
    torch.manual_seed(0)
    cfg = TransformerConfig.tiny()
    block = CogVideoXBlock(cfg)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.randn_like(p) * (0.3 if p.ndim > 1 else 0.1)
                    + (1.0 if name.endswith("norm.weight") else 0.0))
    return block.to(dtype), cfg


BLOCK_VARIANTS = ["base", "wo_text", "prev_window"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", BLOCK_VARIANTS)
def test_dit_block_unchanged(variant, dtype, monkeypatch):
    """A DiT block through the new LayerNormZero against the same block with
    the old eager forward: equal outputs; in fp32, gradients to the input and
    every parameter within fp32 reassociation (relative L2 1e-5: the old
    chain's autograd and the Function's formula sum in other orders, and the
    block's attention and feed-forward carry that to every gradient). The
    keys' norm bias gets none: a constant added to a head's every key leaves
    its softmax as it was, so that gradient is rounding noise on both sides,
    held under 1e-6 of the norm weight's. `prev_window` re-norms the previous
    window's raw states through norm1 as strided views."""
    block, cfg = _tiny_block(dtype)
    d, text, s = cfg.inner_dim, 5, 12
    h0 = activations((2, s, d), 1, dtype)
    e0 = activations((2, text, d), 2, dtype)
    temb = activations((2, cfg.time_embed_dim), 3, dtype)
    kw = {}
    if variant == "prev_window":
        kw = dict(prev_hidden_states=activations((2, text + s, d), 4, dtype),
                  prev_clip_weight=0.3)
    train = dtype == torch.float32

    def run():
        h = h0.clone().requires_grad_(train)
        e = None if variant == "wo_text" else e0.clone().requires_grad_(train)
        with torch.set_grad_enabled(train):
            out_h, out_e = block(h, e, temb, None, **kw)
            if not train:
                return out_h, out_e, {}
            loss = out_h.square().sum() + (0 if out_e is None else out_e.sum())
            names, params = zip(*block.named_parameters())
            leaves = [h] + ([] if e is None else [e]) + list(params)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return out_h.detach(), out_e, dict(zip(["h", "e"][:len(leaves) - len(names)]
                                                   + list(names), grads))

    new = run()
    monkeypatch.setattr(norms.LayerNormZero, "forward", old_layer_norm_zero_forward)
    old = run()
    assert torch.equal(new[0], old[0])
    assert (new[1] is None) == (variant == "wo_text")
    if new[1] is not None:
        assert torch.equal(new[1].detach(), old[1].detach())
    assert new[2].keys() == old[2].keys()
    zero = "attn1.norm_k.bias"
    for name, g_old in old[2].items():
        g_new = new[2][name]
        assert (g_new is None) == (g_old is None)
        if g_new is None:
            continue
        if name == zero:
            limit = 1e-6 * old[2]["attn1.norm_k.weight"].norm()
            assert g_new.norm() <= limit and g_old.norm() <= limit
        else:
            assert _rel_l2(g_new, g_old) <= 1e-5, name


# -- on the card --------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _row_ulp_gap(got, ref):
    """The largest |got - ref| in bf16 ulps of each row's largest |ref|."""
    r = ref.float()
    top = r.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    _, e = torch.frexp(top)
    ulp = torch.ldexp(torch.ones_like(top), e - 8)
    return ((got.float() - r).abs() / ulp).max().item()


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


# (batch, video rows, text rows or None, D, dtype, as the any-length slices)
FWD_SHAPES = [(2, 17776, TEXT, 3072, torch.bfloat16, False),
              (2, 17776, TEXT, 3072, torch.bfloat16, True),
              (1, 37, 5, 1920, torch.bfloat16, False), (3, 21, None, 4096, torch.float32, False),
              (2, 11, 0, 24, torch.bfloat16, True), (1, 5, 3, 3072, torch.float32, True)]


def _fwd_operands(bsz, s, text, d, dtype, view, dev, seed):
    if view:
        joint = activations((bsz, (text or 0) + s, d), seed, dtype, dev)
        x, enc = joint[:, text or 0:], (None if text is None else joint[:, :text])
    else:
        x = activations((bsz, s, d), seed, dtype, dev)
        enc = None if text is None else activations((bsz, text, d), seed + 1, dtype, dev)
    shift, scale, enc_shift, enc_scale = modulation(bsz, d, 4, seed + 2, dev)
    kw = {} if enc is None else dict(enc=enc, enc_shift=enc_shift, enc_scale=enc_scale)
    return x, shift, scale, kw


@pytest.mark.cuda
def test_forward_kernel_matches_plain_on_card():
    """The forward kernel against the plain version on the card: the served
    shape [2, 17,776, 3,072] + [2, 226, 3,072] (bf16, contiguous, and as
    slices of one joint tensor as the any-length path hands them), ragged
    tiny shapes, D 1,920 and 4,096, fp32; bf16 and fp32 weights, and none.
    The statistics' sum order is the one difference, so a value lies within
    one bf16 ulp of its row's largest value. One launch a call."""
    dev = _card()
    for bsz, s, text, d, dtype, view in FWD_SHAPES:
        x, shift, scale, kw = _fwd_operands(bsz, s, text, d, dtype, view, dev, seed=s)
        for pdtype in (torch.bfloat16, torch.float32, None):
            w, b = (None, None) if pdtype is None else affine(d, 1, pdtype, dev)
            before = _kernels.LAUNCHES["adaln_fwd"]
            with torch.no_grad():
                got = adaln(x, shift, scale, w, b, eps=1e-5, **kw)
            assert _kernels.LAUNCHES["adaln_fwd"] == before + 1
            ref = adaln_reference(x, shift, scale, w, b, eps=1e-5, **kw)
            torch.cuda.synchronize()
            for g, r in zip(got, ref):
                if r is None:
                    assert g is None
                    continue
                assert g.shape == r.shape and g.dtype == r.dtype and g.is_contiguous()
                gap = _row_ulp_gap(g, r) if r.numel() else 0.0
                print(f"fwd [{bsz}, {s}] + text {text}, D {d} {dtype} view {view} params "
                      f"{pdtype}: largest gap {gap:.3f} bf16 ulp of the row's max")
                assert gap <= 1.0
        del x, kw


def _reference_grads(xs, mods, w, b, dys, with_params):
    """fp32 autograd through the plain version, leaves as `adaln`'s test call
    takes them: dx on fp32 copies of the rows, and so dweight and dbias; the
    modulation's gradients on the rows as they are, since d_scale sums dy
    times the normed row rounded to the rows' dtype (what the forward
    multiplied by 1 + scale), which an fp32 copy does not round."""
    out = []
    for rows_dtype in (torch.float32, None):
        rx = [t.detach().to(rows_dtype or t.dtype).requires_grad_() for t in xs]
        rm = [t.detach().clone().requires_grad_() for t in mods]
        rw, rb = (t.detach().clone().requires_grad_() for t in (w, b))
        rkw = {} if len(rx) == 1 else dict(enc=rx[1], enc_shift=rm[2], enc_scale=rm[3])
        ref = [y for y in adaln_reference(rx[0], rm[0], rm[1], rw, rb, eps=1e-5, **rkw)
               if y is not None]
        rleaves = rx + (rm + [rw, rb] if with_params else [])
        out.append(torch.autograd.grad(ref, rleaves, [t.float() for t in dys]))
    full, as_run = out
    n = len(xs)
    return [*full[:n], *as_run[n:n + len(mods)], *full[n + len(mods):]] if with_params else full


@pytest.mark.cuda
def test_backward_kernel_matches_fp32_autograd_on_card():
    """The backward kernel against fp32 autograd through the plain version:
    relative L2 at most 1e-3 for dx (against the reference rounded to the
    storage type, as the kernel's dx is stored), d_shift, d_scale, dweight
    and dbias (`_reference_grads`). The training call [1, 17,776, 3,072] + [1, 226, 3,072] and
    ragged tiny ones; parameters that need no grad (the frozen backbone)."""
    dev = _card()
    shapes = [(1, 17776, TEXT, 3072, torch.bfloat16, False),
              (2, 37, 5, 1920, torch.bfloat16, True), (1, 29, None, 64, torch.float32, False)]
    for bsz, s, text, d, dtype, view in shapes:
        x0, shift0, scale0, kw0 = _fwd_operands(bsz, s, text, d, dtype, view, dev, seed=s)
        xs0 = [x0] + ([kw0["enc"]] if kw0 else [])
        mods0 = [shift0, scale0] + ([kw0["enc_shift"], kw0["enc_scale"]] if kw0 else [])
        w0, b0 = affine(d, 2, torch.float32, dev)
        dys = [activations(t.shape, 3 + i, dtype, dev) for i, t in enumerate(xs0)]
        for train_params in (True, False):
            xs = [t.detach().clone().requires_grad_() for t in xs0]
            mods = [t.detach().clone().requires_grad_(train_params) for t in mods0]
            w, b = (t.clone().requires_grad_(train_params) for t in (w0, b0))
            before = dict(_kernels.LAUNCHES)
            kw = {} if len(xs) == 1 else dict(enc=xs[1], enc_shift=mods[2], enc_scale=mods[3])
            out = [y for y in adaln(xs[0], mods[0], mods[1], w, b, eps=1e-5, **kw)
                   if y is not None]
            leaves = xs + (mods + [w, b] if train_params else [])
            grads = torch.autograd.grad(out, leaves, dys)
            assert _kernels.LAUNCHES["adaln_fwd"] == before["adaln_fwd"] + 1
            assert _kernels.LAUNCHES["adaln_bwd"] == before["adaln_bwd"] + 1
            rgrads = _reference_grads(xs, mods, w, b, dys, train_params)
            for i, (g, r) in enumerate(zip(grads, rgrads)):
                if i < len(xs):
                    assert g.dtype == dtype and g.shape == xs[i].shape
                    err = _rel_l2(g, r.to(dtype))
                else:
                    assert g.dtype == torch.float32
                    err = _rel_l2(g, r)
                print(f"bwd [{bsz}, {s}] + text {text}, D {d} {dtype} train_params "
                      f"{train_params} grad {i}: rel L2 {err:.3e}")
                assert err <= 1e-3
        del x0, xs0, kw0


@pytest.mark.cuda
def test_one_launch_per_norm_call_on_card():
    """LAUNCHES["adaln_fwd"] rises by one a LayerNormZero or AdaLayerNorm
    call, with or without the text rows; with grad the backward launches once
    a call; the modules' outputs equal the plain route's."""
    dev = _card()
    torch.manual_seed(0)
    d, cond = 3072, 512
    lnz = LayerNormZero(cond, d).to(dev, torch.bfloat16)
    ada = AdaLayerNorm(cond, 2 * d).to(dev, torch.bfloat16)
    h = activations((2, 300, d), 1, torch.bfloat16, dev)
    e = activations((2, 20, d), 2, torch.bfloat16, dev)
    temb = torch.randn(2, cond, device=dev, dtype=torch.bfloat16)
    for args, m in (((h, e, temb), lnz), ((h, None, temb), lnz), ((h, temb), ada)):
        before = _kernels.LAUNCHES["adaln_fwd"]
        with torch.no_grad():
            m(*args)
        assert _kernels.LAUNCHES["adaln_fwd"] == before + 1
    before = dict(_kernels.LAUNCHES)
    out_h, out_e, _, _ = lnz(h.clone().requires_grad_(), e.clone().requires_grad_(), temb)
    (out_h.float().sum() + out_e.float().square().sum()).backward()
    assert _kernels.LAUNCHES["adaln_fwd"] == before["adaln_fwd"] + 1
    assert _kernels.LAUNCHES["adaln_bwd"] == before["adaln_bwd"] + 1
    assert lnz.norm.weight.grad is not None and lnz.linear.weight.grad is not None
