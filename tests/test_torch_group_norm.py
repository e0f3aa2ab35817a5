"""The VAE's GroupNorm + SiLU (`ops/group_norm.py`): its plain version, its
routing, the kernels' launch geometry, and on the card its CUDA kernels.

CPU: the plain version matches the JAX package's `group_norm` + `silu` at
small odd shapes, in both layouts the VAE hands it (contiguous, and the
channel / frame swapped view of `_per_frame_conv2d`), bf16 and fp32, with and
without the SiLU; every call site gives what the eager composition gave
before, bit for bit; the geometry `plan` computes for the VAE's shapes; the
multiply-shift divisions the kernels use; a CUDA call that needs a gradient
raises, and one that does not never falls back to the plain version. The
`cuda` tests hold the kernels on the card to the function in float64 (rounded
where the plain version rounds) and to the plain version, their statistics to
float64, and a tiny `Encoder3D` through them to the same encoder in fp32. JAX
is imported inside the CPU tests only: the card has none.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.config import VAEConfig
from videopainter_tpu_torch.models import vae as tvae
from videopainter_tpu_torch.ops import basic
from videopainter_tpu_torch.ops import group_norm as gn
from videopainter_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_reference


def old_composition(x, groups, w, b, eps, silu):
    """What the port ran before the kernels: `ops/basic.py` `group_norm`, then
    `F.silu` (`models/vae.py` `_norm_silu`)."""
    y = F.group_norm(x.float(), groups, w.float(), b.float(), eps).to(x.dtype)
    return F.silu(y) if silu else y


def activations(shape, seed=0, dtype=torch.float32, device="cpu", permuted=False):
    """x as the VAE's norms see it: an offset and a spread per channel. With
    `permuted`, the view `_per_frame_conv2d` returns: [B, T, C, H, W] storage
    seen as [B, C, T, H, W]."""
    rng = np.random.default_rng(seed)
    b, c, t, h, w = shape
    x = rng.standard_normal(shape) * rng.uniform(0.5, 3, (1, c, 1, 1, 1)) \
        + rng.uniform(-1, 1, (1, c, 1, 1, 1))
    x = torch.tensor(x, dtype=dtype, device=device)
    if permuted:
        x = x.permute(0, 2, 1, 3, 4).contiguous().permute(0, 2, 1, 3, 4)
    return x


def affine(c, seed=1, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return (torch.tensor(1 + 0.2 * rng.standard_normal(c), dtype=dtype, device=device),
            torch.tensor(0.2 * rng.standard_normal(c), dtype=dtype, device=device))


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])


# -- CPU --------------------------------------------------------------------------------

@DTYPES
@pytest.mark.parametrize("silu", [False, True], ids=["norm", "norm_silu"])
@pytest.mark.parametrize("permuted", [False, True], ids=["contiguous", "frame_view"])
def test_plain_matches_jax(dtype, silu, permuted):
    import jax.numpy as jnp

    from videopainter_tpu.ops.basic import group_norm as j_group_norm
    from videopainter_tpu.ops.basic import silu as j_silu

    x = activations((2, 12, 3, 5, 7), seed=3, dtype=dtype, permuted=permuted)
    assert x.is_contiguous() != permuted
    w, b = affine(12)
    got = group_norm_silu(x, 4, w, b, eps=1e-6, silu=silu)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                               else jnp.float32)
    ref = j_group_norm({"scale": jnp.asarray(w.numpy()), "bias": jnp.asarray(b.numpy())},
                       jnp.moveaxis(xj, 1, -1), num_groups=4, eps=1e-6)
    if silu:
        ref = j_silu(ref)
    ref = np.moveaxis(np.asarray(ref.astype(jnp.float32)), -1, 1)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:   # the same fp32 arithmetic in another order
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    else:   # each side rounds its fp32 result to bf16; XLA's SiLU rounds once more
        # inside, so a value may land one bf16 spacing (2^-8 relative) away
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7, atol=2 ** -10)


@DTYPES
def test_every_call_site_equals_the_old_composition(dtype):
    """The plain route (CPU) of `group_norm_silu`, `ops/basic.py` `group_norm`
    and `GroupNorm`, and the VAE's `_norm_silu` give what the eager
    composition gave, bit for bit, on both layouts."""
    w, b = affine(16, seed=2)
    mod = basic.GroupNorm(4, 16, eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(w)
        mod.bias.copy_(b)
    for permuted in (False, True):
        x = activations((1, 16, 3, 6, 10), seed=4, dtype=dtype, permuted=permuted)
        for silu in (False, True):
            want = old_composition(x, 4, w, b, 1e-6, silu)
            assert torch.equal(group_norm_silu(x, 4, w, b, eps=1e-6, silu=silu), want)
            assert torch.equal(group_norm_silu_reference(x, 4, w, b, eps=1e-6, silu=silu), want)
        want = old_composition(x, 4, w, b, 1e-6, False)
        assert torch.equal(basic.group_norm(x, 4, w, b, eps=1e-6), want)
        assert torch.equal(mod(x), want)
        assert torch.equal(tvae._norm_silu(mod, x), old_composition(x, 4, w, b, 1e-6, True))
    # gradients flow through the plain route on the CPU
    x = activations((1, 16, 2, 4, 4), seed=5).requires_grad_()
    group_norm_silu(x, 4, mod.weight, mod.bias, silu=True).sum().backward()
    assert x.grad is not None and mod.weight.grad is not None


def _meta(shape, dtype=torch.bfloat16, permuted=False):
    if permuted:
        b, c, t, h, w = shape
        return torch.empty((b, t, c, h, w), dtype=dtype, device="meta").permute(0, 2, 1, 3, 4)
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("shape,permuted", [
    ((1, 128, 9, 480, 720), False),    # down block 0
    ((1, 128, 5, 240, 360), True),     # down block 1's first norm, after Downsample3D
    ((1, 512, 13, 60, 90), False),
    ((1, 128, 1, 480, 720), False),    # the first-frame encode
    ((1, 128, 9, 768, 1360), False),   # the CogVideoX 1.5 clip's encode
    ((2, 12, 3, 5, 7), False),         # odd planes: one value a load
], ids=["down0", "down1_view", "c512", "one_frame", "hd", "odd"])
def test_plan_covers_each_group_in_equal_chunks(shape, permuted):
    sms = 132
    x = _meta(shape, permuted=permuted)
    pl = gn.plan(x, 32 if shape[1] >= 32 else 4, sms)
    b, c, t, h, w = shape
    assert (pl.batch, pl.cg * pl.groups, pl.frames, pl.plane) == (b, c, t, h * w)
    assert pl.strides == (x.stride(0) if b > 1 else 0, x.stride(1), x.stride(2) if t > 1 else 0)
    assert pl.vec == (8 if h * w % 8 == 0 else 1)
    assert pl.chunk % pl.vec == 0
    assert pl.chunk * (pl.nchunk - 1) < pl.group_elems <= pl.chunk * pl.nchunk
    blocks = pl.batch * pl.groups * pl.nchunk
    # several blocks an SM, or chunks at their floor
    assert blocks >= gn._BLOCKS_PER_SM * sms or pl.chunk <= gn._MIN_CHUNK + pl.vec
    assert pl.nchunk == 1 or pl.chunk >= gn._MIN_CHUNK


def test_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="plane"):
        gn.plan(_meta((1, 8, 2, 16, 24))[..., :20], 4, 132)     # rows not contiguous
    with pytest.raises(ValueError, match="plane"):
        gn.plan(_meta((1, 8, 2, 16, 24)).transpose(3, 4), 4, 132)
    with pytest.raises(ValueError, match="groups"):
        gn.plan(_meta((1, 10, 2, 4, 4)), 4, 132)
    with pytest.raises(ValueError, match="32-bit"):
        gn.plan(_meta((1, 32, 64, 1024, 1024)), 1, 132)
    with pytest.raises(ValueError, match="T, H, W"):
        gn.plan(_meta((2, 8, 6, 8)), 4, 132)
    # fp32 loads 4 values; a plane that 4 does not divide reads one at a time
    assert gn.plan(_meta((1, 8, 2, 6, 6), torch.float32), 4, 132).vec == 4
    assert gn.plan(_meta((1, 8, 2, 5, 5), torch.float32), 4, 132).vec == 1


def test_divider_matches_integer_division():
    rng = np.random.default_rng(0)
    ns = [int(n) for n in rng.integers(0, 2 ** 31, 2000)] + [0, 1, 2 ** 31 - 2, 2 ** 31 - 1]
    for d in (1, 2, 3, 7, 90, 5400, 65280, 86400, 345600, 1044480, 2 ** 20, 2 ** 31 - 1):
        mul, shift = gn.divider(d)
        assert 0 <= mul < 2 ** 32 and 0 <= shift < 32
        for n in ns + [d - 1, d, d + 1]:
            got = n if d == 1 else ((n * mul) >> 32) >> shift
            assert got == n // d, (n, d)


def test_cuda_route_needs_no_grad_and_never_falls_back(monkeypatch):
    """A tensor the router takes for a CUDA one (the device check mocked):
    with a gradient wanted it raises before any launch; without, it goes to
    the kernels, which raise here (no card), rather than to the plain version."""
    monkeypatch.setattr(gn, "_device_kind", lambda x: "cuda")
    w, b = affine(8)
    x = activations((1, 8, 2, 4, 4))
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        group_norm_silu(x.clone().requires_grad_(), 4, w, b, silu=True)
    with pytest.raises(RuntimeError, match="no backward"):
        group_norm_silu(x, 4, w.clone().requires_grad_(), b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with torch.no_grad():
            group_norm_silu(x, 4, w.clone().requires_grad_(), b, silu=True)
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        monkeypatch.setattr(gn, "_device_kind", lambda x: "meta")
        group_norm_silu(x, 4, w, b)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        gn.group_norm_silu_cuda(x.half(), 4, w, b, eps=1e-6, silu=False)


# -- on the card ----------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ulp_bf16(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(v), e - 8)


def stats64(x, groups, eps):
    """Each (batch, group)'s float64 mean and rstd [B, G]."""
    x64 = x.double().reshape(x.shape[0], groups, -1)
    return x64.mean(-1), torch.rsqrt(x64.var(-1, unbiased=False) + eps)


def exact(x, groups, w, b, eps, silu):
    """The function in float64, rounded where the plain version rounds: the
    affine to x's dtype, then the SiLU of that to x's dtype. Returns (result,
    its affine value, the terms the fp32 affine adds: |x a| + |s| with a =
    rstd w, s = b - mean a), all float32."""
    mean, rstd = (t.repeat_interleave(x.shape[1] // groups, dim=1)[..., None, None, None]
                  for t in stats64(x, groups, eps))
    a = rstd * w.double()[:, None, None, None]
    shift = b.double()[:, None, None, None] - mean * a
    aff = (x.double() * a + shift).to(x.dtype)
    out = F.silu(aff.double()).to(x.dtype) if silu else aff
    terms = x.float().abs() * a.abs().float() + shift.abs().float()
    return out.float(), aff.float(), terms


def ulp_gap(got, ref, aff, terms):
    """|got - ref| in bf16 spacings at each value's scale: the largest of
    |ref|, |its affine value| and 1/256 of the terms the affine adds (where
    they cancel, an fp32 affine keeps an error of a few 2^-24 of them, far
    inside one spacing at 1/256 of them). Returns the largest gap and the
    share of values that differ."""
    scale = torch.maximum(torch.maximum(ref.abs(), aff.abs()), terms / 256)
    diff = (got.float() - ref).abs()
    return (diff / _ulp_bf16(scale)).max().item(), (diff > 0).float().mean().item()


def rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


CARD_SHAPES = [  # (shape, groups, permuted, dtype)
    ((1, 128, 9, 480, 720), 32, False, torch.bfloat16),    # down block 0's largest
    ((1, 128, 5, 240, 360), 32, True, torch.bfloat16),     # after Downsample3D: the view
    ((1, 512, 13, 60, 90), 32, False, torch.bfloat16),
    ((1, 128, 1, 480, 720), 32, False, torch.bfloat16),    # one frame
    ((2, 12, 3, 5, 7), 4, True, torch.bfloat16),           # odd planes, one value a load
    ((2, 64, 3, 24, 40), 8, True, torch.float32),
    ((1, 12, 3, 5, 7), 4, False, torch.float32),
]


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both kernels on the card, with and without the SiLU, bf16 and fp32
    weights. Against the function in float64 rounded where the plain version
    rounds (`exact`), bf16 results lie within one bf16 spacing (`ulp_gap`)
    without the SiLU and two with it: the kernels' statistics are within about
    1e-7 of float64, which can flip the affine's rounding once; the SiLU's
    slope is at most 1.1, and its own rounding (after the fast exp and
    division, a few fp32 ulps) can go either way. fp32 results within 1e-5
    (relative and absolute; fp32 arithmetic in another order). Against the
    plain version itself, relative L2 at most 2^-9, half a bf16 spacing: its
    statistics come from fp32 Welford sums over thousands of values a thread,
    about 1e-5 off at the largest shapes, so it is not held to a spacing. The
    statistics against float64: the mean within 1e-5 of |mean| + std and rstd
    within 1e-4 relative (fp32 partials merged over about 20 levels, each at
    fp32's 6e-8). Two launches a call; a contiguous result in x's dtype; the
    same bits from a second call."""
    dev = _card()
    for shape, groups, permuted, dtype in CARD_SHAPES:
        x = activations(shape, seed=sum(shape), dtype=dtype, device=dev, permuted=permuted)
        for pdtype in (torch.bfloat16, torch.float32):
            w, b = affine(shape[1], seed=shape[1], dtype=pdtype, device=dev)
            for silu in (False, True):
                before = dict(_kernels.LAUNCHES)
                with torch.no_grad():
                    got = group_norm_silu(x, groups, w, b, eps=1e-6, silu=silu)
                assert _kernels.LAUNCHES["group_norm_stats"] == before["group_norm_stats"] + 1
                assert _kernels.LAUNCHES["group_norm_apply"] == before["group_norm_apply"] + 1
                assert got.dtype == dtype and got.shape == x.shape and got.is_contiguous()
                ref, aff, terms = exact(x, groups, w, b, 1e-6, silu)
                plain = group_norm_silu_reference(x, groups, w, b, eps=1e-6, silu=silu)
                gap, share = ulp_gap(got, ref, aff, terms)
                plain_gap, _ = ulp_gap(plain, ref, aff, terms)
                err = rel_l2(got, plain)
                print(f"{list(shape)} g{groups} {'view' if permuted else 'contiguous'} {dtype} "
                      f"params {pdtype} silu {silu}: against float64 largest gap {gap:.3f} bf16 "
                      f"spacings ({share * 100:.4f} % of values differ; the plain version "
                      f"{plain_gap:.3f}), against the plain version relative L2 {err:.2e}")
                del terms
                if dtype == torch.bfloat16:
                    assert gap <= (2.0 if silu else 1.0)
                else:
                    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
                assert err <= 2 ** -9
                assert torch.equal(got, group_norm_silu(x, groups, w, b, eps=1e-6, silu=silu))
                del got, ref, aff, plain
        y, mean, rstd = gn.group_norm_silu_cuda(x, groups, w, b, eps=1e-6, silu=False,
                                                stats=True)
        m64, r64 = stats64(x, groups, 1e-6)
        assert ((mean.double() - m64).abs() <= 1e-5 * (m64.abs() + 1 / r64)).all()
        torch.testing.assert_close(rstd.double(), r64, rtol=1e-4, atol=0)
        del x, y


@pytest.mark.cuda
def test_encoder_matches_plain_path_on_card(monkeypatch):
    """A whole `Encoder3D` forward at a tiny width in bf16 (9 frames, so
    Downsample3D hands the next norms its view), through the kernels and with
    every norm on the plain version, each against the same encoder in fp32
    (plain norms, TF32 off): the kernels' path may be no farther from it than
    1.25 times the plain path is. Both paths' errors are their bf16 storage's;
    the kernels change it only where their statistics round another way. Two
    launches a norm."""
    dev = _card()
    cfg = VAEConfig.tiny()
    torch.manual_seed(0)
    enc = tvae.Encoder3D(cfg, device=dev, dtype=torch.float32)
    tvae.init_random_(enc, torch.Generator(device=dev).manual_seed(0))
    x = activations((1, 3, 9, 64, 96), seed=7, dtype=torch.bfloat16, device=dev)
    norms = sum(isinstance(m, basic.GroupNorm) for m in enc.modules())
    tf32 = torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        try:
            torch.backends.cudnn.allow_tf32 = False
            monkeypatch.setattr(gn, "_device_kind", lambda t: "cpu")   # the plain route
            ref32, _ = enc(x.float())
            enc.to(torch.bfloat16)
            plain, _ = enc(x)
            monkeypatch.undo()
            before = dict(_kernels.LAUNCHES)
            got, _ = enc(x)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        assert _kernels.LAUNCHES["group_norm_stats"] - before["group_norm_stats"] == norms
        assert _kernels.LAUNCHES["group_norm_apply"] - before["group_norm_apply"] == norms
    err, err_plain = rel_l2(got, ref32), rel_l2(plain, ref32)
    print(f"Encoder3D tiny, {norms} norms, relative L2 against fp32: kernels {err:.3e}, plain "
          f"{err_plain:.3e}; kernels against plain {rel_l2(got, plain):.3e}")
    assert norms == 13 and err <= 1.25 * err_plain
