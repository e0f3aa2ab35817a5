"""Parity of the port's int8 serving mode (videopainter_tpu_torch) with the JAX
package, on the CPU in float32: the int8 flash attention's plain version and
its uniform-scale precursor against the Pallas kernels in interpret mode, the
W8A8 linear, and the quantize / calibrate / scales-file functions.

Inputs come from a numpy seed; quantized weights reach the port through
convert/from_jax.py, so both sides compute with the same integers. Each
tolerance is stated where it is used.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videopainter_tpu.config as jcfg
import videopainter_tpu.quantize as jq
import videopainter_tpu_torch.config as tcfg
import videopainter_tpu_torch.quantize as tq
from videopainter_tpu.models import CogVideoXBranch as JBranch, CogVideoXTransformer3D as JDiT
from videopainter_tpu.ops.basic import linear as jlinear
from videopainter_tpu.ops.basic import quantize_linear_int8 as jquantize_linear_int8
from videopainter_tpu.ops.flash_attention_int8 import flash_attention_int8 as jflash_int8
from videopainter_tpu.pipelines.common import prepare_rope as jprepare_rope
from videopainter_tpu_torch.convert import (branch_state_dict, load_quantized,
                                            transformer_state_dict)
from videopainter_tpu_torch.models import CogVideoXBranch, CogVideoXTransformer3D
from videopainter_tpu_torch.ops.basic import (Int8Linear, Linear, calibration, int8_matmul,
                                              quantize_linear_int8, quantize_weight_int8)
from videopainter_tpu_torch.ops.flash_attention_int8 import (
    flash_attention_int8, flash_attention_int8_reference, int8_flash_uniform,
    int8_flash_uniform_reference, quantize_qkv)
from videopainter_tpu_torch.pipelines.common import prepare_rope

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def jax_call(fn, *args, **kw):
    """Run a JAX function that may reach a Pallas kernel, as the JAX package's
    own tests do: in interpret mode on the CPU. The call is made as one jitted
    program and its results are fetched at once: an interpret-mode kernel
    runs host callbacks, and an eager JAX op dispatched from this thread
    while they run can block with the interpreter lock held."""
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, jax.jit(lambda: fn(*args, **kw))())


def qkv(s_q, s_k, seed=0, b=2, h=2, d=64):
    """N(0,1) q, k, v with a K common mode of 0.75. K lies on a grid of 1/64
    and its last row is set so that every column sums to exactly 0.75 * S_k:
    any summation order then gives the mean 0.75 and the same centred K in
    both frameworks, so both quantize K to the same integers (a centred K
    that differs in its last bit now and then flips a rounding, which moves
    a whole row of scores by an int8 step and has nothing to do with the
    function under test). The last row is an outlier of about sqrt(S_k)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s_q, d)).astype(np.float32)
    k = np.round((rng.standard_normal((b, h, s_k, d)) + 0.75) * 64) / 64
    k[:, :, -1] = 0.75 * s_k - k[:, :, :-1].sum(axis=2)
    v = rng.standard_normal((b, h, s_k, d)).astype(np.float32)
    return q, k.astype(np.float32), v


# -- int8 flash attention: the plain version against the Pallas kernel --------------------

CASES = {
    "256x512": (256, 512, {}),
    "ragged_300x300": (300, 300, {}),
    "ragged_129x1111": (129, 1111, {}),
    "keys_2x": (200, 400, {}),
    "kv_len_prepadded": (512, 512, dict(kv_len=300)),
    "paged": (384, 768, dict(kv_len=300, kv_page_len=384)),
}


@pytest.mark.parametrize("int8_pv", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_int8_flash_reference_matches_jax(case, int8_pv):
    """Quantization blocks of 128 on both sides. `int8`: the same integers and
    the same fp32 softmax, atol 1e-5. `int8pv`: P * 127 is rounded to an
    integer, and a one-ulp difference in exp between the two frameworks may
    flip a rounding; one flip moves an output by about |v| / (127 * row sum):
    atol 3e-3 on outputs of about 0.1, and a mean error under 1e-4 of the
    mean output, since flips are rare."""
    s_q, s_k, kw = CASES[case]
    q, k, v = qkv(s_q, s_k, seed=len(case))
    ref = jax_call(jflash_int8, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   blk_q=128, blk_k=128, int8_pv=int8_pv, **kw)
    out = flash_attention_int8(T(q), T(k), T(v), blk_q=128, blk_k=128, int8_pv=int8_pv,
                               **kw).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    if int8_pv:
        np.testing.assert_allclose(out, ref, rtol=0, atol=3e-3)
        assert np.abs(out - ref).mean() < 1e-4 * np.abs(ref).mean()
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_int8_flash_cpu_wrapper_is_the_reference_and_checks_arguments():
    q, k, v = map(T, qkv(130, 260))
    out = flash_attention_int8(q, k, v, blk_q=128, blk_k=128)
    assert torch.equal(out, flash_attention_int8_reference(q, k, v, blk_q=128, blk_k=128))
    # close to exact attention: the int8 band of the JAX test (2.5 % relative L1)
    exact = torch.softmax(q @ k.transpose(-1, -2) * 64 ** -0.5, dim=-1) @ v
    assert ((out - exact).abs().mean() / exact.abs().mean()) < 0.025
    with pytest.raises(ValueError, match="kv_page_len requires kv_len"):
        flash_attention_int8(q, k, v, kv_page_len=130)
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_int8(q, k, v, kv_len=261)


def test_quantize_qkv_blocks_and_scales():
    """The ragged last block's scale is the max over the rows that exist; K is
    centred per (batch, head) over all rows; scales floor at 1e-8."""
    q, k, v = map(T, qkv(300, 300))
    qq = quantize_qkv(q, k, v, blk_q=128, blk_k=256, int8_pv=True)
    assert qq.q_i8.dtype == torch.int8 and qq.sq.shape == (2, 2, 3) and qq.sk.shape == (2, 2, 2)
    torch.testing.assert_close(qq.sq[..., 2], q[:, :, 256:].abs().amax(dim=(2, 3)) / 127)
    kc = k - k.mean(dim=2, keepdim=True)
    torch.testing.assert_close(qq.sk[..., 1], kc[:, :, 256:].abs().amax(dim=(2, 3)) / 127)
    torch.testing.assert_close(qq.sv[..., 0], v[:, :, :256].abs().amax(dim=(2, 3)) / 127)
    assert int(qq.q_i8.abs().max()) == 127 and int(qq.v.abs().max()) == 127
    zero = quantize_qkv(torch.zeros_like(q), k, v, blk_q=128, blk_k=256, int8_pv=False)
    assert float(zero.sq.max()) == pytest.approx(1e-8) and not zero.q_i8.any()
    assert zero.v is v and zero.sv is None


def test_int8_flash_raises_under_autograd():
    q = torch.zeros((1, 2, 128, 64), requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        flash_attention_int8(q, q, q, blk_q=128, blk_k=128)
    with torch.no_grad():
        assert flash_attention_int8(q, q, q, blk_q=128, blk_k=128).shape == q.shape


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's microbenchmark module, which holds the precursor kernel."""
    spec = importlib.util.spec_from_file_location("jax_bench_int8_attn",
                                                  REPO / "tools" / "bench_int8_attn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("int8_pv", [False, True])
@pytest.mark.parametrize("kv_len", [256, 200])
def test_int8_uniform_reference_matches_jax(jax_tool, kv_len, int8_pv):
    """The uniform-scale precursor against `_int8_flash` in interpret mode on
    the same int8 operands (the JAX kernel emits bf16, as the port does):
    2^-7 of the largest output, one bf16 ulp there, for the bf16 P.V mode. In
    the int8 P.V mode a flipped rounding of P (see above) moves an output by
    |v_i8| / 127 over the row sum, at most 1 here (v_i8 up to 127, row sums
    at least 1): atol 2 on outputs of up to about 40, and a mean error under
    1e-3 of the mean output, since flips are rare."""
    rng = np.random.default_rng(kv_len)
    n, s, d = 3, 256, 64
    q_i8 = rng.integers(-127, 128, (n, s, d)).astype(np.int8)
    k_i8 = rng.integers(-127, 128, (n, s, d)).astype(np.int8)
    v = rng.integers(-127, 128, (n, s, d)).astype(np.int8) if int8_pv else \
        rng.standard_normal((n, s, d)).astype(np.float32)
    deq = 3.0 / (127 * 127)
    jv = jnp.asarray(v) if int8_pv else jnp.asarray(v, jnp.bfloat16)
    ref = jax_call(lambda *a, **k: jax_tool._int8_flash(*a, **k).astype(jnp.float32),
                   jnp.asarray(q_i8), jnp.asarray(k_i8), jv, d ** -0.5, deq, kv_len, 128, 128,
                   int8_pv=int8_pv)
    tv = T(v) if int8_pv else T(v).to(torch.bfloat16)
    # key blocks of 128 as in the JAX call: P is rounded against the running max per block
    out = int8_flash_uniform_reference(T(q_i8), T(k_i8), tv, d ** -0.5, deq, kv_len,
                                       int8_pv=int8_pv, blk_k=128)
    assert out.dtype == torch.bfloat16 and out.shape == (n, s, d)
    # on the CPU the wrapper is the plain version (one key block here)
    assert torch.equal(
        int8_flash_uniform(T(q_i8), T(k_i8), tv, d ** -0.5, deq, kv_len, int8_pv=int8_pv),
        int8_flash_uniform_reference(T(q_i8), T(k_i8), tv, d ** -0.5, deq, kv_len,
                                     int8_pv=int8_pv))
    out32 = out.float().numpy()
    if int8_pv:
        np.testing.assert_allclose(out32, ref, rtol=0, atol=2.0)
        assert np.abs(out32 - ref).mean() < 1e-3 * np.abs(ref).mean()
    else:
        np.testing.assert_allclose(out32, ref, rtol=0, atol=2.0 ** -7 * np.abs(ref).max())
    with pytest.raises(ValueError, match="kv_len"):
        int8_flash_uniform(T(q_i8), T(k_i8), tv, d ** -0.5, deq, s + 1, int8_pv=int8_pv)


# -- the W8A8 linear -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_linear():
    rng = np.random.default_rng(5)
    p = {"kernel": (rng.standard_normal((48, 40)) / 7).astype(np.float32),
         "bias": (0.05 * rng.standard_normal(40)).astype(np.float32)}
    p["kernel"][:, 3] = 0   # an all-zero channel keeps scale 1
    x = rng.standard_normal((2, 19, 48)).astype(np.float32)
    x[0, 4] = 0             # an all-zero token keeps scale 1 (the amax > 0 guard)
    return p, jquantize_linear_int8(p), x


def port_linear(qp, ascale=None):
    return Int8Linear(T(np.asarray(qp["kernel_q"]).T), T(qp["kscale"]), T(qp["bias"]),
                      None if ascale is None else torch.tensor(ascale))


@pytest.mark.parametrize("mode", ["dynamic", "static", "static_clipping"])
def test_int8_linear_matches_jax(jax_linear, mode):
    """The same int8 weights on both sides; the products are exact integers,
    so only the fp32 dequantization order differs: atol 1e-5. The static
    scale 0.004 clips activations at +-127."""
    p, qp, x = jax_linear
    ascale = {"dynamic": None, "static": 0.05, "static_clipping": 0.004}[mode]
    jp = dict(qp) if ascale is None else dict(qp, ascale=jnp.float32(ascale))
    ref = np.asarray(jlinear(jp, jnp.asarray(x)))
    with torch.no_grad():
        out = port_linear(qp, ascale)(T(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    if mode == "dynamic":   # and close to the fp32 linear: int8 noise of about 1 %
        full = x @ p["kernel"] + p["bias"]
        assert np.abs(out - full).mean() < 0.02 * np.abs(full).mean()


def test_quantize_weight_matches_jax(jax_linear):
    p, qp, _ = jax_linear
    lin = Linear(48, 40)
    lin.load_state_dict({"weight": T(p["kernel"].T), "bias": T(p["bias"])})
    q, scale = quantize_weight_int8(lin.weight.detach())
    np.testing.assert_array_equal(q.numpy(), np.asarray(qp["kernel_q"]).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(qp["kscale"]))
    assert float(scale[3]) == 1.0
    m = quantize_linear_int8(lin)
    assert m.weight_q.dtype == torch.int8 and m.ascale is None and lin.weight is not None
    assert sorted(m.state_dict()) == ["bias", "kscale", "weight_q"]
    freed = quantize_linear_int8(lin, free_source=True)
    assert lin.weight is None and torch.equal(freed.weight_q, m.weight_q)


def test_int8_linear_raises_under_autograd_and_matmul_is_exact(jax_linear):
    _, qp, x = jax_linear
    m = port_linear(qp)
    # under autograd the linear no longer raises: it is a straight-through
    # estimator, dx = (g * kscale) @ W_q as a product of bf16 values (exact
    # parity with the JAX package: tests/test_torch_training.py)
    xt = T(x).requires_grad_()
    y = m(xt)
    g = torch.ones_like(y)
    (dx,) = torch.autograd.grad(y, xt, g)
    want = (g * m.kscale).to(torch.bfloat16).float() @ m.weight_q.float()
    np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(6)
    a = rng.integers(-127, 128, (5, 2000)).astype(np.int8)
    w = rng.integers(-127, 128, (7, 2000)).astype(np.int8)
    got = int8_matmul(T(a), T(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)


# -- quantize.py ---------------------------------------------------------------------------------

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
TCFG, JCFG = tcfg.TransformerConfig.tiny(**DIT_KW), jcfg.TransformerConfig.tiny(**DIT_KW)
SITES = ["to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out"]


def random_params(init, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        r = rng.standard_normal(x.shape).astype(np.float32)
        if "kernel" in name:
            return r / np.sqrt(np.prod(x.shape[:-1]))
        return 1 + 0.05 * r if "scale" in name else 0.05 * r

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def dit():
    jp = random_params(JDiT(JCFG).init, 1)
    m = CogVideoXTransformer3D(TCFG)
    m.load_state_dict(transformer_state_dict(jp))
    rng = np.random.default_rng(3)
    x = {"latent": rng.standard_normal((2, 3, 4, 6, 32)).astype(np.float32),
         "text": rng.standard_normal((2, 5, 12)).astype(np.float32), "t": np.array([999, 421]),
         "jrope": jprepare_rope(JCFG, 32, 48, 3), "trope": prepare_rope(TCFG, 32, 48, 3)}
    return jp, m, x


def jax_out(params, x, **kw):
    return JDiT(JCFG).apply(params, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                            jnp.asarray(x["t"]), rope=x["jrope"], **kw)


def port_out(m, x, **kw):
    with torch.no_grad():
        return m(T(x["latent"]), T(x["text"]), T(x["t"]), rope=x["trope"], **kw)


def test_quantize_transformer_int8_matches_jax(dit):
    """Quantizing in the port gives the JAX package's scales to the last bit
    but one (its jitted stacked path multiplies by 1 / 127 where the port
    divides by 127: rtol 2e-7) and its integers up to such a flip (at most one
    step, on under 0.1 % of the weights); the quantized DiT gives the JAX
    one's output: 1e-4 through 2 layers (exact integer products), and exactly
    so on the carried-over integers."""
    jp, m, x = dit
    jqp = jq.quantize_transformer_int8(jp)
    q = tq.quantize_transformer_int8(m)
    assert q is not m and isinstance(m.transformer_blocks[0].attn1.to_q, Linear)
    want = transformer_state_dict(jax.tree.map(np.asarray, jqp))
    got = q.state_dict()
    assert set(got) == set(want)
    for k in want:
        if k.endswith("kscale"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-7, err_msg=k)
        if k.endswith("weight_q"):
            diff = np.abs(got[k].numpy().astype(int) - want[k].numpy().astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
    assert sum(k.endswith("weight_q") for k in want) == 12
    assert tq.ascale_site_order(q) == jq.ascale_site_order(jqp["blocks"]) == SITES
    with pytest.raises(ValueError, match="site layout"):
        tq.ascale_site_order(m)
    np.testing.assert_allclose(port_out(q, x).sample.numpy(), np.asarray(jax_out(jqp, x).sample),
                               rtol=0, atol=1e-4)
    # the carried-over weights load into a plain model as int8 linears
    loaded = load_quantized(CogVideoXTransformer3D(TCFG), want)
    assert isinstance(loaded.transformer_blocks[0].ff.net[0].proj, Int8Linear)
    np.testing.assert_array_equal(loaded.state_dict()["transformer_blocks.1.attn1.to_v.weight_q"],
                                  want["transformer_blocks.1.attn1.to_v.weight_q"])
    np.testing.assert_allclose(port_out(loaded, x).sample.numpy(),
                               np.asarray(jax_out(jqp, x).sample), rtol=0, atol=1e-4)


def test_quantize_free_source_rewrites_in_place(dit):
    jp, _, x = dit
    m = CogVideoXTransformer3D(TCFG)
    m.load_state_dict(transformer_state_dict(jp))
    ref = port_out(tq.quantize_transformer_int8(m), x).sample
    same = tq.quantize_transformer_int8(m, free_source=True)
    assert same is m and isinstance(m.transformer_blocks[1].ff.net[2], Int8Linear)
    assert not any(k.endswith("attn1.to_q.weight") for k in m.state_dict())
    assert isinstance(m.proj_out, Linear) and isinstance(m.time_embedding.linear_1, Linear)
    assert torch.equal(port_out(m, x).sample, ref)


@pytest.mark.parametrize("kind", ["uniform", "per_site"])
def test_attach_static_ascale_matches_jax(dit, kind):
    jp, m, x = dit
    rng = np.random.default_rng(7)
    ascale = 0.06 if kind == "uniform" else \
        {s: rng.uniform(0.03, 0.08, 2).astype(np.float32) for s in SITES[:4]}
    jqp = jq.attach_static_ascale(jq.quantize_transformer_int8(jp), ascale)
    q = tq.attach_static_ascale(tq.quantize_transformer_int8(m), ascale)
    blk = q.transformer_blocks[1]
    if kind == "per_site":
        assert float(blk.attn1.to_k.ascale) == pytest.approx(float(ascale["to_k"][1]))
        assert blk.ff.net[2].ascale is None   # sites missing from the dict stay dynamic
    else:
        assert float(blk.ff.net[2].ascale) == pytest.approx(0.06)
    np.testing.assert_allclose(port_out(q, x).sample.numpy(), np.asarray(jax_out(jqp, x).sample),
                               rtol=0, atol=1e-4)
    # static scales carried over from the JAX tree land on the same linears
    loaded = load_quantized(CogVideoXTransformer3D(TCFG),
                            transformer_state_dict(jax.tree.map(np.asarray, jqp)))
    assert float(loaded.transformer_blocks[1].attn1.to_q.ascale) == \
        pytest.approx(float(blk.attn1.to_q.ascale))
    np.testing.assert_allclose(port_out(loaded, x).sample.numpy(),
                               np.asarray(jax_out(jqp, x).sample), rtol=0, atol=1e-4)


def test_calibrate_ascales_matches_jax(dit):
    """Per-layer per-site activation amax of the dynamic int8 linears, through
    the int8 numerics themselves: relative 1e-4 against the JAX package."""
    jp, m, x = dit
    jqp, q = jq.quantize_transformer_int8(jp), tq.quantize_transformer_int8(m)
    jargs = (jnp.asarray(x["latent"]), jnp.asarray(x["text"]), jnp.asarray(x["t"]))
    targs = (T(x["latent"]), T(x["text"]), T(x["t"]))
    ref = jq.calibrate_ascales(JDiT(JCFG), jqp, [(jargs, dict(rope=x["jrope"]))], margin=1.1)
    out = tq.calibrate_ascales(q, [(targs, dict(rope=x["trope"]))], margin=1.1)
    assert list(out) == SITES
    for s in SITES:
        assert out[s].shape == (2,) and out[s].dtype == np.float32
        np.testing.assert_allclose(out[s], ref[s], rtol=1e-4)
    assert all(lin.calib is None for lin in q.modules() if isinstance(lin, Int8Linear))
    # the guards: the plain path only, dynamic linears only, at least one sample
    with pytest.raises(ValueError, match="plain forward"):
        port_out(q, x, calibrate=True, return_hidden_states=True)
    with pytest.raises(ValueError, match="no dynamic int8 linear"):
        port_out(m, x, calibrate=True)
    with pytest.raises(ValueError, match="at least one sample"):
        tq.calibrate_ascales(q, [])
    with calibration(q.transformer_blocks[0]) as taps:
        pass
    assert taps == []


def test_calibrate_branch_matches_jax():
    jb, tb = (jcfg.BranchConfig.from_transformer(JCFG, num_layers=2),
              tcfg.BranchConfig.from_transformer(TCFG, num_layers=2))
    jp = random_params(JBranch(jb).init, 4)
    m = CogVideoXBranch(tb)
    m.load_state_dict(branch_state_dict(jp))
    rng = np.random.default_rng(8)
    noisy = rng.standard_normal((2, 3, 4, 6, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 3, 4, 6, 17)).astype(np.float32)
    text = rng.standard_normal((2, 5, 12)).astype(np.float32)
    t = np.array([999, 421])
    jqp, q = jq.quantize_transformer_int8(jp), tq.quantize_transformer_int8(m)
    ref = jq.calibrate_ascales(JBranch(jb), jqp, [((jnp.asarray(noisy), jnp.asarray(text),
                                                    jnp.asarray(cond), jnp.asarray(t)), {})])
    out = tq.calibrate_ascales(q, [((T(noisy), T(text), T(cond), T(t)), {})])
    for s in SITES:
        np.testing.assert_allclose(out[s], ref[s], rtol=1e-4)
    with torch.no_grad():
        feats, amax = q(T(noisy), T(text), T(cond), T(t), calibrate=True)
    assert feats.shape == (2, 2, 18, 32) and amax.shape == (2, 6)


def test_load_ascales_reads_the_repository_file(tmp_path):
    """`calib_ascales.npz` at the root: the same content as the JAX package
    reads, 42 DiT layers and 2 branch layers per site; and the round trip."""
    path = str(REPO / "calib_ascales.npz")
    out, prov = tq.load_ascales(path, return_provenance=True)
    ref, jprov = jq.load_ascales(path, return_provenance=True)
    assert prov == jprov and prov is not None
    assert set(out) == set(ref) == {"transformer", "branch"}
    for model, n in (("transformer", 42), ("branch", 2)):
        assert sorted(out[model]) == sorted(SITES)
        for s in SITES:
            assert out[model][s].shape == (n,)
            np.testing.assert_array_equal(out[model][s], ref[model][s])
    dst = str(tmp_path / "scales.npz")
    tq.save_ascales(dst, {"branch": out["branch"]}, provenance={"margin": 1.0})
    back, p2 = jq.load_ascales(dst, return_provenance=True)
    assert p2 == {"margin": 1.0}
    np.testing.assert_array_equal(back["branch"]["to_q"], out["branch"]["to_q"])
    with pytest.raises(ValueError, match="no scales"):
        tq.save_ascales(dst, {})
    # the file's branch scales attach to a 2-layer quantized branch
    tb = tcfg.BranchConfig.from_transformer(TCFG, num_layers=2)
    q = tq.attach_static_ascale(tq.quantize_transformer_int8(CogVideoXBranch(tb)), out["branch"])
    assert float(q.transformer_blocks[1].ff.net[0].proj.ascale) == \
        pytest.approx(float(out["branch"]["proj_in"][1]))


# -- on the card ---------------------------------------------------------------------------------

@pytest.mark.cuda
def test_int8_flash_kernel_matches_reference_on_the_card():
    """The CUDA kernel has no CPU mode: on a card, hold it to its plain version
    (`int8`: 2^-6 of the largest output, two bf16 ulps; `int8pv`: 3 % relative
    L1, the P-rounding noise between tile and block running maxima)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    q, k, v = (T(a).cuda().to(torch.bfloat16) for a in qkv(300, 700))
    for pv in (False, True):
        out = flash_attention_int8(q, k, v, blk_q=128, blk_k=128, int8_pv=pv, kv_len=513).float()
        ref = flash_attention_int8_reference(q, k, v, blk_q=128, blk_k=128, int8_pv=pv,
                                             kv_len=513).float()
        if pv:
            assert (out - ref).abs().mean() <= 0.03 * ref.abs().mean()
        else:
            assert (out - ref).abs().max() <= 2.0 ** -6 * ref.abs().max()
