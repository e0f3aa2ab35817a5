"""Parity of the port's any-length slice (videopainter_tpu_torch) with the JAX
package, on the CPU in float32: the attention variants in every `use_flash`
mode, the DiT with previous-window states and captures, LoRA, the compressed
capture's indices, and the tiny any-length pipeline end to end (against the
JAX pipeline and against the torch reference's goldens).

Weights are random numpy arrays carried over by convert/from_jax.py; inputs
come from a numpy seed. On the CPU the port's flash wrappers run their plain
versions; the JAX side runs its Pallas kernels in interpret mode, as its own
tests do. Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videopainter_tpu.config as jcfg
import videopainter_tpu_torch.config as tcfg
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.models import lora as jlora
from videopainter_tpu.ops.attention import joint_attention as jjoint_attention
from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintAnyLPipeline as JAnyL
from videopainter_tpu.pipelines.common import capture_token_indices as jcapture_token_indices
from videopainter_tpu.pipelines.common import prepare_rope as jprepare_rope
from videopainter_tpu.quantize import quantize_transformer_int8 as jquantize
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu_torch.convert import (branch_state_dict, captured_state, load_quantized,
                                            lora_params, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.models import lora as tlora
from videopainter_tpu_torch.ops.attention import Attention, joint_attention
from videopainter_tpu_torch.pipelines import (CogVideoXI2VDualInpaintAnyLPipeline,
                                              capture_token_indices, prepare_rope)
from videopainter_tpu_torch.quantize import quantize_transformer_int8
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

torch.set_num_threads(2)

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
RS_KW = dict(DIT_KW, id_pool_resample_learnable=True)


def random_params(init, seed):
    """Random numpy weights in the tree structure `init` builds (traced
    abstractly): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2),
    biases N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        r = rng.standard_normal(x.shape).astype(np.float32)
        if "kernel" in name:
            return r / np.sqrt(np.prod(x.shape[:-1]))
        if "scale" in name:
            return 1 + 0.05 * r
        return 0.05 * r

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init, jax.random.PRNGKey(0)))


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def close(a, b, tol):
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def jax_call(fn, *args, **kw):
    """Run a JAX function that may reach a Pallas kernel, as the JAX package's
    own tests do: in interpret mode on the CPU. The call is made as one jitted
    program and its results are fetched at once: an interpret-mode kernel
    runs host callbacks, and an eager JAX op dispatched from this thread
    while they run can block with the interpreter lock held."""
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, jax.jit(lambda: fn(*args, **kw))())


def tree_t(x):
    """numpy / jax (dicts of) arrays -> torch."""
    return {k: tree_t(v) for k, v in x.items()} if isinstance(x, dict) else T(x)


# -- attention variants x use_flash ---------------------------------------------------

@pytest.fixture(scope="module")
def attn():
    """One attention layer at the kernel's head dim (2 heads x 64)."""
    rng = np.random.default_rng(0)
    lin = lambda: {"kernel": (rng.standard_normal((128, 128)) / np.sqrt(128)).astype(np.float32),
                   "bias": (0.05 * rng.standard_normal(128)).astype(np.float32)}
    norm = lambda: {"scale": (1 + 0.05 * rng.standard_normal(64)).astype(np.float32),
                    "bias": (0.05 * rng.standard_normal(64)).astype(np.float32)}
    p = {"to_q": lin(), "to_k": lin(), "to_v": lin(), "to_out": lin(),
         "norm_q": norm(), "norm_k": norm()}
    m = Attention(128, num_heads=2)
    sd = {}
    for name, port in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                       ("to_out", "to_out.0")):
        sd[f"{port}.weight"], sd[f"{port}.bias"] = T(p[name]["kernel"].T), T(p[name]["bias"])
    for name in ("norm_q", "norm_k"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = T(p[name]["scale"]), T(p[name]["bias"])
    m.load_state_dict(sd)
    x = {"h": rng.standard_normal((2, 24, 128)).astype(np.float32),
         "e": rng.standard_normal((2, 5, 128)).astype(np.float32),
         "mask": rng.random((2, 29)) > 0.5,
         "prev": rng.standard_normal((2, 29, 128)).astype(np.float32),
         "pmask": rng.random((2, 29)) > 0.5,
         "rope": jprepare_rope(jcfg.TransformerConfig.tiny(attention_head_dim=64), 32, 48, 4)}
    return p, m, x


VARIANTS = {
    "base": lambda x: {},
    "wo_text": lambda x: {},
    "resample": lambda x: dict(resample_mask=x["mask"]),
    "prev_blend": lambda x: dict(prev_hidden_states=x["prev"], prev_clip_weight=0.3),
    "prev_resample": lambda x: dict(prev_hidden_states=x["prev"], prev_clip_weight=0.4,
                                    prev_resample_mask=x["pmask"]),
}
# Same fp32 arithmetic in another order: 1e-5. "int8pv" rounds P * 127 to an
# integer, and a one-ulp difference in exp between the two frameworks may flip
# a rounding: one flip moves an output by about |v| / (127 * row sum), 2e-3 here.
ATTN_TOL = {False: 1e-5, True: 1e-5, "int8": 1e-5, "int8pv": 2e-3}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("use_flash", [False, True, "int8", "int8pv"])
def test_attention_variant_matches_jax(attn, use_flash, variant):
    p, m, x = attn
    kw = VARIANTS[variant](x)
    wo_text = variant == "wo_text"
    # wo_text ropes the whole (video-only) sequence: 24 positions = a 4x2x3 grid
    rope = x["rope"] if not wo_text else None
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref_h, ref_e = jax_call(jjoint_attention, p, jnp.asarray(x["h"]),
                            None if wo_text else jnp.asarray(x["e"]),
                            num_heads=2, rope=rope, use_flash=use_flash, **jkw)
    with torch.no_grad():
        out_h, out_e = joint_attention(m, T(x["h"]), None if wo_text else T(x["e"]),
                                       rope=None if rope is None else tuple(map(T, rope)),
                                       use_flash=use_flash, **tkw)
    close(out_h, ref_h, ATTN_TOL[use_flash])
    if wo_text:
        assert out_e is None and ref_e is None
    else:
        close(out_e, ref_e, ATTN_TOL[use_flash])


def test_attention_rejects_unknown_flash_mode(attn):
    _, m, x = attn
    with pytest.raises(ValueError, match="use_flash"):
        joint_attention(m, T(x["h"]), T(x["e"]), use_flash="fp8")


# -- DiT: resample, previous-window states, captures --------------------------------

TCFG, JCFG = tcfg.TransformerConfig.tiny(**RS_KW), jcfg.TransformerConfig.tiny(**RS_KW)


@pytest.fixture(scope="module")
def dit():
    jp = random_params(JDiT(JCFG).init, 1)
    m = CogVideoXTransformer3D(TCFG)
    m.load_state_dict(transformer_state_dict(jp))
    rng = np.random.default_rng(3)
    b, t, h, w = 2, 3, 4, 6
    mask = np.zeros((b, t, h, w), np.float32)
    mask[0, :, 1:3, 2:5] = 1
    mask[1, 1:, :2, :3] = 1
    x = {"latent": rng.standard_normal((b, t, h, w, 32)).astype(np.float32),
         "text": rng.standard_normal((b, 5, 12)).astype(np.float32),
         "t": np.array([999, 421]), "mask": mask,
         "branch": rng.standard_normal((2, b, t * (h // 2) * (w // 2), 32)).astype(np.float32),
         "jrope": jprepare_rope(JCFG, h * 8, w * 8, t), "trope": prepare_rope(TCFG, h * 8, w * 8, t)}
    return jp, m, x


def run_both(dit, jkw, tkw, use_flash=True):
    """The JAX DiT runs without its resident padded sequence (a Mosaic
    workaround the port has no use for), so both see the same keys."""
    jp, m, x = dit
    ref = jax_call(JDiT(JCFG).apply, jp, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                   jnp.asarray(x["t"]), rope=x["jrope"],
                   branch_block_samples=jnp.asarray(x["branch"]),
                   branch_block_masks=jnp.asarray(x["mask"]),
                   use_flash=use_flash, resident=False, **jkw)
    with torch.no_grad():
        out = m(T(x["latent"]), T(x["text"]), T(x["t"]), rope=x["trope"],
                branch_block_samples=T(x["branch"]), branch_block_masks=T(x["mask"]),
                use_flash=use_flash, **tkw)
    return ref, out


@pytest.fixture(scope="module")
def captures(dit):
    """The JAX DiT's captures in the three forms, as the next window's input."""
    jp, _, x = dit
    idx = np.asarray(jcapture_token_indices(jnp.asarray(x["mask"]), 2, 5, bucket=4))
    out = {}
    for form, kw in (("full", {}), ("compressed", dict(capture_indices=jnp.asarray(idx))),
                     ("int8", dict(capture_indices=jnp.asarray(idx), capture_quant=True))):
        o = JDiT(JCFG).apply(jp, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                             jnp.asarray(x["t"]), rope=x["jrope"],
                             branch_block_samples=jnp.asarray(x["branch"]),
                             branch_block_masks=jnp.asarray(x["mask"]),
                             id_pool_resample=True, return_hidden_states=True, **kw)
        out[form] = (jax.tree.map(np.asarray, o.hidden_states_list), np.asarray(o.resample_mask))
    return idx, out


@pytest.mark.parametrize("form", ["full", "compressed", "int8"])
def test_dit_captures_match_jax(dit, captures, form):
    """Captured states through 2 layers: 1e-4 on the fp32 forms; the int8 form
    dequantized (one int8 step of a state is its scale, up to 4e-2 here, so a
    flipped rounding is allowed for: values within 1 step, dequantized 5e-2).
    Pad slots (index S_joint) hold whatever token the clamp reaches, which the
    consumer's scatter drops: only real slots are compared."""
    idx, caps = captures
    real = idx < 5 + 18   # [B, M]
    kw = {} if form == "full" else dict(capture_indices=idx)
    if form == "int8":
        kw["capture_quant"] = True
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    ref, out = run_both(dit, dict(id_pool_resample=True, return_hidden_states=True, **jkw),
                        dict(id_pool_resample=True, return_hidden_states=True, **tkw))
    close(out.sample, ref.sample, 1e-4)
    np.testing.assert_array_equal(out.resample_mask.numpy(), np.asarray(ref.resample_mask))
    if form == "int8":
        hs, rs = out.hidden_states_list, ref.hidden_states_list
        assert hs["values"].dtype == torch.int8 and hs["values"].shape == rs["values"].shape
        ov, rv = hs["values"].numpy()[:, real], np.asarray(rs["values"])[:, real]
        osc, rsc = hs["scales"].numpy()[:, real], np.asarray(rs["scales"])[:, real]
        close(osc, rsc, 1e-5)
        assert np.abs(ov.astype(int) - rv.astype(int)).max() <= 1
        close(ov * osc[..., None], rv * rsc[..., None], 5e-2)
    elif form == "compressed":
        assert out.hidden_states_list.shape == ref.hidden_states_list.shape
        close(out.hidden_states_list.numpy()[:, real],
              np.asarray(ref.hidden_states_list)[:, real], 1e-4)
    else:
        assert out.hidden_states_list.shape == ref.hidden_states_list.shape
        close(out.hidden_states_list, ref.hidden_states_list, 1e-4)


@pytest.mark.parametrize("use_flash", [False, True, "int8"])
@pytest.mark.parametrize("form", ["full", "compressed", "int8"])
def test_dit_prev_states_match_jax(dit, captures, form, use_flash):
    """Previous-window states in all three forms feed the resample attention:
    1e-4 through 2 layers (the int8 form is dequantized from the same
    integers on both sides)."""
    idx, caps = captures
    hs, rmask = caps[form]
    kw = dict(prev_hidden_states=hs, prev_clip_weight=0.3, prev_resample_mask=rmask,
              id_pool_resample=True)
    if form != "full":
        kw["prev_hidden_indices"] = idx
    to_j = lambda v: jax.tree.map(jnp.asarray, v) if isinstance(v, (dict, np.ndarray)) else v
    to_t = lambda v: tree_t(v) if isinstance(v, (dict, np.ndarray)) else v
    ref, out = run_both(dit, {k: to_j(v) for k, v in kw.items()},
                        {k: to_t(v) for k, v in kw.items()}, use_flash=use_flash)
    close(out.sample, ref.sample, 1e-4)


def test_dit_prev_blend_matches_jax():
    """A model without the learnable resample takes the base processor's
    two-call blend on full previous states."""
    jc, tc = jcfg.TransformerConfig.tiny(**DIT_KW), tcfg.TransformerConfig.tiny(**DIT_KW)
    jp = random_params(JDiT(jc).init, 5)
    m = CogVideoXTransformer3D(tc)
    m.load_state_dict(transformer_state_dict(jp))
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, 3, 4, 6, 32)).astype(np.float32)
    text = rng.standard_normal((1, 5, 12)).astype(np.float32)
    prev = rng.standard_normal((2, 1, 23, 32)).astype(np.float32)
    ref = JDiT(jc).apply(jp, jnp.asarray(lat), jnp.asarray(text), jnp.asarray([500]),
                         rope=jprepare_rope(jc, 32, 48, 3), prev_hidden_states=jnp.asarray(prev),
                         prev_clip_weight=0.3).sample
    with torch.no_grad():
        out = m(T(lat), T(text), T(np.array([500])), rope=prepare_rope(tc, 32, 48, 3),
                prev_hidden_states=T(prev), prev_clip_weight=0.3, use_flash=True).sample
    close(out, ref, 1e-4)
    with pytest.raises(ValueError, match="ID-resample"):
        m(T(lat), T(text), T(np.array([500])), prev_hidden_states=T(prev[:, :, :4]),
          prev_clip_weight=0.3, prev_hidden_indices=torch.zeros((1, 4), dtype=torch.int32))


def test_captured_state_converter(captures):
    _, caps = captures
    assert captured_state(caps["full"][0]).shape == caps["full"][0].shape
    q = captured_state(caps["int8"][0])
    assert q["values"].dtype == torch.int8 and q["scales"].dtype == torch.float32


def test_capture_token_indices_match_jax(dit):
    _, _, x = dit
    for bucket in (4, 7, 2048):
        ref = np.asarray(jcapture_token_indices(jnp.asarray(x["mask"]), 2, 5, bucket=bucket))
        out = capture_token_indices(T(x["mask"]), 2, 5, bucket=bucket)
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("use_flash", [False, True])
def test_wo_text_branch_matches_jax(use_flash):
    jt, tt = jcfg.TransformerConfig.tiny(**DIT_KW), tcfg.TransformerConfig.tiny(**DIT_KW)
    jb = jcfg.BranchConfig.from_transformer(jt, num_layers=2, wo_text=True)
    tb = tcfg.BranchConfig.from_transformer(tt, num_layers=2, wo_text=True)
    jp = random_params(JBranch(jb).init, 4)
    m = CogVideoXBranch(tb)
    m.load_state_dict(branch_state_dict(jp))
    rng = np.random.default_rng(8)
    noisy = rng.standard_normal((2, 3, 4, 6, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 3, 4, 6, 17)).astype(np.float32)
    text = rng.standard_normal((2, 5, 12)).astype(np.float32)
    t = np.array([999, 421])
    ref = jax_call(JBranch(jb).apply, jp, jnp.asarray(noisy), jnp.asarray(text),
                   jnp.asarray(cond), jnp.asarray(t), rope=jprepare_rope(jt, 32, 48, 3),
                   conditioning_scale=0.7, use_flash=use_flash)
    with torch.no_grad():
        out = m(T(noisy), T(text), T(cond), T(t), rope=prepare_rope(tt, 32, 48, 3),
                conditioning_scale=0.7, use_flash=use_flash)
    close(out, ref, 1e-4)


# -- LoRA ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lora(dit):
    jp, _, _ = dit
    rng = np.random.default_rng(9)
    tree = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.PRNGKey(1), jp, rank=4))
    for ab in tree.values():   # a non-zero B, or the adapter is the identity
        ab["lora_B"] = (0.1 * rng.standard_normal(ab["lora_B"].shape)).astype(np.float32)
    return tree


def fresh_dit(jp):
    m = CogVideoXTransformer3D(TCFG)
    m.load_state_dict(transformer_state_dict(jp))
    return m


def dit_out(m, x, **kw):
    with torch.no_grad():
        return m(T(x["latent"]), T(x["text"]), T(x["t"]), rope=x["trope"], **kw).sample


def test_lora_merge_matches_jax(dit, lora):
    jp, _, x = dit
    merged = jlora.merge_lora(jp, jax.tree.map(jnp.asarray, lora), alpha=2.0, rank=4)
    want = transformer_state_dict(jax.tree.map(np.asarray, merged))
    m = tlora.merge_lora(fresh_dit(jp), lora_params(lora), alpha=2.0, rank=4)
    for k, v in m.state_dict().items():
        close(v, want[k], 1e-6)   # W + factor * A B, the same fp32 product


@pytest.mark.parametrize("int8", [False, True])
def test_lora_attach_matches_jax(dit, lora, int8):
    """The attached adapter against the JAX package's, on the plain and on
    the int8-quantized backbone (the same quantized weights, carried over):
    1e-4 through 2 layers."""
    jp, _, x = dit
    base = jquantize(jp) if int8 else jp
    jparams = jlora.attach_lora(base, jax.tree.map(jnp.asarray, lora), alpha=2.0, rank=4)
    ref = JDiT(JCFG).apply(jparams, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                           jnp.asarray(x["t"]), rope=x["jrope"]).sample
    m = CogVideoXTransformer3D(TCFG)
    if int8:
        load_quantized(m, transformer_state_dict(jax.tree.map(np.asarray, base)))
    else:
        m.load_state_dict(transformer_state_dict(jp))
    tlora.attach_lora(m, lora_params(lora), alpha=2.0, rank=4)
    close(dit_out(m, x), ref, 1e-4)
    if not int8:   # attach == merge on the plain backbone
        merged = tlora.merge_lora(fresh_dit(jp), lora_params(lora), alpha=2.0, rank=4)
        close(dit_out(m, x), dit_out(merged, x), 1e-5)


def test_lora_init_and_peft_round_trip(dit):
    jp, m, _ = dit
    fresh = tlora.init_lora_params(torch.Generator().manual_seed(0), m, rank=4)
    assert set(fresh) == set(tlora.LORA_TARGETS)
    assert fresh["to_q"]["lora_A"].shape == (2, 32, 4)
    assert fresh["to_q"]["lora_A"].abs().max() <= 32 ** -0.5
    assert not fresh["to_out"]["lora_B"].any()
    q = quantize_transformer_int8(m)   # a copy; shapes come from the int8 linears
    assert tlora.init_lora_params(None, q, rank=4)["to_v"]["lora_B"].shape == (2, 4, 32)
    rng = np.random.default_rng(2)
    tree = {t: {"lora_A": T(rng.standard_normal((2, 32, 4)).astype(np.float32)),
                "lora_B": T(rng.standard_normal((2, 4, 32)).astype(np.float32))}
            for t in tlora.LORA_TARGETS}
    sd = tlora.export_peft_lora_state_dict(tree)
    ref = jlora.export_peft_lora_state_dict(jax.tree.map(lambda v: v.numpy(), tree))
    assert set(sd) == set(ref) and "transformer.transformer_blocks.1.attn1.to_out.0.lora_B.weight" in sd
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k])
    back = tlora.convert_peft_lora_state_dict(sd, num_layers=2, rank=4)
    for t in tree:
        for k in ("lora_A", "lora_B"):
            np.testing.assert_array_equal(back[t][k].numpy(), tree[t][k].numpy())
    with pytest.raises(KeyError, match="layer 2"):
        tlora.convert_peft_lora_state_dict(sd, num_layers=3, rank=4)


# -- the any-length pipeline -------------------------------------------------------------

STEPS = 2


@pytest.fixture(scope="module")
def stacks():
    """Tiny JAX and port pipelines on the same weights, with and without the
    learnable ID resample."""
    jv, tv = jcfg.VAEConfig.tiny(latent_channels=16), tcfg.VAEConfig.tiny(latent_channels=16)
    jb = jcfg.BranchConfig.from_transformer(jcfg.TransformerConfig.tiny(**DIT_KW))
    tb = tcfg.BranchConfig.from_transformer(tcfg.TransformerConfig.tiny(**DIT_KW))
    params = {"transformer": random_params(JDiT(JCFG).init, 11),
              "branch": random_params(JBranch(jb).init, 12),
              "vae": random_params(JVAE(jv).init, 13)}
    out = {}
    for learnable in (True, False):
        kw = RS_KW if learnable else DIT_KW
        jpipe = JAnyL(JDiT(jcfg.TransformerConfig.tiny(**kw)), JBranch(jb), JVAE(jv),
                      JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()))
        models = (CogVideoXTransformer3D(tcfg.TransformerConfig.tiny(**kw)), CogVideoXBranch(tb),
                  AutoencoderKLCogVideoX(tv))
        for mod, sd in zip(models, (transformer_state_dict(params["transformer"]),
                                    branch_state_dict(params["branch"]),
                                    vae_state_dict(params["vae"]))):
            mod.load_state_dict(sd)
        port = CogVideoXI2VDualInpaintAnyLPipeline(
            *models, CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference()),
            device="cpu")
        out[learnable] = (jpipe, port)
    return params, out


def anyl_inputs(seed, windows=2):
    rng = np.random.default_rng(seed)
    frames = 9 + 4 * (windows - 1)
    video = rng.uniform(-1, 1, (1, frames, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, frames, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    return {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
            "embeds": rng.standard_normal((1, 5, 12)).astype(np.float32),
            "init": [rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32)
                     for _ in range(windows)],
            "dpm": [rng.standard_normal((STEPS, 1, 3, 8, 12, 16)).astype(np.float32)
                    for _ in range(windows)]}


ANYL = dict(num_frames=9, stride=4, num_inference_steps=STEPS, guidance_scale=6.0,
            use_dynamic_cfg=True, prev_clip_weight=0.3, replace_gt=True, mask_add=True,
            vae_sample_mode="mode")


def run_port_anyl(pipe, x, **kw):
    return pipe(video=T(x["video"]), masks=T(x["masks"]), image=T(x["image"]),
                prompt_embeds=T(x["embeds"]), negative_prompt_embeds=torch.zeros_like(T(x["embeds"])),
                init_noises=[T(n) for n in x["init"]], dpm_noises_list=[T(n) for n in x["dpm"]],
                **{**ANYL, **kw})


def run_jax_anyl(pipe, params, x, **kw):
    return np.asarray(pipe(params, video=jnp.asarray(x["video"]), masks=jnp.asarray(x["masks"]),
                           image=jnp.asarray(x["image"]), prompt_embeds=jnp.asarray(x["embeds"]),
                           negative_prompt_embeds=jnp.zeros_like(jnp.asarray(x["embeds"])),
                           init_noises=[jnp.asarray(n) for n in x["init"]],
                           dpm_noises_list=[jnp.asarray(n) for n in x["dpm"]],
                           rng=jax.random.PRNGKey(0), scan_chunk=0, **{**ANYL, **kw}))


@pytest.mark.parametrize("variant", ["id_resample", "id_resample_sequential_cfg",
                                     "id_resample_int8_capture", "prev_clip_blend"])
def test_port_anyl_matches_jax(stacks, variant):
    """Two windows, 2 DPM steps, CFG: the port (its flash wrapper's plain
    version) against the JAX pipeline (exact attention), both fp32. 1e-4 on
    outputs in [-1, 1], the single-clip test's limit; the int8 capture stores
    the same integers on both sides unless a rounding flips, so it keeps it."""
    params, pipes = stacks
    learnable = variant != "prev_clip_blend"
    jpipe, port = pipes[learnable]
    kw = {"id_pool_resample": True, "compress_capture": 4} if learnable else {}
    if variant == "id_resample_sequential_cfg":
        kw["sequential_cfg"] = True
    if variant == "id_resample_int8_capture":
        kw["capture_int8"] = True
    x = anyl_inputs(31)
    ref = run_jax_anyl(jpipe, params, x, **kw)
    out = run_port_anyl(port, x, use_flash=True, **kw)
    assert out.shape == ref.shape and out.shape[2:] == (64, 96, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_port_anyl_compressed_capture_is_exact(stacks):
    """Only masked-region tokens pass the previous window's resample mask, so
    the compressed capture gives bit-equal latents; the int8 capture stays
    close (a state's int8 step is under 1% of it) and options are checked."""
    _, pipes = stacks
    _, port = pipes[True]
    x = anyl_inputs(32)
    kw = dict(id_pool_resample=True, use_flash=True, output_type="latent")
    full = run_port_anyl(port, x, compress_capture=None, **kw)
    comp = run_port_anyl(port, x, compress_capture=4, **kw)
    assert full.shape == (1, 4, 8, 12, 16)
    assert torch.equal(full, comp)
    q = run_port_anyl(port, x, compress_capture=4, capture_int8=True, **kw)
    assert not torch.equal(q, comp) and (q - comp).abs().max() < 5e-2
    with pytest.raises(NotImplementedError, match="stream_decode"):
        run_port_anyl(port, x, stream_decode=True, **kw)
    with pytest.raises(ValueError, match="capture"):
        run_port_anyl(port, x, skip_steps=(STEPS - 1,), **kw)
    with pytest.raises(ValueError, match="stride"):
        run_port_anyl(port, x, **{**kw, "stride": 5})


@pytest.mark.parametrize("name", ["anyl", "anyl_rs"])
def test_port_anyl_matches_torch_golden(goldens, name):
    """Three windows, 4 steps against the torch reference's recorded outputs,
    at the JAX golden test's bounds: atol 3e-3, mean error < 3e-4, and for
    the plain any-length run PSNR >= 35 dB."""
    g = goldens("pipeline")

    def sd(part):
        pre = f"sd::{part}::"
        return {k[len(pre):]: T(g[k]) for k in g.files if k.startswith(pre)}

    kw = RS_KW if name == "anyl_rs" else DIT_KW
    t = tcfg.TransformerConfig.tiny(**kw)
    models = (CogVideoXTransformer3D(t), CogVideoXBranch(tcfg.BranchConfig.from_transformer(t)),
              AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16)))
    for mod, part in zip(models, ("transformer", "branch", "vae")):
        mod.load_state_dict(sd(part))
    pipe = CogVideoXI2VDualInpaintAnyLPipeline(
        *models, CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference()),
        device="cpu")
    lat = lambda a: np.ascontiguousarray(np.transpose(a, (0, 1, 3, 4, 2)), np.float32)
    # the reference draws SDE noise twice on middle steps and uses the second
    inits, dpms, c = [], [], 0
    for _ in range(3):
        inits.append(T(lat(g[f"noise::{name}::{c}"])))
        used, c = [], c + 1
        for i in range(4):
            c += 0 if i in (0, 3) else 1
            used.append(lat(g[f"noise::{name}::{c}"]))
            c += 1
        dpms.append(T(np.stack(used)))
    assert c == int(g[f"io::{name}::n_noises"])
    f32 = lambda a: T(np.ascontiguousarray(a, np.float32))
    embeds = f32(g["io::embeds"])
    out = pipe(video=f32(g["io::video2"] * 2 - 1), masks=f32(g["io::masks2"]),
               image=f32(g["io::image2"] * 2 - 1), prompt_embeds=embeds,
               negative_prompt_embeds=torch.zeros_like(embeds), init_noises=inits,
               dpm_noises_list=dpms, use_flash=True, id_pool_resample=(name == "anyl_rs"),
               **{**ANYL, "num_inference_steps": 4})
    out01, ref = out / 2 + 0.5, g[f"io::{name}::out"][None]
    np.testing.assert_allclose(out01, ref, rtol=0, atol=3e-3)
    assert np.abs(out01 - ref).mean() < 3e-4
    if name == "anyl":
        psnr = 10 * np.log10(1.0 / max(np.square(out01 - ref).mean(), 1e-12))
        assert psnr >= 35.0, f"PSNR vs torch reference {psnr:.1f} dB < 35"
