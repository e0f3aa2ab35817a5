"""Module parity: each of the port's modules (videopainter_tpu_torch) against
its JAX counterpart on the same weights and inputs, on the CPU in float32.

Weights are random numpy arrays in the tree structure of the JAX package's
`init` (with non-trivial biases and norm scales) and reach the port through
videopainter_tpu_torch/convert/from_jax.py; inputs are made from a numpy
seed. Tolerances: 1e-5 where both sides do the same fp32 arithmetic in
another order, 1e-4 through a whole model (two layers, reassociated sums).
The DPM scheduler is also held to tests/goldens/schedulers.npz at the JAX
test's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videopainter_tpu.config as jcfg
import videopainter_tpu_torch as vp
import videopainter_tpu_torch.config as tcfg
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.models.dit import dit_block as jdit_block
from videopainter_tpu.ops.embeddings import timestep_embedding as jtimestep_embedding
from videopainter_tpu.ops.patch_embed import patch_embed as jpatch_embed
from videopainter_tpu.ops.rope import apply_rotary_emb as japply_rope
from videopainter_tpu.pipelines.common import prepare_rope as jprepare_rope
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.ops.embeddings import timestep_embedding
from videopainter_tpu_torch.ops.rope import apply_rotary_emb
from videopainter_tpu_torch.pipelines.common import prepare_rope
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler, make_timesteps

vp.set_numerics(conv_tf32=False)  # full fp32 (no effect on CPU)

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
TCFG = tcfg.TransformerConfig.tiny(**DIT_KW)
JCFG = jcfg.TransformerConfig.tiny(**DIT_KW)
B_T, B_J = (tcfg.BranchConfig.from_transformer(TCFG, num_layers=2),
            jcfg.BranchConfig.from_transformer(JCFG, num_layers=2))


def random_params(init, seed):
    """Random numpy weights in the tree structure `init` builds (traced
    abstractly, not run): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2),
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


@pytest.fixture(scope="module")
def dit():
    jp = random_params(JDiT(JCFG).init, 1)
    m = CogVideoXTransformer3D(TCFG)
    m.load_state_dict(transformer_state_dict(jp))
    return jp, m


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    b, t, h, w = 2, 3, 4, 6
    return {
        "latent": rng.standard_normal((b, t, h, w, 32)).astype(np.float32),
        "noisy": rng.standard_normal((b, t, h, w, 16)).astype(np.float32),
        "cond": rng.standard_normal((b, t, h, w, 17)).astype(np.float32),
        "text": rng.standard_normal((b, 5, 12)).astype(np.float32),
        "t": np.array([999, 421]),
        "mask": (rng.random((b, t, h, w)) > 0.6).astype(np.float32),
        "branch": rng.standard_normal((2, b, t * (h // 2) * (w // 2), 32)).astype(np.float32),
        "jrope": jprepare_rope(JCFG, h * 8, w * 8, t),
        "trope": prepare_rope(TCFG, h * 8, w * 8, t),
    }


# -- schedulers ---------------------------------------------------------------

def test_dpm_trajectory_matches_golden(goldens):
    g = goldens("schedulers")
    sched = CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference())
    coeffs = sched.precompute(10)
    np.testing.assert_array_equal(coeffs.timesteps, g["dpm_timesteps_10"])
    x = torch.from_numpy(g["dpm_x_in"].astype(np.float32))
    old_x0 = None
    for i in range(10):
        mo = torch.from_numpy(g["dpm_model_outputs"][i].astype(np.float32))
        eps = torch.from_numpy(g["dpm_noises"][i].astype(np.float32))
        x, x0 = sched.step(coeffs, i, mo, old_x0, x, noise=eps)
        np.testing.assert_allclose(x0.numpy(), g["dpm_x0s"][i], rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(x.numpy(), g["dpm_trajectory"][i], rtol=3e-4, atol=3e-4)
        old_x0 = x0


@pytest.mark.parametrize("spacing", ["linspace", "leading", "trailing"])
def test_schedule_matches_golden(goldens, spacing):
    g = goldens("schedulers")
    cfg = tcfg.SchedulerConfig.cogvideox_5b_inference(timestep_spacing=spacing)
    np.testing.assert_allclose(CogVideoXDPMScheduler(cfg).alphas_cumprod, g["alphas_cumprod"],
                               rtol=1e-12, atol=1e-12)
    for n in (50, 30):
        np.testing.assert_array_equal(make_timesteps(cfg, n), g[f"timesteps_{spacing}_{n}"])


def test_dpm_coefficients_match_jax():
    cfg = tcfg.SchedulerConfig.cogvideox_5b_inference()
    ours = CogVideoXDPMScheduler(cfg).precompute(50)
    ref = JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()).precompute(50)
    for name in ours._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ours, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)


# -- ops ------------------------------------------------------------------------

def test_rope_matches_jax(inputs):
    jc, js = inputs["jrope"]
    tc, ts = inputs["trope"]
    close(tc, jc, 0)
    close(ts, js, 0)
    x = np.random.default_rng(5).standard_normal((2, 2, tc.shape[0], 16)).astype(np.float32)
    ref = japply_rope(jnp.asarray(x), jc, js)
    close(apply_rotary_emb(T(x), tc, ts), ref, 1e-6)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 421, 999])
    close(timestep_embedding(T(t), 32), jtimestep_embedding(jnp.asarray(t), 32), 1e-5)


def test_patch_embed_matches_jax(dit, inputs):
    jp, m = dit
    ref, ref_mask = jpatch_embed(jp["patch_embed"], jnp.asarray(inputs["text"]),
                                 jnp.asarray(inputs["latent"]), patch_size=2,
                                 masks=jnp.asarray(inputs["mask"]))
    out, mask = m.patch_embed(T(inputs["text"]), T(inputs["latent"]), masks=T(inputs["mask"]))
    close(out, ref, 1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("use_flash", [False, True])
def test_dit_block_matches_jax(dit, inputs, use_flash):
    jp, m = dit
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 18, 32)).astype(np.float32)
    e = rng.standard_normal((2, 5, 32)).astype(np.float32)
    temb = rng.standard_normal((2, 16)).astype(np.float32)
    bp = jax.tree.map(lambda x: x[0], jp["blocks"])
    rh, re = jdit_block(bp, jnp.asarray(h), jnp.asarray(e), jnp.asarray(temb),
                        inputs["jrope"], num_heads=2)
    oh, oe = m.transformer_blocks[0](T(h), T(e), T(temb), inputs["trope"], use_flash=use_flash)
    close(oh, rh, 1e-5)
    close(oe, re, 1e-5)


# -- models ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["base", "branch_mask_add", "branch_add_first"])
def test_transformer_matches_jax(dit, inputs, variant):
    jp, m = dit
    kw_j, kw_t = {}, {}
    if variant != "base":
        kw_j["branch_block_samples"] = jnp.asarray(inputs["branch"])
        kw_t["branch_block_samples"] = T(inputs["branch"])
    if variant == "branch_mask_add":
        kw_j["branch_block_masks"] = jnp.asarray(inputs["mask"])
        kw_t["branch_block_masks"] = T(inputs["mask"])
    if variant == "branch_add_first":
        kw_j["add_first"] = kw_t["add_first"] = True
    ref = JDiT(JCFG).apply(jp, jnp.asarray(inputs["latent"]), jnp.asarray(inputs["text"]),
                           jnp.asarray(inputs["t"]), rope=inputs["jrope"], **kw_j).sample
    out = m(T(inputs["latent"]), T(inputs["text"]), T(inputs["t"]), rope=inputs["trope"],
            use_flash=True, **kw_t).sample
    close(out, ref, 1e-4)


def test_prev_states_without_weight_raise(dit, inputs):
    _, m = dit
    with pytest.raises(ValueError, match="prev_clip_weight"):
        m(T(inputs["latent"]), T(inputs["text"]), T(inputs["t"]),
          prev_hidden_states=torch.zeros(2, 2, 29, 32))


@pytest.fixture(scope="module")
def branch():
    jp = random_params(JBranch(B_J).init, 4)
    m = CogVideoXBranch(B_T)
    m.load_state_dict(branch_state_dict(jp))
    return jp, m


def test_branch_matches_jax(branch, inputs):
    jp, m = branch
    ref = JBranch(B_J).apply(jp, jnp.asarray(inputs["noisy"]), jnp.asarray(inputs["text"]),
                             jnp.asarray(inputs["cond"]), jnp.asarray(inputs["t"]),
                             rope=inputs["jrope"], conditioning_scale=0.7)
    out = m(T(inputs["noisy"]), T(inputs["text"]), T(inputs["cond"]), T(inputs["t"]),
            rope=inputs["trope"], conditioning_scale=0.7, use_flash=True)
    assert out.shape == ref.shape
    close(out, ref, 1e-4)


def test_branch_init_from_transformer_matches_jax(dit):
    jp, m = dit
    ref = JBranch(B_J).init_from_transformer(jax.random.PRNGKey(0), jp, JCFG)
    br = CogVideoXBranch(B_T).init_from_transformer(m)
    want = branch_state_dict(jax.tree.map(np.asarray, ref))
    got = br.state_dict()
    assert set(want) == set(got)
    # the output head and branch_x_embedder are unused by the forward and
    # keep their own init on both sides
    copied = ("patch_embed.", "time_embedding.", "transformer_blocks.", "branch_blocks.")
    for k in (k for k in want if k.startswith(copied)):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def vae():
    cfg_t, cfg_j = tcfg.VAEConfig.tiny(), jcfg.VAEConfig.tiny()
    jp = random_params(JVAE(cfg_j).init, 7)
    m = AutoencoderKLCogVideoX(cfg_t)
    m.load_state_dict(vae_state_dict(jp))
    return jp, JVAE(cfg_j), m


@pytest.mark.parametrize("frames", [1, 17])
def test_vae_encode_matches_jax(vae, frames):
    jp, jv, m = vae
    x = np.random.default_rng(8).uniform(-1, 1, (1, frames, 32, 48, 3)).astype(np.float32)
    ref = jv.encode(jp, jnp.asarray(x))
    out = m.encode(T(x))
    close(out.mean, ref.mean, 1e-4)
    close(out.logvar, ref.logvar, 1e-4)


@pytest.mark.parametrize("frames", [1, 5])
def test_vae_decode_matches_jax(vae, frames):
    jp, jv, m = vae
    z = np.random.default_rng(9).standard_normal((1, frames, 4, 6, 4)).astype(np.float32)
    ref = jv.decode(jp, jnp.asarray(z))
    out = m.decode(T(z))
    assert out.shape == ref.shape
    close(out, ref, 1e-4)


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_vae_tiled_matches_jax(vae, direction):
    """32x32-pixel tiles (4x4 latent): the blend reads already-blended
    neighbours on both sides (the reference's in-place quirk)."""
    jp, _, m = vae
    jv = JVAE(jcfg.VAEConfig.tiny())
    for v in (jv, m):
        v.enable_tiling(tile_sample_min_height=32, tile_sample_min_width=32)
    rng = np.random.default_rng(10)
    try:
        if direction == "encode":
            x = rng.uniform(-1, 1, (1, 9, 48, 64, 3)).astype(np.float32)
            ref, out = jv.encode(jp, jnp.asarray(x)).mean, m.encode(T(x)).mean
        else:
            z = rng.standard_normal((1, 3, 8, 12, 4)).astype(np.float32)
            ref, out = jv.decode(jp, jnp.asarray(z)), m.decode(T(z))
    finally:
        m.disable_tiling()
    assert out.shape == ref.shape
    close(out, ref, 1e-4)


@pytest.mark.parametrize("name", ["transformer", "branch", "vae"])
def test_from_jax_inverts_torch_to_flax(goldens, name):
    """Golden state dict -> JAX params (the JAX package's converter) ->
    from_jax gives back the golden state dict, and it loads strictly."""
    from videopainter_tpu.convert import (convert_branch_state_dict,
                                          convert_transformer_state_dict,
                                          convert_vae_state_dict)
    g = goldens("pipeline")
    pre = f"sd::{name}::"
    sd = {k[len(pre):]: g[k] for k in g.files if k.startswith(pre)}
    to_jax = {"transformer": convert_transformer_state_dict,
              "branch": convert_branch_state_dict, "vae": convert_vae_state_dict}[name]
    back = {"transformer": transformer_state_dict, "branch": branch_state_dict,
            "vae": vae_state_dict}[name](to_jax(sd))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    model = {"transformer": lambda: CogVideoXTransformer3D(TCFG),
             "branch": lambda: CogVideoXBranch(B_T),
             "vae": lambda: AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16))}[name]()
    model.load_state_dict(back, strict=True)
