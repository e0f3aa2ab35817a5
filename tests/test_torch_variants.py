"""Parity of the port's variant and generation pipelines, denoise modes, the
DiT's self-guidance swap and the fused to_qkv slot with the JAX package, on
the CPU in float32.

 - Each of the five variants against the torch reference's golden
   (tests/goldens/variants.npz) at the bounds of tests/test_variant_goldens.py
   (atol 3e-3, mean error < 3e-4), its `sd::*` weights loaded with
   `load_state_dict` and its recorded noise injected.
 - Each variant, the SFT any-length pipeline and the three generation
   pipelines against the JAX classes on the same random weights (carried
   over by convert/from_jax.py) and injected noise: atol 1e-4 on outputs in
   [-1, 1], the tolerance of the port's other pipeline tests.
 - The denoise loop in each mode with `dpm_sde` on (injected SDE noise) and
   off (the deterministic step), against the JAX loop: atol 1e-4.
 - `init_sft_from_transformer` against JAX exactly; the DiT with self-guidance
   states against JAX, exact attention and the flash wrapper (its plain
   version here; the JAX side in interpret mode): atol 1e-4.
 - The fused slot: `fuse_qkv_projections` gives the unfused output (1e-5)
   and the JAX fused forward (1e-4); W8A8 of a fused model gives the JAX
   package's int8 values and scales (scales rtol 2e-7, integers up to a
   one-step flip on under 0.1 % of the weights, as tests/test_torch_int8.py
   holds the unfused ones) and site order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videopainter_tpu.config as jcfg
import videopainter_tpu.pipelines as jpipes
import videopainter_tpu.quantize as jq
import videopainter_tpu_torch.config as tcfg
import videopainter_tpu_torch.pipelines as tpipes
import videopainter_tpu_torch.quantize as tq
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.ops.attention import fuse_qkv_projections as jfuse
from videopainter_tpu.pipelines import common as jcommon
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu_torch.convert import (branch_state_dict, load_quantized,
                                            transformer_state_dict, vae_state_dict)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.ops import fuse_qkv_projections
from videopainter_tpu_torch.ops.basic import Int8Linear
from videopainter_tpu_torch.pipelines import common as tcommon
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler


T2V_KW = dict(in_channels=16, out_channels=16, sample_height=8, sample_width=12)
I2V_KW = dict(T2V_KW, in_channels=32)
SCHED_J = jcfg.SchedulerConfig.cogvideox_5b_inference()
SCHED_T = tcfg.SchedulerConfig.cogvideox_5b_inference()
STEPS = 2


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def random_params(init, seed):
    """Random numpy weights in the tree structure `init` builds: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2)."""
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


def jax_call(fn, *args, **kw):
    """A JAX function that may reach a Pallas kernel, in interpret mode, as one
    jitted program whose results are fetched at once (an eager JAX op
    dispatched while interpret-mode callbacks run can deadlock)."""
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, jax.jit(lambda: fn(*args, **kw))())


def load(model, sd):
    model.load_state_dict({k: T(v) for k, v in sd.items()})
    return model


# -- against the torch reference's goldens --------------------------------------------

def extract_sd(g, name):
    pre = f"sd::{name}::"
    return {k[len(pre):]: g[k] for k in g.files if k.startswith(pre)}


def lat(x):   # the reference's latents [B, F, C, h, w] -> [B, F, h, w, C]
    return np.ascontiguousarray(np.transpose(x, (0, 1, 3, 4, 2)))


def effective_dpm_noises(g, prefix, n_steps):
    """The reference's randn queue -> the SDE noise each DPM step used (the
    middle steps draw twice and use the second draw)."""
    used, c = [], 1
    for i in range(n_steps):
        c += 0 if i in (0, n_steps - 1) else 1
        used.append(lat(g[f"noise::{prefix}::{c}"]))
        c += 1
    assert c == int(g[f"io::{prefix}::n_noises"])
    return np.stack(used)


def golden_pipeline(g, name):
    t2v, i2v = tcfg.TransformerConfig.tiny(**T2V_KW), tcfg.TransformerConfig.tiny(**I2V_KW)
    vae = load(AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16)), extract_sd(g, "vae"))
    sched = CogVideoXDPMScheduler(SCHED_T)
    if name == "sft":
        dit = load(tpipes.make_sft_inpaint_transformer(t2v), extract_sd(g, "sft"))
        return tpipes.CogVideoXSFTInpaintPipeline(dit, vae, sched, device="cpu")
    if name == "image2video":
        dit = load(CogVideoXTransformer3D(i2v), extract_sd(g, "i2v"))
        return tpipes.CogVideoXImageToVideoInpaintPipeline(dit, vae, sched, device="cpu")
    dit = load(CogVideoXTransformer3D(t2v), extract_sd(g, "t2v"))
    if name == "t2v_dual":
        branch = load(CogVideoXBranch(tcfg.BranchConfig.from_transformer(t2v, num_layers=2)),
                      extract_sd(g, "dual_branch"))
        return tpipes.CogVideoXDualInpaintPipeline(dit, branch, vae, sched, device="cpu")
    cls = {"selfguidance": tpipes.CogVideoXSelfGuidanceInpaintPipeline,
           "plain": tpipes.CogVideoXInpaintPipeline}[name]
    return cls(dit, vae, sched, device="cpu")


GOLDEN_CALL = {
    "sft": dict(guidance_scale=6.0, use_dynamic_cfg=True),
    "selfguidance": dict(guidance_scale=1.0),
    "plain": dict(guidance_scale=6.0, use_dynamic_cfg=True),
    "t2v_dual": dict(guidance_scale=6.0, use_dynamic_cfg=True, conditioning_scale=1.0,
                     mask_add=True, replace_gt=True),
    "image2video": dict(guidance_scale=6.0, use_dynamic_cfg=True),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CALL))
def test_variant_matches_torch_golden(goldens, name):
    g = goldens("variants")
    pipe = golden_pipeline(g, name)
    embeds = T(g["io::embeds"].astype(np.float32))
    kw = dict(GOLDEN_CALL[name])
    if name == "image2video":
        kw["image"] = T(g["io::image01"].astype(np.float32) * 2 - 1)
    out = pipe(video=T(g["io::video01"].astype(np.float32) * 2 - 1),
               masks=T(g["io::masks"].astype(np.float32)), prompt_embeds=embeds,
               negative_prompt_embeds=torch.zeros_like(embeds), num_inference_steps=4,
               vae_sample_mode="mode", init_noise=T(lat(g[f"noise::{name}::0"])),
               dpm_noises=T(effective_dpm_noises(g, name, 4)), **kw)
    ours01 = out / 2 + 0.5
    ref = g[f"io::{name}::out"][None]
    np.testing.assert_allclose(ours01, ref, rtol=0, atol=3e-3)
    assert np.abs(ours01 - ref).mean() < 3e-4


# -- against the JAX classes on the same weights ---------------------------------------

@pytest.fixture(scope="module")
def weights():
    """JAX parameter trees for T2V, I2V, SFT backbones, a T2V branch and a VAE
    (latent 16)."""
    t2v, i2v = jcfg.TransformerConfig.tiny(**T2V_KW), jcfg.TransformerConfig.tiny(**I2V_KW)
    return {"t2v": random_params(JDiT(t2v).init, 31), "i2v": random_params(JDiT(i2v).init, 32),
            "sft": random_params(jpipes.make_sft_inpaint_transformer(t2v).init, 33),
            "branch": random_params(
                JBranch(jcfg.BranchConfig.from_transformer(t2v, num_layers=2)).init, 34),
            "vae": random_params(JVAE(jcfg.VAEConfig.tiny(latent_channels=16)).init, 35)}


def build_both(name, w):
    """(JAX pipeline, its params, the port's pipeline) of variant `name`."""
    jt2v, ji2v = jcfg.TransformerConfig.tiny(**T2V_KW), jcfg.TransformerConfig.tiny(**I2V_KW)
    tt2v, ti2v = tcfg.TransformerConfig.tiny(**T2V_KW), tcfg.TransformerConfig.tiny(**I2V_KW)
    jvae, tvae = JVAE(jcfg.VAEConfig.tiny(latent_channels=16)), AutoencoderKLCogVideoX(
        tcfg.VAEConfig.tiny(latent_channels=16))
    load(tvae, vae_state_dict(w["vae"]))
    jsched, tsched = JDPM(SCHED_J), CogVideoXDPMScheduler(SCHED_T)
    cls = {"sft": "CogVideoXSFTInpaintPipeline", "sft_anyl": "CogVideoXI2VInpaintAnyLPipeline",
           "selfguidance": "CogVideoXSelfGuidanceInpaintPipeline",
           "plain": "CogVideoXInpaintPipeline", "t2v_dual": "CogVideoXDualInpaintPipeline",
           "image2video": "CogVideoXImageToVideoInpaintPipeline", "t2v": "CogVideoXPipeline",
           "i2v": "CogVideoXImageToVideoPipeline", "v2v": "CogVideoXVideoToVideoPipeline"}[name]
    jcls, tcls = getattr(jpipes, cls), getattr(tpipes, cls)
    if name in ("sft", "sft_anyl"):
        key, jdit, tdit = "sft", jpipes.make_sft_inpaint_transformer(jt2v), \
            tpipes.make_sft_inpaint_transformer(tt2v)
    elif name in ("image2video", "i2v"):
        key, jdit, tdit = "i2v", JDiT(ji2v), CogVideoXTransformer3D(ti2v)
    else:
        key, jdit, tdit = "t2v", JDiT(jt2v), CogVideoXTransformer3D(tt2v)
    load(tdit, transformer_state_dict(w[key]))
    params = {"transformer": w[key], "vae": w["vae"]}
    if name == "t2v_dual":
        bcfg = (jcfg.BranchConfig.from_transformer(jt2v, num_layers=2),
                tcfg.BranchConfig.from_transformer(tt2v, num_layers=2))
        tbranch = load(CogVideoXBranch(bcfg[1]), branch_state_dict(w["branch"]))
        params["branch"] = w["branch"]
        return (jcls(jdit, JBranch(bcfg[0]), jvae, jsched), params,
                tcls(tdit, tbranch, tvae, tsched, device="cpu"))
    return jcls(jdit, jvae, jsched), params, tcls(tdit, tvae, tsched, device="cpu")


def case_inputs(name, seed=41):
    rng = np.random.default_rng(seed)
    frames = 17 if name == "sft_anyl" else 9
    video = rng.uniform(-1, 1, (1, frames, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, frames, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    embeds = rng.standard_normal((1, 5, 12)).astype(np.float32)
    kw = {"prompt_embeds": embeds, "negative_prompt_embeds": np.zeros_like(embeds),
          "num_inference_steps": STEPS, "guidance_scale": 6.0, "use_dynamic_cfg": True,
          "vae_sample_mode": "mode"}
    noise = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    if name == "sft_anyl":
        kw.update(video=video, masks=masks, num_frames=9, stride=8,
                  init_noises=[noise(1, 3, 8, 12, 16) for _ in range(2)],
                  dpm_noises_list=[noise(STEPS, 1, 3, 8, 12, 16) for _ in range(2)])
        return kw
    steps = STEPS
    if name == "v2v":
        kw.update(num_inference_steps=4, strength=0.5)   # half the steps run
    if name in ("t2v", "i2v"):
        kw.update(num_frames=9, height=64, width=96)
    elif name == "v2v":
        kw.update(video=video)
    else:
        kw.update(video=video, masks=masks)
    if name in ("image2video", "i2v"):
        kw["image"] = video[:, 0] * (1 - masks[:, 0, ..., None])
    if name == "selfguidance":
        kw["guidance_scale"] = 1.0   # the reference's loop is CFG-broken
    if name == "t2v_dual":
        kw.update(mask_add=True, replace_gt=True)
    kw.update(init_noise=noise(1, 3, 8, 12, 16), dpm_noises=noise(steps, 1, 3, 8, 12, 16))
    return kw


def to_jax(v):
    if isinstance(v, np.ndarray):
        return jnp.asarray(v)
    if isinstance(v, list):
        return [jnp.asarray(x) for x in v]
    return v


def to_torch(v):
    if isinstance(v, np.ndarray):
        return T(v)
    if isinstance(v, list):
        return [T(x) for x in v]
    return v


PIPELINES = ["sft", "sft_anyl", "selfguidance", "plain", "t2v_dual", "image2video",
             "t2v", "i2v", "v2v"]


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_matches_jax(weights, name):
    jpipe, params, port = build_both(name, weights)
    kw = case_inputs(name)
    ref = np.asarray(jpipe(params, rng=jax.random.PRNGKey(0),
                           **{k: to_jax(v) for k, v in kw.items()}))
    out = port(**{k: to_torch(v) for k, v in kw.items()})
    assert out.shape == ref.shape and out.shape[-1] == 3 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_variants_pin_their_blend(monkeypatch):
    """SFT pins replace_gt off (the reference's blend is dead code), the
    self-guidance / plain / image2video baselines pin it on, and the
    branchless classes hold no branch."""
    seen = []
    monkeypatch.setattr(tpipes.CogVideoXI2VDualInpaintPipeline, "__call__",
                        lambda self, **kw: seen.append(kw["replace_gt"]))
    for cls in (tpipes.CogVideoXSFTInpaintPipeline, tpipes.CogVideoXSelfGuidanceInpaintPipeline,
                tpipes.CogVideoXInpaintPipeline, tpipes.CogVideoXImageToVideoInpaintPipeline):
        pipe = cls(CogVideoXTransformer3D(tcfg.TransformerConfig.tiny(**T2V_KW)),
                   AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16)),
                   CogVideoXDPMScheduler(SCHED_T), device="cpu")
        assert pipe.branch is None
        pipe(replace_gt=cls is tpipes.CogVideoXSFTInpaintPipeline)   # the opposite of the pin
    assert seen == [False, True, True, True]


# -- the denoise loop in each mode, with and without SDE noise ---------------------------

@pytest.mark.parametrize("dpm_sde", [True, False])
@pytest.mark.parametrize("mode", ["dual", "sft", "plain", "selfguidance"])
def test_denoise_mode_matches_jax(weights, mode, dpm_sde):
    """One denoise loop (2 DPM steps, CFG, replace_gt) in each mode: with
    dpm_sde the SDE noise is injected on both sides; without it neither side
    draws any."""
    jt2v, tt2v = jcfg.TransformerConfig.tiny(**T2V_KW), tcfg.TransformerConfig.tiny(**T2V_KW)
    key = {"sft": "sft"}.get(mode, "t2v")
    jdit = jpipes.make_sft_inpaint_transformer(jt2v) if mode == "sft" else JDiT(jt2v)
    tdit = load(tpipes.make_sft_inpaint_transformer(tt2v) if mode == "sft"
                else CogVideoXTransformer3D(tt2v), transformer_state_dict(weights[key]))
    bcfg = (jcfg.BranchConfig.from_transformer(jt2v, num_layers=2),
            tcfg.BranchConfig.from_transformer(tt2v, num_layers=2))
    tbranch = load(CogVideoXBranch(bcfg[1]), branch_state_dict(weights["branch"]))
    params = {"transformer": weights[key], "branch": weights["branch"]}

    rng = np.random.default_rng(5)
    shp = (1, 3, 4, 6, 16)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    mask = np.zeros(shp[:4], np.float32)
    mask[:, :, 1:3, 2:5] = 1
    x = dict(latents=arr(*shp), image_latents=arr(*shp), masked_video_latents=arr(*shp),
             mask=mask, prompt_embeds=arr(2, 5, 12), noise=arr(*shp), video_latents=arr(*shp),
             dpm_noises=arr(STEPS, *shp) if dpm_sde else None)
    common = dict(num_inference_steps=STEPS, do_cfg=True, use_dynamic_cfg=True,
                  guidance_scale=6.0, conditioning_scale=1.0, replace_gt=True, mask_add=True,
                  mask_background=False, add_first=False, wo_text=False, id_pool_resample=False,
                  dpm_sde=dpm_sde, mode=mode)
    jsched, tsched = JDPM(SCHED_J), CogVideoXDPMScheduler(SCHED_T)
    timesteps = jsched.timesteps(STEPS)
    jfn = jcommon.make_denoise_fn(jdit, JBranch(bcfg[0]), jsched,
                                  jcommon.DenoiseConfig(is_dpm=True, **common), timesteps)
    jin = jcommon.DenoiseInputs(**{k: None if v is None else jnp.asarray(v)
                                   for k, v in x.items()})
    rope = (jcommon.prepare_rope(jt2v, 32, 48, 3), tcommon.prepare_rope(tt2v, 32, 48, 3))
    ref = np.asarray(jfn(params, jin, rope[0], jax.random.PRNGKey(0))[0])
    tfn = tcommon.make_denoise_fn(tdit, tbranch, tsched, tcommon.DenoiseConfig(**common),
                                  tsched.timesteps(STEPS))
    tin = tcommon.DenoiseInputs(**{k: None if v is None else T(v) for k, v in x.items()})
    out = tfn(tin, rope[1], torch.Generator().manual_seed(0))[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_denoise_rejects_unknown_mode(weights):
    tt2v = tcfg.TransformerConfig.tiny(**T2V_KW)
    cfg = tcommon.DenoiseConfig(num_inference_steps=1, do_cfg=False, use_dynamic_cfg=False,
                                guidance_scale=1.0, conditioning_scale=1.0, replace_gt=False,
                                mask_add=False, mask_background=False, add_first=False,
                                mode="branchless")
    with pytest.raises(ValueError, match="mode"):
        tcommon.make_denoise_fn(CogVideoXTransformer3D(tt2v), None,
                                CogVideoXDPMScheduler(SCHED_T), cfg, np.array([999]))


# -- SFT backbone, self-guidance swap ---------------------------------------------------

def test_init_sft_from_transformer_matches_jax(weights):
    jt2v, tt2v = jcfg.TransformerConfig.tiny(**T2V_KW), tcfg.TransformerConfig.tiny(**T2V_KW)
    ref = transformer_state_dict(jpipes.init_sft_from_transformer(
        jax.random.PRNGKey(9), weights["t2v"], jt2v))
    base = load(CogVideoXTransformer3D(tt2v), transformer_state_dict(weights["t2v"]))
    sft = tpipes.init_sft_from_transformer(base)
    got = sft.state_dict()
    assert set(got) == set(ref)
    for k in ref:   # the JAX tree mixes float32 and float64 leaves of float32 values
        assert torch.equal(got[k], ref[k].to(got[k].dtype)), k
    assert got["patch_embed.proj.weight"].shape[1] == 2 * 16 + 1
    # every module but the patch embed's projection is the base's own
    assert sft.transformer_blocks is base.transformer_blocks
    assert sft.patch_embed.text_proj is base.patch_embed.text_proj
    assert sft.patch_embed.proj is not base.patch_embed.proj


@pytest.mark.parametrize("use_flash", [False, True])
def test_dit_self_guidance_matches_jax(use_flash):
    """The DiT with a guidance pass's per-layer video states swapped in
    outside the mask (head dim 64, the flash kernels' width)."""
    kw = dict(T2V_KW, attention_head_dim=64)
    jc, tc = jcfg.TransformerConfig.tiny(**kw), tcfg.TransformerConfig.tiny(**kw)
    jp = random_params(JDiT(jc).init, 51)
    m = load(CogVideoXTransformer3D(tc), transformer_state_dict(jp))
    rng = np.random.default_rng(52)
    b, t, h, w = 2, 3, 4, 6
    mask = np.zeros((b, t, h, w), np.float32)
    mask[0, :, 1:3, 2:5] = 1
    mask[1, 1:, :2, :3] = 1
    x = rng.standard_normal((b, t, h, w, 16)).astype(np.float32)
    text = rng.standard_normal((b, 5, 12)).astype(np.float32)
    sg = rng.standard_normal((2, b, t * (h // 2) * (w // 2), 128)).astype(np.float32)
    ts = np.array([999, 421])
    ref = jax_call(JDiT(jc).apply, jp, jnp.asarray(x), jnp.asarray(text), jnp.asarray(ts),
                   rope=jcommon.prepare_rope(jc, 32, 48, t),
                   self_guidance_hidden_states=jnp.asarray(sg),
                   self_guidance_masks=jnp.asarray(mask), use_flash=use_flash)
    with torch.no_grad():
        out = m(T(x), T(text), T(ts), rope=tcommon.prepare_rope(tc, 32, 48, t),
                self_guidance_hidden_states=T(sg), self_guidance_masks=T(mask),
                use_flash=use_flash)
        plain = m(T(x), T(text), T(ts), rope=tcommon.prepare_rope(tc, 32, 48, t),
                  use_flash=use_flash)
    np.testing.assert_allclose(out.sample.numpy(), np.asarray(ref.sample), rtol=0, atol=1e-4)
    assert not torch.allclose(out.sample, plain.sample, atol=1e-3)   # the swap acts
    with pytest.raises(ValueError, match="plain forward"):
        m(T(x), T(text), T(ts), rope=tcommon.prepare_rope(tc, 32, 48, t), calibrate=True,
          self_guidance_hidden_states=T(sg), self_guidance_masks=T(mask))


# -- the fused to_qkv slot -------------------------------------------------------------

RS_KW = dict(I2V_KW, id_pool_resample_learnable=True)


@pytest.fixture(scope="module")
def fused_case():
    jc, tc = jcfg.TransformerConfig.tiny(**RS_KW), tcfg.TransformerConfig.tiny(**RS_KW)
    jp = random_params(JDiT(jc).init, 61)
    rng = np.random.default_rng(62)
    b, t, h, w = 2, 3, 4, 6
    mask = np.zeros((b, t, h, w), np.float32)
    mask[0, :, 1:3, 2:5] = 1
    mask[1, 1:, :2, :3] = 1
    x = {"latent": rng.standard_normal((b, t, h, w, 32)).astype(np.float32),
         "text": rng.standard_normal((b, 5, 12)).astype(np.float32), "t": np.array([999, 421]),
         "mask": mask, "prev": rng.standard_normal((2, b, 5 + t * 6, 32)).astype(np.float32),
         "jrope": jcommon.prepare_rope(jc, 32, 48, t), "trope": tcommon.prepare_rope(tc, 32, 48, t)}
    return jc, tc, jp, x


FUSED_VARIANTS = {
    "plain": ({}, {}),
    "resample": (dict(id_pool_resample=True), dict(id_pool_resample=True)),
    "prev_resample": (dict(id_pool_resample=True, prev_clip_weight=0.4), dict(
        id_pool_resample=True, prev_clip_weight=0.4)),
}


def _fused_kw(x, variant, jax_side):
    kw = dict(FUSED_VARIANTS[variant][0 if jax_side else 1])
    conv = jnp.asarray if jax_side else T
    kw["branch_block_masks"] = conv(x["mask"])
    if "prev_clip_weight" in kw:
        kw["prev_hidden_states"] = conv(x["prev"])
        rm = np.zeros((2, x["prev"].shape[2]), bool)
        rm[:, 5::3] = True
        kw["prev_resample_mask"] = conv(rm)
    return kw


@pytest.mark.parametrize("variant", sorted(FUSED_VARIANTS))
def test_fused_qkv_matches_unfused_and_jax(fused_case, variant):
    jc, tc, jp, x = fused_case
    m = load(CogVideoXTransformer3D(tc), transformer_state_dict(jp))
    fused = fuse_qkv_projections(load(CogVideoXTransformer3D(tc), transformer_state_dict(jp)))
    attn = fused.transformer_blocks[0].attn1
    assert attn.fused and not hasattr(attn, "to_q") and attn.to_qkv.weight.shape == (96, 32)
    args = (T(x["latent"]), T(x["text"]), T(x["t"]))
    with torch.no_grad():
        want = m(*args, rope=x["trope"], **_fused_kw(x, variant, False)).sample
        got = fused(*args, rope=x["trope"], **_fused_kw(x, variant, False)).sample
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    jfp = jfuse(jp)
    ref = JDiT(jc).apply(jfp, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                         jnp.asarray(x["t"]), rope=x["jrope"], **_fused_kw(x, variant, True))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.sample), rtol=0, atol=1e-4)
    # the JAX fused tree carries over to a fused port model
    carried = fuse_qkv_projections(CogVideoXTransformer3D(tc))
    load(carried, transformer_state_dict(jax.tree.map(np.asarray, jfp)))
    assert torch.equal(carried.state_dict()["transformer_blocks.1.attn1.to_qkv.weight"],
                       fused.state_dict()["transformer_blocks.1.attn1.to_qkv.weight"])


def test_fused_qkv_w8a8_matches_jax(fused_case):
    """W8A8 of a fused model: the JAX package's int8 values and scales on the
    to_qkv site, its static-scale site order, and the unfused W8A8 output
    (per-out-channel weight scales and per-token activation scales are the
    same numbers fused or not)."""
    jc, tc, jp, x = fused_case
    jqp = jq.quantize_transformer_int8(jfuse(jp))
    q = tq.quantize_transformer_int8(
        fuse_qkv_projections(load(CogVideoXTransformer3D(tc), transformer_state_dict(jp))))
    want = transformer_state_dict(jax.tree.map(np.asarray, jqp))
    got = q.state_dict()
    assert set(got) == set(want)
    assert sum(k.endswith("to_qkv.weight_q") for k in want) == 2
    for k in want:
        if k.endswith("kscale"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-7, err_msg=k)
        if k.endswith("weight_q"):
            diff = np.abs(got[k].numpy().astype(int) - want[k].numpy().astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
    sites = ["to_qkv", "to_out", "proj_in", "proj_out"]
    assert tq.ascale_site_order(q) == jq.ascale_site_order(jqp["blocks"]) == sites
    unfused = tq.quantize_transformer_int8(load(CogVideoXTransformer3D(tc),
                                                transformer_state_dict(jp)))
    args = (T(x["latent"]), T(x["text"]), T(x["t"]))
    with torch.no_grad():
        out = q(*args, rope=x["trope"]).sample
        np.testing.assert_allclose(out.numpy(), unfused(*args, rope=x["trope"]).sample.numpy(),
                                   rtol=0, atol=1e-5)
    ref = JDiT(jc).apply(jqp, jnp.asarray(x["latent"]), jnp.asarray(x["text"]),
                         jnp.asarray(x["t"]), rope=x["jrope"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.sample), rtol=0, atol=1e-4)
    # calibration records the fused layout's four sites; static scales attach to them
    scales = tq.calibrate_ascales(q, [(args, dict(rope=x["trope"]))])
    jscales = jq.calibrate_ascales(JDiT(jc), jqp, [((jnp.asarray(x["latent"]),
                                                     jnp.asarray(x["text"]),
                                                     jnp.asarray(x["t"])),
                                                    dict(rope=x["jrope"]))])
    assert list(scales) == list(jscales) == sites
    for s in sites:
        np.testing.assert_allclose(scales[s], jscales[s], rtol=1e-4)
    tq.attach_static_ascale(q, scales)
    assert isinstance(q.transformer_blocks[1].attn1.to_qkv, Int8Linear)
    assert float(q.transformer_blocks[1].attn1.to_qkv.ascale) == pytest.approx(
        float(scales["to_qkv"][1]))
    loaded = load_quantized(fuse_qkv_projections(CogVideoXTransformer3D(tc)), want)
    np.testing.assert_array_equal(loaded.state_dict()["transformer_blocks.0.attn1.to_qkv.weight_q"],
                                  want["transformer_blocks.0.attn1.to_qkv.weight_q"])


def test_fuse_qkv_refuses_quantized_linears(fused_case):
    _, tc, jp, _ = fused_case
    q = tq.quantize_transformer_int8(load(CogVideoXTransformer3D(tc), transformer_state_dict(jp)))
    with pytest.raises(ValueError, match="plain linears"):
        fuse_qkv_projections(q)
