"""End-to-end parity of the port's flagship pipeline
(videopainter_tpu_torch CogVideoXI2VDualInpaintPipeline), on the CPU.

 - Against the JAX pipeline on the same random weights (carried over by
   convert/from_jax.py), the same init noise and SDE noise, 4 DPM steps with
   CFG, dynamic guidance, branch injection (mask_add) and replace_gt. The
   port runs use_flash=True (its flash wrapper's plain version on the CPU),
   the JAX side exact attention. Both fp32: tolerance 1e-4 on outputs in
   [-1, 1] (the same arithmetic in another order through VAE, 2+2 layers and
   4 steps).
 - Alone against the torch reference's golden (tests/goldens/pipeline.npz
   `io::single::out`), at the JAX golden test's bounds: atol 2e-3, mean
   error < 2e-4, PSNR >= 35 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videopainter_tpu.config as jcfg
import videopainter_tpu_torch.config as tcfg
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintPipeline as JPipe
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintPipeline
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

torch.set_num_threads(2)

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
STEPS = 4


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


def port_pipeline(sds):
    t = tcfg.TransformerConfig.tiny(**DIT_KW)
    models = (CogVideoXTransformer3D(t), CogVideoXBranch(tcfg.BranchConfig.from_transformer(t)),
              AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16)))
    for m, sd in zip(models, sds):
        m.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()})
    sched = CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference())
    return CogVideoXI2VDualInpaintPipeline(*models, sched, device="cpu")


def case_inputs(seed):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (1, 9, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, 9, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    return {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
            "embeds": rng.standard_normal((1, 5, 12)).astype(np.float32),
            "init_noise": rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32),
            "dpm_noises": rng.standard_normal((STEPS, 1, 3, 8, 12, 16)).astype(np.float32)}


COMMON = dict(num_inference_steps=STEPS, guidance_scale=6.0, use_dynamic_cfg=True,
              replace_gt=True, mask_add=True, vae_sample_mode="mode")


def run_port(pipe, x, **kw):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return pipe(video=t["video"], masks=t["masks"], image=t["image"],
                prompt_embeds=t["embeds"], negative_prompt_embeds=torch.zeros_like(t["embeds"]),
                init_noise=t["init_noise"], dpm_noises=t["dpm_noises"], use_flash=True,
                **COMMON, **kw)


@pytest.fixture(scope="module")
def jax_stack():
    jt = jcfg.TransformerConfig.tiny(**DIT_KW)
    jb = jcfg.BranchConfig.from_transformer(jt)
    jv = jcfg.VAEConfig.tiny(latent_channels=16)
    params = {"transformer": random_params(JDiT(jt).init, 11),
              "branch": random_params(JBranch(jb).init, 12),
              "vae": random_params(JVAE(jv).init, 13)}
    jpipe = JPipe(JDiT(jt), JBranch(jb), JVAE(jv),
                  JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()))
    port = port_pipeline((transformer_state_dict(params["transformer"]),
                          branch_state_dict(params["branch"]),
                          vae_state_dict(params["vae"])))
    return jpipe, params, port


@pytest.mark.parametrize("variant", ["cfg_batch", "sequential_cfg"])
def test_port_pipeline_matches_jax(jax_stack, variant):
    jpipe, params, port = jax_stack
    x = case_inputs(21)
    kw = {"sequential_cfg": True} if variant == "sequential_cfg" else {}
    j = {k: jnp.asarray(v) for k, v in x.items()}
    ref = np.asarray(jpipe(params, video=j["video"], masks=j["masks"], image=j["image"],
                           prompt_embeds=j["embeds"],
                           negative_prompt_embeds=jnp.zeros_like(j["embeds"]),
                           init_noise=j["init_noise"], dpm_noises=j["dpm_noises"],
                           rng=jax.random.PRNGKey(0), **COMMON, **kw))
    out = run_port(port, x, **kw)
    assert out.shape == ref.shape == (1, 9, 64, 96, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_port_pipeline_matches_torch_golden(goldens):
    g = goldens("pipeline")

    def sd(name):
        pre = f"sd::{name}::"
        return {k[len(pre):]: g[k] for k in g.files if k.startswith(pre)}

    pipe = port_pipeline((sd("transformer"), sd("branch"), sd("vae")))
    lat = lambda a: np.transpose(a, (0, 1, 3, 4, 2))  # reference [B,F,C,h,w] -> [B,F,h,w,C]
    # the reference draws SDE noise twice on middle steps and uses the second
    # (scheduling_dpm_cogvideox.py), once on the first and last steps
    used, c = [], 1
    for i in range(STEPS):
        c += 0 if i in (0, STEPS - 1) else 1
        used.append(lat(g[f"noise::single::{c}"]))
        c += 1
    assert c == int(g["io::single::n_noises"])
    x = {"video": g["io::video01"] * 2 - 1, "masks": g["io::masks"],
         "image": g["io::image01"] * 2 - 1, "embeds": g["io::embeds"],
         "init_noise": lat(g["noise::single::0"]), "dpm_noises": np.stack(used)}
    out01 = run_port(pipe, {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}) / 2 + 0.5
    ref = g["io::single::out"][None]
    np.testing.assert_allclose(out01, ref, rtol=0, atol=2e-3)
    assert np.abs(out01 - ref).mean() < 2e-4
    psnr = 10 * np.log10(1.0 / max(np.square(out01 - ref).mean(), 1e-12))
    assert psnr >= 35.0, f"PSNR vs torch reference {psnr:.1f} dB < 35"


def test_port_pipeline_options(jax_stack):
    """Skipped steps reuse the cached prediction (so differ from the full
    run), latents come back unclipped, and the variant options change nothing
    on this model, as in the JAX pipeline: `wo_text` is the branch config's to
    decide, and `id_pool_resample` needs the learnable resample."""
    _, _, port = jax_stack
    x = case_inputs(22)
    full = run_port(port, x, output_type="latent")
    assert full.shape == (1, 3, 8, 12, 16)
    skipped = run_port(port, x, output_type="latent", skip_steps=(2,))
    assert torch.isfinite(skipped).all() and not torch.equal(full, skipped)
    with pytest.raises(ValueError, match="step 0"):
        run_port(port, x, skip_steps=(0,))
    for kw in ({"wo_text": True}, {"id_pool_resample": True}):
        assert torch.equal(run_port(port, x, output_type="latent", **kw), full)
