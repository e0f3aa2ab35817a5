"""The port's `parallel/inference.py` (`inference_param_specs`,
`shard_inference_params`, `denoise_shardings`) against the JAX package's
(tests/test_inference_sharding.py:18-60), on the CPU.

The spec trees of a tiny {transformer, branch, vae} are held equal to the
JAX ones, mapped by name ([L, in, out] kernels against the port's stacked
[L, out, in] weights); the pipeline sharded by `shard_inference_params`
under `model` 2 (two processes over gloo, `parallel/workers.pipeline_rank`)
gives the same latents as one process and as the JAX single-device run, at
tests/test_inference_sharding.py's rtol 2e-4, atol 2e-5.
"""

import numpy as np
import pytest
import torch

from videopainter_tpu_torch.parallel import run_local, workers


def _port_modules(models, quantize=False):
    import videopainter_tpu_torch.config as tcfg
    from videopainter_tpu_torch.convert import load_quantized
    from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                               CogVideoXTransformer3D)

    t = CogVideoXTransformer3D(tcfg.TransformerConfig.from_dict(models["tcfg"]))
    b = CogVideoXBranch(tcfg.BranchConfig.from_dict(models["bcfg"]))
    v = AutoencoderKLCogVideoX(tcfg.VAEConfig.from_dict(models["vcfg"]))
    out = {"transformer": t, "branch": b, "vae": v}
    for k, m in out.items():
        sd = {n: torch.as_tensor(np.asarray(x)) for n, x in models["state"][k].items()}
        if quantize and k != "vae":
            load_quantized(m, sd)
        else:
            m.load_state_dict(sd, strict=False)
    return out


@pytest.mark.parametrize("variant", ["bf16", "w8a8"])
def test_inference_specs_equal_jax(variant):
    """`inference_param_specs` of {transformer, branch, vae}: the backbone's
    and the branch's block linears column- or row-parallel as JAX places
    them (W8A8 weights and per-row scales too), everything else and the
    whole VAE replicated; `denoise_shardings` gives those trees and the
    replicated spec of the loop's inputs, as JAX's (NamedSharding(mesh,
    spec) trees, P())."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from test_torch_parallel import _expected_port_specs, _strip, tiny_stack
    from videopainter_tpu.parallel import inference as jinf
    from videopainter_tpu.quantize import quantize_transformer_int8 as jquantize
    from videopainter_tpu_torch.convert import branch_state_dict, transformer_state_dict
    from videopainter_tpu_torch.parallel import inference as tinf

    _, params, models = tiny_stack()
    if variant == "w8a8":
        params = dict(params, transformer=jquantize(params["transformer"]),
                      branch=jquantize(params["branch"]))
        models = dict(models, state=dict(models["state"],
                                         transformer=transformer_state_dict(params["transformer"]),
                                         branch=branch_state_dict(params["branch"])))
    mods = _port_modules(models, quantize=variant == "w8a8")
    jspecs = jinf.inference_param_specs(params)
    got = tinf.inference_param_specs(mods)
    assert sorted(got) == sorted(jspecs) == ["branch", "transformer", "vae"]
    for k in ("transformer", "branch"):
        want = _expected_port_specs(jspecs[k], mods[k].cfg.num_layers)
        ruled = {n for n, spec in got[k].items() if spec}
        assert ruled == set(want) and len(ruled) >= 8, (k, sorted(ruled ^ set(want)))
        for name, spec in got[k].items():
            assert _strip(spec) == want.get(name, ()), (k, name)
    jvae = jax.tree_util.tree_leaves(jspecs["vae"], is_leaf=lambda x: isinstance(x, P))
    assert jvae and all(s == P() for s in jvae)
    assert len(got["vae"]) >= len(jvae) and all(s == () for s in got["vae"].values())

    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 1, 2), ("data", "seq", "model"))
    jparams, jrep = jinf.denoise_shardings(params, mesh)
    assert isinstance(jrep, NamedSharding) and jrep.spec == P()
    pspecs, prep = tinf.denoise_shardings(mods, None)
    assert pspecs == got and _strip(prep) == _strip(tuple(jrep.spec))
    to_q = jparams["transformer"]["blocks"]["attn1"]["to_q"]
    assert to_q["kernel_q" if variant == "w8a8" else "kernel"].spec == P(None, None, "model")
    assert pspecs["transformer"]["transformer_blocks.0.attn1.to_q." + (
        "weight_q" if variant == "w8a8" else "weight")] == (None, "model", None)


def test_shard_inference_params_pipeline_world2():
    """World 2, `model` 2: each rank builds the tiny pipeline, shards it with
    `shard_inference_params({transformer, branch, vae}, mesh)` (2 of 4 heads
    a rank, the VAE whole) and runs it (DPM, 2 steps, CFG, latents; the same
    init and SDE noise): its latents equal one process's and the JAX
    single-device run's (rtol 2e-4, atol 2e-5)."""
    import videopainter_tpu.config as jcfg
    from videopainter_tpu.schedulers import CogVideoXDPMScheduler

    from test_torch_parallel import _jax_pipeline, _port_call, tiny_stack

    mods, params, models = tiny_stack()
    rng = np.random.RandomState(0)
    video = (rng.rand(1, 9, 64, 96, 3).astype(np.float32) * 2 - 1)
    masks = np.zeros((1, 9, 64, 96), np.float32)
    masks[:, :, 16:40, 24:64] = 1.0
    inputs = {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
              "prompt_embeds": rng.rand(1, 5, 12).astype(np.float32),
              "init_noise": rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32),
              "dpm_noises": rng.standard_normal((2, 1, 3, 8, 12, 16)).astype(np.float32)}
    call = dict(num_inference_steps=2, guidance_scale=6.0, replace_gt=True, mask_add=True,
                vae_sample_mode="mode", output_type="latent")
    ref = _jax_pipeline(mods, params, CogVideoXDPMScheduler(
        jcfg.SchedulerConfig.cogvideox_5b_inference()), call, inputs)
    spec = {"mesh": (1, 1, 2), "models": models, "call": _port_call(inputs, call)}
    one = workers.pipeline_rank(dict(spec, mesh=None))
    res = run_local(2, workers.pipeline_rank, spec, timeout=240, threads=torch.get_num_threads())
    assert one["local_heads"] == 4
    np.testing.assert_allclose(one["out"], ref, rtol=2e-4, atol=2e-5)
    for r in res:
        assert r["local_heads"] == 2 and r["comm"]["all_reduce"]["calls"] > 0
        np.testing.assert_allclose(r["out"], one["out"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["out"], ref, rtol=2e-4, atol=2e-5)
