"""The port's mesh, placements, tensor and sequence parallelism
(videopainter_tpu_torch/parallel/) against the JAX package's on the CPU.

Multi-rank cases run as processes over gloo (`parallel.launch.run_local`,
each call with its own timeout; the rank functions live in
`parallel/workers.py`, which imports no JAX). JAX references run on the
virtual CPU devices of tests/conftest.py or on one device, each as one
jitted program or one pipeline call. The same numpy weights go to both
sides (`convert.from_jax`), the same init noise and SDE noise to both
pipelines. Tolerances are those of tests/test_inference_sharding.py, whose
cases these mirror; the W8A8 tensor-parallel forward is held tight to the
port's one-process forward (equal int32 products and scales: only the fp32
order of the row-parallel sum differs), and a control that quantizes with
the local amax must fail that limit.
"""

import numpy as np
import pytest
import torch

from videopainter_tpu_torch.parallel import run_local, workers

DIT_KW = dict(num_attention_heads=4, attention_head_dim=16, in_channels=32, out_channels=16,
              sample_height=8, sample_width=12)
INT8_TP_REL = 1e-5   # max |TP - one process| / max |one process|, W8A8 forward


def random_params(init, seed):
    """Random numpy weights in the tree `init` builds: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.05^2), biases N(0, 0.05^2) (non-zero, so a
    row-parallel bias added on every rank shows)."""
    import jax

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


def tiny_stack(seed=11, **kw):
    """JAX configs and modules, numpy params, and the port's model spec."""
    import videopainter_tpu.config as jcfg
    from videopainter_tpu.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                         CogVideoXTransformer3D)
    from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                                vae_state_dict)

    jt = jcfg.TransformerConfig.tiny(**{**DIT_KW, **kw})
    jb = jcfg.BranchConfig.from_transformer(jt, num_layers=2)
    jv = jcfg.VAEConfig.tiny(latent_channels=16)
    mods = (CogVideoXTransformer3D(jt), CogVideoXBranch(jb), AutoencoderKLCogVideoX(jv))
    params = {"transformer": random_params(mods[0].init, seed),
              "branch": random_params(mods[1].init, seed + 1),
              "vae": random_params(mods[2].init, seed + 2)}
    models = {"tcfg": jt.to_dict(), "bcfg": jb.to_dict(), "vcfg": jv.to_dict(),
              "state": {"transformer": transformer_state_dict(params["transformer"]),
                        "branch": branch_state_dict(params["branch"]),
                        "vae": vae_state_dict(params["vae"])}}
    return mods, params, models


# -- mesh ---------------------------------------------------------------------------------------

def test_mesh_constructors_errors_and_groups():
    """make_mesh / make_hybrid_mesh / auto_mesh / initialize_distributed (as
    tests/test_inference_sharding.py:169-183 holds the JAX ones): a mesh
    that does not match the world raises ValueError, no launcher means rank
    0, one rank makes its own group; on 4 ranks a (2, 1, 2) mesh puts
    `model` innermost and each axis group sums over its own ranks."""
    import torch.distributed as dist

    from videopainter_tpu_torch.parallel import (MeshAxes, auto_mesh, initialize_distributed,
                                                 make_hybrid_mesh, make_mesh)

    assert initialize_distributed() == 0 and not dist.is_initialized()
    with pytest.raises(ValueError, match="=2 != 1 ranks"):
        make_mesh(2, 1, 1, device="cpu")
    with pytest.raises(ValueError, match="hybrid mesh 3x1x1x1=3 != 1 ranks"):
        make_hybrid_mesh(dcn_data=3, device="cpu")
    try:
        mesh = auto_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "seq", "model") == tuple(vars(MeshAxes()).values())
        assert tuple(mesh.shape) == (1, 1, 1) and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()

    res = run_local(4, workers.mesh_rank, (2, 1, 2), timeout=60, threads=torch.get_num_threads())
    coords = [r["coords"] for r in res]
    assert coords == [(0, 0, 0), (0, 0, 1), (1, 0, 0), (1, 0, 1)]
    assert [r["sum_model"] for r in res] == [1, 1, 5, 5]
    assert [r["sum_data"] for r in res] == [2, 4, 2, 4]
    assert [r["sum_seq"] for r in res] == [0, 1, 2, 3]


# -- placements ---------------------------------------------------------------------------------

_OWNERS = {("attn1", "to_q"): "attn1.to_q", ("attn1", "to_k"): "attn1.to_k",
           ("attn1", "to_v"): "attn1.to_v", ("attn1", "to_qkv"): "attn1.to_qkv",
           ("attn1", "to_out"): "attn1.to_out.0", ("ff", "proj_in"): "ff.net.0.proj",
           ("ff", "proj_out"): "ff.net.2"}
_LEAVES = {"kernel": "weight", "kernel_q": "weight_q", "bias": "bias", "kscale": "kscale",
           "ascale": "ascale"}


def _strip(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _expected_port_specs(jspecs, n_layers):
    """The JAX block specs ([L, in, out] kernels) on the port's names
    ([out, in] weights, stacked as [L, out, in])."""
    import jax
    from jax.sharding import PartitionSpec as P

    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jspecs["blocks"], is_leaf=lambda x: isinstance(x, P)):
        keys = tuple(k.key for k in path)
        owner, leaf = _OWNERS.get(keys[:2]), _LEAVES.get(keys[-1])
        if owner is None or leaf is None:
            continue
        parts = list(spec) + [None] * 3
        port = (parts[0], parts[2], parts[1]) if keys[-1] in ("kernel", "kernel_q") \
            else tuple(parts[:2])
        for i in range(n_layers):
            if _strip(port):
                out[f"transformer_blocks.{i}.{owner}.{leaf}"] = _strip(port)
    return out


@pytest.mark.parametrize("variant", ["bf16", "fused", "w8a8"])
def test_placements_equal_jax_specs(variant):
    """Every parameter (and int8 buffer) of a tiny DiT and branch gets the
    JAX package's spec, mapped by name: column-parallel q / k / v (fused
    too), FFN in, their biases and per-row scales; row-parallel out and FFN
    out weights; everything else replicated; ZeRO-2 moment specs as JAX's
    `optimizer_state_specs` converts them."""

    from videopainter_tpu.ops.attention import fuse_qkv_projections as jfuse
    from videopainter_tpu.parallel import sharding as js
    from videopainter_tpu.quantize import quantize_transformer_int8 as jquantize
    from videopainter_tpu_torch.convert import load_quantized, transformer_state_dict
    from videopainter_tpu_torch.models import CogVideoXTransformer3D
    from videopainter_tpu_torch.ops.attention import fuse_qkv_projections
    from videopainter_tpu_torch.parallel import sharding as ts
    import videopainter_tpu_torch.config as tcfg

    mods, params, models = tiny_stack()
    tp = params["transformer"]
    port = CogVideoXTransformer3D(tcfg.TransformerConfig.from_dict(models["tcfg"]))
    if variant == "fused":
        tp = jfuse(tp)
        fuse_qkv_projections(port)
        port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                              for k, v in transformer_state_dict(tp).items()})
    elif variant == "w8a8":
        tp = jquantize(tp)
        load_quantized(port, transformer_state_dict(tp))
    jspecs = js.transformer_param_specs(tp)
    want = _expected_port_specs(jspecs, port.cfg.num_layers)
    got = ts.transformer_param_specs(port)
    ruled = {k for k, v in got.items() if v}
    assert ruled == set(want) and len(ruled) >= 8, sorted(ruled ^ set(want))
    for name, spec in got.items():
        assert _strip(spec) == want.get(name, ()), name
    # ZeRO-2: the moments of ruled block leaves shard their layer axis over data
    zero = ts.optimizer_state_specs(got)
    jzero = js.optimizer_state_specs(jspecs)
    assert all(zero[k][0] == "data" for k in ruled)
    assert all(v == () for k, v in zero.items() if k not in ruled)
    assert str(jzero["blocks"]["ff"]["proj_out"]["kernel" if variant != "w8a8"
                                                 else "kernel_q"]) == "PartitionSpec('data', 'model', None)"
    assert zero["transformer_blocks.0.ff.net.2." + ("weight" if variant != "w8a8" else
                                                     "weight_q")] == ("data", None, "model")
    if variant == "bf16":   # an AdamW state's moments take their parameter's ZeRO-2 spec
        from videopainter_tpu_torch.training import make_optimizer

        params = dict(port.named_parameters())
        opt = make_optimizer(lr=1e-3).init([params[k] for k in sorted(params)], sorted(params))
        specs = ts.opt_state_specs(opt, params, got)
        assert specs["count"] == ()
        assert specs["mu.transformer_blocks.1.attn1.to_q.weight"] == ("data", "model", None)
        assert specs["nu.transformer_blocks.0.attn1.to_out.0.bias"] == ()


def test_fit_spec_matches_jax():
    """An axis whose mesh size does not divide the dim stays replicated."""
    from jax.sharding import PartitionSpec as P

    from videopainter_tpu.parallel.sharding import fit_spec as jfit
    from videopainter_tpu_torch.parallel.sharding import fit_spec

    class JMesh:
        shape = {"data": 4, "seq": 2, "model": 2}

    cases = [((2, 130, 140), (None, None, "model")), ((2, 130, 140), ("data", None, "model")),
             ((8, 12), ("data", "model")), ((6, 5), ("seq", "model")),
             ((16, 3), (("data", "seq"), None)), ((12, 3), (("data", "seq"), None)),
             ((7,), ()), ((4, 6, 8), ("data",))]
    for shape, spec in cases:
        want = _strip(jfit(np.zeros(shape), P(*spec), JMesh()))
        assert _strip(fit_spec(shape, spec, JMesh.shape)) == want, (shape, spec)


# -- tensor and sequence parallel inference ------------------------------------------------------

def _jax_pipeline(mods, params, sched, call, inputs):
    import jax
    import jax.numpy as jnp

    from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintPipeline

    pipe = CogVideoXI2VDualInpaintPipeline(*mods, sched)
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    return np.asarray(pipe(params, video=j["video"], masks=j["masks"], image=j["image"],
                           prompt_embeds=j["prompt_embeds"],
                           negative_prompt_embeds=jnp.zeros_like(j["prompt_embeds"]),
                           init_noise=j["init_noise"],
                           **({"dpm_noises": j["dpm_noises"]} if "dpm_noises" in j else {}),
                           rng=jax.random.PRNGKey(7), **call))


def _port_call(inputs, call):
    out = dict(call, video=inputs["video"], masks=inputs["masks"], image=inputs["image"],
               prompt_embeds=inputs["prompt_embeds"],
               negative_prompt_embeds=np.zeros_like(inputs["prompt_embeds"]),
               init_noise=inputs["init_noise"])
    if "dpm_noises" in inputs:
        out["dpm_noises"] = inputs["dpm_noises"]
    return out


def test_tp_pipeline_and_w8a8_forward_world2():
    """World 2, `model` 2: the dual-stream pipeline with the backbone and
    branch tensor-parallel against the JAX single-device run
    (test_inference_sharding.py:18-57: DPM, 2 steps, CFG, latents; rtol
    2e-4, atol 2e-5), and its control with the row-parallel bias added on
    every rank failing that limit; a W8A8 backbone forward on 2 local heads
    of 4 held to the one-process forward at INT8_TP_REL, and its
    local-amax control failing it."""
    import videopainter_tpu.config as jcfg
    from videopainter_tpu.schedulers import CogVideoXDPMScheduler

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

    pipe = {"mesh": (1, 1, 2), "models": models, "call": _port_call(inputs, call)}
    int8_models = {**models, "quantize": True, "vcfg": None, "bcfg": None}
    rs = np.random.default_rng(3)
    dit = {"mesh": (1, 1, 2), "models": int8_models,
           "inputs": {"hidden": rs.standard_normal((1, 3, 8, 12, 32)).astype(np.float32),
                      "text": rs.standard_normal((1, 5, 12)).astype(np.float32),
                      "timestep": np.array([500])}}
    cases = [("pipeline_rank", pipe), ("pipeline_rank", dict(pipe, control="bias_every_rank")),
             ("dit_rank", dit), ("dit_rank", dict(dit, control="local_amax"))]
    res = run_local(2, workers.cases_rank, cases, timeout=240, threads=torch.get_num_threads())
    one = workers.dit_rank(dict(dit, mesh=None))["sample"]
    for r in res:
        tp, broken, int8, int8_broken = r
        np.testing.assert_allclose(tp["out"], ref, rtol=2e-4, atol=2e-5)
        assert not np.allclose(broken["out"], ref, rtol=2e-4, atol=2e-5)
        assert tp["comm"]["all_reduce"]["calls"] > 0
        scale = np.abs(one).max()
        assert np.abs(int8["sample"] - one).max() <= INT8_TP_REL * scale
        assert np.abs(int8_broken["sample"] - one).max() > INT8_TP_REL * scale
        assert int8["comm"]["all_reduce"]["calls"] > int8_broken["comm"]["all_reduce"]["calls"]


def test_tp_sp_pipeline_world4():
    """World 4, data 1 x seq 2 x model 2: the decoded pipeline output with
    TP-sharded weights and `seq_axis` sequence parallelism (K / V
    all-gathered, the flash path's plain version) against the JAX
    single-device run (test_inference_sharding.py:91-139: DDIM, random
    masks, 2 steps; rtol 1e-4, atol 2e-4); every rank returns the whole
    video."""
    import videopainter_tpu.config as jcfg
    from videopainter_tpu.schedulers import CogVideoXDDIMScheduler

    sched_kw = dict(prediction_type="v_prediction", timestep_spacing="trailing")
    mods, params, models = tiny_stack(num_layers=2, text_embed_dim=16)
    rng = np.random.RandomState(0)
    video = (rng.rand(1, 9, 64, 96, 3) * 2 - 1).astype(np.float32)
    inputs = {"video": video, "masks": (rng.rand(1, 9, 64, 96) > 0.5).astype(np.float32),
              "image": video[:, 0], "prompt_embeds": rng.rand(1, 5, 16).astype(np.float32),
              "init_noise": rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32)}
    call = dict(num_inference_steps=2, guidance_scale=6.0, replace_gt=True, mask_add=True,
                vae_sample_mode="mode")
    ref = _jax_pipeline(mods, params, CogVideoXDDIMScheduler(jcfg.SchedulerConfig(**sched_kw)),
                        call, inputs)
    spec = {"mesh": (1, 2, 2), "models": models, "seq": "seq",
            "scheduler": ("ddim", jcfg.SchedulerConfig(**sched_kw).to_dict()),
            "call": dict(_port_call(inputs, call), use_flash=True)}
    res = run_local(4, workers.pipeline_rank, spec, timeout=240, threads=torch.get_num_threads())
    for r in res:
        assert r["out"].shape == ref.shape == (1, 9, 64, 96, 3)
        np.testing.assert_allclose(r["out"], ref, rtol=1e-4, atol=2e-4)
        assert r["comm"]["all_gather"]["calls"] > 0 and r["comm"]["all_reduce"]["calls"] > 0


def test_dit_ring_and_sequence_parallel_world4():
    """World 4 on `seq`: the DiT with ring attention (ring_mesh) against the
    JAX single-device forward (test_inference_sharding.py:142-166, 1e-5),
    and with `seq_axis` alone (the all-gather path, which must move data:
    :60-88's collectives check), also on a video length 4 does not divide
    (shards of 12, 12, 12 and 9 tokens, as GSPMD splits it), with the
    gradient of sum(sample^2) w.r.t. the latents against the one-process
    port."""
    import jax
    import jax.numpy as jnp

    import videopainter_tpu.config as jcfg
    from videopainter_tpu.models import CogVideoXTransformer3D
    from videopainter_tpu_torch.convert import transformer_state_dict

    cfg = jcfg.TransformerConfig.tiny(num_layers=2)
    m = CogVideoXTransformer3D(cfg)
    params = random_params(m.init, 5)
    models = {"tcfg": cfg.to_dict(), "state": {"transformer": transformer_state_dict(params)}}
    rng = np.random.default_rng(1)
    t = np.array([500])
    cases, refs = [], []
    for shape, seq in (((1, 2, 8, 16, cfg.in_channels), "ring"),
                       ((1, 4, 8, 8, cfg.in_channels), "seq"),
                       ((1, 3, 6, 10, cfg.in_channels), "seq")):   # 45 tokens: 12, 12, 12, 9
        hidden = rng.standard_normal(shape).astype(np.float32)
        text = rng.standard_normal((1, 3, cfg.text_embed_dim)).astype(np.float32)
        refs.append(np.asarray(jax.jit(lambda p, h, x, tt: m.apply(p, h, x, tt).sample)(
            params, jnp.asarray(hidden), jnp.asarray(text), jnp.asarray(t))))
        cases.append(("dit_rank", {"mesh": (1, 4, 1), "models": models, "seq": seq,
                                   "grad": True,
                                   "inputs": {"hidden": hidden, "text": text,
                                              "timestep": t}}))
    res = run_local(4, workers.cases_rank, cases, timeout=180, threads=torch.get_num_threads())
    for i, ((_, spec), ref) in enumerate(zip(cases, refs)):
        one = workers.dit_rank(dict(spec, mesh=None, seq=None))
        for r in res:
            got = r[i]
            np.testing.assert_allclose(one["sample"], ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["sample"], ref, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["grad_hidden"], one["grad_hidden"], rtol=1e-4,
                                       atol=1e-5)
        c = res[0][i]["comm"]
        if spec["seq"] == "ring":
            assert c["sendrecv"]["calls"] > 0
        else:
            assert c["all_gather"]["calls"] > 0 and c["sendrecv"]["calls"] == 0


def test_anyl_pipeline_sequence_parallel_world2():
    """World 2 on `seq`: the any-length pipeline (two windows, 2 DPM steps,
    CFG) with its captures gathered over the ranks and the previous window's
    states sliced to each rank's tokens: with the learnable ID resample
    (masked K / V page all-gathered, compressed capture) and with the
    prev-clip blend (previous K / V all-gathered), against the JAX pipeline
    (tests/test_torch_anyl.py's limit, 1e-4 on outputs in [-1, 1])."""
    import jax
    import jax.numpy as jnp

    import videopainter_tpu.config as jcfg
    from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintAnyLPipeline
    from videopainter_tpu.schedulers import CogVideoXDPMScheduler

    rng = np.random.default_rng(31)
    video = rng.uniform(-1, 1, (1, 13, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, 13, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    x = {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
         "prompt_embeds": rng.standard_normal((1, 5, 12)).astype(np.float32),
         "negative_prompt_embeds": np.zeros((1, 5, 12), np.float32),
         "init_noises": [rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32)
                         for _ in range(2)],
         "dpm_noises_list": [rng.standard_normal((2, 1, 3, 8, 12, 16)).astype(np.float32)
                             for _ in range(2)]}
    call = dict(num_frames=9, stride=4, num_inference_steps=2, guidance_scale=6.0,
                use_dynamic_cfg=True, prev_clip_weight=0.3, replace_gt=True, mask_add=True,
                vae_sample_mode="mode")
    cases, refs = [], []
    for learnable in (True, False):
        kw = {"id_pool_resample": True, "compress_capture": 4} if learnable else {}
        mods, params, models = tiny_stack(num_attention_heads=2,
                                          id_pool_resample_learnable=learnable)
        jpipe = CogVideoXI2VDualInpaintAnyLPipeline(*mods, CogVideoXDPMScheduler(
            jcfg.SchedulerConfig.cogvideox_5b_inference()))
        j = {k: ([jnp.asarray(a) for a in v] if isinstance(v, list) else jnp.asarray(v))
             for k, v in x.items()}
        refs.append(np.asarray(jpipe(params, rng=jax.random.PRNGKey(0), scan_chunk=0,
                                     **j, **call, **kw)))
        cases.append(("pipeline_rank", {"mesh": (1, 2, 1), "models": models, "seq": "seq",
                                        "pipeline": "anyl",
                                        "call": dict(x, use_flash=True, **call, **kw)}))
    res = run_local(2, workers.cases_rank, cases, timeout=240, threads=torch.get_num_threads())
    for r in res:
        for got, ref in zip(r, refs):
            assert got["out"].shape == ref.shape and ref.shape[2:] == (64, 96, 3)
            np.testing.assert_allclose(got["out"], ref, rtol=0, atol=1e-4)
            assert got["comm"]["all_gather"]["calls"] > 0
