"""The port's gate tools (videopainter_tpu_torch/tools: gate_int8_flagship,
gate_skip_flagship, smoke_chip_anyl, gates) on the CPU, at tiny widths (2
layers, 2 heads of 16, the 3x8x12 latent grid).

- The int8 gate's trajectory (its `combine` step, sequential CFG, the
  kernels' plain versions) and the skip gate's denoise run (DPM, dynamic
  CFG, replace_gt, sequential CFG, schedule 2:6:2, injected SDE noise),
  each against the same trajectory built from the JAX package's functions
  on the same weights (`convert.from_jax`), the JAX side as one jitted
  program with its Pallas kernels in interpret mode: atol 1e-4 on the fp32
  path, PSNR >= 35 dB on the W8A8 + int8-attention path.
- The calibrated static scales (the maximum over both CFG halves and every
  step of the calibrate=True tap, `quantize.ascales_from_amax`) against the
  JAX in-scan tap's at SCALES_RTOL: four float32 ulps. The scale arithmetic
  is the same on both sides (amax * margin / 127 in numpy); the amaxes are
  activations after two steps of two frameworks' fp32 kernels and differ by
  up to three ulps (2.2e-7 relative measured, above the 2e-7 of the scale
  arithmetic alone).
- One `--smoke` artifact per tool, read back as strict JSON with its
  required keys.
- ADVICE.md's findings fixed in the port's tools: a reference cached under
  one geometry is not reused under another; bit-identical outputs give a
  null PSNR and `"identical": true`; an artifact whose robustness schedule
  is not among its schedules is refused.
"""

import json

import numpy as np
import pytest
import torch

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.tools import gate_int8_flagship as g8
from videopainter_tpu_torch.tools import gate_skip_flagship as gs
from videopainter_tpu_torch.tools import gates, smoke_chip_anyl

LAT = (1, 3, 8, 12)
FP32_ATOL = 1e-4
SCALES_RTOL = 4 * 2.0 ** -23


def strict_load(path):
    def refuse(c):
        raise ValueError(f"non-standard JSON constant {c}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def stack(quantize: bool):
    """JAX modules and numpy params of the smoke model, and the port's
    modules on the same weights (W8A8 from JAX's quantization when
    `quantize`)."""
    import jax

    import videopainter_tpu.config as jcfg
    from videopainter_tpu.models import CogVideoXBranch as JBranch
    from videopainter_tpu.models import CogVideoXTransformer3D as JDiT
    from videopainter_tpu.quantize import quantize_transformer_int8 as jquantize
    from videopainter_tpu_torch.config import BranchConfig
    from videopainter_tpu_torch.convert import (branch_state_dict, load_quantized,
                                                transformer_state_dict)
    from videopainter_tpu_torch.models import CogVideoXBranch, CogVideoXTransformer3D

    tcfg = g8.smoke_config()
    jt = jcfg.TransformerConfig.from_dict(tcfg.to_dict())
    jb = jcfg.BranchConfig.from_transformer(jt, num_layers=2)
    jdit, jbranch = JDiT(jt), JBranch(jb)
    rng = np.random.default_rng(5)

    def random_params(init):
        def leaf(path, x):
            name = jax.tree_util.keystr(path[-1:])
            r = rng.standard_normal(x.shape).astype(np.float32)
            if "kernel" in name:
                return r / np.sqrt(np.prod(x.shape[:-1]))
            return 1 + 0.05 * r if "scale" in name else 0.05 * r
        return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init,
                                                                     jax.random.PRNGKey(0)))

    params = {"transformer": random_params(jdit.init), "branch": random_params(jbranch.init)}
    if quantize:
        params = {k: jquantize(v) for k, v in params.items()}
    t = CogVideoXTransformer3D(tcfg)
    b = CogVideoXBranch(BranchConfig.from_transformer(tcfg, num_layers=2))
    for m, sd in ((t, transformer_state_dict(params["transformer"])),
                  (b, branch_state_dict(params["branch"]))):
        sd = {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}
        if quantize:
            load_quantized(m, sd)
        else:
            m.load_state_dict(sd, strict=False)
    return (jdit, jbranch, params), (t.eval(), b.eval()), tcfg


def jax_call(fn):
    """One jitted program, its results fetched at once, Pallas in interpret
    mode (as tests/test_torch_int8.py's jax_call)."""
    import jax
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, jax.jit(fn)())


def rope_np(tcfg):
    from videopainter_tpu.pipelines.common import prepare_rope
    import videopainter_tpu.config as jcfg
    cos, sin = prepare_rope(jcfg.TransformerConfig.from_dict(tcfg.to_dict()), LAT[2] * 8,
                            LAT[3] * 8, LAT[1], 8)
    return np.array(cos, np.float32), np.array(sin, np.float32)


def traj_inputs(tcfg, seed=3):
    rng = np.random.default_rng(seed)
    shape = LAT + (16,)
    return {"latents": rng.standard_normal(shape).astype(np.float32),
            "masked": rng.standard_normal(shape).astype(np.float32),
            "image_latents": np.zeros(shape, np.float32),
            "mask": (rng.random(LAT) > 0.5).astype(np.float32),
            "embeds": rng.standard_normal((2, tcfg.max_text_seq_length,
                                           tcfg.text_embed_dim)).astype(np.float32),
            "rope": rope_np(tcfg)}


def jax_traj(jdit, jbranch, params, inp, steps, use_flash, calibrate=False):
    """The JAX tool's trajectory (tools/gate_int8_flagship.py:131-195):
    branch then backbone per CFG half, `combine`, timestep 500 - i."""
    import jax.numpy as jnp

    def run():
        x = {k: (tuple(jnp.asarray(r) for r in v) if k == "rope" else jnp.asarray(v))
             for k, v in inp.items()}
        b = x["latents"].shape[0]

        def fwd(lat, e, ts):
            model_in = jnp.concatenate([lat, x["image_latents"]], axis=-1)
            cond = jnp.concatenate([x["masked"], x["mask"][..., None]], axis=-1)
            samples = jbranch.apply(params["branch"], lat, e, cond, ts, rope=x["rope"],
                                    use_flash=use_flash, calibrate=calibrate)
            am_b = None
            if calibrate:
                samples, am_b = samples
            out = jdit.apply(params["transformer"], model_in, e, ts, rope=x["rope"],
                             branch_block_samples=samples, branch_block_masks=x["mask"],
                             use_flash=use_flash, calibrate=calibrate)
            return out.sample, am_b, out.calib_amax

        lat, acc = x["latents"], None
        for i in range(steps):
            ts = jnp.broadcast_to(jnp.asarray(500 - i), (b,))
            u, ab1, at1 = fwd(lat, x["embeds"][:b], ts)
            c, ab2, at2 = fwd(lat, x["embeds"][b:], ts)
            if calibrate:
                am = (jnp.maximum(ab1, ab2), jnp.maximum(at1, at2))
                acc = am if acc is None else (jnp.maximum(acc[0], am[0]),
                                              jnp.maximum(acc[1], am[1]))
            pred = u.astype(jnp.float32) + 6.0 * (c - u).astype(jnp.float32)
            lat = (lat.astype(jnp.float32) * 0.99 - 0.01 * pred).astype(lat.dtype)
        return lat, acc

    return jax_call(run)


def port_inputs(inp):
    return {k: (tuple(torch.from_numpy(r) for r in v) if k == "rope" else torch.from_numpy(v))
            for k, v in inp.items()}


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_int8_gate_trajectory_matches_jax(mode):
    """2 steps of the int8 gate's trajectory: the fp32 path (the bf16
    kernel's plain version) at atol 1e-4, the W8A8 + int8-attention path
    (the int8 kernel's plain version) at PSNR >= 35 dB."""
    (jdit, jbranch, params), (t, b), tcfg = stack(quantize=mode == "int8")
    inp = traj_inputs(tcfg)
    use_flash = True if mode == "fp32" else "int8"
    want, _ = jax_traj(jdit, jbranch, params, inp, 2, use_flash)
    got, am_b, am_t = g8.run_traj(t, b, port_inputs(inp), 2, use_flash)
    assert am_b is None and am_t is None and got.dtype == torch.float32
    if mode == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    else:
        assert gates.psnr_db(got, want) >= gates.MIN_PSNR_DB


def test_calibrated_scales_match_jax_tap():
    """The dynamic-int8 trajectory's calibrated scales, both models, against
    the JAX in-scan tap's (its amax over both CFG halves and every step,
    times margin / 127): SCALES_RTOL; the calibrated run's latents equal the
    uncalibrated run's."""
    from videopainter_tpu.quantize import ascale_site_order

    (jdit, jbranch, params), (t, b), tcfg = stack(quantize=True)
    inp = traj_inputs(tcfg, seed=4)
    _, (jam_b, jam_t) = jax_traj(jdit, jbranch, params, inp, 2, "int8", calibrate=True)
    got, am_b, am_t = g8.run_traj(t, b, port_inputs(inp), 2, "int8", calibrate=True)
    plain, _, _ = g8.run_traj(t, b, port_inputs(inp), 2, "int8")
    assert torch.equal(got, plain)
    for model, jtree, jam, am in ((t, params["transformer"], jam_t, am_t),
                                  (b, params["branch"], jam_b, am_b)):
        sites = ascale_site_order(jtree["blocks"])
        want = {n: jam[:, i] * (1.1 / 127.0) for i, n in enumerate(sites)}
        scales = g8.ascales_from_amax(model, am, margin=1.1)
        assert sorted(scales) == sorted(want) and len(scales) == 6
        for n in want:
            np.testing.assert_allclose(scales[n], want[n], rtol=SCALES_RTOL, err_msg=n)


@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_skip_gate_loop_matches_jax(mode):
    """The skip gate's denoise run, 6 steps with schedule 2:6:2 (steps 3 and
    5 reuse the cached prediction), injected SDE noise: the port's
    `make_denoise_fn` as the gate calls it against JAX's with the JAX tool's
    DenoiseConfig (sequential CFG), fp32 at atol 1e-4, W8A8 + int8
    attention at PSNR >= 35 dB; the skipped run differs from the full one."""
    import jax
    import jax.numpy as jnp

    import videopainter_tpu.config as jcfg
    from videopainter_tpu.pipelines import common as jcommon
    from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
    from videopainter_tpu_torch.config import SchedulerConfig
    from videopainter_tpu_torch.pipelines.common import DenoiseInputs
    from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

    (jdit, jbranch, params), (t, b), tcfg = stack(quantize=mode == "int8")
    rng = np.random.default_rng(6)
    shape = LAT + (16,)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = gates.MASK_GEOMS["tall"](*LAT[1:])[None]
    arrays = dict(latents=n(*shape), image_latents=np.zeros(shape, np.float32),
                  masked_video_latents=n(*shape), mask=mask,
                  prompt_embeds=n(2, tcfg.max_text_seq_length, tcfg.text_embed_dim),
                  noise=n(*shape), video_latents=n(*shape), dpm_noises=n(6, *shape))
    rope = rope_np(tcfg)
    use_flash = True if mode == "fp32" else "int8"
    skip = gs.parse_skip_steps("2:6:2", 6)
    assert skip == (3, 5)
    sched = JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference())
    dcfg = jcommon.DenoiseConfig(
        num_inference_steps=6, do_cfg=True, use_dynamic_cfg=True, guidance_scale=6.0,
        conditioning_scale=1.0, replace_gt=True, mask_add=True, mask_background=False,
        add_first=False, wo_text=False, id_pool_resample=False, is_dpm=True,
        use_flash=use_flash, sequential_cfg=True, scan_chunk=0, mode="dual", skip_steps=skip)
    fn = jcommon.make_denoise_fn(jdit, jbranch, sched, dcfg, sched.timesteps(6))
    want = jax_call(lambda: fn(params, jcommon.DenoiseInputs(
        **{k: jnp.asarray(v) for k, v in arrays.items()}), tuple(map(jnp.asarray, rope)),
        jax.random.PRNGKey(7))[0])
    port = DenoiseInputs(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    psched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())
    rope_t = tuple(torch.from_numpy(r) for r in rope)
    got, wall = gs.run_loop(t, b, psched, port, rope_t, steps=6, use_flash=use_flash, skip=skip)
    full, _ = gs.run_loop(t, b, psched, port, rope_t, steps=6, use_flash=use_flash)
    assert wall > 0 and not torch.equal(got, full)
    if mode == "fp32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    else:
        assert gates.psnr_db(got, want) >= gates.MIN_PSNR_DB


def _check_common(rec):
    assert {"environment", "launches", "peak_memory_gib"} <= set(rec)
    assert {"card", "torch", "cuda", "git_commit", "argv"} <= set(rec["environment"])
    assert set(rec["launches"]) == set(_kernels.LAUNCHES)


def test_int8_gate_smoke_artifact(tmp_path):
    out, scales = tmp_path / "gate.json", tmp_path / "scales.npz"
    assert g8.main(["--smoke", "--deep", "--ascale", "--save-scales", str(scales),
                    "--out", str(out)]) == 0
    rec = strict_load(out)
    _check_common(rec)
    assert rec["steps"] == 2 and rec["layers"] == 2 and rec["mode"] == "int8"
    assert {"psnr_db", "cosine", "rel_l1"} <= set(rec["latent"])
    assert {"latent_psnr_vs_bf16_db", "latent_psnr_vs_dynamic_int8_db"} <= set(
        rec["static_ascale"])
    assert {"captured_tokens", "roundtrip_rel_l1", "roundtrip_cosine",
            "window1_propagation_psnr_db", "consumption_control_maxdiff"} <= set(
                rec["capture_int8"])
    assert rec["capture_int8"]["consumption_control_maxdiff"] > 0
    assert {"psnr_db", "ssim", "clip_saturation_frac"} <= set(rec["pixel"])
    assert {"bf16", "int8"} == set(rec["traj_wall_s"])
    from videopainter_tpu_torch.quantize import load_ascales
    sc, prov = load_ascales(str(scales), return_provenance=True)
    assert sorted(sc) == ["branch", "transformer"] and prov["steps"] == 2
    # a quick run is recorded beside the deep one, under its mode
    assert g8.main(["--smoke", "--pv", "--out", str(out)]) == 0
    rec = strict_load(out)
    assert rec["quick_int8pv"]["mode"] == "int8pv" and "capture_int8" in rec


def test_skip_gate_smoke_artifact(tmp_path):
    out = tmp_path / "skip.json"
    anyl = tmp_path / "anyl.json"
    anyl.write_text(json.dumps({"leg": "stub", "pixel_psnr_skip_vs_full_db": None,
                                "identical": True}))
    assert gs.main(["--smoke", "--no-perceptual", "--seeds", "2", "--out", str(out),
                    "--anyl", str(anyl)]) == 0
    rec = strict_load(out)
    _check_common(rec)
    assert rec["serving_mode"] == "int8" and rec["steps"] == 6
    e = rec["schedules"]["2:6:2"]
    assert e["skipped_steps"] == 2 and e["evaluated_steps"] == 4
    assert {"latent_psnr_vs_bf16_db", "latent_psnr_vs_serving_full_db", "pixel_psnr_db",
            "pixel_ssim"} <= set(e)
    rob = rec["robustness"]
    assert rob["schedule"] in rec["schedules"] and len(rob["configs"]) == 1
    assert all("pixel_psnr_db" in r and "latent_psnr_vs_bf16_db" in r for r in rob["configs"])
    assert rec["anyl"]["identical"] is True and "measured_by" in rec["anyl"]


def test_anyl_tool_smoke_artifact(tmp_path):
    out = tmp_path / "anyl.json"
    assert smoke_chip_anyl.main(["--smoke", "--resample", "--int8_attn", "--capture_int8",
                                 "--skip_steps", "1", "--compare-full", "--out",
                                 str(out)]) == 0
    rec = strict_load(out)
    _check_common(rec)
    assert rec["windows"] == 2 and rec["skipped_steps"] == 1 and rec["finite"]
    assert "pixel_psnr_skip_vs_full_db" in rec and {"skip", "full"} == set(rec["wall_s"])
    for run in ("skip", "full"):
        w = rec["windows_by_run"][run]
        assert [x["window"] for x in w] == [0, 1]
        assert all(len(x["step_s"]) == 3 for x in w) and w[0]["vae_encode_s"] > 0


def test_ref_cache_is_keyed_by_the_whole_configuration(tmp_path):
    """A trajectory cached under geom "rect" is never handed out under
    "tall" (nor under another seed, step count or mode); the same
    configuration is, after a reload from disk."""
    path = str(tmp_path / "refs.npz")
    cache = gates.RefCache(path)
    base = dict(kind="bf16_full", mode="bf16", layers=2, width=32, steps=6, dims="1x3x8x12",
                weights=0, seed=0)
    cache.put(gates.RefCache.key(geom="rect", **base), np.ones(3, np.float32), 1.5)
    again = gates.RefCache(path)
    hit = again.get(gates.RefCache.key(geom="rect", **base))
    assert hit is not None and hit[1] == 1.5 and np.array_equal(hit[0], np.ones(3))
    for change in (dict(geom="tall"), dict(geom="rect", seed=1), dict(geom="rect", steps=5),
                   dict(geom="rect", mode="int8")):
        assert again.get(gates.RefCache.key(**dict(base, **change))) is None, change


def test_identical_outputs_write_null_and_flag(tmp_path):
    """Bit-identical outputs: a null PSNR beside "identical": true, written
    as strict JSON; a non-finite number is refused before any file is
    written."""
    x = torch.randn(2, 3)
    entry = gates.put_psnr({}, "pixel_psnr_skip_vs_full_db", x, x.clone())
    assert entry == {"pixel_psnr_skip_vs_full_db": None, "identical": True}
    assert gates.latent_stats(x, x)["identical"] is True
    assert gates.psnr_db(x + 1e-3, x) > 0
    path = tmp_path / "a.json"
    gates.write_artifact(str(path), {"leg": entry})
    assert strict_load(path)["leg"]["identical"] is True
    with pytest.raises(ValueError):
        gates.write_artifact(str(tmp_path / "b.json"), {"psnr": float("inf")})
    with pytest.raises(ValueError):
        gates.check_finite({"a": [1.0, float("nan")]})
    assert not (tmp_path / "b.json").exists()


def test_missing_robustness_schedule_is_refused():
    """An artifact whose robustness schedule is not one of its schedules, or
    whose robustness config lacks a pixel PSNR, raises instead of being
    written."""
    good = {"schedules": {"4:48:5": {"pixel_psnr_db": 40.0}},
            "robustness": {"schedule": "4:48:5",
                           "configs": [{"latent_psnr_vs_bf16_db": 50.0,
                                        "pixel_psnr_db": 40.0}]}}
    gs.validate(good)
    with pytest.raises(ValueError, match="robustness schedule"):
        gs.validate(dict(good, robustness=dict(good["robustness"], schedule="4:48:4")))
    with pytest.raises(ValueError, match="pixel"):
        gs.validate(dict(good, robustness=dict(good["robustness"],
                                               configs=[{"latent_psnr_vs_bf16_db": 50.0}])))
    with pytest.raises(ValueError):
        gs.validate({"schedules": good["schedules"]})
