"""The port's training path (videopainter_tpu_torch/training/, the DDIM
scheduler, the straight-through int8 linear, checkpointing in the models)
against the JAX package on the CPU, at tiny dims (2-layer DiT and branch, 77
joint tokens), with the same weights (convert/from_jax.py) and the same
numpy-made tensors on both sides.

Tolerances: losses rtol 1e-5 (fp32 on both sides, other summation orders);
gradients atol 2e-6 + rtol 2e-4 (the JAX side's are read off an
`optax.sgd(1.0)` update, p - (p - g), which rounds at the parameter's ulp);
optimizer trajectories rtol 2e-5 after three steps; schedules rtol 1e-6 plus
1e-7 of the base rate (float32 in JAX, python floats here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import videopainter_tpu.config as jcfg
import videopainter_tpu_torch.config as tcfg
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE, CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.models import lora as jlora
from videopainter_tpu.ops import basic as jbasic
from videopainter_tpu.pipelines.common import prepare_rope as jprepare_rope
from videopainter_tpu.quantize import quantize_transformer_int8 as jquantize
from videopainter_tpu.schedulers import CogVideoXDDIMScheduler as JDDIM
from videopainter_tpu.training import optim as joptim
from videopainter_tpu.training import train_branch as jtrain
from videopainter_tpu_torch.convert import (branch_state_dict, load_quantized,
                                            load_safetensors_dir, lora_params,
                                            transformer_state_dict, vae_state_dict)
from videopainter_tpu_torch.convert.from_jax import to_jax_layout
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.models.lora import (convert_peft_lora_state_dict,
                                                init_lora_params)
from videopainter_tpu_torch.ops.basic import Int8Linear
from videopainter_tpu_torch.pipelines.common import prepare_rope
from videopainter_tpu_torch.schedulers import CogVideoXDDIMScheduler
from videopainter_tpu_torch.training import (BranchTrainConfig, encode_batch_latent_moments,
                                             init_branch_train_state, make_branch_train_step,
                                             make_lora_train_step, make_lr_schedule,
                                             make_optimizer)
from videopainter_tpu_torch.training import checkpoint as tckpt
from videopainter_tpu_torch.training.train_branch import _x0_loss, tree_leaves


DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
SCHED_KW = dict(prediction_type="v_prediction")
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def random_params(init, seed):
    """Random numpy weights in the tree structure `init` builds (traced
    abstractly): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), biases
    N(0, 0.05^2)."""
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


def jax_fetch(fn, *args):
    """Call a (jitted) JAX function that may reach a Pallas kernel in interpret
    mode and fetch all results at once (see tests/test_torch_flash_attention.py)."""
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, fn(*args))


class Stack:
    """The tiny models of both packages on the same weights."""

    def __init__(self, resample: bool = False):
        kw = dict(DIT_KW, id_pool_resample_learnable=resample)
        self.jt, self.tt = jcfg.TransformerConfig.tiny(**kw), tcfg.TransformerConfig.tiny(**kw)
        self.jb = jcfg.BranchConfig.from_transformer(self.jt, num_layers=2)
        self.jv = jcfg.VAEConfig.tiny(latent_channels=16)
        self.jdit, self.jbranch, self.jvae = JDiT(self.jt), JBranch(self.jb), JVAE(self.jv)
        self.tp = random_params(self.jdit.init, 11)
        self.bp = random_params(self.jbranch.init, 12)
        self.vp = random_params(self.jvae.init, 13)
        self.jsched = JDDIM(jcfg.SchedulerConfig(**SCHED_KW))
        self.sched = CogVideoXDDIMScheduler(tcfg.SchedulerConfig(**SCHED_KW))

    def port(self, int8: bool = False):
        """Fresh port modules (transformer, branch, vae) with the JAX weights."""
        dit = CogVideoXTransformer3D(self.tt)
        if int8:
            load_quantized(dit, transformer_state_dict(jquantize(self.tp)))
        else:
            dit.load_state_dict(transformer_state_dict(self.tp))
        branch = CogVideoXBranch(tcfg.BranchConfig.from_transformer(self.tt, num_layers=2))
        branch.load_state_dict(branch_state_dict(self.bp))
        vae = AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16))
        vae.load_state_dict(vae_state_dict(self.vp))
        return dit, branch, vae


@pytest.fixture(scope="module")
def stack():
    return Stack()


@pytest.fixture(scope="module")
def stack_rs():
    return Stack(resample=True)


def make_batch(seed=0, b=1, t=9):
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, t, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    video = rng.uniform(-1, 1, (b, t, 64, 96, 3)).astype(np.float32)
    return {"pixel_values": video,
            "conditioning_pixel_values": video * (1 - masks[..., None]),
            "masks": masks,
            "prompt_embeds": rng.standard_normal((b, 5, 12)).astype(np.float32)}


def jax_prepared(s: Stack, cfg, seed=0):
    """The JAX package's prepare step on the batch, with the split key the
    train step would use: numpy (noisy, image_latents, branch_cond, mask_lat,
    model_input, timesteps)."""
    batch = {k: jnp.asarray(v) for k, v in make_batch().items()}
    rng_prep, _ = jax.random.split(jax.random.PRNGKey(seed))
    prep = jtrain._make_prepare(s.jvae, s.jsched, cfg)(s.vp, batch, rng_prep)
    return [np.asarray(x) for x in prep], np.asarray(batch["prompt_embeds"])


def jax_cfg(**kw):
    return jtrain.BranchTrainConfig(height=64, width=96, mask_add=True, remat=False, **kw)


def port_cfg(**kw):
    kw.setdefault("remat", False)
    return BranchTrainConfig(height=64, width=96, mask_add=True, **kw)


class GradTap:
    """Stands in for the optimizer: keeps the gradients, changes nothing."""

    def init(self, params, names=None):
        return {}

    def update_(self, params, grads, state):
        self.grads = [g.clone() for g in grads]
        return state


# -- scheduler and loss -------------------------------------------------------------------------

def to_bthwc(x):  # [B, F, C, H, W] -> [B, F, H, W, C]
    return np.transpose(x, (0, 1, 3, 4, 2))


def test_ddim_add_noise_get_velocity_and_step_match_goldens(goldens):
    g = goldens("schedulers")
    sched = CogVideoXDDIMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference())
    s, n, t = T(g["an_sample"]), T(g["an_noise"]), g["an_t"]
    np.testing.assert_allclose(sched.add_noise(s, n, t).numpy(), g["an_out"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sched.get_velocity(s, n, T(t)).numpy(), g["gv_out"],
                               rtol=1e-5, atol=1e-6)
    coeffs = sched.precompute(10)
    np.testing.assert_array_equal(coeffs.timesteps, g["ddim_timesteps_10"])
    x = T(g["ddim_x0_in"]).float()
    for i in range(10):
        x, _ = sched.step(coeffs, i, T(g["ddim_model_outputs"][i]).float(), x)
        np.testing.assert_allclose(x.numpy(), g["ddim_trajectory"][i], rtol=2e-5, atol=2e-5)


def test_x0_loss_matches_golden_and_jax(goldens):
    g = goldens("train_loss")
    kw = dict(num_train_timesteps=1000, beta_start=0.00085, beta_end=0.012,
              beta_schedule="scaled_linear", snr_shift_scale=3.0, rescale_betas_zero_snr=True,
              prediction_type="v_prediction")
    sched, jsched = CogVideoXDDIMScheduler(tcfg.SchedulerConfig(**kw)), JDDIM(
        jcfg.SchedulerConfig(**kw))
    x0, noise, mo = (to_bthwc(g[k]) for k in ("model_input", "noise", "model_output"))
    noisy = sched.add_noise(T(x0), T(noise), T(g["timesteps"]))
    np.testing.assert_allclose(noisy.numpy(), to_bthwc(g["noisy_video_latents"]),
                               rtol=1e-5, atol=1e-6)
    mask_lat = g["masks"][:, :, 0]
    total, (loss, inp) = _x0_loss(sched, T(mo), noisy, T(g["timesteps"]), T(x0), T(mask_lat), 1.0)
    for got, key in ((loss, "loss"), (inp, "inpainting_loss"), (total, "total")):
        np.testing.assert_allclose(float(got), float(g[key]), rtol=1e-5)
    jtotal, (jloss, jinp) = jtrain._x0_loss(
        jsched, jnp.asarray(mo), jnp.asarray(noisy.numpy()), jnp.asarray(g["timesteps"]),
        jnp.asarray(x0), jnp.asarray(mask_lat), 1.0)
    for got, want in ((loss, jloss), (inp, jinp), (total, jtotal)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# -- the branch step ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def branch_reference(stack):
    """The JAX branch grad_step on JAX-prepared tensors: loss metrics and the
    gradient tree (read off an sgd(1.0) update)."""
    s = stack
    cfg = jax_cfg()
    prep, embeds = jax_prepared(s, cfg)
    rope = jprepare_rope(s.jt, 64, 96, prep[4].shape[1], s.jv.spatial_compression_ratio)
    opt = optax.sgd(1.0)
    step = jtrain.make_branch_train_step(s.jdit, s.jbranch, s.jvae, s.jsched, opt, cfg)
    state = jtrain.init_branch_train_state(jax.tree.map(jnp.asarray, s.bp), opt)
    new, metrics = jax_fetch(step.grad_step, state, s.tp, *map(jnp.asarray, prep),
                             jnp.asarray(embeds), rope)
    grads = jax.tree.map(lambda p, n: np.asarray(p) - n, s.bp, new.trainable)
    return prep, embeds, metrics, grads


def port_branch_grads(s, prep, embeds, cfg):
    dit, branch, vae = s.port()
    tap = GradTap()
    state = init_branch_train_state(branch, tap)
    step = make_branch_train_step(dit, branch, vae, s.sched, tap, cfg)
    tensors = [T(x) for x in prep]
    state1, m = step.grad_step(state, *tensors, T(embeds), step.rope(tensors))
    assert state1.step == 1
    assert all(p.grad is None for mod in (dit, vae) for p in mod.parameters())
    named = dict(zip(sorted(state.trainable), tap.grads))
    return m, named, branch


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("remat,remat_chunk", [(False, None), (True, None), (True, 1)])
def test_branch_grad_step_matches_jax(stack, branch_reference, use_flash, remat, remat_chunk):
    prep, embeds, jm, jgrads = branch_reference
    m, named, _ = port_branch_grads(stack, prep, embeds,
                                    port_cfg(use_flash=use_flash, remat=remat,
                                             remat_chunk=remat_chunk))
    for k in ("loss", "inpainting_loss", "total_loss", "gradient_norm_before_clip"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    got = to_jax_layout(named, stack.bp)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat_got) == len(flat_want) > 20
    for path, a in flat_got:
        np.testing.assert_allclose(a, flat_want[path], err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)
    # the per-layer projections gate the output: they get gradient
    assert np.abs(got["branch_blocks"]["kernel"]).max() > 0


def test_branch_grad_step_matches_jax_flash_interpret(stack, branch_reference):
    """The JAX side through its Pallas forward and backward kernels (interpret
    mode) gives the loss and gradients of its exact-attention step, which the
    port is held to above: tolerance of the flash tests (3e-4 / 3e-5)."""
    s = stack
    prep, embeds, jm, jgrads = branch_reference
    cfg = jax_cfg(use_flash=True)
    rope = jprepare_rope(s.jt, 64, 96, prep[4].shape[1], s.jv.spatial_compression_ratio)
    opt = optax.sgd(1.0)
    step = jtrain.make_branch_train_step(s.jdit, s.jbranch, s.jvae, s.jsched, opt, cfg)
    state = jtrain.init_branch_train_state(jax.tree.map(jnp.asarray, s.bp), opt)
    new, metrics = jax_fetch(step.grad_step, state, s.tp, *map(jnp.asarray, prep),
                             jnp.asarray(embeds), rope)
    np.testing.assert_allclose(float(metrics["total_loss"]), float(jm["total_loss"]), rtol=1e-5)
    m, named, _ = port_branch_grads(s, prep, embeds, port_cfg(use_flash=True, remat=True))
    got = to_jax_layout(named, s.bp)
    want = jax.tree.map(lambda p, n: np.asarray(p) - n, s.bp, new.trainable)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5)


def test_branch_train_step_end_to_end(stack):
    """The whole step (the port's own VAE prep, AdamW): finite metrics under
    their names, parameters move, frozen modules get no gradient, the zero
    projections of a branch initialised from the backbone receive gradient."""
    dit, _, vae = stack.port()
    branch = CogVideoXBranch(tcfg.BranchConfig.from_transformer(stack.tt, num_layers=2))
    branch.init_from_transformer(dit)
    assert float(branch.branch_blocks[0].weight.abs().max()) == 0
    opt = make_optimizer(lr=1e-3)
    state = init_branch_train_state(branch, opt)
    step = make_branch_train_step(dit, branch, vae, stack.sched, opt, port_cfg(remat=True))
    before = {n: p.detach().clone() for n, p in branch.named_parameters()}
    batch = {k: T(v) for k, v in make_batch().items()}
    state, m = step(state, batch, torch.Generator().manual_seed(0))
    assert sorted(m) == ["gradient_norm_after_clip", "gradient_norm_before_clip",
                         "inpainting_loss", "loss", "total_loss"]
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["gradient_norm_before_clip"]) > 0
    assert float(m["gradient_norm_after_clip"]) <= 1.0 + 1e-6
    assert state.step == 1 and state.opt_state["count"] == 1
    assert sum(float((p.detach() - before[n]).abs().sum())
               for n, p in branch.named_parameters()) > 0
    assert all(float(lin.weight.abs().max()) > 0 for lin in branch.branch_blocks)
    assert all(p.grad is None and not p.requires_grad
               for mod in (dit, vae) for p in mod.parameters())


def test_prepare_step_contract(stack):
    """The port's VAE prep: shapes, the latent-grid mask in the branch cond,
    zero padding and dropout of the image latents, determinism under a seed,
    and the precomputed-moments path drawing the same samples."""
    dit, branch, vae = stack.port()
    batch = {k: T(v) for k, v in make_batch().items()}
    opt = GradTap()

    def prepare(cfg, b=batch, seed=3):
        step = make_branch_train_step(dit, branch, vae, stack.sched, opt, cfg)
        return step.prepare(b, torch.Generator().manual_seed(seed))

    noisy, img, cond, mask_lat, x0, t = prepare(port_cfg(noised_image_dropout=0.0))
    assert noisy.shape == x0.shape == img.shape == (1, 3, 8, 12, 16)
    assert cond.shape == (1, 3, 8, 12, 17) and mask_lat.shape == (1, 3, 8, 12)
    assert t.shape == (1,) and 0 <= int(t) < 1000
    torch.testing.assert_close(cond[..., -1], mask_lat)
    assert set(np.unique(mask_lat.numpy())) <= {0.0, 1.0} and mask_lat.sum() > 0
    assert float(img[:, 1:].abs().max()) == 0 and float(img[:, 0].abs().max()) > 0
    again = prepare(port_cfg(noised_image_dropout=0.0))
    assert all(torch.equal(a, b) for a, b in zip((noisy, img, cond, mask_lat, x0, t), again))
    dropped = prepare(port_cfg(noised_image_dropout=1.0))
    assert float(dropped[1].abs().max()) == 0 and torch.equal(dropped[4], x0)
    cached = prepare(port_cfg(noised_image_dropout=0.0), encode_batch_latent_moments(vae, batch))
    assert all(torch.equal(a, b) for a, b in zip((noisy, img, cond, mask_lat, x0, t), cached))
    assert not any(x.requires_grad for x in (noisy, img, cond, x0))


def test_calibrate_with_remat_raises(stack):
    dit, branch, _ = stack.port()
    x = torch.zeros((1, 3, 8, 12, 32))
    with pytest.raises(ValueError, match="remat"):
        dit(x, torch.zeros((1, 5, 12)), torch.tensor([1]), calibrate=True, remat=True)
    with pytest.raises(ValueError, match="remat"):
        branch(x[..., :16], torch.zeros((1, 5, 12)), torch.zeros((1, 3, 8, 12, 17)),
               torch.tensor([1]), calibrate=True, remat=True)


@pytest.mark.parametrize("capture_quant", [False, True])
def test_remat_keeps_forward_and_captures(stack, capture_quant):
    """Per-block and grouped checkpoints change no number of the forward, its
    captured states included (the int8 capture crosses a group's checkpoint
    flattened)."""
    dit, _, _ = stack.port()
    rng = np.random.default_rng(2)
    x = T(rng.standard_normal((1, 3, 8, 12, 32)).astype(np.float32)).requires_grad_()
    e, t = T(rng.standard_normal((1, 5, 12)).astype(np.float32)), torch.tensor([400])
    masks = torch.zeros((1, 3, 8, 12))
    masks[:, :, 2:6, 3:9] = 1
    kw = dict(branch_block_masks=masks, return_hidden_states=True, capture_quant=capture_quant)
    ref = dit(x, e, t, **kw)
    for remat_kw in (dict(remat=True), dict(remat=True, remat_chunk=1)):
        out = dit(x, e, t, **kw, **remat_kw)
        assert torch.equal(out.sample, ref.sample)
        if capture_quant:
            assert all(torch.equal(out.hidden_states_list[k], ref.hidden_states_list[k])
                       for k in ("values", "scales"))
        else:
            assert torch.equal(out.hidden_states_list, ref.hidden_states_list)


# -- the LoRA step ------------------------------------------------------------------------------

def random_lora(s: Stack, seed=5, rank=4):
    rng = np.random.default_rng(seed)
    tree = jlora.init_lora_params(jax.random.PRNGKey(0), s.tp, rank=rank)
    return jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def lora_reference(stack_rs):
    """The JAX LoRA step on the ID-resample stack: prepared tensors, embeddings,
    the adapter, its metrics and its gradient tree (read off an sgd(1.0)
    update)."""
    s = stack_rs
    cfg = jax_cfg(lora_rank=4, lora_alpha=2.0)
    prep, embeds = jax_prepared(s, cfg)
    lora = random_lora(s)
    opt = optax.sgd(1.0)
    jstep = jtrain.make_lora_train_step(s.jdit, s.jbranch, s.jvae, s.jsched, opt, cfg)
    jstate = jtrain.init_branch_train_state(jax.tree.map(jnp.asarray, lora), opt)
    # the JAX LoRA step exposes no grad_step: the whole step is called with the
    # key whose split made `prep`, so it prepares the same tensors
    new, jm = jax_fetch(jstep, jstate, {"transformer": s.tp, "vae": s.vp, "branch": s.bp},
                        {k: jnp.asarray(v) for k, v in make_batch().items()},
                        jax.random.PRNGKey(0))
    return prep, embeds, lora, jm, jax.tree.map(lambda p, n: np.asarray(p) - n, lora,
                                                new.trainable)


@pytest.mark.parametrize("use_flash,remat", [(False, False), (True, True)])
def test_lora_grad_step_matches_jax(stack_rs, lora_reference, use_flash, remat):
    s = stack_rs
    prep, embeds, lora, jm, want = lora_reference
    dit, branch, vae = s.port()
    tap = GradTap()
    state = init_branch_train_state(lora_params(lora), tap)
    step = make_lora_train_step(dit, branch, vae, s.sched, tap,
                                port_cfg(lora_rank=4, lora_alpha=2.0, use_flash=use_flash,
                                         remat=remat))
    tensors = [T(x) for x in prep]
    _, m = step.grad_step(state, *tensors, T(embeds), step.rope(tensors))
    for k in ("loss", "inpainting_loss", "total_loss", "gradient_norm_before_clip"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    grads = dict(zip([(t, n) for t in sorted(lora) for n in sorted(lora[t])], tap.grads))
    for (tgt, name), g in grads.items():
        assert float(g.abs().max()) > 0, (tgt, name)
        np.testing.assert_allclose(g.numpy(), want[tgt][name], err_msg=f"{tgt}.{name}",
                                   **GRAD_TOL)
    assert all(p.grad is None for mod in (dit, branch, vae) for p in mod.parameters())


def test_lora_step_on_int8_backbone(stack_rs):
    """QLoRA: the adapter trains through a frozen W8A8 backbone (the
    straight-through backward): finite loss, lora_B moves off zero."""
    s = stack_rs
    dit, branch, vae = s.port(int8=True)
    assert sum(isinstance(m, Int8Linear) for m in dit.modules()) == 12
    lora = init_lora_params(torch.Generator().manual_seed(0), dit, rank=4)
    opt = make_optimizer(lr=1e-3)
    state = init_branch_train_state(lora, opt)
    step = make_lora_train_step(dit, branch, vae, s.sched, opt,
                                port_cfg(lora_rank=4, lora_alpha=2.0, remat=True))
    state, m = step(state, {k: T(v) for k, v in make_batch().items()},
                    torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["total_loss"])) and float(m["gradient_norm_before_clip"]) > 0
    assert all(float(ab["lora_B"].abs().max()) > 0 for ab in state.trainable.values())


def test_int8_linear_ste_gradient_matches_jax():
    """Int8MatmulSTE's backward against `_int8_matmul_ste`'s (dynamic and
    static activation scales): the same product of the same bf16 values, so
    rtol 1e-5."""
    rng = np.random.default_rng(7)
    p = {"kernel": (rng.standard_normal((24, 16)) / 5).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}
    q = jbasic.quantize_linear_int8({k: jnp.asarray(v) for k, v in p.items()})
    kq, ks = q["kernel_q"], q["kscale"]
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    g = rng.standard_normal((2, 7, 16)).astype(np.float32)
    for ascale in (None, 0.03):
        qp = {"kernel_q": kq, "kscale": ks, "bias": jnp.asarray(p["bias"])}
        if ascale is not None:
            qp["ascale"] = jnp.asarray(ascale, jnp.float32)
        want_y, want_dx = jax.value_and_grad(
            lambda xx: jnp.sum(jbasic.linear(qp, xx) * jnp.asarray(g)))(jnp.asarray(x))
        lin = Int8Linear(T(np.asarray(kq).T), T(ks), T(p["bias"]),
                         None if ascale is None else torch.tensor(ascale))
        xt = T(x).requires_grad_()
        y = lin(xt)
        (dx,) = torch.autograd.grad(y, xt, T(g))
        np.testing.assert_allclose(float((y * T(g)).sum()), float(want_y), rtol=1e-5)
        np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-6)


# -- optimizer and schedules --------------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear", "cosine", "cosine_with_restarts", "polynomial",
                                  "constant", "constant_with_warmup"])
def test_lr_schedules_match_jax(name):
    kw = dict(warmup_steps=7, total_steps=50, num_cycles=2, power=2.0)
    js, ts = joptim.make_lr_schedule(name, 3e-4, **kw), make_lr_schedule(name, 3e-4, **kw)
    for step in [0, 1, 3, 6, 7, 8, 20, 28, 29, 49, 50, 51, 80]:
        # atol 1e-7 of the base rate: 1 + cos cancels in float32 near a cycle's end
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=3e-11,
                                   err_msg=f"{name} at {step}")
    with pytest.raises(ValueError, match="unknown lr_scheduler"):
        make_lr_schedule("nope", 1e-3)


@pytest.mark.parametrize("case", ["adamw_clip_active", "adamw_clip_inactive", "adam_schedule",
                                  "adamw_accumulate_2", "adamw_no_clip", "adafactor_clip",
                                  "adafactor_no_decay", "prodigy_clip", "prodigy_safeguard"])
def test_optimizer_matches_optax(case):
    """Three optimizer steps on the same parameters and gradients as the JAX
    package's optax chain. The (130, 140) and (3, 130, 128) tensors are large
    enough for Adafactor's factored second moment."""
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "c": rng.standard_normal((130, 140)).astype(np.float32),
              "d": rng.standard_normal((3, 130, 128)).astype(np.float32)}
    scale = {"adamw_clip_active": 3.0, "adamw_clip_inactive": 1e-4}.get(case, 1.0)
    kw = dict(optimizer=case.split("_")[0], weight_decay=1e-2,
              max_grad_norm=None if case == "adamw_no_clip" else 1.0,
              accumulate_steps=2 if case == "adamw_accumulate_2" else 1)
    if case == "adafactor_no_decay":
        kw["weight_decay"] = 0.0
    if case == "prodigy_safeguard":
        kw.update(prodigy_safeguard_warmup=True, prodigy_beta3=0.9, prodigy_decouple=False)
    sched_kw = dict(warmup_steps=2, total_steps=10)
    if case == "adam_schedule":
        jopt = joptim.make_optimizer(schedule=joptim.make_lr_schedule("cosine", 1e-2, **sched_kw),
                                     **kw)
        topt = make_optimizer(schedule=make_lr_schedule("cosine", 1e-2, **sched_kw), **kw)
    else:
        lr = 1.0 if case.startswith("prodigy") else 1e-2
        jopt, topt = joptim.make_optimizer(lr=lr, **kw), make_optimizer(lr=lr, **kw)
    n_calls = 3 * kw["accumulate_steps"]
    grads = [{k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(n_calls)]

    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = [T(params[k].copy()) for k in sorted(params)]
    tstate = topt.init(tp)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = topt.update_(tp, [T(g[k]) for k in sorted(g)], tstate)
        for k, t in zip(sorted(params), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=2e-5, atol=1e-7,
                                       err_msg=f"{case} call {i} {k}")
    assert tstate["count"] == 3
    moved = sum(float(np.abs(t.numpy() - params[k]).sum()) for k, t in zip(sorted(params), tp))
    assert moved > 0


def test_adafactor_blocks_are_the_jax_leaves():
    """Adafactor's clip and parameter-scale rms run over one leaf of the JAX
    tree: per-layer weights named `<stack>.<i>.<rest>` count as the stacked
    leaf [L, in, out] (factored: 130 and 140 reach 128), a Conv2d weight as
    the matrix [(kh kw I), O] (factored there, 132 x 130, though no axis pair
    of [O, I, kh, kw] is). Three steps against optax on the stacked tree, same
    numbers on both sides: rtol 2e-5 as the other optimizer trajectories."""
    rng = np.random.default_rng(5)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    to_named = lambda t: {
        "blocks.0.ff.weight": t["ff"]["kernel"][0].T, "blocks.1.ff.weight": t["ff"]["kernel"][1].T,
        "blocks.0.ff.bias": t["ff"]["bias"][0], "blocks.1.ff.bias": t["ff"]["bias"][1],
        "embed.proj.weight": t["proj"].reshape(2, 2, 33, 130).transpose(3, 2, 0, 1)}
    tree = lambda scale: {"ff": {"kernel": scale * r(2, 130, 140), "bias": scale * r(2, 140)},
                          "proj": scale * r(132, 130)}
    params = tree(1.0)
    params["ff"]["kernel"][1] *= 4.0   # layers of unlike rms: per-layer blocks would differ
    kw = dict(lr=1e-2, optimizer="adafactor", weight_decay=1e-2)
    jopt, topt = joptim.make_optimizer(**kw), make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    named = {k: T(v.copy()) for k, v in to_named(params).items()}
    names = sorted(named)
    tp = [named[k] for k in names]
    tstate = topt.init(tp, names)
    assert sorted(map(len, tstate["blocks"])) == [1, 2, 2]
    for i in range(3):
        g = tree(0.5 if i else 3.0)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gn = to_named(g)
        tstate = topt.update_(tp, [T(gn[k]) for k in names], tstate)
        want = to_named(jax.tree.map(np.asarray, jp))
        for k in names:
            np.testing.assert_allclose(named[k].numpy(), want[k], rtol=2e-5, atol=1e-7,
                                       err_msg=f"step {i} {k}")


def test_branch_adafactor_step_matches_jax(stack, branch_reference):
    """Two Adafactor steps of the tiny branch on the JAX step's gradients
    (carried across by `branch_state_dict`), against optax on the JAX tree:
    the parameters agree leaf by leaf at rtol 2e-5, which per-layer block
    statistics would miss."""
    jgrads = branch_reference[3]
    kw = dict(lr=1e-2, optimizer="adafactor", weight_decay=1e-2)
    jopt, topt = joptim.make_optimizer(**kw), make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, stack.bp)
    jstate = jopt.init(jp)
    _, branch, _ = stack.port()
    state = init_branch_train_state(branch, topt)
    names = sorted(state.trainable)
    assert max(map(len, state.opt_state["blocks"])) == 2 < len(names)
    leaves = tree_leaves(state.trainable)
    tgrads = branch_state_dict(jgrads)
    jupdate = jax.jit(jopt.update)   # eager, optax's Adafactor compiles op by op
    for _ in range(2):
        upd, jstate = jupdate(jax.tree.map(jnp.asarray, jgrads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        with torch.no_grad():
            topt.update_(leaves, [tgrads[k] for k in names], state.opt_state)
    got = to_jax_layout(state.trainable, stack.bp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("lr", [1e-5, 1e-3])
def test_branch_adamw_steps_from_zero_projections_match_jax(stack, lr):
    """Two AdamW updates of a branch initialised from the backbone (its output
    projections zero, as the training smoke builds it), the same prepared
    tensors every step (the smoke's --fixed-noise), at the smoke's widths:
    the three losses agree with the JAX step under optax at rtol 1e-5 and
    the parameters within 2e-2 lr (a first AdamW step is lr g / (|g| + eps),
    which turns a gradient's GRAD_TOL difference near |g| ~ eps into a part
    of lr). At these widths neither side's loss rises after the first update."""
    s = stack
    cfg = jax_cfg()
    prep, embeds = jax_prepared(s, cfg)
    rope = jprepare_rope(s.jt, 64, 96, prep[4].shape[1], s.jv.spatial_compression_ratio)
    dit, _, vae = s.port()
    branch = CogVideoXBranch(tcfg.BranchConfig.from_transformer(s.tt, num_layers=2))
    branch.init_from_transformer(dit)
    assert float(branch.branch_blocks[0].weight.abs().max()) == 0
    topt, jopt = make_optimizer(lr=lr), joptim.make_optimizer(lr=lr)
    state = init_branch_train_state(branch, topt)
    step = make_branch_train_step(dit, branch, vae, s.sched, topt, port_cfg())
    jtree = to_jax_layout({k: v.detach().clone() for k, v in state.trainable.items()}, s.bp)
    jstep = jtrain.make_branch_train_step(s.jdit, s.jbranch, s.jvae, s.jsched, jopt, cfg)
    jstate = jtrain.init_branch_train_state(jax.tree.map(jnp.asarray, jtree), jopt)
    tensors = [T(x) for x in prep]
    losses, jlosses = [], []
    for _ in range(3):   # the loss before each update; the third follows two updates
        state, m = step.grad_step(state, *tensors, T(embeds), step.rope(tensors))
        jstate, jm = jax_fetch(jstep.grad_step, jstate, s.tp, *map(jnp.asarray, prep),
                               jnp.asarray(embeds), rope)
        losses.append(float(m["total_loss"]))
        jlosses.append(float(jm["total_loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[2] < losses[1] < losses[0] and jlosses[2] < jlosses[1] < jlosses[0]
    got = to_jax_layout(state.trainable, s.bp)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(jstate.trainable)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-2 * lr,
                                   err_msg=jax.tree_util.keystr(path))
    moved = np.abs(got["branch_blocks"]["kernel"] - jtree["branch_blocks"]["kernel"]).max()
    assert moved > 0.5 * lr   # the zero projections took a step of about lr


def test_make_optimizer_surface():
    """As tests/test_training.py holds the JAX factory: every choice moves the
    parameters by a finite amount, and Adafactor's state is smaller."""
    sizes = {}
    for name in ("adam", "adamw", "prodigy", "adafactor"):
        opt = make_optimizer(lr=1e-2, optimizer=name)
        params = [torch.ones((256, 128)), torch.zeros((128,))]
        before = [p.clone() for p in params]
        state = opt.init(params)
        opt.update_(params, [torch.full((256, 128), 0.1), torch.full((128,), -0.2)], state)
        moved = sum(float((p - b).abs().sum()) for p, b in zip(params, before))
        assert np.isfinite(moved), name
        if name != "prodigy":   # prodigy's first step is lr discovery
            assert moved > 0, name
        sizes[name] = sum(t.numel() for v in state.values() if isinstance(v, list)
                          for t in v if torch.is_tensor(t))
    assert sizes["adafactor"] < 0.55 * sizes["adamw"], sizes
    with pytest.raises(ValueError, match="unsupported optimizer"):
        make_optimizer(optimizer="sgd-nope")


# -- checkpoints, exports, the CLI --------------------------------------------------------------

def test_checkpoint_save_rotate_resume(tmp_path, stack):
    _, branch, _ = stack.port()
    opt = make_optimizer(lr=1e-2, accumulate_steps=2)
    state = init_branch_train_state(branch, opt)
    leaves = tree_leaves(state.trainable)
    grads = [torch.full_like(p, 0.01) for p in leaves]
    for _ in range(2):
        opt.update_(leaves, grads, state.opt_state)
    out = str(tmp_path)
    saved = {"step": 2, "trainable": state.trainable, "opt_state": state.opt_state}
    for step in (1, 2, 3):
        tckpt.save_checkpoint(out, step, dict(saved, step=step), total_limit=2)
    assert sorted(os.listdir(out)) == ["checkpoint-2", "checkpoint-3"]
    assert tckpt.latest_checkpoint(out).endswith("checkpoint-3")
    assert tckpt.latest_checkpoint(os.path.join(out, "missing")) is None
    tckpt.rotate_checkpoints(out, 1)
    assert sorted(os.listdir(out)) == ["checkpoint-3"]

    want = {n: p.detach().clone() for n, p in state.trainable.items()}
    want_mu = [m.clone() for m in state.opt_state["mu"]]
    _, fresh, _ = stack.port()
    fresh_state = init_branch_train_state(fresh, opt)
    with torch.no_grad():
        for p in fresh.parameters():
            p.add_(1.0)
    target = {"step": 0, "trainable": fresh_state.trainable, "opt_state": fresh_state.opt_state}
    restored = tckpt.restore_checkpoint(tckpt.latest_checkpoint(out), target)
    assert restored["step"] == 3 and restored["opt_state"]["count"] == 1
    for n, p in fresh.named_parameters():   # copied into the module's own tensors
        assert torch.equal(p.detach(), want[n])
    assert all(torch.equal(a, b) for a, b in zip(restored["opt_state"]["mu"], want_mu))
    raw = tckpt.restore_checkpoint(tckpt.latest_checkpoint(out))
    assert raw["step"] == 3 and sorted(raw) == ["opt_state", "step", "trainable"]


def test_export_round_trip_under_reference_names(tmp_path, stack):
    """The branch under diffusers names and the adapter under peft names, as
    the JAX package writes them: same files, same keys, same values."""
    from safetensors.numpy import load_file

    from videopainter_tpu.training import checkpoint as jckpt

    _, branch, _ = stack.port()
    bcfg = tcfg.BranchConfig.from_transformer(stack.tt, num_layers=2)
    tckpt.export_branch_pretrained(branch, bcfg.to_dict(), str(tmp_path / "port"))
    jckpt.export_branch_pretrained(stack.bp, stack.jb.to_dict(), str(tmp_path / "jax"))
    name = "diffusion_pytorch_model.safetensors"
    got, want = load_file(str(tmp_path / "port" / name)), load_file(str(tmp_path / "jax" / name))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert cfg["_class_name"] == "CogvideoXBranchModel"
    assert cfg == json.loads((tmp_path / "jax" / "config.json").read_text())
    fresh = CogVideoXBranch(tcfg.load_config(str(tmp_path / "port" / "config.json"),
                                             tcfg.BranchConfig))
    fresh.load_state_dict(load_safetensors_dir(str(tmp_path / "port")))
    for (n, a), (_, b) in zip(fresh.state_dict().items(), branch.state_dict().items()):
        assert torch.equal(a, b), n

    lora = random_lora(stack)
    tckpt.export_lora_weights(lora_params(lora), str(tmp_path / "port_lora"))
    jckpt.export_lora_weights(lora, str(tmp_path / "jax_lora"))
    name = "pytorch_lora_weights.safetensors"
    got = load_file(str(tmp_path / "port_lora" / name))
    want = load_file(str(tmp_path / "jax_lora" / name))
    assert sorted(got) == sorted(want) and len(got) == 2 * 4 * 2
    assert "transformer.transformer_blocks.1.attn1.to_out.0.lora_B.weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = convert_peft_lora_state_dict(got, num_layers=2, rank=4)
    for tgt in lora:
        np.testing.assert_array_equal(back[tgt]["lora_A"].numpy(), lora[tgt]["lora_A"])


@pytest.mark.parametrize("mode", ["branch", "lora"])
def test_validation_fn_runs_the_pipeline(stack, stack_rs, mode):
    """The in-training validation: the current weights through the single-clip
    pipeline (DDIM, the trainer's scheduler), a side-by-side video in [0, 1];
    an adapter attached for the run is taken off again."""
    from videopainter_tpu_torch.training.validation import make_validation_fn

    s = stack_rs if mode == "lora" else stack
    dit, branch, vae = s.port()
    batch = {k: T(v) for k, v in make_batch().items()}
    fn = make_validation_fn(dit, branch, vae, s.sched, batch, num_inference_steps=2, mode=mode,
                            lora_alpha=2.0, lora_rank=4)
    trainable = lora_params(random_lora(s)) if mode == "lora" else dict(branch.named_parameters())
    out = fn(trainable, 2)
    assert out.shape == (9, 64, 3 * 96, 3) and np.isfinite(out).all()
    assert out.min() >= 0 and out.max() <= 1
    np.testing.assert_allclose(out[:, :, :96], make_batch()["pixel_values"][0] / 2 + 0.5,
                               atol=1e-6)
    assert not any(n.startswith("lora_") for m in dit.modules() for n in m._buffers)
    if mode == "branch":   # replace_gt alternates with the step: another video
        assert np.abs(fn(trainable, 3)[:, :, 192:] - out[:, :, 192:]).max() > 0


def _cli_fixture(root, stack):
    """Tiny exported checkpoints, a one-clip dataset and prompt embeddings."""
    cv2 = pytest.importorskip("cv2")
    pd = pytest.importorskip("pandas")
    dit, branch, vae = stack.port()
    tckpt.export_transformer_pretrained(dit, stack.tt.to_dict(),
                                        os.path.join(root, "model", "transformer"))
    tckpt.export_vae_pretrained(vae, tcfg.VAEConfig.tiny(latent_channels=16).to_dict(),
                                os.path.join(root, "model", "vae"))
    tckpt.export_branch_pretrained(
        branch, tcfg.BranchConfig.from_transformer(stack.tt, num_layers=2).to_dict(),
        os.path.join(root, "branch"))
    rng = np.random.RandomState(0)
    video = (rng.rand(9, 64, 96, 3) * 255).astype(np.uint8)
    vpath = os.path.join(root, "vid.mp4")
    vw = cv2.VideoWriter(vpath, cv2.VideoWriter_fourcc(*"mp4v"), 8, (96, 64))
    for f in video:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    masks = np.zeros((9, 64, 96), np.uint8)
    masks[:, 20:40, 30:60] = 1
    np.savez(os.path.join(root, "all_masks.npz"), **{"0": masks})
    pd.DataFrame([{"path": vpath, "fps": 8, "start_frame": 0, "end_frame": 0, "mask_id": 0,
                   "caption": "a colorful noise pattern morphing over time x"}]
                 ).to_csv(os.path.join(root, "meta.csv"), index=False)
    np.save(os.path.join(root, "embeds.npy"), rng.rand(1, 5, 12).astype(np.float32))


@pytest.mark.parametrize("mode", ["branch", "lora"])
def test_cli_two_steps_on_tiny_checkpoints(tmp_path, stack, stack_rs, mode, capsys):
    """`cli.main` end to end on the CPU: 2 optimizer steps from tiny exported
    checkpoints with --prompt_embeds_file, a pipeline validation after step 2,
    a checkpoint at step 2, the final export under the reference names, and a
    resume that has nothing left to do."""
    from safetensors.numpy import load_file

    from videopainter_tpu_torch.training import cli

    root = str(tmp_path)
    _cli_fixture(root, stack_rs if mode == "lora" else stack)
    out = os.path.join(root, "run")
    argv = ["--pretrained_model_name_or_path", os.path.join(root, "model"),
            "--meta_file_path", os.path.join(root, "meta.csv"),
            "--prompt_embeds_file", os.path.join(root, "embeds.npy"),
            "--output_dir", out, "--height", "64", "--width", "96", "--max_num_frames", "9",
            "--min_caption_len", "10", "--max_train_steps", "2", "--checkpointing_steps", "2",
            "--lr_warmup_steps", "0", "--learning_rate", "1e-3", "--mask_add",
            "--first_frame_gt", "--device", "cpu", "--mode", mode,
            "--val_meta_file_path", os.path.join(root, "meta.csv"), "--validating_steps", "2"]
    if mode == "lora":
        argv += ["--cogvideox_branch_name_or_path", os.path.join(root, "branch"), "--rank", "4",
                 "--lora_alpha", "2.0"]
    state = cli.main(argv)
    assert "validation failed" not in capsys.readouterr().out
    assert state.step == 2 and state.opt_state["count"] == 2
    assert os.path.isfile(os.path.join(out, "checkpoint-2", tckpt.STATE_FILE))
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert log and np.isfinite(log[0]["total_loss"]) and "lr" in log[0]
    if mode == "branch":
        sd = load_file(os.path.join(out, "export", "diffusion_pytorch_model.safetensors"))
        assert np.abs(sd["branch_blocks.0.weight"]).max() > 0
    else:
        sd = load_file(os.path.join(out, "export", "pytorch_lora_weights.safetensors"))
        assert np.abs(sd["transformer.transformer_blocks.0.attn1.to_q.lora_B.weight"]).max() > 0
    resumed = cli.main(argv)   # resumes from checkpoint-2: no step left
    assert resumed.step == 2
    for a, b in zip(tree_leaves(resumed.trainable), tree_leaves(state.trainable)):
        assert torch.equal(a.detach(), b.detach())


def test_cli_refuses_what_is_not_ported(tmp_path):
    from videopainter_tpu_torch.training import cli

    base = ["--pretrained_model_name_or_path", str(tmp_path), "--meta_file_path", "x.csv",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="=2 != 1 ranks"):
        cli.main(base + ["--mesh_data", "2"])   # a mesh larger than the world
    args = cli.get_args(base + ["--use_flash", "--remat_chunk", "7", "--optimizer", "adafactor"])
    assert args.use_flash and args.remat_chunk == 7 and args.gradient_checkpointing
