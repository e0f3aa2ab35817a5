"""The port's data-, sequence- and tensor-parallel training (ZeRO-2 optimizer
state, `train(mesh=)`, the CLI's mesh flags) on the CPU.

Ranks are processes over gloo (`parallel.launch.run_local`, each call with
its own timeout; rank functions in `parallel/workers.py`, which imports no
JAX). The grad steps are held to the JAX package's on JAX-prepared tensors
(tests/test_torch_training.py's tolerances: losses rtol 1e-5, gradients
rtol 2e-4 + atol 2e-6; the remat-chunk tensor-parallel loss rtol 2e-5, as
tests/test_training.py:445-500); the loops, whose random draws differ
between the packages, to the port's one-process loop at the same global
batch: the parameters after two steps at rtol 1e-5 (2e-5 for Adafactor),
atol 1e-5. AdamW moves each parameter by about lr = 1e-3 a step whatever
its gradient's size, so where a gradient is near zero the rounding of the
batch mean (two per-rank halves against one sum) shows at that scale:
1 % of a step.
"""
PARAM_ATOL = 1e-5

import os

import numpy as np
import pytest
import torch

from videopainter_tpu_torch.parallel import run_local, workers

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)


def random_params(init, seed):
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


def make_batch(b, seed=0, t=9):
    rng = np.random.default_rng(seed)
    masks = np.zeros((b, t, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    video = rng.uniform(-1, 1, (b, t, 64, 96, 3)).astype(np.float32)
    return {"pixel_values": video, "conditioning_pixel_values": video * (1 - masks[..., None]),
            "masks": masks, "prompt_embeds": rng.standard_normal((b, 5, 12)).astype(np.float32)}


class Stack:
    """Tiny JAX models and params, and the port's model spec on them."""

    def __init__(self, **kw):
        import videopainter_tpu.config as jcfg
        from videopainter_tpu.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                             CogVideoXTransformer3D)
        from videopainter_tpu.schedulers import CogVideoXDDIMScheduler
        from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                                    vae_state_dict)

        self.jt = jcfg.TransformerConfig.tiny(**{**DIT_KW, **kw})
        self.jb = jcfg.BranchConfig.from_transformer(self.jt, num_layers=2)
        self.jv = jcfg.VAEConfig.tiny(latent_channels=16)
        self.jdit, self.jbranch = CogVideoXTransformer3D(self.jt), CogVideoXBranch(self.jb)
        self.jvae = AutoencoderKLCogVideoX(self.jv)
        self.tp = random_params(self.jdit.init, 11)
        self.bp = random_params(self.jbranch.init, 12)
        self.vp = random_params(self.jvae.init, 13)
        self.sched_cfg = jcfg.SchedulerConfig(prediction_type="v_prediction")
        self.jsched = CogVideoXDDIMScheduler(self.sched_cfg)
        self.models = {"tcfg": self.jt.to_dict(), "bcfg": self.jb.to_dict(),
                       "vcfg": self.jv.to_dict(),
                       "state": {"transformer": transformer_state_dict(self.tp),
                                 "branch": branch_state_dict(self.bp),
                                 "vae": vae_state_dict(self.vp)}}

    def spec(self, **kw):
        return dict({"models": self.models, "scheduler": ("ddim", self.sched_cfg.to_dict())},
                    **kw)

    def jax_grad_step(self, b, **cfg_kw):
        """The JAX grad step on its own prepared tensors for a batch of b:
        (prepared numpy tensors, embeddings, metrics, gradient tree)."""
        import jax
        import jax.numpy as jnp
        import optax

        from videopainter_tpu.pipelines.common import prepare_rope
        from videopainter_tpu.training import train_branch as jtrain

        cfg = jtrain.BranchTrainConfig(height=64, width=96, mask_add=True, **cfg_kw)
        batch = {k: jnp.asarray(v) for k, v in make_batch(b).items()}
        # one jitted program: eager, the VAE encodes compile op by op
        prep = jax.jit(jtrain._make_prepare(self.jvae, self.jsched, cfg))(
            self.vp, batch, jax.random.PRNGKey(0))
        prep = [np.asarray(x) for x in prep]
        rope = prepare_rope(self.jt, 64, 96, prep[4].shape[1],
                            self.jv.spatial_compression_ratio)
        opt = optax.sgd(1.0)
        step = jtrain.make_branch_train_step(self.jdit, self.jbranch, self.jvae, self.jsched,
                                             opt, cfg)
        state = jtrain.init_branch_train_state(jax.tree.map(jnp.asarray, self.bp), opt)
        new, metrics = step.grad_step(state, self.tp, *map(jnp.asarray, prep),
                                      batch["prompt_embeds"], rope)
        grads = jax.tree.map(lambda p, n: np.asarray(p) - np.asarray(n), self.bp,
                             new.trainable)
        return prep, np.asarray(batch["prompt_embeds"]), \
            {k: float(v) for k, v in metrics.items()}, grads


def _check_grads(stack_bp, named, jgrads):
    import jax

    from videopainter_tpu_torch.convert.from_jax import to_jax_layout

    got = to_jax_layout({k: torch.from_numpy(v) for k, v in named.items()}, stack_bp)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_want) > 20
    for path, a in flat_got:
        np.testing.assert_allclose(a, flat_want[path], err_msg=jax.tree_util.keystr(path),
                                   **GRAD_TOL)


def test_parallel_grad_steps_match_jax():
    """World 2, on JAX-prepared tensors: the branch grad step at a global
    batch of 2 under `data` 2 (each rank its sample, gradients averaged), at
    batch 1 under `seq` 2 with the ring (flash path: B1 blocks forward, the
    merged-lse backward) and under `model` 2 (tensor-parallel backbone and
    branch, their gradients gathered whole), each against the JAX step; the
    remat-chunk loss of a 5-layer, 4-head backbone tensor-parallel (chunks
    of 2: a remainder group) against JAX's unsharded flat-remat loss
    (tests/test_training.py:445-500); and the ID-LoRA step under model=2
    (whole adapter factors sliced to each rank's rows or columns, their
    gradients summed over `model`) against the one-process port."""
    s = Stack()
    s5 = Stack(num_attention_heads=4, attention_head_dim=16, num_layers=5)
    bcfg = dict(height=64, width=96, mask_add=True, remat=False)
    p2, e2, jm2, jg2 = s.jax_grad_step(2, remat=False)
    p1, e1, jm1, jg1 = s.jax_grad_step(1, remat=False)
    p5, e5, jm5, _ = s5.jax_grad_step(1, remat=True)
    cases = [
        ("grad_step_rank", s.spec(mesh=(2, 1, 1), prepared=p2, embeds=e2, bcfg=bcfg)),
        ("grad_step_rank", s.spec(mesh=(1, 2, 1), prepared=p1, embeds=e1, seq="ring",
                                  bcfg=dict(bcfg, use_flash=True, remat=True))),
        ("grad_step_rank", s.spec(mesh=(1, 1, 2), prepared=p1, embeds=e1, bcfg=bcfg)),
        ("grad_step_rank", s5.spec(mesh=(1, 1, 2), prepared=p5, embeds=e5,
                                   bcfg=dict(bcfg, remat=True, remat_chunk=2))),
    ]
    rng = np.random.default_rng(9)
    lora = {t: {"lora_A": rng.standard_normal((2, 32, 4)).astype(np.float32) * 0.2,
                "lora_B": rng.standard_normal((2, 4, 32)).astype(np.float32) * 0.2}
            for t in ("to_k", "to_out", "to_q", "to_v")}
    lora_spec = s.spec(mesh=(1, 1, 2), prepared=p1, embeds=e1, lora=lora,
                       bcfg=dict(bcfg, lora_rank=4, lora_alpha=2.0))
    cases.append(("grad_step_rank", lora_spec))
    res = run_local(2, workers.cases_rank, cases, timeout=240, threads=torch.get_num_threads())
    one = workers.grad_step_rank(dict(lora_spec, mesh=None))
    for r in res:
        for got, jm, jg in ((r[0], jm2, jg2), (r[1], jm1, jg1), (r[2], jm1, jg1)):
            for k in ("loss", "inpainting_loss", "total_loss", "gradient_norm_before_clip"):
                np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=1e-5, err_msg=k)
            _check_grads(s.bp, got["grads"], jg)
        np.testing.assert_allclose(r[3]["metrics"]["total_loss"], jm5["total_loss"], rtol=2e-5)
        np.testing.assert_allclose(r[4]["metrics"]["total_loss"], one["metrics"]["total_loss"],
                                   rtol=1e-5)
        assert sorted(r[4]["grads"]) == sorted(one["grads"]) and len(one["grads"]) == 8
        for k, v in one["grads"].items():
            assert np.abs(v).max() > 0, k
            np.testing.assert_allclose(r[4]["grads"][k], v, err_msg=k, **GRAD_TOL)
    assert res[0][1]["comm"]["sendrecv"]["calls"] > 0


def _trainer_spec(s, out_dir, steps, optimizer="adamw", mesh=None, resume=None):
    return s.spec(mesh=mesh, batch=make_batch(2), bcfg=dict(height=64, width=96, mask_add=True,
                                                             remat=False),
                  trainer=dict(output_dir=out_dir, max_train_steps=steps, learning_rate=1e-3,
                               lr_warmup_steps=0, lr_scheduler="constant", optimizer=optimizer,
                               checkpointing_steps=2, validating_steps=100, log_every=1,
                               resume_from_checkpoint=resume, seed=3))


def test_train_mesh_zero2_resume_and_adafactor(tmp_path):
    """`train(mesh)` at data 2 (the JAX `train(mesh)` of
    tests/test_training.py:413-443, the port's way): two AdamW steps equal to
    the one-process loop at the same global batch of 2, each rank holding
    half of the stacked block moments, parameters bit-equal on both ranks;
    its checkpoint (gathered to the one-card layout) resumes on one process
    to the same third step as the one-process run's; Adafactor under ZeRO-2
    (its block rms summed over the ranks) equal to one process, its
    checkpoint resumed on one process too."""
    s = Stack()
    d = lambda name: str(tmp_path / name)
    cases = [("trainer_rank", _trainer_spec(s, d("zero"), 2, mesh=(2, 1, 1))),
             ("trainer_rank", _trainer_spec(s, d("zero_af"), 2, "adafactor", mesh=(2, 1, 1)))]
    res = run_local(2, workers.cases_rank, cases, timeout=240, threads=torch.get_num_threads())
    one = workers.trainer_rank(_trainer_spec(s, d("one"), 2))
    one_af = workers.trainer_rank(_trainer_spec(s, d("one_af"), 2, "adafactor"))
    for case, ref, tol in ((0, one, 1e-5), (1, one_af, 2e-5)):
        a, b = res[0][case], res[1][case]
        assert a["checksum"] == b["checksum"] and a["step"] == b["step"] == 2
        assert a["opt_numel"] < ref["opt_numel"] and a["opt_numel"] == b["opt_numel"]
        for k, v in ref["params"].items():
            np.testing.assert_allclose(a["params"][k], v, rtol=tol, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose([x["total_loss"] for x in a["log"]],
                                   [x["total_loss"] for x in ref["log"]], rtol=1e-5)
    assert res[0][0]["comm"]["all_gather"]["calls"] > 0   # the ZeRO-2 parameter sync
    # resume the ZeRO-2 checkpoint on one process; the one-process run resumes its own
    assert os.path.isdir(os.path.join(d("zero"), "checkpoint-2"))
    for zero_dir, one_dir, opt, tol in (("zero", "one", "adamw", 1e-5),
                                        ("zero_af", "one_af", "adafactor", 2e-5)):
        r_zero = workers.trainer_rank(_trainer_spec(s, d(zero_dir), 3, opt, resume="latest"))
        r_one = workers.trainer_rank(_trainer_spec(s, d(one_dir), 3, opt, resume="latest"))
        assert r_zero["step"] == r_one["step"] == 3
        for k, v in r_one["params"].items():
            np.testing.assert_allclose(r_zero["params"][k], v, rtol=tol, atol=PARAM_ATOL,
                                       err_msg=f"{opt} {k}")


def test_tp_adafactor_step_matches_one_process_and_optax():
    """World 2, `model` 2, Adafactor (also what `--use_8bit_adam` runs): one
    branch-SFT step on a backbone of 4 heads x 64 (inner width 256), so
    each column-parallel weight's split axis keeps 128 rows a rank and
    factors on both sides of the split. The factored moment's row and
    column means over the split axis are sums over `model` divided by the
    whole leaf's length, and the factoring is chosen on the whole leaf's
    shape: the parameters after the step equal the one-process step's and
    optax.adafactor's on the one-process gradient (rtol 2e-5, atol
    PARAM_ATOL, the Adafactor limits above)."""
    import jax
    import jax.numpy as jnp
    import optax

    from videopainter_tpu.training.optim import make_optimizer as jmake
    from videopainter_tpu_torch.convert.from_jax import to_jax_layout

    s = Stack(num_attention_heads=4, attention_head_dim=64)
    opt = dict(lr=1e-3, optimizer="adafactor", weight_decay=1e-4)
    spec = s.spec(mesh=(1, 1, 2), batch=make_batch(1), steps=1, optimizer=opt,
                  bcfg=dict(height=64, width=96, mask_add=True, remat=False),
                  return_params=True)
    res = run_local(2, workers.train_rank, spec, timeout=240, threads=torch.get_num_threads())
    one = workers.train_rank(dict(spec, mesh=None))
    names = sorted(one["params"])
    sizes = [one["params"][k].size for k in names]
    flat = np.split(one["grad"], np.cumsum(sizes)[:-1])
    grads = {k: torch.from_numpy(g.reshape(one["params"][k].shape)) for k, g in zip(names, flat)}
    jgrads = jax.tree.map(jnp.asarray, to_jax_layout(grads, s.bp))
    params0 = jax.tree.map(jnp.asarray, s.bp)
    tx = jmake(**opt)
    # one program: eager, optax's Adafactor compiles op by op
    updates, _ = jax.jit(tx.update)(jgrads, tx.init(params0), params0)
    want = jax.tree.map(np.asarray, optax.apply_updates(params0, updates))
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    factored = [k for k in names if "transformer_blocks" in k and k.endswith("to_q.weight")]
    assert factored and all(min(one["params"][k].shape) >= 256 for k in factored)
    for r in res:
        assert r["comm"]["all_reduce"]["calls"] > 0
        for k in names:
            np.testing.assert_allclose(r["params"][k], one["params"][k], rtol=2e-5,
                                       atol=PARAM_ATOL, err_msg=k)
        got = to_jax_layout({k: torch.from_numpy(v) for k, v in r["params"].items()}, s.bp)
        for path, a in jax.tree_util.tree_flatten_with_path(got)[0]:
            np.testing.assert_allclose(a, flat_want[path], rtol=2e-5, atol=PARAM_ATOL,
                                       err_msg=jax.tree_util.keystr(path))


def _cli_files(root, s):
    """Tiny exported checkpoints of the stack, a two-row dataset of one clip
    and prompt embeddings."""
    cv2 = pytest.importorskip("cv2")
    pd = pytest.importorskip("pandas")

    import videopainter_tpu_torch.config as tcfg
    from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                               CogVideoXTransformer3D)
    from videopainter_tpu_torch.training import checkpoint as tckpt

    t = tcfg.TransformerConfig.from_dict(s.jt.to_dict())
    mods = (CogVideoXTransformer3D(t), CogVideoXBranch(tcfg.BranchConfig.from_transformer(
        t, num_layers=2)), AutoencoderKLCogVideoX(tcfg.VAEConfig.from_dict(s.jv.to_dict())))
    for m, key in zip(mods, ("transformer", "branch", "vae")):
        m.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in s.models["state"][key].items()}, strict=False)
    tckpt.export_transformer_pretrained(mods[0], t.to_dict(), os.path.join(root, "model",
                                                                           "transformer"))
    tckpt.export_vae_pretrained(mods[2], s.jv.to_dict(), os.path.join(root, "model", "vae"))
    tckpt.export_branch_pretrained(mods[1], s.jb.to_dict(), os.path.join(root, "branch"))
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
    row = {"path": vpath, "fps": 8, "start_frame": 0, "end_frame": 0, "mask_id": 0,
           "caption": "a colorful noise pattern morphing over time x"}
    pd.DataFrame([row, row]).to_csv(os.path.join(root, "meta.csv"), index=False)
    np.save(os.path.join(root, "embeds.npy"), rng.rand(1, 5, 12).astype(np.float32))


def test_cli_mesh_data_2(tmp_path):
    """`cli.main` with `--mesh_data 2` on two ranks (as under torchrun): one
    optimizer step at a global batch of 2, the ranks' parameters bit-equal,
    the final export (rank 0's) equal to a one-process run's at the same
    batch."""
    from safetensors.numpy import load_file

    from videopainter_tpu_torch.training import cli

    s = Stack()
    root = str(tmp_path)
    _cli_files(root, s)

    def argv(out):
        return ["--pretrained_model_name_or_path", os.path.join(root, "model"),
                "--cogvideox_branch_name_or_path", os.path.join(root, "branch"),
                "--meta_file_path", os.path.join(root, "meta.csv"),
                "--prompt_embeds_file", os.path.join(root, "embeds.npy"),
                "--output_dir", out, "--height", "64", "--width", "96", "--max_num_frames", "9",
                "--min_caption_len", "10", "--max_train_steps", "1", "--checkpointing_steps",
                "100", "--lr_warmup_steps", "0", "--learning_rate", "1e-3", "--mask_add",
                "--first_frame_gt", "--device", "cpu", "--train_batch_size", "2"]

    res = run_local(2, workers.cli_rank, argv(os.path.join(root, "mesh")) + ["--mesh_data", "2"],
                    timeout=240, threads=torch.get_num_threads())
    assert res[0]["step"] == res[1]["step"] == 1 and res[0]["checksum"] == res[1]["checksum"]
    cli.main(argv(os.path.join(root, "one")))
    name = os.path.join("export", "diffusion_pytorch_model.safetensors")
    got, want = (load_file(os.path.join(root, d, name)) for d in ("mesh", "one"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=PARAM_ATOL, err_msg=k)
