"""The port's inference entry points (videopainter_tpu_torch/infer/) and its
checkpoint reader, on the CPU, against the JAX package's CLIs.

 - convert/safetensors_io: checkpoint directories, sharded with their
   index or not, written and read back exactly.
 - `build_pipeline` on the checkpoint directories that
   tests/test_cli_integration.make_ckpts writes with the JAX exports: the
   loaded state dicts equal `from_jax` of the JAX build_pipeline's params
   (exactly; the LoRA-merged attention weights to 1e-6, the same product
   summed in another order), with a branch, without (the SFT any-length
   pipeline), and with a rank-256 ID adapter.
 - The pipeline call that `generate_video` makes from `get_args(argv)`: its
   arguments equal the JAX CLI's for each flag set (everything but the random
   key), each side's pipeline call recorded instead of run.
 - `main(argv)` end to end on make_data's mp4, masks and CSV (the mp4 is
   written; two runs with one --seed are equal); `--int8 --int8_scales` with
   scales the port saved; no CUDA and no `--device cpu` raises.
 - `make_self_first_frame_inpaint` (dual, and the branchless SFT) as
   tests/test_first_frame.py holds the JAX one, and against it with the same
   injected noise (atol 1e-4 on frames in [0, 1]).
 - `edit_bench_main`: the sweep and the VLM fallback as
   tests/test_edit_bench.py holds the JAX one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import videopainter_tpu.config as jcfg  # noqa: E402
import videopainter_tpu.infer.inpaint as jinfer  # noqa: E402
import videopainter_tpu.pipelines as jpipes  # noqa: E402
import videopainter_tpu_torch.config as tcfg  # noqa: E402
import videopainter_tpu_torch.infer.inpaint as tinfer  # noqa: E402
import videopainter_tpu_torch.pipelines as tpipes  # noqa: E402
from tests.test_cli_integration import make_ckpts, make_data  # noqa: E402
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,  # noqa: E402
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM  # noqa: E402
from videopainter_tpu.training.checkpoint import export_lora_weights  # noqa: E402
from videopainter_tpu_torch.convert import (branch_state_dict, load_safetensors_dir,  # noqa: E402
                                            save_safetensors_dir, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.infer.edit import edit_bench_main  # noqa: E402
from videopainter_tpu_torch.infer.first_frame import make_self_first_frame_inpaint  # noqa: E402
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,  # noqa: E402
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.ops.basic import Int8Linear  # noqa: E402
from videopainter_tpu_torch.quantize import save_ascales  # noqa: E402
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler  # noqa: E402


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


# -- checkpoint directories ------------------------------------------------------------

@pytest.mark.parametrize("max_shard_bytes", [None, 200])
def test_checkpoint_dir_round_trip(tmp_path, max_shard_bytes):
    """save_safetensors_dir writes one file or shards with their index (the
    diffusers layout); load_safetensors_dir reads either back exactly, and
    a directory of several files without an index."""
    from safetensors.numpy import save_file

    g = torch.Generator().manual_seed(1)
    sd = {"blocks.0.w": torch.randn((8, 6), generator=g).to(torch.bfloat16),
          "blocks.0.q": torch.randint(-127, 128, (5, 3), generator=g, dtype=torch.int8),
          "blocks.1.w": torch.randn((10, 4), generator=g),
          "scale": torch.tensor(0.25), "strided": torch.randn((4, 6), generator=g).t()}
    out = str(tmp_path / "ckpt")
    n = save_safetensors_dir(sd, out, max_shard_bytes=max_shard_bytes, config={"x": 1})
    files = sorted(f for f in os.listdir(out) if f.endswith(".safetensors"))
    if max_shard_bytes:
        assert len(files) > 1
        assert files[0] == f"diffusion_pytorch_model-00001-of-{len(files):05d}.safetensors"
        with open(os.path.join(out, "diffusion_pytorch_model.safetensors.index.json")) as f:
            index = json.load(f)
        assert set(index["weight_map"]) == set(sd)
        assert set(index["weight_map"].values()) == set(files)
    else:
        assert files == ["diffusion_pytorch_model.safetensors"]
    assert n == sum(os.path.getsize(os.path.join(out, f)) for f in files)
    with open(os.path.join(out, "config.json")) as f:
        assert json.load(f) == {"x": 1}
    loaded = load_safetensors_dir(out)
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    # files without an index (as the JAX exports write them) are read all together
    plain = tmp_path / "plain"
    plain.mkdir()
    save_file({"a": np.arange(3, dtype=np.float32)}, str(plain / "one.safetensors"))
    save_file({"b": np.ones(2, np.int64)}, str(plain / "two.safetensors"))
    both = load_safetensors_dir(str(plain))
    assert torch.equal(both["a"], torch.arange(3.0)) and torch.equal(both["b"], torch.ones(2).long())
    save_file({"a": np.zeros(1, np.float32)}, str(plain / "three.safetensors"))
    with pytest.raises(ValueError, match="more than one file"):
        load_safetensors_dir(str(plain))


# -- build_pipeline against the JAX CLI's ------------------------------------------------

def lora_dir(root):
    """A rank-256 ID adapter for make_ckpts' 2-layer backbone (inner 32), in
    the JAX package's export."""
    rng = np.random.default_rng(7)
    lora = {t: {"lora_A": (rng.standard_normal((2, 32, 256)) * 0.1).astype(np.float32),
                "lora_B": (rng.standard_normal((2, 256, 32)) * 0.1).astype(np.float32)}
            for t in ("to_q", "to_k", "to_v", "to_out")}
    path = os.path.join(root, "lora")
    export_lora_weights(lora, path)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpts"))
    make_ckpts(root)
    make_data(root)
    np.save(os.path.join(root, "embeds.npy"),
            np.random.RandomState(3).rand(1, 5, 12).astype(np.float32))
    return root, lora_dir(root)


def f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.mark.parametrize("case", ["branch", "no_branch", "id_adapter", "branch_bf16"])
def test_build_pipeline_matches_jax(ckpts, case):
    root, lora = ckpts
    branch = None if case == "no_branch" else os.path.join(root, "branch")
    adapter = lora if case == "id_adapter" else None
    dtype = "bfloat16" if case == "branch_bf16" else "float32"
    jpipe, params = jinfer.build_pipeline(os.path.join(root, "model"), branch, adapter, dtype)
    pipe = tinfer.build_pipeline(os.path.join(root, "model"), branch, adapter, dtype,
                                 device="cpu")
    assert type(pipe).__name__ == type(jpipe).__name__
    assert pipe.transformer.cfg.id_pool_resample_learnable == (case == "id_adapter")
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pairs = [("transformer", pipe.transformer, transformer_state_dict(f32(params["transformer"]))),
             ("vae", pipe.vae, vae_state_dict(f32(params["vae"])))]
    if branch:
        pairs.append(("branch", pipe.branch, branch_state_dict(f32(params["branch"]))))
    else:
        assert pipe.branch is None and "branch" not in params
    for name, module, want in pairs:
        got = module.state_dict()
        assert set(got) == set(want), name
        for k, v in want.items():
            assert got[k].dtype == want_dtype, k
            g = got[k].float()
            if case == "id_adapter" and ".attn1.to_" in k and k.endswith("weight"):
                np.testing.assert_allclose(g.numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
            else:
                assert torch.equal(g, v.float()), f"{name} {k}"


# -- the CLI's pipeline call against the JAX CLI's ---------------------------------------

FLAG_SETS = {"default": [], "int8_attn": ["--int8", "--int8_attn"], "int8_pv": ["--int8_pv"],
             "skip_steps": ["--num_inference_steps", "6", "--skip_steps", "2:5:2"],
             "sequential_cfg": ["--sequential_cfg"],
             "no_capture_int8": ["--int8", "--no_capture_int8", "--capture_int8"]}


def cli_argv(root, extra=()):
    return ["--model_path", os.path.join(root, "model"),
            "--inpainting_branch", os.path.join(root, "branch"),
            "--meta_file_path", os.path.join(root, "meta.csv"), "--video_id", "0",
            "--output_path", os.path.join(root, "out"),
            "--prompt_embeds", os.path.join(root, "embeds.npy"),
            "--height", "64", "--width", "96", "--num_frames", "9",
            "--num_inference_steps", "2", "--replace_gt", "--mask_add", "--first_frame_gt",
            *extra]


def _value(v):
    """A pipeline argument of either package in comparable form."""
    if isinstance(v, torch.dtype):
        return "dtype", str(v).removeprefix("torch.")
    if isinstance(v, torch.Tensor):
        return "array", v.float().numpy()
    if isinstance(v, (np.ndarray, jax.Array)):
        return "array", np.asarray(v, np.float32)
    if isinstance(v, type):   # a JAX dtype
        return "dtype", jnp.dtype(v).name
    return "value", v


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_cli_pipeline_call_matches_jax(ckpts, monkeypatch, flags):
    root, lora = ckpts
    extra = FLAG_SETS[flags] + (["--id_adapter", lora] if flags == "int8_attn" else [])
    calls = {}

    def record(key):
        def call(self, *params, **kw):
            calls[key] = kw
            return np.zeros(tuple(kw["video"].shape), np.float32)
        return call

    monkeypatch.setattr(jpipes.CogVideoXI2VDualInpaintAnyLPipeline, "__call__", record("jax"))
    monkeypatch.setattr(tpipes.CogVideoXI2VDualInpaintAnyLPipeline, "__call__", record("port"))
    jinfer.generate_video(jinfer.get_args(cli_argv(root, [*extra, "--dtype", "float32"])))
    tinfer.generate_video(tinfer.get_args(cli_argv(root, [*extra, "--dtype", "float32",
                                                          "--device", "cpu"])))
    j, t = dict(calls["jax"]), dict(calls["port"])
    assert isinstance(j.pop("rng"), jax.Array) and isinstance(t.pop("generator"), torch.Generator)
    assert set(j) == set(t)
    for k in j:
        (kind_j, vj), (kind_t, vt) = _value(j[k]), _value(t[k])
        assert kind_j == kind_t, k
        if kind_j == "array":
            assert vj.shape == vt.shape and np.array_equal(vj, vt), k
        else:
            assert vj == vt, (k, vj, vt)
    assert t["use_flash"] == {"int8_attn": "int8", "int8_pv": "int8pv"}.get(flags, False)


@pytest.mark.parametrize("spec", ["2:5:2", "1:8", "3:9:3", "5,5,7", "0,2"])
def test_parse_skip_steps_matches_jax(spec):
    from videopainter_tpu.pipelines.common import parse_skip_steps as jparse

    assert tpipes.parse_skip_steps(spec, 10) == jparse(spec, 10)


@pytest.mark.parametrize("spec", ["12", "0:3", "2:5:1"])
def test_parse_skip_steps_rejects_what_jax_rejects(spec):
    from videopainter_tpu.pipelines.common import parse_skip_steps as jparse

    with pytest.raises(ValueError):
        jparse(spec, 10)
    with pytest.raises(ValueError):
        tpipes.parse_skip_steps(spec, 10)


# -- end to end -------------------------------------------------------------------------

def test_cli_main_end_to_end(ckpts):
    root, _ = ckpts
    argv = cli_argv(root, ["--dtype", "float32", "--device", "cpu", "--seed", "3"])
    mp4 = os.path.join(root, "out", "video_0.mp4")
    if os.path.exists(mp4):
        os.remove(mp4)
    first = tinfer.main(argv)
    assert os.path.exists(mp4) and os.path.getsize(mp4) > 0
    cap = cv2.VideoCapture(mp4)
    n, ok = 0, True
    while ok:
        ok, frame = cap.read()
        n += ok
        if ok:
            assert frame.shape == (64, 3 * 96, 3)
    assert n == 9
    assert first.shape == (9, 64, 96, 3) and np.isfinite(first).all()
    again = tinfer.generate_video(tinfer.get_args(argv))
    np.testing.assert_array_equal(first, again)


def test_cli_int8_static_scales(ckpts):
    root, _ = ckpts
    sites = ("to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out")
    path = os.path.join(root, "port_scales.npz")
    save_ascales(path, {m: {s: np.full(2, 0.2, np.float32) for s in sites}
                        for m in ("transformer", "branch")})
    args = tinfer.get_args(cli_argv(root, ["--dtype", "float32", "--device", "cpu", "--int8",
                                           "--sequential_cfg", "--int8_scales", path,
                                           "--vae_frame_batch", "1"]))
    pipe = tinfer.load_pipeline(args)
    assert pipe.vae.num_latent_frames_batch_size == 1
    for model in (pipe.transformer, pipe.branch):
        lin = model.transformer_blocks[1].attn1.to_v
        assert isinstance(lin, Int8Linear) and float(lin.ascale) == pytest.approx(0.2)
    out01 = tinfer.generate_video(args)
    assert out01.shape == (9, 64, 96, 3) and np.isfinite(out01).all()


def test_profile_region_writes_a_trace(tmp_path):
    from videopainter_tpu_torch.utils import annotate, maybe_profile

    with maybe_profile(False, "off", str(tmp_path)) as p:
        assert p is None
    with maybe_profile(True, "denoise", str(tmp_path)) as p:
        with annotate("step"):
            torch.ones(8).add_(1)
    with open(os.path.join(p, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert p == str(tmp_path / "denoise") and "step" in names


def test_cli_without_a_card_needs_device_cpu(ckpts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    root, _ = ckpts
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinfer.main(cli_argv(root))


# -- the first-frame hook ---------------------------------------------------------------

VAE_J, VAE_T = jcfg.VAEConfig.tiny(), tcfg.VAEConfig.tiny()
FF_KW = dict(in_channels=8, out_channels=4, sample_height=8, sample_width=12)
SFT_KW = dict(FF_KW, in_channels=4)


def _frame_and_mask():
    rng = np.random.RandomState(3)
    frame01 = rng.rand(64, 96, 3).astype(np.float32)
    mask = np.zeros((64, 96), np.float32)
    mask[16:40, 24:64] = 1.0
    return frame01, mask


def first_frame_stacks(kind):
    """(JAX any-length pipeline, its params, the port's) on the same weights."""
    sched = (JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()),
             CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference()))
    jvae = JVAE(VAE_J)
    vp = jvae.init(jax.random.PRNGKey(2))
    tvae = AutoencoderKLCogVideoX(VAE_T)
    tvae.load_state_dict(vae_state_dict(f32(vp)))
    if kind == "dual":
        jc, tc = jcfg.TransformerConfig.tiny(**FF_KW), tcfg.TransformerConfig.tiny(**FF_KW)
        tp = JDiT(jc).init(jax.random.PRNGKey(1))
        jb = JBranch(jcfg.BranchConfig.from_transformer(jc, num_layers=2))
        bp = jb.init_from_transformer(jax.random.PRNGKey(3), tp, jc)
        t = CogVideoXTransformer3D(tc)
        t.load_state_dict(transformer_state_dict(f32(tp)))
        b = CogVideoXBranch(tcfg.BranchConfig.from_transformer(tc, num_layers=2))
        b.load_state_dict(branch_state_dict(f32(bp)))
        return (jpipes.CogVideoXI2VDualInpaintAnyLPipeline(JDiT(jc), jb, jvae, sched[0]),
                {"transformer": tp, "branch": bp, "vae": vp},
                tpipes.CogVideoXI2VDualInpaintAnyLPipeline(t, b, tvae, sched[1], device="cpu"))
    jc, tc = jcfg.TransformerConfig.tiny(**SFT_KW), tcfg.TransformerConfig.tiny(**SFT_KW)
    base = JDiT(jc).init(jax.random.PRNGKey(0))
    tp = jpipes.init_sft_from_transformer(jax.random.PRNGKey(1), base, jc)
    t = tpipes.make_sft_inpaint_transformer(tc)
    t.load_state_dict(transformer_state_dict(f32(tp)))
    return (jpipes.CogVideoXI2VInpaintAnyLPipeline(jpipes.make_sft_inpaint_transformer(jc),
                                                   jvae, sched[0]),
            {"transformer": tp, "vae": vp},
            tpipes.CogVideoXI2VInpaintAnyLPipeline(t, tvae, sched[1], device="cpu"))


@pytest.mark.parametrize("kind", ["dual", "sft"])
def test_first_frame_inpaint_matches_jax(monkeypatch, kind):
    from videopainter_tpu.infer.first_frame import \
        make_self_first_frame_inpaint as jmake_self_first_frame_inpaint

    jpipe, params, pipe = first_frame_stacks(kind)
    frame01, mask = _frame_and_mask()
    embeds = np.random.RandomState(0).rand(1, 5, 12).astype(np.float32)
    steps = 3
    fn = make_self_first_frame_inpaint(pipe, num_inference_steps=steps, prompt_embeds=embeds)
    out = fn(frame01, mask, "a prompt")
    assert out.shape == frame01.shape and np.isfinite(out).all()
    outside = mask == 0   # composite: the pixels outside the hole are untouched
    np.testing.assert_array_equal(out[outside], frame01[outside])
    hole = out[mask > 0.5]   # the hole is filled, not left as the masked input
    masked_in = (frame01 * (1 - mask[..., None]))[mask > 0.5]
    assert np.abs(hole).max() > 1e-3 and np.abs(hole - masked_in).max() > 1e-3

    # against the JAX hook with the same noise injected into both single clips
    rng = np.random.default_rng(4)
    c = 4
    init = rng.standard_normal((1, 1, 8, 12, c)).astype(np.float32)
    dpm = rng.standard_normal((steps, 1, 1, 8, 12, c)).astype(np.float32)

    def injecting(cls, conv):
        orig = cls.__call__

        def call(self, *a, **kw):
            kw.update(init_noise=conv(init), dpm_noises=conv(dpm), vae_sample_mode="mode")
            return orig(self, *a, **kw)
        monkeypatch.setattr(cls, "__call__", call)

    injecting(jpipes.CogVideoXI2VDualInpaintPipeline, jnp.asarray)
    injecting(tpipes.CogVideoXI2VDualInpaintPipeline, T)
    ref = jmake_self_first_frame_inpaint(jpipe, params, num_inference_steps=steps,
                                         prompt_embeds=embeds)(frame01, mask, "a prompt")
    got = make_self_first_frame_inpaint(pipe, num_inference_steps=steps,
                                        prompt_embeds=embeds)(frame01, mask, "a prompt")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_first_frame_encode_prompt_fn_path():
    _, _, pipe = first_frame_stacks("dual")
    frame01, mask = _frame_and_mask()
    calls = []

    def enc(prompt):
        calls.append(prompt)
        e = np.random.RandomState(1).rand(1, 5, 12).astype(np.float32)
        return e, np.zeros_like(e)

    out = make_self_first_frame_inpaint(pipe, num_inference_steps=2, encode_prompt_fn=enc)(
        frame01, mask, "the prompt")
    assert calls == ["the prompt"] and np.isfinite(out).all()


# -- the edit CLI -----------------------------------------------------------------------

def edit_argv(root, *extra):
    return ["--model_path", os.path.join(root, "model"),
            "--inpainting_branch", os.path.join(root, "branch"),
            "--meta_file_path", os.path.join(root, "meta.csv"), "--video_id", "0",
            "--output_path", os.path.join(root, "edit_out"),
            "--prompt_embeds", os.path.join(root, "embeds.npy"),
            "--height", "64", "--width", "96", "--num_frames", "9",
            "--num_inference_steps", "2", "--replace_gt", "--dtype", "float32",
            "--device", "cpu", *extra]


def test_edit_bench_sweep(ckpts):
    root, _ = ckpts
    with open(os.path.join(root, "instrs.json"), "w") as f:
        json.dump({"0": ["Remove the square", "Replace the square with a cat"]}, f)
    vlm_calls = []

    def fake_generate_instructions(video, caption):
        vlm_calls.append(caption)
        return ["Delete the object"]

    def fake_llm(instruction, caption):
        return f"{caption} EDITED[{instruction}]", f"frame with {instruction}"

    def fake_first_frame_edit(frame01, mask, desc):
        out = frame01.copy()
        out[mask > 0.5] = 0.5
        return out

    results = edit_bench_main(
        ["--bench", "--instructions_json", os.path.join(root, "instrs.json"),
         *edit_argv(root, "--mask_add")],
        llm_fn=fake_llm, first_frame_edit_fn=fake_first_frame_edit,
        generate_instructions_fn=fake_generate_instructions)
    # row 0 had 2 instructions in the JSON; the VLM hook is only for rows missing there
    assert set(results) == {(0, 0), (0, 1)} and not vlm_calls
    for tag, instr in [("0", "Remove the square"), ("1", "Replace the square with a cat")]:
        mp4 = os.path.join(root, "edit_out", f"edit_0_{tag}.mp4")
        assert os.path.exists(mp4) and os.path.getsize(mp4) > 0
        with open(os.path.join(root, "edit_out", f"edit_0_{tag}.json")) as f:
            d = json.load(f)
        assert set(d) == {"Original_video_caption", "Edited_video_caption",
                          "Edited_image_caption", "Editing_instruction"}
        assert d["Editing_instruction"] == instr
        assert d["Edited_video_caption"].endswith(f"EDITED[{instr}]")
        assert d["Edited_image_caption"] == f"frame with {instr}"


def test_edit_bench_vlm_fallback(ckpts):
    root, _ = ckpts
    seen = []

    def fake_generate_instructions(video, caption):
        seen.append((video.shape, caption))
        return ["Delete the object"]

    results = edit_bench_main(["--bench", *edit_argv(root)],
                              generate_instructions_fn=fake_generate_instructions)
    assert set(results) == {(0, 0)}
    assert len(seen) == 1 and seen[0][0][0] == 9   # 9 frames read
    with open(os.path.join(root, "edit_out", "edit_0.json")) as f:
        d = json.load(f)
    assert d["Editing_instruction"] == "Delete the object"
    assert d["Edited_video_caption"] == "a colorful noise pattern morphing over time x. Delete the object"
