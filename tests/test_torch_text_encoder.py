"""The port's prompt path on the CPU: `models/text_encoder.py` (T5) against the
torch golden and the JAX wrapper, both pipelines driven by `prompt=` against
the JAX pipelines driven the same way, the training CLI's local T5, and the
flagship's `build_text_encoder` (T5-XXL) at a tiny width.

Tolerances: the T5 golden rtol 1e-4 / atol 1e-5 (the JAX test's); the port's
and the JAX wrapper's hidden states atol 1e-5 (fp32 on both sides); the tiny
pipelines atol 1e-4 on outputs in [-1, 1] (tests/test_torch_pipeline.py's
limit), and bit equality between a prompt-driven run and the same pipeline
given the same embeddings.
"""

import os
import shutil

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
from videopainter_tpu.models.text_encoder import T5TextEncoder as JT5TextEncoder
from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintAnyLPipeline as JAnyL
from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintPipeline as JPipe
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu_torch.convert import (branch_state_dict, transformer_state_dict,
                                            vae_state_dict)
from videopainter_tpu_torch.flagship import HashTokenizer, build_text_encoder
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D, T5TextEncoder,
                                           load_prompt_embeds)
from videopainter_tpu_torch.pipelines import (CogVideoXI2VDualInpaintAnyLPipeline,
                                              CogVideoXI2VDualInpaintPipeline)
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler


T5_TINY = "tests/goldens/t5_tiny"   # d_model 32, 2 layers, vocab 512
DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12,
              text_embed_dim=32)
STEPS = 2
PROMPT = "a red fox crossing a snowy field"


class _FakeTokenizer:
    """Maps any prompt to the golden ids (max_length padding included), as
    tests/test_text_encoder.py's."""

    def __init__(self, ids):
        self.ids = ids

    def __call__(self, text, *, padding, max_length, truncation,
                 add_special_tokens, return_tensors):
        assert padding == "max_length" and truncation and add_special_tokens
        out = np.zeros((1, max_length), np.int32)
        n = min(self.ids.shape[1], max_length)
        out[:, :n] = self.ids[:, :n]
        return {"input_ids": out}


def torch_t5():
    transformers = pytest.importorskip("transformers")
    return transformers.T5EncoderModel.from_pretrained(T5_TINY, torch_dtype=torch.float32).eval()


def flax_t5():
    transformers = pytest.importorskip("transformers")
    return transformers.FlaxT5EncoderModel.from_pretrained(T5_TINY, dtype=jnp.float32,
                                                           from_pt=True)


def test_t5_wrapper_reproduces_the_torch_golden(goldens):
    g = goldens("t5")
    enc = T5TextEncoder(_FakeTokenizer(g["ids"]), torch_t5(), max_length=g["ids"].shape[1])
    out = enc.encode("a prompt")
    assert out.shape == (1, 8, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), g["hidden"], rtol=1e-4, atol=1e-5)
    # an ordinary tensor: the training step may save it for its backward pass
    assert not out.is_inference()


def test_t5_wrapper_matches_jax_wrapper():
    """Both wrappers on the same word-hash ids at the pipelines' 226 tokens."""
    tok = HashTokenizer(vocab_size=512)
    port = T5TextEncoder(tok, torch_t5())
    jax_enc = JT5TextEncoder(tok, flax_t5())
    for prompt in (PROMPT, ""):
        out = port.encode(prompt).numpy()
        ref = np.asarray(jax_enc.encode(None, prompt))
        assert out.shape == ref.shape == (1, 226, 32)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    pos, neg = port.encode_with_negative(PROMPT)
    assert torch.equal(pos, port.encode(PROMPT)) and torch.equal(neg, port.encode(""))
    assert port.encode(None, max_length=7).shape == (1, 7, 32)


def test_hash_tokenizer_contract():
    tok = HashTokenizer(vocab_size=512)
    kw = dict(padding="max_length", max_length=6, truncation=True, add_special_tokens=True,
              return_tensors="np")
    ids = tok("a b a", **kw)["input_ids"]
    assert ids.shape == (1, 6) and ids.dtype == np.int64
    assert ids[0, 0] == ids[0, 2] != ids[0, 1] and ids[0, 3] == 1 and not ids[0, 4:].any()
    assert (ids[0, :3] >= 3).all() and (ids[0, :3] < 512).all()
    long = tok(" ".join(["w"] * 20), **kw)["input_ids"]
    assert long.shape == (1, 6) and long[0, -1] == 1          # truncated, </s> kept
    assert tok("", **kw)["input_ids"].tolist() == [[1, 0, 0, 0, 0, 0]]
    with pytest.raises(ValueError):
        tok("a", **dict(kw, return_tensors="pt"))


def test_build_text_encoder_at_tiny_width():
    """The flagship's `build_text_encoder` (T5-v1.1-XXL's fields but the widths) on the
    CPU: seeded, T5's initialisation scales, finite embeddings."""
    tiny = dict(d_model=64, d_kv=8, d_ff=96, num_layers=2, num_heads=4, vocab_size=512)
    a = build_text_encoder(3, device="cpu", **tiny)
    b = build_text_encoder(3, device="cpu", **tiny)
    cfg = a.model.config
    assert cfg.feed_forward_proj == "gated-gelu" and cfg.relative_attention_num_buckets == 32
    assert cfg.relative_attention_max_distance == 128 and cfg.layer_norm_epsilon == 1e-6
    params = dict(a.model.named_parameters())
    assert all(p.dtype == torch.bfloat16 for p in params.values())
    assert a.model.encoder.embed_tokens.weight is a.model.shared.weight   # one embedding
    q = params["encoder.block.0.layer.0.SelfAttention.q.weight"].float()
    assert abs(q.std().item() * (64 * 8) ** 0.5 - 1) < 0.1
    assert torch.equal(params["encoder.final_layer_norm.weight"], torch.ones(64, dtype=torch.bfloat16))
    out = a.encode(PROMPT)
    assert out.shape == (1, 226, 64) and bool(torch.isfinite(out.float()).all())
    assert torch.equal(out, b.encode(PROMPT)) and not torch.equal(out, a.encode(""))


def test_load_prompt_embeds_shapes(tmp_path):
    np.save(tmp_path / "e.npy", np.ones((5, 8), np.float32))
    np.savez(tmp_path / "e.npz", x=np.zeros((1, 5, 8), np.float32))
    for name in ("e.npy", "e.npz"):
        e = load_prompt_embeds(str(tmp_path / name))
        assert isinstance(e, torch.Tensor) and e.shape == (1, 5, 8)


# -- the pipelines driven by a prompt -------------------------------------------------------

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


@pytest.fixture(scope="module")
def prompt_stacks():
    """Tiny JAX and port pipelines of both kinds on the same weights, each
    with T5-tiny and the word-hash tokenizer as its text encoder."""
    jt, tt = jcfg.TransformerConfig.tiny(**DIT_KW), tcfg.TransformerConfig.tiny(**DIT_KW)
    assert tt.max_text_seq_length == jt.max_text_seq_length
    jb, jv = jcfg.BranchConfig.from_transformer(jt), jcfg.VAEConfig.tiny(latent_channels=16)
    params = {"transformer": random_params(JDiT(jt).init, 11),
              "branch": random_params(JBranch(jb).init, 12),
              "vae": random_params(JVAE(jv).init, 13)}
    tok = HashTokenizer(vocab_size=512)
    jte, te = JT5TextEncoder(tok, flax_t5()), T5TextEncoder(tok, torch_t5())
    out = {}
    for kind, jcls, tcls in (("single", JPipe, CogVideoXI2VDualInpaintPipeline),
                             ("anyl", JAnyL, CogVideoXI2VDualInpaintAnyLPipeline)):
        models = (CogVideoXTransformer3D(tt), CogVideoXBranch(tcfg.BranchConfig.from_transformer(tt)),
                  AutoencoderKLCogVideoX(tcfg.VAEConfig.tiny(latent_channels=16)))
        for m, sd in zip(models, (transformer_state_dict(params["transformer"]),
                                  branch_state_dict(params["branch"]),
                                  vae_state_dict(params["vae"]))):
            m.load_state_dict(sd)
        sched = tcfg.SchedulerConfig.cogvideox_5b_inference()
        out[kind] = (jcls(JDiT(jt), JBranch(jb), JVAE(jv),
                          JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()), text_encoder=jte),
                     tcls(*models, CogVideoXDPMScheduler(sched), te, device="cpu"))
    return params, out


def inputs(seed, frames):
    rng = np.random.default_rng(seed)
    video = rng.uniform(-1, 1, (1, frames, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, frames, 64, 96), np.float32)
    masks[:, :, 16:48, 24:64] = 1
    windows = (frames - 9) // 4 + 1
    return {"video": video, "masks": masks, "image": video[:, 0] * (1 - masks[:, 0, ..., None]),
            "init": [rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32)
                     for _ in range(windows)],
            "dpm": [rng.standard_normal((STEPS, 1, 3, 8, 12, 16)).astype(np.float32)
                    for _ in range(windows)]}


COMMON = dict(num_inference_steps=STEPS, guidance_scale=6.0, use_dynamic_cfg=True,
              replace_gt=True, mask_add=True, vae_sample_mode="mode")


def port_call(pipe, kind, x, **kw):
    T = torch.from_numpy
    noise = (dict(init_noise=T(x["init"][0]), dpm_noises=T(x["dpm"][0])) if kind == "single"
             else dict(init_noises=[T(n) for n in x["init"]],
                       dpm_noises_list=[T(n) for n in x["dpm"]], num_frames=9, stride=4,
                       id_pool_resample=False, prev_clip_weight=0.3))
    return pipe(video=T(x["video"]), masks=T(x["masks"]), image=T(x["image"]), use_flash=True,
                **COMMON, **noise, **kw)


def jax_call(pipe, params, kind, x, **kw):
    J = jnp.asarray
    noise = (dict(init_noise=J(x["init"][0]), dpm_noises=J(x["dpm"][0])) if kind == "single"
             else dict(init_noises=[J(n) for n in x["init"]],
                       dpm_noises_list=[J(n) for n in x["dpm"]], num_frames=9, stride=4,
                       prev_clip_weight=0.3, scan_chunk=0))
    return np.asarray(pipe(params, video=J(x["video"]), masks=J(x["masks"]), image=J(x["image"]),
                           rng=jax.random.PRNGKey(0), **COMMON, **noise, **kw))


@pytest.mark.parametrize("kind", ["single", "anyl"])
def test_pipeline_from_a_prompt_matches_jax(prompt_stacks, kind):
    """`prompt=` / `negative_prompt=` through each pipeline's text encoder:
    the port against the JAX pipeline driven the same way, and against
    itself given the embeddings of the same prompts (bit-equal)."""
    params, stacks = prompt_stacks
    jpipe, port = stacks[kind]
    x = inputs(41, 9 if kind == "single" else 13)
    ref = jax_call(jpipe, params, kind, x, prompt=PROMPT, negative_prompt="")
    out = port_call(port, kind, x, prompt=PROMPT, negative_prompt="")
    assert out.shape == ref.shape and out.shape[2:] == (64, 96, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    pos, neg = port.encode_prompt(PROMPT, "", port.transformer.cfg.max_text_seq_length)
    assert pos.shape == (1, 5, 32)
    given = port_call(port, kind, x, prompt_embeds=pos, negative_prompt_embeds=neg)
    np.testing.assert_array_equal(out, given)
    # the embeddings take precedence over the prompt
    np.testing.assert_array_equal(
        port_call(port, kind, x, prompt="ignored", prompt_embeds=pos, negative_prompt_embeds=neg),
        given)


def test_missing_text_encoder_raises(prompt_stacks):
    _, stacks = prompt_stacks
    port = stacks["single"][1]
    bare = CogVideoXI2VDualInpaintPipeline(port.transformer, port.branch, port.vae,
                                           port.scheduler, device="cpu")
    with pytest.raises(ValueError, match="no text encoder configured; pass prompt_embeds"):
        bare.encode_prompt(PROMPT)
    x = inputs(42, 9)
    with pytest.raises(ValueError, match="no text encoder configured"):
        port_call(bare, "single", x, prompt=PROMPT)
    with pytest.raises(ValueError, match="CFG requires negative_prompt_embeds"):
        port_call(bare, "single", x, prompt_embeds=torch.zeros((1, 5, 32)))


# -- the training CLI with a local T5 ------------------------------------------------------

def test_cli_step_with_local_t5_and_slicing(tmp_path, monkeypatch):
    """`cli.main` for one step from tiny exported checkpoints whose
    text_encoder/ is T5-tiny with a word-level tokenizer, no
    --prompt_embeds_file, and --enable_slicing."""
    cv2 = pytest.importorskip("cv2")
    pd = pytest.importorskip("pandas")
    tokenizers = pytest.importorskip("tokenizers")
    from transformers import PreTrainedTokenizerFast

    from videopainter_tpu_torch.training import checkpoint as tckpt
    from videopainter_tpu_torch.training import cli

    root = str(tmp_path)
    gen = torch.Generator().manual_seed(0)
    tt = tcfg.TransformerConfig.tiny(**DIT_KW)
    vcfg = tcfg.VAEConfig.tiny(latent_channels=16)
    tckpt.export_transformer_pretrained(CogVideoXTransformer3D(tt).init_random_(gen),
                                        tt.to_dict(), os.path.join(root, "model", "transformer"))
    tckpt.export_vae_pretrained(AutoencoderKLCogVideoX(vcfg).init_random_(gen), vcfg.to_dict(),
                                os.path.join(root, "model", "vae"))
    te_dir = os.path.join(root, "model", "text_encoder")
    shutil.copytree(T5_TINY, te_dir)
    words = "a colorful noise pattern morphing over time x".split()
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: 3 + i for i, w in enumerate(words)}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
                            unk_token="<unk>").save_pretrained(te_dir)
    rng = np.random.RandomState(0)
    vpath = os.path.join(root, "vid.mp4")
    vw = cv2.VideoWriter(vpath, cv2.VideoWriter_fourcc(*"mp4v"), 8, (96, 64))
    for f in (rng.rand(9, 64, 96, 3) * 255).astype(np.uint8):
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    masks = np.zeros((9, 64, 96), np.uint8)
    masks[:, 20:40, 30:60] = 1
    np.savez(os.path.join(root, "all_masks.npz"), **{"0": masks})
    pd.DataFrame([{"path": vpath, "fps": 8, "start_frame": 0, "end_frame": 0, "mask_id": 0,
                   "caption": " ".join(words)}]).to_csv(os.path.join(root, "meta.csv"),
                                                        index=False)
    calls = {"encode": [], "slicing": 0}
    encode = T5TextEncoder.encode

    def counted(self, prompt, max_length=None):
        out = encode(self, prompt, max_length)
        calls["encode"].append(tuple(out.shape))
        return out

    monkeypatch.setattr(T5TextEncoder, "encode", counted)
    monkeypatch.setattr(AutoencoderKLCogVideoX, "enable_slicing",
                        lambda self: calls.__setitem__("slicing", calls["slicing"] + 1))
    state = cli.main(["--pretrained_model_name_or_path", os.path.join(root, "model"),
                      "--meta_file_path", os.path.join(root, "meta.csv"),
                      "--output_dir", os.path.join(root, "run"), "--height", "64", "--width",
                      "96", "--max_num_frames", "9", "--min_caption_len", "10",
                      "--max_train_steps", "1", "--checkpointing_steps", "1",
                      "--lr_warmup_steps", "0", "--mask_add", "--first_frame_gt",
                      "--device", "cpu", "--enable_slicing"])
    assert state.step == 1
    assert calls["slicing"] == 1
    assert calls["encode"] and all(s == (1, tt.max_text_seq_length, 32) for s in calls["encode"])
