"""CogVideoX1.5-5B-I2V in the port, on the CPU at tiny widths with odd latent
frames (9 pixel frames: 3 latent frames, padded to 4 so that they pair up
into 2-frame patches), held against the plain reference
`benchmark/reference/cogvideox15.py` (plain float32 torch, importing nothing
of the port), which the benchmark's cell checks against too.

- 3-D patchify and unpatchify are inverse, in the diffusers feature order.
- The float32 DiT output and branch features, on the pipeline's own padded
  inputs, match the reference at relative L2 <= 1e-5 (float32 rounding reads
  2.5e-7 here). A fault left in (the ofs embedding left out, the patch mask
  pooled per frame, the padded frame zero) reads 0.11, 0.095 and 0.011, so
  the tolerance sees each. In bf16 (weights rounded, the
  reference given the same rounded weights) the output lies within 2e-2: the
  bf16 activations' rounding (2^-8 relative) over two blocks reads about 5e-3.
- The integer RoPE tables equal the reference's, at the tiny grid and at the
  cell's 11 x 48 x 85 grid (float32 angles: within 1e-5 there).
- `prepare_inputs` pads the latent streams, scales the image latent by
  1 / scaling_factor, and the padded frame is dropped before the decode.
- A 1.5 `config.json` keeps its new keys through `load_config`; the inference
  CLI, the any-length pipeline and its state paths, W8A8, branch training
  and sequence parallelism raise NotImplementedError on it.
- The `dit.patch` span opens around the patch embed and the output head of
  both patch kinds.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videopainter_tpu_torch import _kernels
from videopainter_tpu_torch.config import (BranchConfig, SchedulerConfig, TransformerConfig,
                                           VAEConfig, load_config)
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.ops.patch_embed import patchify, pool_patch_mask, unpatchify
from videopainter_tpu_torch.pipelines import (CogVideoXI2VDualInpaintAnyLPipeline,
                                              CogVideoXI2VDualInpaintPipeline)
from videopainter_tpu_torch.pipelines.common import OFS, prepare_rope
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
import reference.cogvideox15 as ref15  # noqa: E402
from reference.vae_encoder import Encoder  # noqa: E402


FRAMES, HEIGHT, WIDTH = 9, 32, 48     # 3 x 4 x 6 latents, padded to 4 frames
TOL = 1e-5


def tiny_cfg(**kw) -> TransformerConfig:
    """The 1.5 preset at tiny widths (8 latent-pair channels, 2 x 2 x 2 patches)."""
    base = dict(num_attention_heads=2, attention_head_dim=16, num_layers=2, time_embed_dim=16,
                text_embed_dim=12, ofs_embed_dim=16, sample_frames=FRAMES, sample_height=16,
                sample_width=16, max_text_seq_length=5, in_channels=8, out_channels=4)
    base.update(kw)
    return TransformerConfig.cogvideox15_5b_i2v(**base)


def fill_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter U(-0.2, 0.2) from `seed`, biases and norms included."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.rand(p.shape, generator=g) * 0.4 - 0.2)
    return module


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def pipe():
    tcfg = tiny_cfg()
    vcfg = VAEConfig.tiny(scaling_factor=0.7, invert_scale_latents=True)
    transformer = fill_(CogVideoXTransformer3D(tcfg), 1)
    branch = fill_(CogVideoXBranch(BranchConfig.from_transformer(tcfg, num_layers=2)), 2)
    vae = AutoencoderKLCogVideoX(vcfg).init_random_(torch.Generator().manual_seed(3))
    sched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference(snr_shift_scale=1.0))
    return CogVideoXI2VDualInpaintPipeline(transformer, branch, vae, sched, device="cpu")


@pytest.fixture(scope="module")
def clip():
    g = torch.Generator().manual_seed(4)
    video = torch.rand((1, FRAMES, HEIGHT, WIDTH, 3), generator=g) * 2 - 1
    masks = torch.zeros((1, FRAMES, HEIGHT, WIDTH))
    masks[:, :, 8:24, 16:40] = 1.0
    masks[:, 3:6, :, :8] = 1.0    # a hole in latent frame 1 alone, which pairs with frame 2
    image = video[:, 0] * (1 - masks[:, 0, ..., None])
    text = torch.randn((2, 5, 12), generator=g)
    return video, masks, image, text


@pytest.fixture(scope="module")
def prepared(pipe, clip):
    video, masks, image, _ = clip
    noise = torch.randn((1, 4, 4, 6, 4), generator=torch.Generator().manual_seed(5))
    inputs = pipe.prepare_inputs(video=video, image=image, masks=masks, vae_sample_mode="mode",
                                 init_noise=noise)
    enc = Encoder(pipe.vae.state_dict(), pipe.vae.cfg.to_dict(), device="cpu")
    lat = ref15.i2v_latents(enc, video, masks, image, 2, pipe.vae.cfg.scaling_factor)
    return inputs, lat


# -- patches -----------------------------------------------------------------------------

def test_3d_patchify_order_matches_the_index_formula_and_unpatchify_inverts_it():
    b, t, h, w, c, p, q = 2, 4, 6, 8, 3, 2, 2
    x = torch.randn(b, t, h, w, c)
    tok = patchify(x, p, q)
    assert tok.shape == (b, (t // q) * (h // p) * (w // p), c * q * p * p)
    for bi, tt, hh, ww, cc in [(0, 0, 0, 0, 0), (1, 3, 5, 7, 2), (0, 2, 3, 6, 1), (1, 1, 4, 1, 0)]:
        token = ((tt // q) * (h // p) + hh // p) * (w // p) + ww // p
        feat = ((cc * q + tt % q) * p + hh % p) * p + ww % p
        assert tok[bi, token, feat] == x[bi, tt, hh, ww, cc]
    assert torch.equal(unpatchify(tok, t, h, w, p, q), x)


def test_3d_patch_mask_marks_a_token_when_any_cell_of_its_window_is_masked():
    m = torch.zeros(1, 4, 4, 4)
    m[0, 1, 3, 0] = 1.0     # the second frame of pair 0, cell (1, 1) of its patch (1, 0)
    got = pool_patch_mask(m, 2, 2).reshape(2, 2, 2)
    want = torch.zeros(2, 2, 2, dtype=torch.bool)
    want[0, 1, 0] = True
    assert torch.equal(got, want)


# -- the model against the reference ---------------------------------------------------------

@torch.no_grad()
def model_pass(pipe, inputs, text, fault=None):
    """One CFG-batched branch and DiT pass on the prepared inputs (step 10's
    timestep): (DiT output, branch features), as `make_denoise_fn` runs it."""
    rep = lambda x: torch.cat([x, x])
    lat = rep(inputs.latents)
    mask = rep(inputs.mask)
    t = torch.full((2,), 500, dtype=torch.long)
    rope = prepare_rope(pipe.transformer.cfg, HEIGHT, WIDTH, inputs.latents.shape[1])
    if fault == "mask per frame":
        mask = mask.clone()
        mask[:, 0::2] = 0.0     # only the second frame of each pair pooled
    feats = pipe.branch(lat, text, torch.cat([rep(inputs.masked_video_latents),
                                              mask[..., None]], dim=-1), t,
                        ofs=OFS, rope=rope)
    out = pipe.transformer(torch.cat([lat, rep(inputs.image_latents)], dim=-1), text, t,
                           ofs=OFS, rope=rope, branch_block_samples=feats,
                           branch_block_masks=mask)
    return out.sample, feats


def reference_pass(pipe, inputs, lat, text, dtype=torch.float32):
    masked, _, mask_lat, image_lat = lat
    rep = lambda x: torch.cat([x, x])
    x = rep(inputs.latents.float())
    t = torch.full((2,), 500.0)
    sd_t = {k: v.to(dtype).float() for k, v in pipe.transformer.state_dict().items()}
    sd_b = {k: v.to(dtype).float() for k, v in pipe.branch.state_dict().items()}
    bcfg = pipe.branch.cfg.to_dict()
    feats = ref15.branch_features(sd_b, bcfg, x, rep(torch.cat([masked, mask_lat[..., None]],
                                                                dim=-1)), text, t, device="cpu")
    out = ref15.dit_forward(sd_t, pipe.transformer.cfg.to_dict(),
                            torch.cat([x, rep(image_lat)], dim=-1), text, t, device="cpu",
                            feats=feats, mask_lat=rep(mask_lat))
    return out, torch.stack(feats)


def test_float32_dit_and_branch_match_the_reference(pipe, prepared, clip):
    inputs, lat = prepared
    text = clip[3]
    out, feats = model_pass(pipe, inputs, text)
    ref_out, ref_feats = reference_pass(pipe, inputs, lat, text)
    assert out.shape == ref_out.shape == (2, 4, 4, 6, 4)
    assert rel(feats, ref_feats) <= TOL
    assert rel(out, ref_out) <= TOL


@pytest.mark.parametrize("fault", ["ofs left out", "mask per frame", "padded frame zero"])
def test_a_fault_fails_the_tolerance(pipe, prepared, clip, monkeypatch, fault):
    inputs, lat = prepared
    text = clip[3]
    if fault == "ofs left out":
        for m in (pipe.transformer, pipe.branch):
            monkeypatch.setattr(m.ofs_embedding, "forward", lambda x: torch.zeros_like(x))
    if fault == "padded frame zero":
        inputs = inputs._replace(masked_video_latents=torch.cat(
            [torch.zeros_like(inputs.masked_video_latents[:, :1]),
             inputs.masked_video_latents[:, 1:]], dim=1))
    out, _ = model_pass(pipe, inputs, text, fault)
    ref_out, _ = reference_pass(pipe, prepared[0], lat, text)
    assert rel(out, ref_out) > 100 * TOL


def test_bf16_dit_is_within_its_stated_tolerance_of_the_reference(pipe, prepared, clip):
    inputs, lat = prepared
    text = clip[3]
    pipe.transformer.to(torch.bfloat16)
    pipe.branch.to(torch.bfloat16)
    try:
        bf = lambda x: x.to(torch.bfloat16)
        out, _ = model_pass(pipe, inputs._replace(
            latents=bf(inputs.latents), image_latents=bf(inputs.image_latents),
            masked_video_latents=bf(inputs.masked_video_latents)), bf(text))
        ref_out, _ = reference_pass(pipe, inputs._replace(latents=bf(inputs.latents).float()),
                                    [bf(x).float() for x in lat], bf(text).float(), torch.bfloat16)
    finally:
        pipe.transformer.float()
        pipe.branch.float()
    assert TOL < rel(out.float(), ref_out) <= 2e-2


@pytest.mark.parametrize("grid", [(4, 4, 6), (22, 96, 170)])
def test_integer_rope_tables_equal_the_references(grid):
    t, h, w = grid
    cfg = TransformerConfig.cogvideox15_5b_i2v()
    cos, sin = prepare_rope(cfg, h * 8, w * 8, t)
    rc, rs = ref15.rope_tables(64, t // 2, h // 2, w // 2, "cpu")
    assert cos.shape == rc.shape == ((t // 2) * (h // 2) * (w // 2), 64)
    atol = 1e-6 if t == 4 else 1e-5
    assert torch.allclose(cos, rc, atol=atol, rtol=0) and torch.allclose(sin, rs, atol=atol, rtol=0)


def test_rope_grid_past_the_sample_dims_raises():
    with pytest.raises(ValueError, match="RoPE grid"):
        prepare_rope(tiny_cfg(), 256, 48, 4)


# -- the pipeline ------------------------------------------------------------------------------

def test_prepare_inputs_pads_the_latent_streams_and_scales_the_image_latent(pipe, prepared, clip):
    inputs, lat = prepared
    assert inputs.pad_frames == 1
    for x in (inputs.latents, inputs.masked_video_latents, inputs.video_latents,
              inputs.image_latents, inputs.noise):
        assert x.shape == (1, 4, 4, 6, 4)
    assert inputs.mask.shape == (1, 4, 4, 6)
    for x in (inputs.masked_video_latents, inputs.video_latents, inputs.mask):
        assert torch.equal(x[:, 0], x[:, 1])
    assert not torch.equal(inputs.mask[:, 2], inputs.mask[:, 3])
    assert torch.count_nonzero(inputs.image_latents[:, 1:]) == 0
    sf = pipe.vae.cfg.scaling_factor
    mean = pipe.vae.encode(clip[2][:, None]).mode()
    assert torch.allclose(inputs.image_latents[:, :1], mean / sf, atol=1e-6)
    mean_v = pipe.vae.encode(clip[0]).mode()
    assert torch.allclose(inputs.video_latents[:, 1:], mean_v * sf, atol=1e-6)
    for got, want in zip((inputs.masked_video_latents, inputs.video_latents, inputs.mask,
                          inputs.image_latents), lat):
        assert rel(got, want) <= TOL


def test_the_padded_frame_is_dropped_before_the_decode_and_counted_a_step(pipe, clip,
                                                                          monkeypatch):
    video, masks, image, text = clip
    seen = []
    real = pipe.vae.decode
    monkeypatch.setattr(pipe.vae, "decode", lambda z: seen.append(z.shape) or real(z))
    _kernels.reset_launches()
    out = pipe(video=video, masks=masks, image=image, prompt_embeds=text[1:],
               negative_prompt_embeds=text[:1], num_inference_steps=2, use_dynamic_cfg=True,
               replace_gt=True, mask_add=True, generator=torch.Generator().manual_seed(6),
               vae_sample_mode="mode", output_type="pt")
    assert seen == [(1, 3, 4, 6, 4)]
    assert out.shape == (1, FRAMES, HEIGHT, WIDTH, 3)
    # 2 steps x the CFG pair: one padded frame each, the 2 x 3 tokens of its patch pair
    assert _kernels.PADDING == {"latent_frames": 4, "tokens": 24}
    _kernels.reset_launches()
    assert _kernels.PADDING == {"latent_frames": 0, "tokens": 0}


def test_more_frames_than_the_model_takes_raise(pipe):
    """A 1.5 model takes up to its sample_frames (81 published, 9 here)."""
    v = torch.zeros((1, FRAMES + 4, 8, 8, 3))
    with pytest.raises(ValueError, match=f"> {FRAMES};"):
        pipe(video=v, masks=v[..., 0], prompt_embeds=torch.zeros(1, 5, 12),
             negative_prompt_embeds=torch.zeros(1, 5, 12))


# -- configuration -----------------------------------------------------------------------------

PUBLISHED = {   # THUDM/CogVideoX1.5-5B-I2V transformer/config.json
    "_class_name": "CogVideoXTransformer3DModel", "_diffusers_version": "0.32.0.dev0",
    "activation_fn": "gelu-approximate", "attention_bias": True, "attention_head_dim": 64,
    "dropout": 0.0, "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 32,
    "max_text_seq_length": 226, "norm_elementwise_affine": True, "norm_eps": 1e-05,
    "num_attention_heads": 48, "num_layers": 42, "ofs_embed_dim": 512, "out_channels": 16,
    "patch_bias": False, "patch_size": 2, "patch_size_t": 2, "sample_frames": 81,
    "sample_height": 300, "sample_width": 300, "spatial_interpolation_scale": 1.875,
    "temporal_compression_ratio": 4, "temporal_interpolation_scale": 1.0,
    "text_embed_dim": 4096, "time_embed_dim": 512, "timestep_activation_fn": "silu",
    "use_learned_positional_embeddings": False, "use_rotary_positional_embeddings": True}


@pytest.fixture
def model_dir(tmp_path):
    os.makedirs(tmp_path / "transformer")
    with open(tmp_path / "transformer" / "config.json", "w") as f:
        json.dump(PUBLISHED, f)
    return tmp_path


def test_a_published_15_config_loads_with_its_new_keys(model_dir):
    cfg = load_config(str(model_dir / "transformer" / "config.json"), TransformerConfig)
    assert cfg == TransformerConfig.cogvideox15_5b_i2v()
    assert (cfg.patch_size_t, cfg.ofs_embed_dim, cfg.patch_bias) == (2, 512, False)
    b = BranchConfig.from_transformer(cfg, num_layers=2)
    assert (b.patch_size_t, b.ofs_embed_dim, b.patch_bias, b.patch_in_channels) == (2, 512,
                                                                                   False, 33)
    m = CogVideoXTransformer3D(cfg, device="meta")
    assert m.patch_embed.proj.weight.shape == (3072, 256) and m.patch_embed.proj.bias is None
    assert m.proj_out.weight.shape == (128, 3072)
    assert m.ofs_embedding.linear_1.weight.shape == (512, 512)
    assert not hasattr(m.patch_embed, "pos_embedding")
    assert CogVideoXBranch(b, device="meta").patch_embed.proj.weight.shape == (3072, 264)


def refusals(model_dir):
    from videopainter_tpu_torch.infer.inpaint import build_pipeline
    from videopainter_tpu_torch.parallel.sequence import seq_shard
    from videopainter_tpu_torch.quantize import quantize_transformer_int8
    from videopainter_tpu_torch.training import make_branch_train_step

    cfg = tiny_cfg()
    m = fill_(CogVideoXTransformer3D(cfg), 1)
    x, text, t = torch.zeros(1, 4, 4, 6, 8), torch.zeros(1, 5, 12), torch.tensor([1])
    anyl = CogVideoXI2VDualInpaintAnyLPipeline(m, None, AutoencoderKLCogVideoX(VAEConfig.tiny()),
                                               None, device="cpu")
    v = torch.zeros((1, 9, 32, 48, 3))
    return {
        "inference CLI": lambda: build_pipeline(str(model_dir), None, device="cpu"),
        "any-length pipeline": lambda: anyl(video=v, masks=v[..., 0], prompt_embeds=text,
                                            negative_prompt_embeds=text),
        "capture": lambda: m(x, text, t, ofs=OFS, return_hidden_states=True),
        "ID resample": lambda: m(x, text, t, ofs=OFS, id_pool_resample=True),
        "W8A8": lambda: quantize_transformer_int8(m),
        "branch training": lambda: make_branch_train_step(m, None, None, None, None, None),
        "sequence parallelism": lambda: seq_shard("seq", None, 24, cfg.patch_size_t),
    }


@pytest.mark.parametrize("path", ["inference CLI", "any-length pipeline", "capture",
                                  "ID resample", "W8A8", "branch training",
                                  "sequence parallelism"])
def test_out_of_scope_paths_raise_on_a_15_model(model_dir, path):
    with pytest.raises(NotImplementedError, match="patch_size_t=2"):
        refusals(model_dir)[path]()


def test_a_15_model_needs_its_ofs_and_paired_frames():
    m = fill_(CogVideoXTransformer3D(tiny_cfg()), 1)
    text, t = torch.zeros(1, 5, 12), torch.tensor([1])
    with pytest.raises(ValueError, match="pass ofs"):
        m(torch.zeros(1, 4, 4, 6, 8), text, t)
    with pytest.raises(ValueError, match="pair up"):
        m(torch.zeros(1, 3, 4, 6, 8), text, t, ofs=OFS)


def test_branch_init_from_a_15_trunk_copies_its_patch_slots_and_ofs_embedding():
    cfg = tiny_cfg()
    trunk = fill_(CogVideoXTransformer3D(cfg), 1)
    br = CogVideoXBranch(BranchConfig.from_transformer(cfg, num_layers=2)).init_from_transformer(
        trunk)
    w = br.patch_embed.proj.weight.unflatten(1, (9, 8))        # [D, 2 x 4 + 1, q p p]
    tw = trunk.patch_embed.proj.weight.unflatten(1, (8, 8))
    assert torch.equal(w[:, :4], tw[:, :4]) and torch.equal(w[:, 4:8], tw[:, :4])
    assert torch.count_nonzero(w[:, 8]) == 0
    assert torch.equal(br.ofs_embedding.linear_2.weight, trunk.ofs_embedding.linear_2.weight)


# -- tracing -------------------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["1.0", "1.5"])
def test_dit_patch_span_opens_around_the_embed_and_the_head(kind):
    if kind == "1.5":
        cfg, x, kw = tiny_cfg(), torch.randn(1, 4, 4, 6, 8), {"ofs": OFS}
    else:
        cfg, x, kw = TransformerConfig.tiny(in_channels=8, out_channels=4), \
            torch.randn(1, 3, 4, 6, 8), {}
    m = fill_(CogVideoXTransformer3D(cfg), 1)
    br = fill_(CogVideoXBranch(BranchConfig.from_transformer(cfg, num_layers=1)), 2)
    text, t = torch.randn(1, 5, 12), torch.tensor([7])
    rope = prepare_rope(cfg, 32, 48, x.shape[1])
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        br(x[..., :4], text, torch.zeros(*x.shape[:-1], 5), t, rope=rope, **kw)
        m(x, text, t, rope=rope, **kw)
    names = [e.name for e in prof.events()]
    assert names.count("dit.patch") == 3    # the branch's embed; the DiT's embed and head
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name == "dit.patch")
    blocks = [e.time_range.start for e in prof.events() if e.name == "dit.adaln"]
    assert all(not (s < b < e) for s, e in spans for b in blocks)
    assert np.all(np.diff([s for s, _ in spans]) > 0)
