"""The port's SAM2 (videopainter_tpu_torch.segmentation) against the torch
reference's goldens and against the JAX package, on the CPU in float32.

 - every module against tests/goldens/sam2.npz, the video predictor against
   sam2_e2e.npz (click, propagation, reverse) and sam2_e2e_hires.npz, the
   image predictor against sam2_image.npz and the automatic mask generator
   against amg.npz, at the JAX tests' own tolerances (stated where used);
 - the modules, both predictors and the generator (with its small-region
   repair, which runs the connected-components plain version) against the
   JAX package on the same seeded weights, carried over by
   `convert.from_jax.sam2_state_dict`: 1e-4 absolute on float32 outputs of
   order 1, the round-off of two fp32 implementations;
 - the checkpoint paths (`build_sam2_video_predictor` from a .pt and from
   the JAX package's flat .npz) and the resize helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videopainter_tpu.segmentation import SAM2Config as JConfig
from videopainter_tpu.segmentation import SAM2VideoPredictor as JPredictor
from videopainter_tpu.segmentation import image_predictor as jimage
from videopainter_tpu.segmentation import memory as jmemory
from videopainter_tpu.segmentation import modules as jmodules
from videopainter_tpu.segmentation import sam_heads as jheads
from videopainter_tpu.segmentation.convert import convert_sam2_state_dict
from videopainter_tpu.segmentation.hiera import HieraConfig as JHiera
from videopainter_tpu.segmentation.hiera import HieraImageEncoder
from videopainter_tpu_torch.convert import sam2_state_dict
from videopainter_tpu_torch.segmentation import (SAM2Config, SAM2VideoPredictor,
                                                 build_sam2_video_predictor)
from videopainter_tpu_torch.segmentation import modules as tmodules
from videopainter_tpu_torch.segmentation.convert import load_sam2_npz
from videopainter_tpu_torch.segmentation.hiera import HieraConfig, ImageEncoder
from videopainter_tpu_torch.segmentation.image_predictor import (
    AutoMaskConfig, SAM2AutomaticMaskGenerator, SAM2ImagePredictor)
from videopainter_tpu_torch.segmentation.memory import MemoryAttention, MemoryEncoder
from videopainter_tpu_torch.segmentation.sam_heads import MaskDecoder, PromptEncoder


MODULE_TOL = dict(rtol=3e-4, atol=3e-5)    # test_sam2_modules.py
E2E_TOL = dict(rtol=1e-3, atol=2e-3)       # test_sam2_e2e.py / test_sam2_image_golden.py
JAX_ATOL = 1e-4

GOLDEN_HIERA = dict(embed_dim=16, num_heads=1, stages=(1, 2, 2, 1), window_spec=(4, 2, 4, 2),
                    global_att_blocks=(4,), window_pos_embed_bkg_spatial_size=(4, 4),
                    d_model=32, scalp=1, q_pool=3)
GOLDEN_CFG = dict(image_size=64, num_maskmem=7, mem_dim=16, hidden_dim=32,
                  memory_attention_heads=2, mask_decoder_heads=8, max_obj_ptrs_in_encoder=4,
                  add_tpos_enc_to_obj_ptrs=False)
# the module widths the goldens' tools chose (the published ones are the defaults)
GOLDEN_WIDTHS = dict(memory_attention_layers=2, memory_attention_ff=64,
                     mask_downsampler=(4, 4, 0))


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def npy(t):
    return t.detach().numpy()


def jit(fn, *args):
    """A JAX function as one jitted program, its results as numpy."""
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def golden_sd(g, prefix="sd::"):
    return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}


def port_predictor(cfg, sd, cls=SAM2VideoPredictor):
    model = cls(cfg)
    model.load_state_dict({k: T(v) for k, v in sd.items()})
    return model.eval()


def golden_configs(hires):
    jc = JConfig(hiera=JHiera(**GOLDEN_HIERA), **GOLDEN_CFG)
    tc = SAM2Config(hiera=HieraConfig(**GOLDEN_HIERA), use_high_res_features_in_sam=hires,
                    **GOLDEN_CFG, **GOLDEN_WIDTHS)
    return jc, tc


# -- the torch reference's goldens ---------------------------------------------------

def test_image_encoder_matches_golden(goldens):
    g = goldens("sam2")
    enc = ImageEncoder(HieraConfig(**GOLDEN_HIERA))
    enc.load_state_dict({k: T(v) for k, v in golden_sd(g, "sd::image_encoder::").items()})
    with torch.no_grad():
        out = enc(T(g["io::enc::img"]))
    n = sum(1 for k in g.files if k.startswith("io::enc::fpn"))
    assert len(out["backbone_fpn"]) == n
    for i in range(n):
        np.testing.assert_allclose(npy(out["backbone_fpn"][i]), g[f"io::enc::fpn{i}"],
                                   **MODULE_TOL)
        np.testing.assert_allclose(npy(out["vision_pos_enc"][i]), g[f"io::enc::pos{i}"],
                                   rtol=1e-5, atol=1e-5)


def golden_prompt_encoder(g):
    sd = golden_sd(g, "sd::prompt_encoder::")
    pe = PromptEncoder(32, (4, 4), (64, 64), mask_in_chans=sd["mask_downscaling.3.weight"].shape[0])
    pe.load_state_dict({k: T(v) for k, v in sd.items()})
    return pe


def test_prompt_encoder_matches_golden(goldens):
    g = goldens("sam2")
    pe = golden_prompt_encoder(g)
    pts = (T(g["io::pe::points"]), T(g["io::pe::labels"]))
    with torch.no_grad():
        sparse, dense = pe(points=pts)
        _, dense_m = pe(points=pts, masks=T(g["io::pe::mask_in"]))
        dense_pe = pe.get_dense_pe()
    np.testing.assert_allclose(npy(sparse), g["io::pe::sparse"], **MODULE_TOL)
    np.testing.assert_allclose(npy(dense), g["io::pe::dense"], **MODULE_TOL)
    np.testing.assert_allclose(npy(dense_pe), g["io::pe::dense_pe"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npy(dense_m), g["io::pe::dense_mask"], **MODULE_TOL)


def test_mask_decoder_matches_golden(goldens):
    g = goldens("sam2")
    sd = golden_sd(g, "sd::mask_decoder::")
    dec = MaskDecoder(32, num_heads=2,
                      mlp_dim=sd["transformer.layers.0.mlp.layers.0.weight"].shape[0],
                      iou_head_hidden_dim=sd["iou_prediction_head.layers.0.weight"].shape[0],
                      use_high_res_features=False)
    dec.load_state_dict({k: T(v) for k, v in sd.items()})
    pe = golden_prompt_encoder(g)
    with torch.no_grad():
        sparse, dense = pe(points=(T(g["io::pe::points"]), T(g["io::pe::labels"])))
        masks, iou, tokens, obj = dec(T(g["io::dec::img_emb"]), T(g["io::pe::dense_pe"]),
                                      sparse, dense, multimask_output=True)
    for got, key in ((masks, "masks"), (iou, "iou"), (tokens, "sam_tokens"), (obj, "obj")):
        np.testing.assert_allclose(npy(got), g[f"io::dec::{key}"], **MODULE_TOL)


def test_memory_attention_matches_golden(goldens):
    g = goldens("sam2")
    sd = golden_sd(g, "sd::memory_attention::")
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    ma = MemoryAttention(32, n, 2, sd["layers.0.linear1.weight"].shape[0],
                         sd["layers.0.cross_attn_image.k_proj.weight"].shape[1])
    ma.load_state_dict({k: T(v) for k, v in sd.items()})
    with torch.no_grad():
        out = ma(T(g["io::ma::curr"]), T(g["io::ma::memory"]), T(g["io::ma::curr_pos"]),
                 T(g["io::ma::memory_pos"]), feat_size=(4, 4), num_obj_ptr_tokens=4)
    np.testing.assert_allclose(npy(out), g["io::ma::out"], **MODULE_TOL)


def test_memory_encoder_matches_golden(goldens):
    g = goldens("sam2")
    sd = golden_sd(g, "sd::memory_encoder::")
    k = sd["mask_downsampler.encoder.0.weight"].shape[-1]
    n_fuser = len({key.split(".")[2] for key in sd if key.startswith("fuser.layers.")})
    me = MemoryEncoder(sd["pix_feat_proj.weight"].shape[0], sd["out_proj.weight"].shape[0],
                       (k, k, 0), n_fuser)
    me.load_state_dict({key: T(v) for key, v in sd.items()})
    with torch.no_grad():
        feat, pos = me(T(g["io::me::pix"]), T(g["io::me::mask"]))
    np.testing.assert_allclose(npy(feat), g["io::me::feat"], **MODULE_TOL)
    np.testing.assert_allclose(npy(pos), g["io::me::pos"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,hires", [("sam2_e2e", False), ("sam2_e2e_hires", True)])
def test_video_predictor_matches_golden(goldens, name, hires):
    g = goldens(name)
    _, cfg = golden_configs(hires)
    pred = port_predictor(cfg, golden_sd(g))
    state = pred.init_state(g["io::video_decoded"])
    mask = pred.add_new_points(state, 0, g["io::points"], g["io::labels"])
    np.testing.assert_allclose(mask, np.squeeze(g["io::click_mask"]), **E2E_TOL)
    for idx, m in pred.propagate_in_video(state):
        np.testing.assert_allclose(m, np.squeeze(g[f"io::prop::{idx}"]), err_msg=f"frame {idx}",
                                   **E2E_TOL)
        assert (m > 0).any(), f"frame {idx} lost the object"


def test_video_predictor_reverse_matches_golden(goldens):
    g = goldens("sam2_e2e")
    _, cfg = golden_configs(False)
    pred = port_predictor(cfg, golden_sd(g))
    state = pred.init_state(g["io::video_decoded"])
    mask = pred.add_new_points(state, 3, np.array([[40.0, 36.0]], np.float32),
                               np.array([1], np.int32))
    np.testing.assert_allclose(mask, np.squeeze(g["io::rev_click_mask"]), **E2E_TOL)
    for idx, m in pred.propagate_in_video(state, start_frame_idx=3, reverse=True):
        np.testing.assert_allclose(m, np.squeeze(g[f"io::rev::{idx}"]), err_msg=f"frame {idx}",
                                   **E2E_TOL)


def test_image_predictor_matches_golden(goldens):
    g = goldens("sam2_image")
    _, cfg = golden_configs(True)
    pred = SAM2ImagePredictor(port_predictor(cfg, golden_sd(g)))
    pred.set_image(g["io::img"])
    masks, iou, low = pred.predict(point_coords=g["io::pt::coords"],
                                   point_labels=g["io::pt::labels"], multimask_output=True,
                                   return_logits=True)
    np.testing.assert_allclose(iou, g["io::pt::iou"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(masks, g["io::pt::masks"], **E2E_TOL)
    np.testing.assert_allclose(low, g["io::pt::low"], **E2E_TOL)
    masks, iou, _ = pred.predict(box=g["io::box::box"], multimask_output=False,
                                 return_logits=True)
    np.testing.assert_allclose(iou, g["io::box::iou"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(masks, g["io::box::masks"], **E2E_TOL)


def mask_iou(a, b):
    union = np.logical_or(a, b).sum()
    return np.logical_and(a, b).sum() / union if union else 1.0


def test_amg_matches_golden(goldens):
    """The torch generator's full survivor set, in order (test_amg_golden.py's
    limits: mask IoU > 0.99, predicted IoU 1e-3, stability 1e-2)."""
    g = goldens("amg")
    _, cfg = golden_configs(True)
    amg = SAM2AutomaticMaskGenerator(
        SAM2ImagePredictor(port_predictor(cfg, golden_sd(g))),
        AutoMaskConfig(points_per_side=8, pred_iou_thresh=0.45, stability_score_thresh=0.0,
                       stability_offset=1.0, box_nms_thresh=0.7, min_mask_region_area=0))
    anns = amg.generate(g["io::img"])
    assert len(anns) == int(g["n_masks"])
    for i, a in enumerate(anns):
        assert mask_iou(a["segmentation"], g[f"mask::{i}"] > 0) > 0.99, f"mask {i}"
        assert abs(a["predicted_iou"] - float(g[f"iou::{i}"])) < 1e-3, f"iou {i}"
        assert abs(a["stability_score"] - float(g[f"stab::{i}"])) < 1e-2, f"stability {i}"


# -- against the JAX package on the same seeded weights ---------------------------------------

def tiny_tree():
    """A seeded JAX-initialised SAM2 tree (test_sam2_predictor.tiny_params),
    completed to the torch SAM2's layout: a mask downsampler whose channels
    grow by stride^2 per stage, the no-object pointer and the (unused)
    mask_downsample conv."""
    from test_sam2_predictor import tiny_params

    cfgs = []

    def init(key):   # one jitted program: eager JAX init is slow
        cfg, p = tiny_params(key)
        cfgs.append(cfg)
        return p

    params = jax.jit(init)(jax.random.PRNGKey(0))
    jc = cfgs[0]
    rng = np.random.default_rng(5)
    d = 32
    me = params["memory_encoder"]
    me["mask_down_convs"] = [jmodules.init_conv2d(jax.random.PRNGKey(i), cin, cout, k)
                             for i, (cin, cout, k) in enumerate(((1, 16, 4), (16, 256, 4),
                                                                 (256, d, 1)))]
    me["mask_down_lns"] = [{"scale": jnp.asarray(1 + 0.1 * rng.standard_normal(c), jnp.float32),
                            "bias": jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32)}
                           for c in (16, 256)]
    params["no_obj_ptr"] = jnp.asarray(rng.standard_normal((1, d)), jnp.float32)
    params["mask_downsample"] = jmodules.init_conv2d(jax.random.PRNGKey(9), 1, 1, 4)
    params = jax.tree.map(np.asarray, params)
    h = jc.hiera
    tc = SAM2Config(
        hiera=HieraConfig(embed_dim=h.embed_dim, num_heads=h.num_heads, stages=h.stages,
                          window_spec=h.window_spec, global_att_blocks=h.global_att_blocks,
                          window_pos_embed_bkg_spatial_size=h.window_pos_embed_bkg_spatial_size,
                          d_model=h.d_model, scalp=h.scalp, q_pool=h.q_pool),
        image_size=jc.image_size, num_maskmem=jc.num_maskmem, mem_dim=jc.mem_dim,
        hidden_dim=jc.hidden_dim, memory_attention_heads=jc.memory_attention_heads,
        mask_decoder_heads=jc.mask_decoder_heads,
        max_obj_ptrs_in_encoder=jc.max_obj_ptrs_in_encoder, use_high_res_features_in_sam=False,
        prompt_mask_in_chans=8, mask_decoder_mlp_dim=64, iou_head_hidden_dim=d,
        memory_attention_layers=2, memory_attention_ff=64, mask_downsampler=(4, 4, 0),
        memory_encoder_fuser_layers=1)
    return jc, tc, params


@pytest.fixture(scope="module")
def tiny():
    jc, tc, params = tiny_tree()
    return jc, tc, params, port_predictor(tc, {k: npy(v) for k, v in
                                               sam2_state_dict(params).items()})


def test_state_dict_round_trip(goldens):
    """sam2_state_dict inverts the JAX converter exactly, key for key."""
    for name in ("sam2_e2e", "sam2_e2e_hires"):
        sd = golden_sd(goldens(name))
        back = sam2_state_dict(convert_sam2_state_dict(sd))
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert np.array_equal(npy(back[k]), v), k


def test_modules_match_jax(tiny):
    """Image encoder, prompt encoder, mask decoder, memory attention and
    memory encoder of the port against the JAX functions, same weights."""
    jc, tc, params, pred = tiny
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    jout = jit(HieraImageEncoder(jc.hiera).apply, params["image_encoder"], img)
    with torch.no_grad():
        out = pred.image_encoder(T(nchw(img)))
    for a, b in zip(out["backbone_fpn"], jout["backbone_fpn"]):
        np.testing.assert_allclose(npy(a), nchw(b), rtol=0, atol=JAX_ATOL)
    for a, b in zip(out["vision_pos_enc"], jout["vision_pos_enc"]):
        np.testing.assert_allclose(npy(a), nchw(b), rtol=0, atol=1e-6)

    pts = rng.uniform(0, 64, (1, 2, 2)).astype(np.float32)
    lbl = np.array([[1, 0]], np.int32)
    mask_in = rng.standard_normal((1, 16, 16, 1)).astype(np.float32)
    js, jd = jit(lambda p, m: jheads.prompt_encoder(
        p, image_embedding_size=(4, 4), input_image_size=(64, 64), points=(pts, lbl), masks=m),
        params["prompt_encoder"], mask_in)
    with torch.no_grad():
        ts, td = pred.sam_prompt_encoder(points=(T(pts), T(lbl)), masks=T(nchw(mask_in)))
    np.testing.assert_allclose(npy(ts), js, rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(npy(td), nchw(jd), rtol=0, atol=JAX_ATOL)

    emb = rng.standard_normal((1, 4, 4, 32)).astype(np.float32)
    for multimask in (True, False):
        def heads(p, e, multimask=multimask):
            js, jd = jheads.prompt_encoder(p["prompt_encoder"], image_embedding_size=(4, 4),
                                           input_image_size=(64, 64), points=(pts, lbl))
            return jheads.mask_decoder(
                p["mask_decoder"], image_embeddings=e,
                image_pe=jheads.get_dense_pe(p["prompt_encoder"], (4, 4)),
                sparse_prompt_embeddings=js, dense_prompt_embeddings=jd,
                multimask_output=multimask, num_heads=2, iou_prediction_use_sigmoid=True)

        jres = jit(heads, params, emb)
        with torch.no_grad():
            ts, td = pred.sam_prompt_encoder(points=(T(pts), T(lbl)))
            tres = pred.sam_mask_decoder(T(nchw(emb)), pred.sam_prompt_encoder.get_dense_pe(),
                                         ts, td, multimask_output=multimask)
        for a, b in zip(tres, jres):
            np.testing.assert_allclose(npy(a), np.asarray(b), rtol=0, atol=JAX_ATOL)

    # a box prompt (the encoder's box path), and the stability fallback of a
    # single-mask output
    box = np.array([[4.0, 6.0, 50.0, 40.0]], np.float32)

    def boxed(p, e):
        js, jd = jheads.prompt_encoder(p["prompt_encoder"], image_embedding_size=(4, 4),
                                       input_image_size=(64, 64), points=(pts, lbl),
                                       boxes=jnp.asarray(box))
        res = jheads.mask_decoder(
            p["mask_decoder"], image_embeddings=e,
            image_pe=jheads.get_dense_pe(p["prompt_encoder"], (4, 4)),
            sparse_prompt_embeddings=js, dense_prompt_embeddings=jd, multimask_output=False,
            num_heads=2, dynamic_multimask_via_stability=True, stability_thresh=0.5,
            iou_prediction_use_sigmoid=True)
        return js, res

    js, jres = jit(boxed, params, emb)
    with torch.no_grad():
        ts, td = pred.sam_prompt_encoder(points=(T(pts), T(lbl)), boxes=T(box))
        tres = pred.sam_mask_decoder(T(nchw(emb)), pred.sam_prompt_encoder.get_dense_pe(), ts,
                                     td, multimask_output=False,
                                     dynamic_multimask_via_stability=True, stability_thresh=0.5)
    np.testing.assert_allclose(npy(ts), js, rtol=0, atol=JAX_ATOL)
    for a, b in zip(tres[:2], jres[:2]):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=0, atol=JAX_ATOL)

    curr = rng.standard_normal((16, 1, 32)).astype(np.float32)
    cpos = rng.standard_normal((16, 1, 32)).astype(np.float32)
    mem = rng.standard_normal((2 * 16 + 4, 1, 16)).astype(np.float32)
    mpos = rng.standard_normal((2 * 16 + 4, 1, 16)).astype(np.float32)
    jo = jit(lambda p, *a: jmemory.memory_attention(p, *a, num_heads=2, feat_size=(4, 4),
                                                    num_obj_ptr_tokens=4),
             params["memory_attention"], curr, mem, cpos, mpos)
    with torch.no_grad():
        to = pred.memory_attention(T(curr), T(mem), T(cpos), T(mpos), feat_size=(4, 4),
                                   num_obj_ptr_tokens=4)
    np.testing.assert_allclose(npy(to), np.asarray(jo), rtol=0, atol=JAX_ATOL)

    pix = rng.standard_normal((1, 4, 4, 32)).astype(np.float32)
    m = rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
    jf, jp = jit(jmemory.memory_encoder, params["memory_encoder"], pix, m)
    with torch.no_grad():
        tf, tp = pred.memory_encoder(T(nchw(pix)), T(nchw(m)))
    np.testing.assert_allclose(npy(tf), nchw(jf), rtol=0, atol=JAX_ATOL)
    np.testing.assert_allclose(npy(tp), nchw(jp), rtol=0, atol=1e-6)


def tiny_video(seed=0, t=5):
    return (np.random.default_rng(seed).random((t, 64, 64, 3)) * 255).astype(np.uint8)


def test_video_predictor_matches_jax(tiny):
    """Clicks (an accumulating negative one included), forward propagation,
    reset and a reverse propagation from a click on the last frame."""
    jc, _, params, pred = tiny
    jpred = JPredictor(jc, params)
    video = tiny_video()
    js, ts = jpred.init_state(video), pred.init_state(video)
    np.testing.assert_array_equal(npy(ts.images.permute(0, 2, 3, 1)), js.images)
    for pts, lbl in (([[32.0, 30.0]], [1]), ([[10.0, 12.0]], [0])):
        p, l_ = np.array(pts, np.float32), np.array(lbl, np.int32)
        np.testing.assert_allclose(pred.add_new_points(ts, 0, p, l_),
                                   jpred.add_new_points(js, 0, p, l_), rtol=0, atol=JAX_ATOL)
    assert ts.points[0][0].shape[0] == 2
    ref = dict(jpred.propagate_in_video(js))
    got = dict(pred.propagate_in_video(ts))
    assert sorted(got) == sorted(ref) == list(range(len(video)))
    for i in ref:
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=JAX_ATOL, err_msg=f"frame {i}")
    pred.reset_state(ts)
    jpred.reset_state(js)
    assert not ts.points and not ts.cond_outputs and not ts.non_cond_outputs
    p, l_ = np.array([[40.0, 20.0]], np.float32), np.array([1], np.int32)
    np.testing.assert_allclose(pred.add_new_points(ts, 4, p, l_),
                               jpred.add_new_points(js, 4, p, l_), rtol=0, atol=JAX_ATOL)
    ref = dict(jpred.propagate_in_video(js, start_frame_idx=4, reverse=True))
    for i, m in pred.propagate_in_video(ts, start_frame_idx=4, reverse=True):
        np.testing.assert_allclose(m, ref[i], rtol=0, atol=JAX_ATOL, err_msg=f"frame {i}")


@pytest.mark.parametrize("hw", [(48, 72), (8, 12), (24, 12)])
def test_image_predictor_matches_jax(tiny, hw):
    """Point and box prompts; the masks resized to the image: up (48x72),
    down with antialiasing (8x12 from the 16x16 low-res masks) and mixed."""
    jc, _, params, pred = tiny
    img = (np.random.default_rng(1).random((*hw, 3)) * 255).astype(np.uint8)
    jp, tp = jimage.SAM2ImagePredictor(jc, params), SAM2ImagePredictor(pred)
    jp.set_image(img)
    tp.set_image(img)
    pt = np.array([[hw[1] / 2, hw[0] / 3]], np.float32)
    for kw in (dict(point_coords=pt, point_labels=np.array([1]), multimask_output=True),
               dict(box=np.array([1, 1, hw[1] - 2, hw[0] - 3], np.float32), point_coords=pt,
                    point_labels=np.array([0]), multimask_output=False)):
        ref = jp.predict(return_logits=True, **kw)
        got = tp.predict(return_logits=True, **kw)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=JAX_ATOL)
    masks, _, _ = tp.predict(point_coords=pt, point_labels=np.array([1]))
    assert masks.dtype == bool and masks.shape == (3, *hw)


@pytest.mark.parametrize("min_area", [0, 40])
def test_amg_matches_jax(tiny, min_area):
    """The same annotations as the JAX generator, in order; with a minimum
    region area the small-region repair runs (the connected-components plain
    version here, the JAX package's C++ union-find there)."""
    jc, _, params, pred = tiny
    img = (np.random.default_rng(2).random((48, 72, 3)) * 255).astype(np.uint8)
    cfg = AutoMaskConfig(points_per_side=4, pred_iou_thresh=0.0, stability_score_thresh=0.0,
                         min_mask_region_area=min_area)
    jcfg = jimage.AutoMaskConfig(**vars(cfg))
    ref = jimage.SAM2AutomaticMaskGenerator(jimage.SAM2ImagePredictor(jc, params),
                                            jcfg).generate(img)
    got = SAM2AutomaticMaskGenerator(SAM2ImagePredictor(pred), cfg).generate(img)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a["segmentation"].dtype == bool
        np.testing.assert_array_equal(a["segmentation"], b["segmentation"])
        assert a["area"] == b["area"] and a["bbox"] == b["bbox"]
        assert a["point_coords"] == b["point_coords"] and a["crop_box"] == b["crop_box"]
        assert abs(a["predicted_iou"] - b["predicted_iou"]) < JAX_ATOL
        assert a["stability_score"] == b["stability_score"]


def test_helpers_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jmodules.bicubic_resize_torch(jnp.asarray(x), 11, 4))
    got = npy(tmodules.bicubic_resize_torch(T(nchw(x)), 11, 4).permute(0, 2, 3, 1))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    for size in ((20, 28), (3, 4), (9, 3)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear"))
        got = npy(tmodules.resize_bilinear(T(nchw(x)), size).permute(0, 2, 3, 1))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5, err_msg=str(size))
    xw = rng.standard_normal((1, 9, 6, 4)).astype(np.float32)
    jw, jpad = jmodules.window_partition(jnp.asarray(xw), 4)
    tw, tpad = tmodules.window_partition(T(xw), 4)
    assert tpad == jpad
    np.testing.assert_array_equal(npy(tw), np.asarray(jw))
    np.testing.assert_array_equal(tmodules.window_unpartition(tw, 4, tpad, (9, 6)).numpy(), xw)
    q = rng.standard_normal((1, 2, 16, 8)).astype(np.float32)
    k = rng.standard_normal((1, 2, 48, 8)).astype(np.float32)
    cis = jmodules.compute_axial_cis(8, 4, 4)
    jq, jk = jmodules.apply_rotary_enc(jnp.asarray(q), jnp.asarray(k), cis, repeat_freqs_k=True)
    tq, tk = tmodules.apply_rotary_enc(T(q), T(k), tmodules.compute_axial_cis(8, 4, 4),
                                       repeat_freqs_k=True)
    np.testing.assert_allclose(npy(tq), np.asarray(jq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(npy(tk), np.asarray(jk), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(npy(tmodules.sine_pos_embed(3, 5, 8)[0].permute(1, 2, 0)),
                                  jmodules.sine_pos_embed(3, 5, 8))


# -- checkpoints ----------------------------------------------------------------------------

def flatten_tree(tree, prefix=""):
    """The JAX parameter tree as tools/convert_checkpoint.py writes it: paths
    joined by '/', list indices as numbers."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def test_build_from_checkpoints(tmp_path):
    """A published variant's module tree from a torch .pt (its "model"
    entry) and from the JAX package's flat .npz of the same weights."""
    torch.manual_seed(0)
    ref = build_sam2_video_predictor("tiny", None, image_size=64, device="cpu")
    sd = {k: v.clone() for k, v in ref.state_dict().items()}
    assert "image_encoder.trunk.blocks.0.attn.qkv.weight" in sd
    assert sd["memory_encoder.mask_downsampler.encoder.0.weight"].shape == (4, 1, 3, 3)
    torch.save({"model": sd}, tmp_path / "sam2.pt")
    tree = convert_sam2_state_dict({k: npy(v) for k, v in sd.items()})
    np.savez(tmp_path / "sam2.npz", **flatten_tree(tree))
    assert {k: v.shape for k, v in load_sam2_npz(str(tmp_path / "sam2.npz")).items()} == \
        {k: v.shape for k, v in sd.items()}
    for path in ("sam2.pt", "sam2.npz"):
        got = build_sam2_video_predictor("tiny", str(tmp_path / path), image_size=64,
                                         device="cpu")
        for k, v in got.state_dict().items():
            assert torch.equal(v, sd[k]), (path, k)
    video = tiny_video(4, 2)
    state = got.init_state(video)
    mask = got.add_new_points(state, 0, np.array([[20.0, 20.0]], np.float32),
                              np.array([1], np.int32))
    assert mask.shape == (64, 64) and np.isfinite(mask).all()
    with pytest.raises(ValueError):
        build_sam2_video_predictor("huge", None, device="cpu")


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sam2_video_predictor("tiny", None, image_size=64)
