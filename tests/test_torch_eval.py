"""The port's evaluation modules (videopainter_tpu_torch/evaluate/) on the
CPU, against the JAX package's `evaluate/` and the goldens, on the same
seeded inputs and weights:

 - the closed-form metrics (float64 on both sides: relative 1e-9), on a frame
   size that is no multiple of 11 and on a batch of frames;
 - LPIPS against `lpips.npz` (< 1e-4, as tests/test_lpips.py) and against the
   JAX forward on weights carried by `convert.lpips_state_dict` (atol 1e-5);
 - I3D against `i3d.npz` (1e-3, as tests/test_extractors.py) and against the
   JAX forward on an odd-sized clip (ragged SAME pads; atol 1e-4), through
   `convert.i3d_state_dict` and through the raw checkpoint;
 - CLIP (`tests/goldens/clip_tiny`) against `clip.npz` (rtol 1e-4 / atol 1e-5);
 - the flow warps, global and masked, with flows that leave the frame
   (atol 1e-6);
 - the DAVIS and VPBench readers (equal arrays, dilation included);
 - `edit_sample_metrics` / `run_edit_eval` against the JAX ones.
"""

import os

import jax
import numpy as np
import pytest
import torch

import videopainter_tpu.evaluate.metrics as jm
import videopainter_tpu_torch.evaluate.metrics as pm
from videopainter_tpu_torch.convert import i3d_state_dict, lpips_state_dict
from videopainter_tpu_torch.evaluate.extractors import (ClipExtractor, I3DExtractor,
                                                        InceptionI3d, i3d_extract_features)
from videopainter_tpu_torch.evaluate.lpips import (LPIPS, LpipsExtractor,
                                                   convert_lpips_state_dict, lpips_forward)

REL = 1e-9


def frames(seed, n=3, h=37, w=50, c=3, noise=0.05):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, h, w, c)
    return a, np.clip(a + rng.randn(*a.shape) * noise, 0, 1)


# -- closed-form metrics ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["psnr", "ssim", "mse", "mae"])
def test_closed_form_metric_matches_jax(name):
    """Per frame and batched over frames, float64, relative 1e-9; a
    channel-less pair too (the JAX functions take [H, W])."""
    a, b = frames(0)
    jv = np.array([getattr(jm, name)(a[i], b[i]) for i in range(len(a))])
    np.testing.assert_allclose(getattr(pm, "frame_" + name)(a, b).numpy(), jv, rtol=REL)
    np.testing.assert_allclose(getattr(pm, name)(a[1], b[1]), jv[1], rtol=REL)
    np.testing.assert_allclose(getattr(pm, name)(a[0, ..., 0], b[0, ..., 0]),
                               getattr(jm, name)(a[0, ..., 0], b[0, ..., 0]), rtol=REL)
    if name == "ssim":   # the host plain version the card's SSIM is held to
        np.testing.assert_allclose(pm.ssim_reference(a[2], b[2]), jv[2], rtol=REL)


def test_masked_and_identity_metrics_match_jax():
    """The calculator's masked variants (pixel-space mask products in
    float32, as the JAX harness passes them) and the identical-frame case
    (PSNR inf, SSIM 1)."""
    a, b = (x.astype(np.float32) for x in frames(1, n=2, h=29, w=41))
    mask = np.zeros((29, 41), np.float32)
    mask[5:20, 9:30] = 1
    jrow = jm.MetricsCalculator().frame_metrics(a[0], b[0], mask=mask)
    prow = pm.MetricsCalculator().frame_metrics(a[0], b[0], mask=mask)
    assert list(prow) == list(jrow)
    for k in jrow:
        np.testing.assert_allclose(prow[k], jrow[k], rtol=REL, err_msg=k)
    assert pm.psnr(a[0], a[0]) == float("inf")
    assert pm.ssim(a[0], a[0]) == pytest.approx(1.0, abs=1e-12)
    rows = pm.MetricsCalculator().video_frame_metrics(a, b, masks=np.stack([mask, mask]))
    assert rows[0] == prow


def test_distributional_metrics_match_jax():
    rng = np.random.RandomState(2)
    fa, fb = rng.randn(40, 6), rng.randn(40, 6) + 0.5
    np.testing.assert_allclose(pm.frechet_distance(fa, fb), jm.frechet_distance(fa, fb),
                               rtol=REL)
    e = rng.randn(7, 16)
    np.testing.assert_allclose(pm.temporal_consistency(e), jm.temporal_consistency(e),
                               rtol=REL)
    np.testing.assert_allclose(pm.temporal_consistency(torch.from_numpy(e)),
                               jm.temporal_consistency(e), rtol=REL)
    np.testing.assert_allclose(pm.cosine_sim(e[0], e[1]), jm.cosine_sim(e[0], e[1]), rtol=REL)
    assert pm.temporal_consistency(e[:1]) == 1.0


# -- LPIPS -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_golden(goldens):
    return goldens("lpips")


def golden_sd(g):
    return {k[4:]: g[k] for k in g.files if k.startswith("sd::")}


@pytest.mark.parametrize("case", [0, 1, 2])
def test_lpips_matches_golden(lpips_golden, tmp_path, case):
    """The golden's `sd::` dict loads with load_state_dict; every case (odd
    sizes: ceil-mode pooling) within 1e-4, through the module and through
    the extractor's [0, 1] contract from an .npz."""
    g = lpips_golden
    model = LPIPS()
    model.load_state_dict(convert_lpips_state_dict(golden_sd(g)))
    a = torch.from_numpy(g[f"a{case}"])[None] * 2 - 1
    b = torch.from_numpy(g[f"b{case}"])[None] * 2 - 1
    with torch.no_grad():
        d = float(lpips_forward(model.eval(), a, b)[0])
    assert abs(d - float(g[f"d{case}"])) < 1e-4
    path = tmp_path / "lpips.npz"
    np.savez(path, **golden_sd(g))
    fn = LpipsExtractor(str(path), device="cpu")
    assert abs(fn(g[f"a{case}"], g[f"b{case}"]) - float(g[f"d{case}"])) < 1e-4


def test_lpips_matches_jax_forward(lpips_golden):
    """The JAX pytree carried by `lpips_state_dict` (weights re-seeded, so
    nothing rests on the golden's) against JAX `lpips_forward`, a batch of
    odd-sized pairs: atol 1e-5; the batched extractor equals per-pair calls."""
    from videopainter_tpu.evaluate.lpips import convert_lpips_state_dict as jconv
    from videopainter_tpu.evaluate.lpips import lpips_forward as jfwd

    rng = np.random.RandomState(3)
    sd = {k: (rng.randn(*v.shape) * 0.08 if "lin" not in k
              else np.abs(rng.randn(*v.shape)) * 0.1).astype(np.float32)
          for k, v in golden_sd(lpips_golden).items() if k not in ("shift", "scale")}
    jparams = jconv(sd)
    a = rng.rand(3, 45, 59, 3).astype(np.float32)
    b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 0.1, 0, 1)
    want = np.asarray(jax.jit(jfwd)(jparams, a * 2 - 1, b * 2 - 1))
    model = LPIPS()
    model.load_state_dict(lpips_state_dict(jax.tree.map(np.asarray, jparams)))
    with torch.no_grad():
        got = lpips_forward(model.eval(), torch.from_numpy(a) * 2 - 1,
                            torch.from_numpy(b) * 2 - 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    ext = LpipsExtractor.__new__(LpipsExtractor)
    ext.device, ext.model = torch.device("cpu"), model
    np.testing.assert_allclose(ext.batch(a, b, chunk=2).numpy(),
                               [ext(a[i], b[i]) for i in range(3)], rtol=1e-6)


# -- I3D -------------------------------------------------------------------------------

def test_i3d_matches_golden(goldens, tmp_path):
    """The pytorch-i3d state dict loads by its names (logits and BatchNorm
    counters included) and gives the golden's features (1e-3), through the
    module and through `I3DExtractor` from a `.pt`."""
    g = goldens("i3d")
    sd = {k[4:]: torch.as_tensor(g[k]) for k in g.files if k.startswith("sd::")}
    model = InceptionI3d()
    model.load_state_dict(sd)
    with torch.no_grad():
        feats = model.eval()(torch.from_numpy(g["video"])).numpy()
    np.testing.assert_allclose(feats, g["features"], rtol=1e-3, atol=1e-3)
    torch.save(sd, tmp_path / "i3d.pt")
    video01 = np.transpose(g["video"][0], (1, 2, 3, 0)) / 2 + 0.5   # [T, H, W, 3] in [0, 1]
    got = I3DExtractor(str(tmp_path / "i3d.pt"), device="cpu")(video01).numpy()
    np.testing.assert_allclose(got, g["features"][0], rtol=1e-3, atol=1e-3)


def test_i3d_matches_jax_on_ragged_pads():
    """A ragged clip (9 x 29 x 36: an even side pads one more after than before),
    JAX `i3d_extract_features` against the port, the weights through
    `i3d_state_dict` and as the raw checkpoint: atol 1e-4."""
    from test_extractors import random_i3d_sd
    from videopainter_tpu.evaluate.extractors import convert_i3d_state_dict
    from videopainter_tpu.evaluate.extractors import i3d_extract_features as jfeat

    sd = random_i3d_sd(seed=4)
    video = np.random.RandomState(5).rand(1, 9, 29, 36, 3).astype(np.float32) * 2 - 1
    jparams = convert_i3d_state_dict(sd)
    want = jfeat(jparams, video)   # returns numpy: not jittable, and reaches no Pallas kernel
    for weights in (i3d_state_dict(jparams), {k: torch.as_tensor(v) for k, v in sd.items()}):
        model = InceptionI3d()
        model.load_state_dict(weights, strict=False)
        with torch.no_grad():
            got = i3d_extract_features(model.eval(), torch.from_numpy(video)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


# -- CLIP ------------------------------------------------------------------------------

def test_clip_extractor_matches_golden(goldens):
    """torch CLIP + the processor on the tiny checkpoint against the golden:
    image features and the CLIPScore convention; the batched forms equal the
    single ones."""
    pytest.importorskip("transformers")
    g = goldens("clip")
    ce = ClipExtractor("tests/goldens/clip_tiny", device="cpu")
    np.testing.assert_allclose(ce.image_embed(g["img"]).numpy(), g["image_features"],
                               rtol=1e-4, atol=1e-5)
    text = str(g["text"])
    np.testing.assert_allclose(ce.clip_score(g["img"], text), float(g["clip_score"]), rtol=1e-4)
    imgs = np.stack([g["img"], g["img"][::-1].copy(), g["img"] * 0.5])
    np.testing.assert_allclose(ce.clip_score.batch(imgs, text).numpy(),
                               [ce.clip_score(im, text) for im in imgs], rtol=1e-5)
    np.testing.assert_allclose(ce.image_embed.batch(imgs).numpy(),
                               np.stack([ce.image_embed(im).numpy() for im in imgs]),
                               rtol=1e-5, atol=1e-6)


# -- flow ------------------------------------------------------------------------------

def _flow_fn(f0, f1):
    """A deterministic flow of two frames that points out of the frame at
    the borders."""
    f0, f1 = np.asarray(f0), np.asarray(f1)
    h, w = f0.shape[:2]
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (f1 - f0).mean(-1).astype(np.float32)
    return np.stack([(gx - w / 2) * 0.4 + 3 * d, (gy - h / 2) * -0.3 + 2 * d], -1)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_warp_with_flow_matches_jax(dtype):
    from videopainter_tpu.evaluate.flow_util import warp_with_flow as jwarp

    from videopainter_tpu_torch.evaluate.flow_util import warp_with_flow

    rng = np.random.RandomState(6)
    img = rng.rand(13, 17, 3).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    flow = (rng.randn(13, 17, 2) * 6).astype(np.float32)   # many samples leave the frame
    got = warp_with_flow(img, flow)
    want = jwarp(img, flow)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_flow_warping_error_matches_jax():
    from videopainter_tpu.evaluate.flow_util import flow_warping_error as jfwe

    from videopainter_tpu_torch.evaluate.flow_util import flow_warping_error

    rng = np.random.RandomState(7)
    video = rng.rand(4, 12, 15, 3).astype(np.float32)
    masks = (rng.rand(4, 12, 15) > 0.6).astype(np.float32)
    for m in (None, masks):
        np.testing.assert_allclose(flow_warping_error(torch.from_numpy(video), _flow_fn, m),
                                   jfwe(video, _flow_fn, m), atol=1e-6)
    calc = pm.MetricsCalculator(flow_fn=_flow_fn).video_metrics(video, masks=masks)
    want = jm.MetricsCalculator(flow_fn=_flow_fn).video_metrics(video, masks=masks)
    assert list(calc) == list(want)
    for k in want:
        np.testing.assert_allclose(calc[k], want[k], atol=1e-6)


# -- datasets --------------------------------------------------------------------------

def test_davis_reader_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from test_eval_cli import make_davis
    from videopainter_tpu.evaluate.datasets import DavisTestDataset as JDavis

    from videopainter_tpu_torch.evaluate.datasets import DavisTestDataset

    make_davis(str(tmp_path), names=("bear", "boat"), t=5, h=30, w=44)
    kw = dict(root=str(tmp_path / "davis"), height=24, width=40, dilate_iterations=2)
    want, got = list(JDavis(**kw)), list(DavisTestDataset(**kw))
    assert [s["name"] for s in got] == [s["name"] for s in want] == ["bear", "boat"]
    for g, w in zip(got, want):
        assert g["caption"] == w["caption"]
        for k in ("video", "masks"):
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert got[0]["masks"].sum() > 0


def test_vpbench_reader_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from test_cli_integration import make_data
    from videopainter_tpu.evaluate.datasets import VPBenchDataset as JVP

    from videopainter_tpu_torch.evaluate.datasets import VPBenchDataset

    make_data(str(tmp_path))
    kw = dict(meta_file_path=str(tmp_path / "meta.csv"), height=32, width=48,
              dilate_iterations=1, max_videos=1)
    want, got = list(JVP(**kw)), list(VPBenchDataset(**kw))
    assert len(got) == len(want) == 1
    assert got[0]["name"] == want[0]["name"] and got[0]["caption"] == want[0]["caption"]
    for k in ("video", "masks"):
        assert np.array_equal(got[0][k], want[0][k]), k


# -- edit evaluation -------------------------------------------------------------------

def _fake_clip():
    def score(image, text):
        return float(np.asarray(image).mean() * 100 + len(text))

    def embed(image):
        x = np.asarray(image, np.float64)
        return np.array([x.mean(), x[..., 0].mean(), x.std(), 1.0])

    return score, embed


def test_edit_eval_matches_jax(tmp_path):
    from videopainter_tpu.evaluate.eval_edit import EditEvalConfig as JCfg
    from videopainter_tpu.evaluate.eval_edit import edit_sample_metrics as jsample
    from videopainter_tpu.evaluate.eval_edit import run_edit_eval as jrun

    from videopainter_tpu_torch.evaluate.eval_edit import (EditEvalConfig, edit_sample_metrics,
                                                           run_edit_eval)

    rng = np.random.RandomState(8)
    samples = []
    for i in range(2):
        src = rng.rand(4, 23, 31, 3).astype(np.float32)
        masks = np.zeros((4, 23, 31), np.float32)
        masks[:, 4:15, 6 + i:20] = 1
        edited = np.where(masks[..., None] > 0, rng.rand(*src.shape).astype(np.float32), src)
        samples.append({"name": f"s{i}", "edited": edited, "source": src, "masks": masks,
                        "edited_caption": "make it red"})
    score, embed = _fake_clip()
    kw = dict(text_image_score_fn=score, image_embed_fn=embed)
    one = edit_sample_metrics(samples[0]["edited"], samples[0]["source"], samples[0]["masks"],
                              "make it red", pm.MetricsCalculator(**kw), device="cpu")
    want_one = jsample(samples[0]["edited"], samples[0]["source"], samples[0]["masks"],
                       "make it red", jm.MetricsCalculator(**kw))
    assert list(one) == list(want_one)
    for k in want_one:
        np.testing.assert_allclose(one[k], want_one[k], rtol=1e-9, err_msg=k)
    want = jrun(samples, JCfg(output_dir=str(tmp_path / "jax")), jm.MetricsCalculator(**kw))
    got = run_edit_eval(samples, EditEvalConfig(output_dir=str(tmp_path / "port")),
                        pm.MetricsCalculator(**kw), device="cpu")
    assert list(got) == list(want)
    for k in want:
        if k != "time_s":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    assert os.path.exists(tmp_path / "port" / "results.csv")
    # resume: every sample is done
    again = run_edit_eval(samples, EditEvalConfig(output_dir=str(tmp_path / "port")),
                          pm.MetricsCalculator(**kw), device="cpu")
    assert again == got
