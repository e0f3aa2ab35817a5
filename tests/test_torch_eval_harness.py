"""The port's inpainting-evaluation harness, its eval CLI and its sweep
(videopainter_tpu_torch/evaluate/harness.py, cli.py, sweep.py) on the CPU,
against the JAX package's:

 - both harnesses drive the same deterministic stub pipeline (a numpy
   function of its inputs), so everything around the model is compared: the
   frame trimming, the pipeline's arguments, the compositing and the written
   frames, the per-video rows and the `__average__` row of results.csv, FVID
   (relative 1e-6; `time_per_frame_s` is a clock);
 - a partial run resumed: the averages reproduce the JAX harness's, whose
   resume counts its own average row (pinned here);
 - the caption hook;
 - `evaluate.cli.main` and `evaluate.sweep.main` end to end on
   tests/test_cli_integration.make_ckpts checkpoints with `--device cpu`:
   the JAX harness's columns, finite values, a resume that runs no pipeline,
   rows equal to a direct harness call's, the sweep's layout and summary.
"""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import videopainter_tpu.evaluate.harness as jh  # noqa: E402
import videopainter_tpu.evaluate.metrics as jm  # noqa: E402
import videopainter_tpu_torch.evaluate.harness as ph  # noqa: E402
import videopainter_tpu_torch.evaluate.metrics as pm  # noqa: E402
from test_cli_integration import make_ckpts  # noqa: E402
from test_eval_cli import make_davis  # noqa: E402

REL = 1e-6
CLOCKS = ("time_per_frame_s",)


def stub(image, video, masks):
    """[1, T, H, W, 3] in [-1, 1] from the pipeline's inputs (numpy)."""
    return np.clip(0.7 * video + 0.2 * masks[..., None] * np.tanh(3 * image[:, None]) - 0.05,
                   -1, 1).astype(np.float32)


def make_pipes(calls):
    def jax_pipe(params, *, image, video, masks, **kw):
        calls["jax"].append(kw)
        return jnp.asarray(stub(np.asarray(image), np.asarray(video), np.asarray(masks)))

    def port_pipe(*, image, video, masks, **kw):
        calls["port"].append(kw)
        return torch.from_numpy(stub(image.numpy(), video.numpy(), masks.numpy()))

    return jax_pipe, port_pipe


def dataset(n=3, t=15, h=24, w=40, caption="a test clip"):
    rng = np.random.RandomState(11)
    out = []
    for i in range(n):
        masks = np.zeros((t, h, w), np.uint8)
        masks[:, 5 + i:18, 8:30 - i] = 1
        out.append({"name": f"vid{i}", "caption": caption, "masks": masks,
                    "video": (rng.rand(t, h, w, 3) * 255).astype(np.uint8)})
    return out


def fake_extractors():
    """Per-frame callables both harnesses accept (numpy arrays or CPU
    tensors), so the calculator's plumbing is compared, not a model."""
    def lpips(a, b):
        return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).mean() * 3)

    def score(image, text):
        return float(np.asarray(image, np.float64).mean() * 100 + len(text))

    def embed(image):
        x = np.asarray(image, np.float64)
        return np.array([x.mean(), x[..., 1].mean(), x.std(), 0.5])

    def video_feats(video):
        x = np.asarray(video, np.float64)
        return np.array([x.mean(), x.std(), x[..., 0].mean(), (x ** 2).mean()])

    return dict(lpips_fn=lpips, text_image_score_fn=score, image_embed_fn=embed,
                video_feature_fn=video_feats)


def embeds():
    e = np.random.RandomState(0).rand(1, 5, 12).astype(np.float32)
    return (lambda c: (jnp.asarray(e), jnp.zeros_like(jnp.asarray(e))),
            lambda c: (torch.from_numpy(e), torch.zeros_like(torch.from_numpy(e))))


def run_both(tmp_path, data, cfg_kw, metrics=True, sub=""):
    calls = {"jax": [], "port": []}
    jpipe, ppipe = make_pipes(calls)
    jenc, penc = embeds()
    mk = fake_extractors() if metrics else {}
    jsum = jh.run_inpainting_eval(
        jpipe, None, data, jh.EvalConfig(output_dir=str(tmp_path / "jax" / sub), **cfg_kw),
        metrics=jm.MetricsCalculator(**mk), encode_prompt_fn=jenc)
    psum = ph.run_inpainting_eval(
        ppipe, data, ph.EvalConfig(output_dir=str(tmp_path / "port" / sub), **cfg_kw),
        metrics=pm.MetricsCalculator(**mk), encode_prompt_fn=penc, device="cpu")
    return jsum, psum, calls


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def assert_rows_equal(got, want):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert list(got[0]) == list(want[0])
    for g, w in zip(got, want):
        for k in w:
            if k != "name" and k not in CLOCKS:
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=REL, err_msg=k)


def assert_summary_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if k not in CLOCKS:
            np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)


def test_harness_matches_jax(tmp_path):
    """Trim (15 frames, windows of 9 at stride 4: 13 used), the pipeline's
    arguments, the composite frames on disk, results.csv row for row with
    its __average__ row, and the summary with FVID."""
    cfg = dict(num_inference_steps=3, num_frames=9, stride=4, prev_clip_weight=0.3,
               replace_gt=True, mask_add=True)
    jsum, psum, calls = run_both(tmp_path, dataset(), cfg)
    assert_summary_equal(psum, jsum)
    assert "fvid" in psum and np.isfinite(psum["fvid"])
    assert_rows_equal(read_csv(tmp_path / "port" / "results.csv"),
                      read_csv(tmp_path / "jax" / "results.csv"))
    assert read_csv(tmp_path / "port" / "results.csv")[-1]["name"] == "__average__"
    for jkw, pkw in zip(calls["jax"], calls["port"]):
        assert pkw.pop("output_type") == "pt"
        assert isinstance(pkw.pop("generator"), torch.Generator) and "rng" in jkw
        jkw.pop("rng")
        assert list(pkw) == list(jkw)
        for k, v in jkw.items():
            np.testing.assert_array_equal(np.asarray(pkw[k]), np.asarray(v), err_msg=k)
    assert calls["port"][0]["num_frames"] == 9 and calls["port"][0]["stride"] == 4
    for name in ("vid0", "vid2"):
        files = sorted(os.listdir(tmp_path / "port" / "comp_frames" / name))
        assert files == sorted(os.listdir(tmp_path / "jax" / "comp_frames" / name))
        assert len(files) == 13
        for f in files:
            a = cv2.imread(str(tmp_path / "port" / "comp_frames" / name / f))
            b = cv2.imread(str(tmp_path / "jax" / "comp_frames" / name / f))
            assert np.array_equal(a, b), (name, f)


def test_harness_partial_resume_matches_jax(tmp_path):
    """A run stopped after one video, then resumed over three: both harnesses
    read their own __average__ row back, so it joins the means and the first
    video weighs twice: (2 v0 + v1 + v2) / 4. The port keeps that quirk."""
    data = dataset()
    cfg = dict(num_inference_steps=2, num_frames=9, replace_gt=True, mask_add=True)
    run_both(tmp_path, data, dict(cfg, max_videos=1), metrics=False)
    jsum, psum, calls = run_both(tmp_path, data, cfg, metrics=False)
    assert len(calls["port"]) == len(calls["jax"]) == 2   # vid0 was done
    assert_summary_equal(psum, jsum)
    rows = read_csv(tmp_path / "port" / "results.csv")
    assert [r["name"] for r in rows] == ["vid0", "__average__", "vid1", "vid2", "__average__"]
    assert_rows_equal(rows, read_csv(tmp_path / "jax" / "results.csv"))
    v = [float(r["psnr"]) for r in rows[:4]]
    np.testing.assert_allclose(psum["psnr"], (2 * v[0] + v[2] + v[3]) / 4, rtol=1e-12)
    assert abs(psum["psnr"] - (v[0] + v[2] + v[3]) / 3) > 1e-6


def test_harness_caption_hook_matches_jax(tmp_path):
    """Samples without a caption go through caption_fn (the CogVLM2 hook)
    once, with the trimmed-to-nothing uint8 video and masks, and the caption
    reaches the CLIP-score path, on both sides alike."""
    data = dataset(n=1, t=9, caption="")
    seen = {"jax": [], "port": []}

    def runner(side):
        def captioner(video_u8, masks_u8):
            seen[side].append((video_u8.shape, masks_u8.shape, video_u8.dtype))
            return "a synthetic caption"

        scored = []

        def score(image, text):
            scored.append(text)
            return 0.5

        return captioner, score, scored

    jcap, jscore, jscored = runner("jax")
    pcap, pscore, pscored = runner("port")
    jenc, penc = embeds()
    calls = {"jax": [], "port": []}
    jpipe, ppipe = make_pipes(calls)
    cfg = dict(num_inference_steps=2, num_frames=9, replace_gt=True, mask_add=True)
    jsum = jh.run_inpainting_eval(jpipe, None, data,
                                  jh.EvalConfig(output_dir=str(tmp_path / "j"), **cfg),
                                  metrics=jm.MetricsCalculator(text_image_score_fn=jscore),
                                  encode_prompt_fn=jenc, caption_fn=jcap)
    psum = ph.run_inpainting_eval(ppipe, data,
                                  ph.EvalConfig(output_dir=str(tmp_path / "p"), **cfg),
                                  metrics=pm.MetricsCalculator(text_image_score_fn=pscore),
                                  encode_prompt_fn=penc, caption_fn=pcap, device="cpu")
    assert seen["port"] == seen["jax"] == [((9, 24, 40, 3), (9, 24, 40), np.uint8)]
    assert pscored == jscored and set(pscored) == {"a synthetic caption"}
    assert psum["clip_score"] == jsum["clip_score"] == 0.5


# -- the eval CLI and its sweep ---------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_cli"))
    make_ckpts(root)
    make_davis(root)
    np.save(os.path.join(root, "embeds.npy"),
            np.random.RandomState(0).rand(1, 5, 12).astype(np.float32))
    return root


def cli_args(root, out, *extra):
    return ["--model_path", os.path.join(root, "model"),
            "--inpainting_branch", os.path.join(root, "branch"),
            "--save_addr", os.path.join(root, out),
            "--height", "64", "--width", "96", "--num_frames", "9",
            "--num_inference_steps", "1", "--mask_add", "--dtype", "float32",
            "--prompt_embeds_file", os.path.join(root, "embeds.npy"), "--device", "cpu",
            *extra]


def test_eval_cli_end_to_end(tree, tmp_path):
    """`main(argv)` on a DAVIS tree: the JAX harness's columns, finite
    values; a second run resumes (no pipeline call) to the same averages; the
    rows equal a direct harness call on the CLI's own pipeline and reader."""
    from videopainter_tpu_torch.evaluate import cli
    from videopainter_tpu_torch.evaluate.datasets import DavisTestDataset
    from videopainter_tpu_torch.infer.inpaint import build_pipeline

    argv = cli_args(tree, "eval_out", "--dataset", "davis", "--video_root",
                    os.path.join(tree, "davis"), "--dilate_size", "2", "--replace_gt")
    avg = cli.main(argv)
    rows = read_csv(os.path.join(tree, "eval_out", "results.csv"))
    # the columns the JAX harness writes when no extractor is given
    jsum, _, _ = run_both(tmp_path, dataset(n=1, t=9), dict(num_frames=9), metrics=False)
    want_cols = list(read_csv(tmp_path / "jax" / "results.csv")[0])
    assert list(rows[0]) == want_cols and list(avg) == list(jsum)
    assert [r["name"] for r in rows] == ["bear", "__average__"]
    assert all(np.isfinite(float(v)) for k, v in rows[0].items() if k != "name")

    pipeline = build_pipeline(os.path.join(tree, "model"), os.path.join(tree, "branch"),
                              dtype_str="float32", device="cpu")
    called = []
    original = type(pipeline).__call__

    def counting(self, **kw):
        called.append(1)
        return original(self, **kw)

    type(pipeline).__call__ = counting
    try:
        assert cli.main(argv) == avg   # resumed: nothing recomputed
        assert called == []
    finally:
        type(pipeline).__call__ = original

    emb = torch.from_numpy(np.load(os.path.join(tree, "embeds.npy")))
    direct = ph.run_inpainting_eval(
        lambda **kw: pipeline(dtype=torch.float32, **kw),
        DavisTestDataset(root=os.path.join(tree, "davis"), height=64, width=96,
                         dilate_iterations=2),
        ph.EvalConfig(output_dir=str(tmp_path / "direct"), num_inference_steps=1,
                      num_frames=9, replace_gt=True, mask_add=True),
        encode_prompt_fn=lambda c: (emb, torch.zeros_like(emb)), device="cpu")
    assert_summary_equal(direct, avg)
    assert_rows_equal(read_csv(tmp_path / "direct" / "results.csv"), rows)


def test_eval_sweep_layout(tree):
    """The sweep over davis (standard skipped: no meta) x dilate 2 x
    replace_gt {true, false}: one results.csv per cell and a summary row per
    cell, forwarded `--device cpu`."""
    from videopainter_tpu_torch.evaluate import sweep

    argv = cli_args(tree, "sweep_out", "--configs", "davis", "standard",
                    "--davis_root", os.path.join(tree, "davis"), "--dilate_sizes", "2",
                    "--replace_gt_values", "true", "false")
    rows = sweep.main(argv)
    assert len(rows) == 2
    for rg in (0, 1):
        assert os.path.exists(os.path.join(tree, "sweep_out", "davis", f"dilate2_rg{rg}",
                                           "results.csv"))
    recs = read_csv(os.path.join(tree, "sweep_out", "sweep_summary.csv"))
    assert [r["replace_gt"] for r in recs] == ["1", "0"]
    assert list(recs[0])[:4] == ["config", "dilate_size", "out_dir", "replace_gt"]
    assert all(np.isfinite(float(r["psnr"])) for r in recs)
    argv_jax = sweep._combo_args(sweep.get_args(argv), "davis", 2, True, "x")
    assert argv_jax[argv_jax.index("--device") + 1] == "cpu"
