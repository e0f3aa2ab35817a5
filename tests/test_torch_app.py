"""The port's interactive demo (videopainter_tpu_torch.app), dataset download
and `utils.compact_params`, on the CPU.

 - `AppSession` against the JAX package's on tiny models with the same
   weights (SAM2 from a seeded JAX tree through `sam2_state_dict`, the
   any-length pipeline through the DiT / branch / VAE converters) and the
   same injected noise: the click masks, the tracked masks of two objects
   (one refined by a negative click) and the inpainted frames;
 - the image encoder runs once per frame for all objects (shared cache);
 - `build_ui` driven through a stand-in gradio module (a copy of
   tests/test_app_ui.py's shim);
 - `download_videos` on file:// URLs (nothing is fetched from a network),
   `unzip_folder`;
 - `compact_params` keeps every value bit for bit.
"""

import functools
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videopainter_tpu.config as jcfg
import videopainter_tpu_torch.config as tcfg
from videopainter_tpu.app.app import AppSession as JSession
from videopainter_tpu.models import (AutoencoderKLCogVideoX as JVAE,
                                     CogVideoXBranch as JBranch,
                                     CogVideoXTransformer3D as JDiT)
from videopainter_tpu.pipelines import CogVideoXI2VDualInpaintAnyLPipeline as JAnyL
from videopainter_tpu.schedulers import CogVideoXDPMScheduler as JDPM
from videopainter_tpu.segmentation import SAM2VideoPredictor as JPredictor
from videopainter_tpu_torch.app.app import AppSession, build_ui, dilate_mask
from videopainter_tpu_torch.convert import (branch_state_dict, sam2_state_dict,
                                            transformer_state_dict, vae_state_dict)
from videopainter_tpu_torch.data_utils.download import download_videos, unzip_folder
from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                           CogVideoXTransformer3D)
from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintAnyLPipeline
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler
from videopainter_tpu_torch.utils import compact_params

cv2 = pytest.importorskip("cv2")

DIT_KW = dict(in_channels=32, out_channels=16, sample_height=8, sample_width=12)
STEPS = 2
H, W, FRAMES = 64, 96, 9


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def random_params(init, seed):
    """Random numpy weights in the tree structure `init` builds: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2)."""
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
def models():
    """(JAX predictor, port predictor, JAX pipe, its params, port pipe, the
    injected noise and prompt embeddings), all on the same numbers."""
    from test_torch_sam2 import port_predictor, tiny_tree

    jc, tc, sam = tiny_tree()
    jpred = JPredictor(jc, sam)
    tpred = port_predictor(tc, {k: v.numpy() for k, v in sam2_state_dict(sam).items()})

    jb = jcfg.BranchConfig.from_transformer(jcfg.TransformerConfig.tiny(**DIT_KW), num_layers=2)
    tb = tcfg.BranchConfig.from_transformer(tcfg.TransformerConfig.tiny(**DIT_KW), num_layers=2)
    jv, tv = jcfg.VAEConfig.tiny(latent_channels=16), tcfg.VAEConfig.tiny(latent_channels=16)
    params = {"transformer": random_params(JDiT(jcfg.TransformerConfig.tiny(**DIT_KW)).init, 21),
              "branch": random_params(JBranch(jb).init, 22),
              "vae": random_params(JVAE(jv).init, 23)}
    jpipe = JAnyL(JDiT(jcfg.TransformerConfig.tiny(**DIT_KW)), JBranch(jb), JVAE(jv),
                  JDPM(jcfg.SchedulerConfig.cogvideox_5b_inference()))
    mods = (CogVideoXTransformer3D(tcfg.TransformerConfig.tiny(**DIT_KW)), CogVideoXBranch(tb),
            AutoencoderKLCogVideoX(tv))
    for mod, sd in zip(mods, (transformer_state_dict(params["transformer"]),
                              branch_state_dict(params["branch"]),
                              vae_state_dict(params["vae"]))):
        mod.load_state_dict(sd)
    tpipe = CogVideoXI2VDualInpaintAnyLPipeline(
        *mods, CogVideoXDPMScheduler(tcfg.SchedulerConfig.cogvideox_5b_inference()),
        device="cpu")
    rng = np.random.default_rng(24)
    noise = {"init": rng.standard_normal((1, 3, 8, 12, 16)).astype(np.float32),
             "dpm": rng.standard_normal((STEPS, 1, 3, 8, 12, 16)).astype(np.float32),
             "embeds": rng.standard_normal((1, 5, 12)).astype(np.float32)}
    return jpred, tpred, jpipe, params, tpipe, noise


def port_session(models, **kw):
    _, tpred, _, _, tpipe, noise = models
    emb = T(noise["embeds"])
    pipe = functools.partial(tpipe, init_noises=[T(noise["init"])],
                             dpm_noises_list=[T(noise["dpm"])], vae_sample_mode="mode")
    return AppSession(predictor=tpred, pipe=pipe, device="cpu", height=H, width=W,
                      max_frames=FRAMES, encode_prompt_fn=lambda p: (emb, torch.zeros_like(emb)),
                      **kw)


def video_clip():
    return (np.random.RandomState(1).rand(12, 50, 70, 3) * 255).astype(np.uint8)


CLICKS = [(0, 48.0, 32.0, True, 0), (0, 10.0, 10.0, False, 0), (2, 70.0, 40.0, True, 1)]


def test_session_matches_jax(models):
    """Clicks, tracking of two objects and the inpainted frames against the
    JAX session. The SAM2 logits agree to 1e-5 (test_torch_sam2.py), so the
    masks thresholded at 0 are equal; the frames are the pipelines' outputs
    (1e-4 apart on [-1, 1]) rounded to uint8, so a value may round one
    step apart."""
    jpred, _, jpipe, params, _, noise = models
    emb = jnp.asarray(noise["embeds"])

    def jax_pipe(p, **kw):
        return jpipe(p, **kw, init_noises=[jnp.asarray(noise["init"])],
                     dpm_noises_list=[jnp.asarray(noise["dpm"])], vae_sample_mode="mode",
                     scan_chunk=0)

    js = JSession(predictor=jpred, pipe=jax_pipe, pipe_params=params, height=H, width=W,
                  max_frames=FRAMES, encode_prompt_fn=lambda p: (emb, jnp.zeros_like(emb)))
    ts = port_session(models)
    video = video_clip()
    np.testing.assert_array_equal(ts.load_video(video), js.load_video(video))
    for frame, x, y, positive, obj in CLICKS:
        got = ts.click(frame, x, y, positive=positive, obj_id=obj)
        assert got.shape == (H, W) and got.any()
        np.testing.assert_array_equal(got, js.click(frame, x, y, positive=positive, obj_id=obj))
    assert len(ts.states[0].points[0][0]) == 2 and ts.object_ids == [0, 1]
    np.testing.assert_array_equal(ts.track(), js.track())
    for oid in (0, 1):
        np.testing.assert_array_equal(ts.obj_masks[oid], js.obj_masks[oid])
    assert [g.shape for g in ts.tracking_gallery()] == [(H, W, 3)] * 2
    out = ts.inpaint("a cat", num_inference_steps=STEPS)
    ref = js.inpaint("a cat", num_inference_steps=STEPS)
    assert out.shape == (FRAMES, H, W, 3) and out.dtype == np.uint8
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    assert ts.side_by_side().shape == (FRAMES, H, 3 * W, 3)


def test_encoder_runs_once_per_frame_for_all_objects(models):
    ts = port_session(models)
    runs = []
    hook = ts.predictor.image_encoder.register_forward_hook(lambda *a: runs.append(1))
    try:
        ts.load_video(video_clip())
        for frame, x, y, positive, obj in CLICKS:
            ts.click(frame, x, y, positive=positive, obj_id=obj)
        ts.track()
    finally:
        hook.remove()
    assert len(runs) == FRAMES
    ts.reset_object(1)
    assert ts.object_ids == [0] and 1 not in ts.obj_masks
    with pytest.raises(RuntimeError):
        port_session(models).inpaint("x")


def test_objects_share_the_resized_frames(models):
    """The frames are resized and moved once per video: every object's state
    holds the same image tensor and feature cache, each its own memory."""
    ts = port_session(models)
    calls = []
    init_state = ts.predictor.init_state
    ts.predictor.init_state = lambda video: calls.append(1) or init_state(video)
    try:
        ts.load_video(video_clip())
        for frame, x, y, positive, obj in CLICKS:
            ts.click(frame, x, y, positive=positive, obj_id=obj)
        ts.click(1, 30.0, 20.0, obj_id=2)
    finally:
        del ts.predictor.init_state
    assert len(calls) == 1 and ts.object_ids == [0, 1, 2]
    first = ts.states[0]
    for oid in (1, 2):
        st = ts.states[oid]
        assert st.images is first.images and st.features is first.features
        assert st.points is not first.points and st.cond_outputs is not first.cond_outputs
    assert sorted(ts.states[2].points) == [1] and sorted(first.points) == [0]


def test_self_first_frame_hook(models):
    """`use_self_first_frame_inpaint` puts the port's own T=1 inpaint on the
    session's pipeline as its first-frame hook: only the hole changes."""
    ts = port_session(models)
    ts.pipe = models[4]
    ts.use_self_first_frame_inpaint(num_inference_steps=1)
    frame = np.random.default_rng(3).random((H, W, 3)).astype(np.float32)
    hole = np.zeros((H, W), np.uint8)
    hole[16:40, 24:60] = 1
    out = ts.first_frame_inpaint_fn(frame, hole, "a cat")
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    np.testing.assert_array_equal(out[hole == 0], frame[hole == 0])
    assert not np.allclose(out[hole == 1], frame[hole == 1])


def test_dilate_mask():
    m = np.zeros((9, 9), np.uint8)
    m[4, 4] = 1
    assert dilate_mask(m, 0) is m
    assert dilate_mask(m, 2).sum() == 25


def test_inpaint_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ts = port_session(models)
    ts.device = None
    ts.load_video(video_clip())
    ts.click(0, 48.0, 32.0)
    ts.track()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.inpaint("x", num_inference_steps=STEPS)


# -- the gradio event graph, through a stand-in module (tests/test_app_ui.py's) ------------

class _Component:
    def __init__(self, registry, *a, **kw):
        self.kw = kw
        self.label = kw.get("label") or (a[0] if a and isinstance(a[0], str) else None)
        self.events = {}
        registry.append(self)

    def _wire(self, name, fn, inputs, outputs):
        as_list = lambda x: x if isinstance(x, list) else ([] if x is None else [x])  # noqa: E731
        self.events.setdefault(name, []).append((fn, as_list(inputs), as_list(outputs)))

    def upload(self, fn, inputs=None, outputs=None):
        self._wire("upload", fn, inputs, outputs)

    def change(self, fn, inputs=None, outputs=None):
        self._wire("change", fn, inputs, outputs)

    def select(self, fn, inputs=None, outputs=None):
        self._wire("select", fn, inputs, outputs)

    def click(self, fn, inputs=None, outputs=None):
        self._wire("click", fn, inputs, outputs)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _SelectData:
    def __init__(self, index):
        self.index = index


def make_fake_gradio(registry):
    gr = types.ModuleType("fake_gradio")
    for name in ["Video", "Image", "Slider", "Radio", "Dropdown", "Button", "Textbox",
                 "Gallery", "Number", "State", "Blocks", "Row", "Column"]:
        setattr(gr, name, functools.partial(_Component, registry))
    gr.SelectData = _SelectData
    gr.update = lambda **kw: dict(kw)
    gr.Progress = lambda *a, **kw: None
    return gr


def test_ui_event_graph(models):
    registry = []
    session = port_session(models)
    build_ui(session, gr=make_fake_gradio(registry))
    comps = {c.label: c for c in registry if c.events}

    def handler(label, event):
        return comps[label].events[event][0][0]

    assert handler("Input video", "upload")(video_clip()).shape == (H, W, 3)
    on_click = handler("Click to segment", "select")
    assert on_click(0, "positive", "0", _SelectData((48, 32))).shape == (H, W, 3)
    on_click(0, "negative", "0", _SelectData((10, 10)))
    assert len(session.states[0].points[0][0]) == 2
    upd = handler("Add object", "click")("0")
    assert upd["value"] == "1" and "1" in upd["choices"]
    on_click(0, "positive", "1", _SelectData((70, 40)))
    assert handler("Frame", "change")(0).shape == (H, W, 3)
    gallery = handler("Track", "click")()
    assert gallery[0].shape == (H, W, 3) and sorted(session.obj_masks) == [0, 1]
    handler("Reset object", "click")("1")
    assert sorted(session.states) == [0]
    calls = []
    out_path, sbs_path = handler("Inpaint", "click")(
        "a cat", STEPS, 6.0, 42, progress=lambda frac, desc="": calls.append(frac))
    assert out_path.endswith(".mp4") and sbs_path.endswith(".mp4")
    assert calls and calls[-1] == 1.0
    cap = cv2.VideoCapture(sbs_path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == 3 * W
    cap.release()


# -- dataset download, compact_params ---------------------------------------------------------

def test_download_videos_and_unzip(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    payloads = {"a/clip0.mp4": b"\x00\x01" * 1000, "b/clip1.mp4": bytes(range(256)) * 7000}
    rows = ["url,path"]
    for i, (rel, data) in enumerate(payloads.items()):
        (src / f"f{i}").write_bytes(data)
        rows.append(f"{(src / f'f{i}').as_uri()},{rel}")
    meta = tmp_path / "meta.csv"
    meta.write_text("\n".join(rows) + "\n")
    out = tmp_path / "out"
    assert download_videos(str(meta), str(out)) == 2
    for rel, data in payloads.items():
        assert (out / rel).read_bytes() == data
    assert download_videos(str(meta), str(out)) == 0            # present: skipped
    (out / "a/clip0.mp4").write_bytes(b"stale")
    assert download_videos(str(meta), str(out), overwrite=True) == 2
    assert (out / "a/clip0.mp4").read_bytes() == payloads["a/clip0.mp4"]
    bad = tmp_path / "bad.csv"
    bad.write_text(f"url,path\n{(src / 'missing').as_uri()},c/x.mp4\n")
    with pytest.raises(OSError):
        download_videos(str(bad), str(out))
    assert not (out / "c/x.mp4").exists() and not (out / "c/x.mp4.part").exists()

    zips = tmp_path / "zips"
    zips.mkdir()
    with zipfile.ZipFile(zips / "set1.zip", "w") as z:
        z.writestr("v/0.txt", "zero")
    (zips / "notes.txt").write_text("not an archive")
    assert unzip_folder(str(zips), str(tmp_path / "unzipped")) == 1
    assert (tmp_path / "unzipped/set1/v/0.txt").read_text() == "zero"


def test_compact_params_bit_identical():
    """Mixed dtypes (float32, bf16, an int8 buffer), a parameter shared by
    two modules, a None buffer: values and outputs bit for bit, one storage
    per dtype, sharing kept."""
    torch.manual_seed(0)
    shared = torch.nn.Linear(6, 6)
    a = torch.nn.Sequential(torch.nn.Linear(4, 6), shared, torch.nn.LayerNorm(6))
    b = torch.nn.Sequential(shared, torch.nn.Linear(6, 3))
    c = torch.nn.Linear(6, 3).to(torch.bfloat16)
    a.register_buffer("q", torch.randint(-127, 127, (5, 7), dtype=torch.int8))
    a.register_buffer("none", None)
    mods = {"a": a, "b": b, "c": c}
    x = torch.randn(2, 4)

    def run():
        with torch.no_grad():
            h = a(x)
            return h, b(h), c(h.to(torch.bfloat16))

    def state():
        return {f"{m}.{k}": v for m, mod in mods.items() for k, v in mod.state_dict().items()}

    before = {k: v.clone() for k, v in state().items()}
    outs = run()
    tensors = {id(t): t for mod in mods.values() for t in [*mod.parameters(), *mod.buffers()]}
    moved = compact_params(a, b, c)
    after = state()
    assert before.keys() == after.keys()
    for k in before:
        assert after[k].dtype == before[k].dtype and torch.equal(after[k], before[k]), k
    assert all(torch.equal(u, v) for u, v in zip(run(), outs))
    assert a[1] is b[0] and a[1].weight is shared.weight
    storages = {}
    for t in [t for mod in mods.values() for t in [*mod.parameters(), *mod.buffers()]]:
        storages.setdefault(t.dtype, set()).add(t.untyped_storage().data_ptr())
    assert sorted(map(str, storages)) == ["torch.bfloat16", "torch.float32", "torch.int8"]
    assert all(len(s) == 1 for s in storages.values())
    assert moved == sum(t.numel() * t.element_size() for t in tensors.values())
