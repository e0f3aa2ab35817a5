"""Interactive inpainting app: segment -> track -> inpaint.

Counterpart of `videopainter_tpu/app/app.py` (reference app/app.py, a 1402-line
gradio UI, and app/utils.py generate_frames :86-160). The flow:
  upload a video -> the first 49 frames at 480x720 -> SAM2 init_state ->
  clicks per object (positive, and negative refinement; add_new_points
  accumulates) -> mask overlay -> propagate_in_video per object, masks
  dilated by 6 -> tracking gallery -> inpaint: masks dilated by 16, the union
  of the objects, [a first-frame hook], the any-length pipeline with
  replace_gt and mask_add, per-step progress.

Each object has its own SAM2 memory state (the reference batches objects in
one state; SAM2 objects never interact, so this is equivalent), and all
share one frame-feature cache, so the image encoder runs once per frame in
all. The session is headless (`AppSession`), so tests and scripts drive it;
`build_ui` wraps it in gradio when gradio is importable (the module is
injectable, as in the JAX package).

    python -m videopainter_tpu_torch.app.app --model_path <cogvideox> \\
        --inpainting_branch <branch> --sam2_checkpoint sam2.pt [--device cpu]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# per-object overlay colours (RGB), cycled
OBJ_COLORS = [(255, 0, 0), (0, 255, 0), (0, 128, 255), (255, 255, 0), (255, 0, 255),
              (0, 255, 255)]


def dilate_mask(mask: np.ndarray, iterations: int) -> np.ndarray:
    import cv2

    if iterations <= 0:
        return mask
    return cv2.dilate(mask.astype(np.uint8), np.ones((3, 3), np.uint8), iterations=iterations)


@dataclass
class AppSession:
    """One user's interactive state (several objects)."""

    predictor: object                      # segmentation.SAM2VideoPredictor
    pipe: object                           # the any-length pipeline (or a partial of it)
    encode_prompt_fn: Callable             # prompt -> (embeds, negative embeds)
    fps: int = 8
    max_frames: int = 49
    height: int = 480
    width: int = 720
    track_dilate: int = 6
    inpaint_dilate: int = 16
    device: Optional[str] = None           # the pipeline's inputs; CUDA unless given
    frames: Optional[np.ndarray] = None    # [T, H, W, 3] uint8
    states: Dict[int, object] = field(default_factory=dict)       # obj_id -> SAM2State
    obj_masks: Dict[int, np.ndarray] = field(default_factory=dict)  # [T, H, W] uint8
    masks: Optional[np.ndarray] = None     # union [T, H, W] uint8
    result: Optional[np.ndarray] = None    # [T, H, W, 3] uint8
    first_frame_inpaint_fn: Optional[Callable] = None
    _shared_features: dict = field(default_factory=dict)

    def use_self_first_frame_inpaint(self, **kw) -> None:
        """Pre-inpaint frame 0 with the port's own image-mode (T=1) pipeline,
        the offline stand-in for the reference's FluxFill step; `kw` goes to
        `infer.first_frame.make_self_first_frame_inpaint`."""
        from ..infer.first_frame import make_self_first_frame_inpaint

        self.first_frame_inpaint_fn = make_self_first_frame_inpaint(
            self.pipe, encode_prompt_fn=self.encode_prompt_fn, **kw)

    # -- step 1: load the video (reference app.py:354-401) ---------------------------
    def load_video(self, path_or_array) -> np.ndarray:
        from ..training.data import read_video_frames, resize_video

        video = (path_or_array if isinstance(path_or_array, np.ndarray)
                 else read_video_frames(path_or_array))
        video = video[: self.max_frames]
        t = ((len(video) - 1) // 4) * 4 + 1
        self.frames = resize_video(video[:t], self.height, self.width)
        self.states, self.obj_masks, self._shared_features = {}, {}, {}
        self.masks = self.result = None
        return self.frames

    def _state_for(self, obj_id: int):
        """One SAM2 memory state per object, all sharing the resized frames
        and their features (the frames are resized and moved once)."""
        if obj_id not in self.states:
            if self.states:
                first = next(iter(self.states.values()))
                st = type(first)(images=first.images)
            else:
                st = self.predictor.init_state(self.frames)
            st.features = self._shared_features
            self.states[obj_id] = st
        return self.states[obj_id]

    @property
    def object_ids(self) -> List[int]:
        return sorted(self.states)

    def reset_object(self, obj_id: int) -> None:
        """Drop an object's clicks and memory (the reference's reset button)."""
        self.states.pop(obj_id, None)
        self.obj_masks.pop(obj_id, None)

    def _to_display(self, logits: np.ndarray) -> np.ndarray:
        import cv2

        return cv2.resize((logits > 0).astype(np.uint8), (self.width, self.height),
                          interpolation=cv2.INTER_NEAREST)

    # -- step 2: click refinement (reference app.py:433-479) ------------------------------
    def click(self, frame_idx: int, x: float, y: float, positive: bool = True,
              obj_id: int = 0) -> np.ndarray:
        """A click in display coordinates; clicks accumulate per (object,
        frame), positive or negative. Returns the refined mask of that frame."""
        s = self.predictor.cfg.image_size
        px = np.array([[x * s / self.width, y * s / self.height]], np.float32)
        lbl = np.array([1 if positive else 0], np.int32)
        logits = self.predictor.add_new_points(self._state_for(obj_id), frame_idx, px, lbl)
        return self._to_display(logits)

    def overlay(self, frame_idx: int, mask: Optional[np.ndarray] = None,
                obj_id: Optional[int] = None) -> np.ndarray:
        """A frame with one mask (in its object's colour) or, with no mask,
        every tracked object blended on it."""
        f = self.frames[frame_idx].copy()
        if mask is not None:
            color = OBJ_COLORS[(obj_id or 0) % len(OBJ_COLORS)]
            f[mask > 0] = (0.5 * f[mask > 0] + 0.5 * np.array(color)).astype(np.uint8)
            return f
        for oid, masks in self.obj_masks.items():
            m = masks[frame_idx] > 0
            f[m] = (0.5 * f[m] + 0.5 * np.array(OBJ_COLORS[oid % len(OBJ_COLORS)])
                    ).astype(np.uint8)
        return f

    # -- step 3: tracking (reference app.py:490-527) ----------------------------------------
    def track(self) -> np.ndarray:
        """Propagate every object through the video; `masks` is their union."""
        if not self.states:
            raise RuntimeError("add at least one click first")
        union = np.zeros((len(self.frames), self.height, self.width), np.uint8)
        for oid, state in self.states.items():
            masks = np.zeros_like(union)
            for idx, logits in self.predictor.propagate_in_video(state):
                masks[idx] = dilate_mask(self._to_display(logits), self.track_dilate)
            self.obj_masks[oid] = masks
            union |= masks
        self.masks = union
        return union

    def tracking_gallery(self, stride: int = 8) -> List[np.ndarray]:
        """Every stride-th frame with all the objects' overlays."""
        if self.masks is None:
            raise RuntimeError("run track() first")
        return [self.overlay(i) for i in range(0, len(self.frames), stride)]

    # -- step 4: inpaint (reference app.py:544-587 + utils.py:86-160) ------------------------
    def inpaint(self, prompt: str, num_inference_steps: int = 50, guidance_scale: float = 6.0,
                seed: int = 42, progress_fn: Optional[Callable] = None) -> np.ndarray:
        from .. import resolve_device

        if self.masks is None:
            raise RuntimeError("run track() first")
        dev = resolve_device(self.device)
        masks = np.stack([dilate_mask(m, self.inpaint_dilate)
                          for m in self.masks]).astype(np.float32)
        masks[0] = 0.0   # frame 0 unmasked (utils.py:118-121)
        video01 = self.frames.astype(np.float32) / 255.0
        first = video01[0]
        if self.first_frame_inpaint_fn is not None:
            first = self.first_frame_inpaint_fn(first, self.masks[0], prompt)
        embeds, neg = self.encode_prompt_fn(prompt)
        out = self.pipe(
            image=torch.from_numpy(np.ascontiguousarray(first, np.float32)).to(dev)[None] * 2 - 1,
            video=torch.from_numpy(video01).to(dev)[None] * 2 - 1,
            masks=torch.from_numpy(masks).to(dev)[None],
            num_frames=len(video01), prompt_embeds=embeds, negative_prompt_embeds=neg,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            use_dynamic_cfg=True, replace_gt=True, mask_add=True, progress_fn=progress_fn,
            generator=torch.Generator(device=dev).manual_seed(seed))
        self.result = ((np.asarray(out)[0] / 2 + 0.5).clip(0, 1) * 255).astype(np.uint8)
        return self.result

    def side_by_side(self) -> np.ndarray:
        """[original | masked | result] per frame (the reference's export)."""
        if self.result is None:
            raise RuntimeError("run inpaint() first")
        t = len(self.result)
        orig = self.frames[:t]
        masked = (orig * (self.masks[:t] == 0)[..., None]).astype(np.uint8)
        return np.concatenate([orig, masked, self.result], axis=2)


def export_mp4(frames: np.ndarray, fps: int) -> str:
    import tempfile

    import cv2

    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as tmp:
        path = tmp.name
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
    return path


def build_ui(session: AppSession, gr=None):
    """The gradio Blocks UI around an AppSession (the reference's event graph,
    app/app.py:1002-1402): upload, object dropdown with add / reset, positive
    and negative clicks on a frame slider, tracking gallery, inpaint controls
    with per-step progress, the result and the side-by-side export. `gr` is
    injectable (tests drive the event graph through a stand-in module)."""
    if gr is None:
        try:
            import gradio as gr
        except ImportError as e:
            raise ImportError("gradio is not installed; drive AppSession headlessly or "
                              "install gradio to serve the UI") from e

    with gr.Blocks(title="VideoPainter") as demo:
        with gr.Row():
            video_in = gr.Video(label="Input video")
            frame_view = gr.Image(label="Click to segment")
        with gr.Row():
            frame_slider = gr.Slider(0, session.max_frames - 1, step=1, value=0, label="Frame")
            click_type = gr.Radio(["positive", "negative"], value="positive", label="Click type")
            obj_dropdown = gr.Dropdown(choices=["0"], value="0", label="Object")
            add_obj_btn = gr.Button("Add object")
            reset_obj_btn = gr.Button("Reset object")
        with gr.Row():
            track_btn = gr.Button("Track")
            gallery = gr.Gallery(label="Tracking result")
        with gr.Row():
            prompt = gr.Textbox(label="Prompt")
            steps = gr.Slider(1, 100, value=50, step=1, label="Steps")
            guidance = gr.Slider(1.0, 12.0, value=6.0, label="Guidance")
            seed = gr.Number(value=42, label="Seed")
        inpaint_btn = gr.Button("Inpaint")
        with gr.Row():
            video_out = gr.Video(label="Result")
            video_sbs = gr.Video(label="Original | Masked | Result")

        def on_upload(path):
            return session.load_video(path)[0]

        def on_slide(frame_idx):
            return None if session.frames is None else session.overlay(int(frame_idx))

        def on_click(frame_idx, ctype, obj_id, evt: "gr.SelectData"):
            x, y = evt.index
            mask = session.click(int(frame_idx), x, y, positive=ctype == "positive",
                                 obj_id=int(obj_id))
            return session.overlay(int(frame_idx), mask, obj_id=int(obj_id))

        def on_add_object(obj_id):
            new_id = max(session.object_ids, default=int(obj_id)) + 1
            session._state_for(new_id)
            return gr.update(choices=[str(i) for i in session.object_ids], value=str(new_id))

        def on_reset_object(obj_id):
            session.reset_object(int(obj_id))
            return None if session.frames is None else session.frames[0]

        def on_track():
            session.track()
            return session.tracking_gallery()

        def on_inpaint(p, n_steps, g, s, progress=None):
            if progress is None:
                progress = getattr(gr, "Progress", lambda: None)()

            def on_step(done, total):
                if progress is not None:
                    progress(done / total, desc=f"denoise step {done}/{total}")

            out = session.inpaint(p, num_inference_steps=int(n_steps), guidance_scale=float(g),
                                  seed=int(s), progress_fn=on_step)
            return export_mp4(out, session.fps), export_mp4(session.side_by_side(), session.fps)

        video_in.upload(on_upload, video_in, frame_view)
        frame_slider.change(on_slide, frame_slider, frame_view)
        frame_view.select(on_click, [frame_slider, click_type, obj_dropdown], frame_view)
        add_obj_btn.click(on_add_object, obj_dropdown, obj_dropdown)
        reset_obj_btn.click(on_reset_object, obj_dropdown, frame_view)
        track_btn.click(on_track, None, gallery)
        inpaint_btn.click(on_inpaint, [prompt, steps, guidance, seed], [video_out, video_sbs])
    return demo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--inpainting_branch", required=True)
    ap.add_argument("--id_adapter", default=None)
    ap.add_argument("--sam2_checkpoint", default=None)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; no silent fallback to the CPU")
    args = ap.parse_args(argv)
    if not args.sam2_checkpoint:
        raise SystemExit("--sam2_checkpoint required for the interactive app")

    from .. import resolve_device
    from ..infer.inpaint import build_pipeline
    from ..segmentation import SAM2Config, SAM2VideoPredictor
    from ..segmentation.convert import load_sam2_checkpoint

    dev = resolve_device(args.device)
    pipe = build_pipeline(args.model_path, args.inpainting_branch, args.id_adapter, device=dev)
    # SAM2Config() as the JAX app has it (its defaults match no published
    # checkpoint's widths; load_state_dict says so)
    predictor = SAM2VideoPredictor(SAM2Config()).to(dev)
    predictor.load_state_dict(load_sam2_checkpoint(args.sam2_checkpoint))
    predictor.eval()

    def encode(prompt):
        return pipe.text_encoder.encode(prompt), pipe.text_encoder.encode("")

    session = AppSession(predictor=predictor, pipe=pipe, encode_prompt_fn=encode,
                         device=str(dev))
    build_ui(session).launch(server_port=args.port)


if __name__ == "__main__":
    main()
