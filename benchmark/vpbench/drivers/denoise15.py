"""Driver of the served denoise loop on CogVideoX1.5-5B-I2V: VideoPainter's
dual-stream I2V inpainting of one clip (`CogVideoXI2VDualInpaintPipeline`)
with the 1.5 DiT (2 x 2 x 2 patches, the ofs embedding, RoPE on the integer
latent grid) and a 2-layer branch cloned from its trunk.

It is `denoise.py`'s single-clip path (reused by import: the seeded weights
and text path, the clip, the recording scheduler, the step clock, the
compared numbers) with what 1.5 changes: the clip's noise is drawn at the
padded latent length T0 + k (the pipeline pads T0 latent frames to a
multiple of `patch_size_t`), the rotary tables come from the program's
`prepare_rope` on the integer grid, the step's work is counted with 3-D
patches, and the plain reference is `reference/cogvideox15.py`.

A program whose `TransformerConfig` has no `patch_size_t` field cannot build
this model (its config would drop the key and build per-frame patches at
about twice the tokens): set-up stops at once with an error and no result.

Set-up ends with a soak: after the mix's warm-up steps (every shape), the
loop serves steps for `SOAK_S` seconds more, so that the window starts from
the power-capped card's steady state of serving clip after clip (a clip is
50 steps, about six minutes) rather than from whatever the card ran before
the process started.

Each step, the padded latent frames and the tokens that hold them
(`_kernels.PADDING`) are printed a step after the window, beside the launch
line. Traffic and configuration keys: as `denoise.py`'s single-clip path.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import torch

from ..counts import Gemm, Work, block_work
from ..loop import StepClock, pick_step
from . import denoise
from .denoise import build_models, compare, merged, program_dtype
from .denoise import metrics  # noqa: F401  (the cell's end-to-end numbers, as denoise's)


SOAK_S = 40.0   # seconds of served steps between the warm-up and the window


def require_3d_patches():
    """Stop where the program's TransformerConfig has no `patch_size_t`."""
    from videopainter_tpu_torch.config import TransformerConfig
    if "patch_size_t" not in {f.name for f in dataclasses.fields(TransformerConfig)}:
        raise SystemExit("this program's TransformerConfig has no patch_size_t: it cannot build "
                         "CogVideoX 1.5's spatio-temporal patches")


def pad_frames(cfg: dict, tr: dict) -> int:
    """k: the latent frames padded at the front so that T0 pairs up."""
    t0 = (tr["frames"] - 1) // cfg["vae"]["temporal_compression_ratio"] + 1
    return -t0 % cfg["transformer"]["patch_size_t"]


class Session(denoise.Session):
    """The 1.5 program built for one run, its inputs and the recorded steps."""

    def __init__(self, cell, seed: int, device, rehearse: bool):
        from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintPipeline
        from videopainter_tpu_torch.pipelines.common import DenoiseConfig, make_denoise_fn

        self.cell, self.seed, self.device = cell, seed, device
        cfg = merged(cell.config, cell.config.get("rehearsal") if rehearse else None)
        tr = merged(cell.traffic, cell.traffic.get("rehearsal") if rehearse else None)
        self.cfg, self.tr = cfg, tr
        srv = cfg["serving"]
        tcfg, _, vcfg, scfg = denoise._configs(cfg, False)
        dtype = program_dtype(cfg)
        transformer, branch, vae, self.shapes = build_models(cfg, seed, device, False)
        self.sched = denoise.recording_scheduler(scfg)
        self.pipe = CogVideoXI2VDualInpaintPipeline(transformer, branch, vae, self.sched,
                                                    device=device)
        self.k = pad_frames(cfg, tr)
        self.clip = c = make_clip(cfg, tr, seed, device, self.k)
        self.timesteps = self.sched.timesteps(tr["steps"])
        self.rope = self.rope_for(tr, vcfg, tcfg)
        embeds = torch.cat([c.negative, c.prompt]).to(dtype)
        inputs = self.pipe.prepare_inputs(
            video=c.video, image=c.image, masks=c.masks, strength=1.0,
            timesteps=self.timesteps, vae_sample_mode="mode", init_noise=c.noise0, dtype=dtype)
        self.inputs = inputs._replace(prompt_embeds=embeds, dpm_noises=c.sde.to(dtype))
        self.prev_state = self.image_w2 = None
        self.clock = StepClock(device)
        transformer.register_forward_hook(self.sched.keep_output)
        dcfg = DenoiseConfig(
            num_inference_steps=tr["steps"], do_cfg=True, use_dynamic_cfg=tr["dynamic_cfg"],
            guidance_scale=tr["guidance_scale"], conditioning_scale=1.0, replace_gt=True,
            mask_add=True, mask_background=False, add_first=False, use_flash=srv["use_flash"],
            mode="dual")
        self.denoise = make_denoise_fn(transformer, branch, self.sched, dcfg, self.timesteps,
                                       progress_fn=self.clock.tick)

    def rope_for(self, tr, vcfg, tcfg):
        from videopainter_tpu_torch.pipelines.common import prepare_rope
        t_lat = (tr["frames"] - 1) // vcfg.temporal_compression_ratio + 1 + self.k
        return prepare_rope(tcfg, tr["height"], tr["width"], t_lat,
                            vcfg.spatial_compression_ratio, device=self.device)

    def work(self) -> Work:
        t, b = self.cfg["transformer"], self.cfg["branch"]
        lat = self.clip.noise0.shape
        p, q = t["patch_size"], t["patch_size_t"]
        s_vid = (lat[1] // q) * (lat[2] // p) * (lat[3] // p)
        s_txt = t["max_text_seq_length"]
        s = s_txt + s_vid
        heads, hd = t["num_attention_heads"], t["attention_head_dim"]
        d = heads * hd
        w = block_work(s, d, heads, hd, batch=2, layers=t["num_layers"])
        w_branch = block_work(s, d, heads, hd, batch=2, layers=b["num_layers"])
        w.gemms += w_branch.gemms
        w.attns += w_branch.attns
        c_lat, te, cell = lat[4], t["time_embed_dim"], q * p * p
        n_all = t["num_layers"] + b["num_layers"]
        w.gemms += [Gemm(2 * s_txt, d, t["text_embed_dim"], count=2),          # text projections
                    Gemm(2 * s_vid, d, cell * 2 * c_lat),                      # DiT patch embed
                    Gemm(2 * s_vid, d, cell * (2 * c_lat + 1)),                # branch patch embed
                    Gemm(2 * s_vid, d, d, count=b["num_layers"]),              # branch projections
                    Gemm(2 * s_vid, cell * t["out_channels"], d),              # output head
                    Gemm(2, 6 * d, te, count=2 * n_all), Gemm(2, 2 * d, te)]   # modulation
        return w

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """Free the program, then hold one recorded step drawn from the seed
        against the reference run on the same inputs; with `control`, also
        the reference computed one precision lower in the program's place."""
        rec = pick_step(self.sched.log, self.seed)
        got = {"raw": rec.raw.float(), "pred": rec.pred.float(),
               "x_next": rec.next_sample.float()}
        x = rec.sample.float()
        old = None if rec.old_x0 is None else rec.old_x0.float()
        self.free_program()
        encodes: Dict[str, torch.Tensor] = {}
        args = (self.cfg, self.tr, self.shapes, self.seed, self.clip, rec.i, x, old, self.device)
        ref = reference(*args, encodes=encodes)
        out = compare(got, ref, x)
        if control is None:
            return out
        return {"step": rec.i, "program": out,
                "control": compare(reference(*args, control=control, encodes=encodes), ref, x)}


def make_clip(cfg: dict, tr: dict, seed: int, device, k: int):
    """`denoise.make_clip`'s inputs, the latent noises drawn at T0 + k frames
    (4 k more pixel frames give k more latent frames)."""
    return denoise.make_clip(cfg, dict(tr, window_frames=tr["frames"] + 4 * k), seed, device)


def reference(cfg, tr, shapes, seed, clip, i, x, old, device, control: Optional[str] = None,
              encodes: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The plain reference's step i from latents x (and the previous x0):
    the DiT's output over the CFG batch, the guided prediction and the
    blended next latents. Weights are drawn again from the seed; the VAE
    latents are encoded again from the clip (`encodes`, when given, keeps
    them for a second call). `control` ("fp8") computes the DiT's and the
    branch's matrix products in fp8 and holds their activations and the
    loop's latents in fp8 (`quant.Control`)."""
    import reference.cogvideox15 as ref
    from reference.dpm import DPMStep, cfg_scale
    from reference.quant import Control
    from reference.vae_encoder import Encoder

    ctl = None if control is None else Control(control)
    encodes = {} if encodes is None else encodes
    sd = denoise.reference_weights(cfg, shapes, seed, device)
    text = torch.cat([clip.negative, clip.prompt]).float()
    tcfg = cfg["transformer"]
    bcfg = dict(tcfg, num_layers=cfg["branch"]["num_layers"])
    t0 = time.perf_counter()
    with torch.no_grad():
        enc = Encoder(sd["vae"], cfg["vae"], device=device)
        masked, clean, mask_lat, image_lat = ref.i2v_latents(
            enc, clip.video, clip.masks, clip.image, tcfg["patch_size_t"],
            cfg["vae"]["scaling_factor"], encodes)
        del enc
        t1 = time.perf_counter()
        st = DPMStep(cfg["scheduler"], tr["steps"], i)
        t = torch.full((2,), st.t, device=device)
        x2 = torch.cat([x, x])
        cond = torch.cat([masked, mask_lat[..., None]], dim=-1)
        feats = ref.branch_features(sd["branch"], bcfg, x2, torch.cat([cond, cond]), text, t,
                                    device=device, control=ctl)
        raw = ref.dit_forward(sd["transformer"], tcfg,
                              torch.cat([x2, torch.cat([image_lat, image_lat])], dim=-1), text,
                              t, device=device, feats=feats,
                              mask_lat=torch.cat([mask_lat, mask_lat]), control=ctl)
        del feats
        u, c = raw.chunk(2)
        pred = u + cfg_scale(st.t, tr["steps"], tr["guidance_scale"], tr["dynamic_cfg"]) * (c - u)
        x_next, _ = st(x, pred, old, clip.sde[i])
        x_next = st.blend(x_next, clean, clip.noise0, mask_lat)
    print(f"note reference_s {time.perf_counter() - t0:.1f} (encodes done at {t1 - t0:.1f})",
          file=sys.stderr)
    return {"raw": raw, "pred": pred, "x_next": x_next if ctl is None else ctl.act(x_next)}


def setup(cell, seed: int, device, rehearse: bool = False) -> Session:
    require_3d_patches()
    s = Session(cell, seed, device, rehearse)
    s.run_steps(steps=s.tr["warmup_steps"])   # the cell's own shapes, both DPM orders
    if not rehearse:
        s.run_steps(seconds=SOAK_S)           # the card's steady serving state
    return s


def window(session: Session, *, seconds: Optional[float] = None, steps: Optional[int] = None):
    """The measured steps, recorded for the check; then the padding a step."""
    from videopainter_tpu_torch import _kernels
    before = dict(_kernels.PADDING)
    clock = denoise.window(session, seconds=seconds, steps=steps)
    print("padded a step: " + json.dumps({k: (v - before[k]) / clock.steps
                                          for k, v in _kernels.PADDING.items()}), file=sys.stderr)
    return clock
