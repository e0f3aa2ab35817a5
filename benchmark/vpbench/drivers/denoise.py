"""Driver of the served denoise loop: VideoPainter's dual-stream I2V
inpainting, one clip (`CogVideoXI2VDualInpaintPipeline`) or, when the mix
gives a `stride`, the any-length path (`CogVideoXI2VDualInpaintAnyLPipeline`'s
windows, ID resample across them).

Set-up builds the program from the seeded weights (with the configuration's
ID adapter merged and its W8A8 quantization applied by the program's own
functions), runs the pipeline's VAE prep (`prepare_inputs`) on the seeded
clip, and warms the loop up. On the any-length path it first runs window 1
through the last step of its schedule only (strength 1 / steps), which is the
step that captures its per-layer states, and prepares window 2 on window 1's
latents, as the pipeline's window loop does. The window runs
`make_denoise_fn`'s loop of the last window over the mix's DPM schedule,
cycled from the same inputs, until the window's time is up; every step ends
with a device synchronise and a host clock reading. The scheduler the loop
is given records each step's input latents, guided prediction and multistep
state, so that one step drawn from the seed can be held against the plain
reference once the window has closed.

Traffic keys: frames, height, width, steps, guidance_scale, dynamic_cfg,
hole, warmup_steps; any length: window_frames, stride, prev_clip_weight,
compress_capture; `rehearsal` overrides them for the CPU rehearsal.
Configuration keys read here: transformer, branch, vae, scheduler, serving
(dtype, use_flash, w8a8, adapter_rank, adapter_alpha, capture_int8).
"""

from __future__ import annotations

import gc
import re
import sys
import time
from typing import Dict, Optional

import torch

from .. import clip as clipmod
from .. import weights
from ..counts import Gemm, Work, block_work
from ..loop import Record, StepClock, pick_step, rel_err

BF16 = torch.bfloat16


def _configs(cfg: dict, anyl: bool):
    from videopainter_tpu_torch.config import (BranchConfig, SchedulerConfig,
                                               TransformerConfig, VAEConfig)
    tcfg = TransformerConfig.from_dict(dict(cfg["transformer"], id_pool_resample_learnable=anyl))
    bcfg = BranchConfig.from_transformer(tcfg, num_layers=cfg["branch"]["num_layers"])
    return tcfg, bcfg, VAEConfig.from_dict(cfg["vae"]), SchedulerConfig.from_dict(cfg["scheduler"])


def program_dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["serving"]["dtype"])


def draw_weights(cfg: dict, shapes: Dict[str, dict], seed: int, device) -> Dict[str, dict]:
    """The seeded state dicts: transformer, branch, vae, and the ID adapter
    (`adapter`, diffusers / peft names) when the configuration has one; the
    text path as `text_path` sets it."""
    gen = weights.generator(seed, device, 0)
    sd = {k: weights.draw(shapes[k], gen, device=device) for k in shapes}
    text_path(sd, cfg)
    return sd


BLOCK_MOD_BIAS = re.compile(r"transformer_blocks\.\d+\.norm1\.linear\.bias")


def text_path(sd: Dict[str, dict], cfg: dict):
    """The served model's text path, in place, when the configuration gives
    `serving.text_gain`: the learned position table's text rows zero (the
    published table's are), and in every DiT and branch block the text
    tokens' attention-side AdaLN scale (the fifth of the six chunks of
    norm1's modulation, 1 + enc_scale) raised to about the gain. Under
    QK-norm the text keys keep their size, but their values grow with it, so
    the prompt moves the output as a trained model's does and the CFG pair
    lies apart by far more than bf16's rounding."""
    gain = cfg["serving"].get("text_gain")
    if not gain:
        return
    text_len = cfg["transformer"]["max_text_seq_length"]
    for part in ("transformer", "branch"):
        for name, t in sd[part].items():
            if name == "patch_embed.pos_embedding":
                t[:, :text_len] = 0
            elif BLOCK_MOD_BIAS.fullmatch(name):
                d = t.shape[0] // 6
                t[4 * d:5 * d] += gain - 1


def adapter_shapes(cfg: dict) -> Dict[str, tuple]:
    """The rank-r ID adapter on every DiT block's to_q / to_k / to_v /
    to_out.0, under the diffusers LoRA names."""
    r = cfg["serving"].get("adapter_rank")
    if not r:
        return {}
    t = cfg["transformer"]
    d = t["num_attention_heads"] * t["attention_head_dim"]
    out = {}
    for i in range(t["num_layers"]):
        for tgt in ("to_q", "to_k", "to_v", "to_out.0"):
            base = f"transformer.transformer_blocks.{i}.attn1.{tgt}"
            out[f"{base}.lora_A.weight"] = (r, d)
            out[f"{base}.lora_B.weight"] = (d, r)
    return out


def build_models(cfg: dict, seed: int, device, anyl: bool):
    """(transformer, branch, vae, shapes) of the program with the seeded
    weights assigned in place (built on the meta device, nothing drawn twice);
    the ID adapter merged and the W8A8 quantization applied as the
    configuration states, by the program's own functions."""
    from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                               CogVideoXTransformer3D)
    from videopainter_tpu_torch.models.lora import convert_peft_lora_state_dict, merge_lora
    from videopainter_tpu_torch.quantize import quantize_transformer_int8

    tcfg, bcfg, vcfg, _ = _configs(cfg, anyl)
    dtype = program_dtype(cfg)
    mods = {"transformer": CogVideoXTransformer3D(tcfg, device="meta", dtype=dtype),
            "branch": CogVideoXBranch(bcfg, device="meta", dtype=dtype),
            "vae": AutoencoderKLCogVideoX(vcfg, device="meta", dtype=dtype)}
    shapes = {k: weights.shapes_of(m) for k, m in mods.items()}
    if adapter_shapes(cfg):
        shapes["adapter"] = adapter_shapes(cfg)
    sd = draw_weights(cfg, shapes, seed, device)
    if dtype != BF16:   # the served bf16 values, held in a wider type
        sd = {k: {n: t.to(dtype) for n, t in v.items()} for k, v in sd.items()}
    for k, m in mods.items():
        m.load_state_dict(sd[k], strict=True, assign=True)
    srv = cfg["serving"]
    if "adapter" in sd:
        rank = srv["adapter_rank"]
        lora = convert_peft_lora_state_dict(sd.pop("adapter"), tcfg.num_layers, rank)
        merge_lora(mods["transformer"], lora, alpha=srv["adapter_alpha"], rank=rank)
        del lora
    del sd
    if srv.get("w8a8"):
        quantize_transformer_int8(mods["transformer"], free_source=True)
        quantize_transformer_int8(mods["branch"], free_source=True)
    return mods["transformer"], mods["branch"], mods["vae"], shapes


def merged(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def n_windows(tr: dict) -> int:
    if "stride" not in tr:
        return 1
    return (tr["frames"] - tr["window_frames"]) // tr["stride"] + 1


def window_span(tr: dict, w: int):
    """Pixel frames [s, e) of window w."""
    if "stride" not in tr:
        return 0, tr["frames"]
    s = w * tr["stride"]
    return s, s + tr["window_frames"]


def overlap_latent(tr: dict, latents: torch.Tensor) -> torch.Tensor:
    """The previous window's latent frame that conditions the next window
    (the pipeline's `image_` at the overlap position)."""
    ov = (tr["window_frames"] - tr["stride"]) // 4
    return latents[:, -ov - 1:-ov] if ov > 0 else latents[:, -1:]


def make_clip(cfg: dict, tr: dict, seed: int, device) -> clipmod.Clip:
    t = cfg["transformer"]
    c = clipmod.make(weights.generator(seed, device, 1), frames=tr["frames"], height=tr["height"],
                     width=tr["width"], steps=tr["steps"], hole=tr["hole"],
                     text_len=t["max_text_seq_length"], text_dim=t["text_embed_dim"],
                     vae=cfg["vae"], device=device,
                     latent_frames=tr.get("window_frames", tr["frames"]))
    # the inputs as the program receives them (bf16), so both sides get the same values
    for f in ("video", "image", "prompt", "negative", "noise0", "sde", "noise_w1"):
        setattr(c, f, getattr(c, f).to(BF16).float())
    return c


class Session:
    """The program built for one run, its inputs and the recorded steps."""

    def __init__(self, cell, seed: int, device, rehearse: bool):
        from videopainter_tpu_torch.pipelines import CogVideoXI2VDualInpaintAnyLPipeline
        from videopainter_tpu_torch.pipelines.common import (DenoiseConfig,
                                                             capture_token_indices,
                                                             make_denoise_fn)

        self.cell, self.seed, self.device = cell, seed, device
        cfg = merged(cell.config, cell.config.get("rehearsal") if rehearse else None)
        tr = merged(cell.traffic, cell.traffic.get("rehearsal") if rehearse else None)
        self.cfg, self.tr = cfg, tr
        srv = cfg["serving"]
        anyl = "stride" in tr
        tcfg, bcfg, vcfg, scfg = _configs(cfg, anyl)
        dtype = program_dtype(cfg)
        transformer, branch, vae, self.shapes = build_models(cfg, seed, device, anyl)
        self.sched = recording_scheduler(scfg)
        self.pipe = CogVideoXI2VDualInpaintAnyLPipeline(transformer, branch, vae, self.sched,
                                                        device=device)
        self.clip = c = make_clip(cfg, tr, seed, device)
        self.timesteps = self.sched.timesteps(tr["steps"])
        self.rope = self.rope_for(tr, vcfg, tcfg)
        embeds = torch.cat([c.negative, c.prompt]).to(dtype)
        base = dict(num_inference_steps=tr["steps"], do_cfg=True,
                    use_dynamic_cfg=tr["dynamic_cfg"], guidance_scale=tr["guidance_scale"],
                    conditioning_scale=1.0, replace_gt=True, mask_add=True,
                    mask_background=False, add_first=False, use_flash=srv["use_flash"],
                    id_pool_resample=anyl, mode="dual")

        def window_inputs(w: int, image, noise, sde, timesteps):
            s, e = window_span(tr, w)
            inputs = self.pipe.prepare_inputs(
                video=c.video[:, s:e], image=image, masks=c.masks[:, s:e],
                strength=len(timesteps) / tr["steps"], timesteps=timesteps,
                vae_sample_mode="mode", init_noise=noise, dtype=dtype)
            return inputs._replace(prompt_embeds=embeds, dpm_noises=sde.to(dtype))

        self.prev_state = self.image_w2 = None
        image = c.image
        if anyl:
            # window 1, its last step only: the step that captures its states
            last = self.timesteps[-1:]
            inputs = window_inputs(0, image, c.noise_w1, c.sde[-1:], last)
            idx = capture_token_indices(inputs.mask, tcfg.patch_size, text_len=embeds.shape[1],
                                        bucket=int(tr["compress_capture"]))
            inputs = inputs._replace(capture_indices=idx)
            dcfg1 = DenoiseConfig(**base, capture_hidden_states=True,
                                  capture_quant=bool(srv.get("capture_int8")))
            latents, hs, rmask = make_denoise_fn(transformer, branch, self.sched, dcfg1,
                                                 last)(inputs, self.rope)
            self.prev_state = {"prev_hidden_states": hs, "prev_resample_mask": rmask,
                               "prev_clip_weight": float(tr["prev_clip_weight"]),
                               "prev_hidden_indices": torch.cat([idx, idx])}
            image = self.image_w2 = overlap_latent(tr, latents)
            del latents, hs, inputs
        self.inputs = window_inputs(n_windows(tr) - 1, image, c.noise0, c.sde, self.timesteps)
        self.clock = StepClock(device)
        transformer.register_forward_hook(self.sched.keep_output)
        self.denoise = make_denoise_fn(transformer, branch, self.sched, DenoiseConfig(**base),
                                       self.timesteps, progress_fn=self.clock.tick)

    def rope_for(self, tr, vcfg, tcfg):
        from videopainter_tpu_torch.pipelines.common import prepare_rope
        t_lat = (tr.get("window_frames", tr["frames"]) - 1) // vcfg.temporal_compression_ratio + 1
        return prepare_rope(tcfg, tr["height"], tr["width"], t_lat,
                            vcfg.spatial_compression_ratio, device=self.device)

    def run_steps(self, *, seconds: Optional[float] = None, steps: Optional[int] = None):
        """Loop steps from the prepared inputs, cycling the schedule, until
        `seconds` have passed or `steps` have run."""
        self.clock.start(seconds=seconds, steps=steps)
        while not self.clock.done:
            self.sched.cycle += 1
            self.clock.run(lambda: self.denoise(self.inputs, self.rope, None, self.prev_state))
        return self.clock

    # -- what a step does, counted from shapes ------------------------------------
    def work(self) -> Work:
        t, b, srv = self.cfg["transformer"], self.cfg["branch"], self.cfg["serving"]
        lat = self.clip.noise0.shape
        p = t["patch_size"]
        s_vid = lat[1] * (lat[2] // p) * (lat[3] // p)
        s_txt = t["max_text_seq_length"]
        s = s_txt + s_vid
        d = t["num_attention_heads"] * t["attention_head_dim"]
        heads, hd = t["num_attention_heads"], t["attention_head_dim"]
        lin = "int8" if srv.get("w8a8") else "bf16"
        qk = "int8" if srv["use_flash"] in ("int8", "int8pv") else "bf16"
        pv = "int8" if srv["use_flash"] == "int8pv" else "bf16"
        resample = "stride" in self.tr
        w = block_work(s, d, heads, hd, batch=2, layers=t["num_layers"], lin=lin, qk=qk,
                       pv=pv, kv_tokens=2 * s if resample else s)
        w_branch = block_work(s, d, heads, hd, batch=2, layers=b["num_layers"], lin=lin,
                              qk=qk, pv=pv)
        w.gemms += w_branch.gemms
        w.attns += w_branch.attns
        if resample:   # the previous window's page: its K and V projections
            w.gemms.append(Gemm(2 * s, d, d, lin, 2 * t["num_layers"]))
        c_lat = lat[4]
        te = t["time_embed_dim"]
        n_all = t["num_layers"] + b["num_layers"]
        w.gemms += [Gemm(2 * s_txt, d, t["text_embed_dim"], count=2),          # text projections
                    Gemm(2 * s_vid, d, p * p * 2 * c_lat),                     # DiT patch embed
                    Gemm(2 * s_vid, d, p * p * (2 * c_lat + 1)),               # branch patch embed
                    Gemm(2 * s_vid, d, d, count=b["num_layers"]),              # branch projections
                    Gemm(2 * s_vid, p * p * t["out_channels"], d),             # output head
                    Gemm(2, 6 * d, te, count=2 * n_all), Gemm(2, 2 * d, te)]   # modulation
        return w

    # -- the comparison -------------------------------------------------------------
    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """Free the program, then hold one recorded step drawn from the seed
        (and, on the any-length path, window 1's latent that conditions
        window 2) against the reference run on the same inputs. With
        `control` ("fp8", "int4"), also the reference computed with its
        linears in that precision, put in the program's place:
        {"program": numbers, "control": numbers}."""
        rec = pick_step(self.sched.log, self.seed)
        got = {"raw": rec.raw.float(), "pred": rec.pred.float(),
               "x_next": rec.next_sample.float()}
        if self.image_w2 is not None:
            got["image_w2"] = self.image_w2.float()
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

    def free_program(self):
        self.sched.log = []
        for a in ("pipe", "denoise", "inputs", "rope", "prev_state", "image_w2"):
            setattr(self, a, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare(got: dict, ref: dict, x: torch.Tensor) -> Dict[str, float]:
    """The numbers the limits hold: the relative errors of the DiT's output
    over the CFG batch, of its guided direction (conditional minus
    unconditional half, which a step that leaves a half out gets wholly
    wrong) and of the guided prediction, the next latents' error against
    the size of the reference's step, and on the any-length path window 1's
    conditioning latent's relative error. `cfg_share`, the size of the
    reference's guided direction against the output's, is a note: how far
    apart the CFG pair lies."""
    ru, rc = ref["raw"].chunk(2)
    pu, pc = got["raw"].chunk(2)
    out = {"raw_rel_err": rel_err(got["raw"], ref["raw"]),
           "cfg_share": rel_err(rc, ru, ref["raw"]),
           "cfg_rel_err": rel_err(pc - pu, rc - ru),
           "pred_rel_err": rel_err(got["pred"], ref["pred"]),
           "step_rel_err": rel_err(got["x_next"], ref["x_next"], ref["x_next"] - x)}
    if "image_w2" in got:
        out["overlap_rel_err"] = rel_err(got["image_w2"], ref["image_w2"])
    return out


def recording_scheduler(scfg):
    from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler

    class RecordingDPM(CogVideoXDPMScheduler):
        """The program's DPM scheduler; while `log` is a list, each step's
        input latents, guided prediction and previous x0 are kept, and the
        blended latents of a step are read as the next step's input."""

        def __init__(self, config):
            super().__init__(config)
            self.log, self.cycle, self.raw = None, 0, None

        def keep_output(self, module, args, out):
            """Forward hook on the DiT: its output over the CFG batch, the
            answer as the model produced it, for the step that follows."""
            if self.log is not None:
                self.raw = out.sample

        def step(self, coeffs, i, model_output, old_pred_original_sample, sample, noise=None):
            if self.log is not None:
                if self.log and self.log[-1].cycle == self.cycle and self.log[-1].i == i - 1:
                    self.log[-1].next_sample = sample
                self.log.append(Record(self.cycle, i, sample, model_output,
                                       old_pred_original_sample, self.raw))
            return super().step(coeffs, i, model_output, old_pred_original_sample, sample, noise)

    return RecordingDPM(scfg)


def reference_weights(cfg: dict, shapes, seed: int, device) -> Dict[str, dict]:
    """The seeded weights drawn again, with the ID adapter merged in float32
    (W + alpha / r * B A) into the DiT's attention projections."""
    sd = draw_weights(cfg, shapes, seed, device)
    ad = sd.pop("adapter", None)
    if ad is not None:
        srv = cfg["serving"]
        f = srv["adapter_alpha"] / srv["adapter_rank"]
        dit = sd["transformer"] = dict(sd["transformer"])
        for name in ad:
            if name.endswith("lora_A.weight"):
                base = name[len("transformer."):-len(".lora_A.weight")]
                up = ad[name.replace("lora_A", "lora_B")].float()
                dit[base + ".weight"] = dit[base + ".weight"].float() + f * (up @ ad[name].float())
    return sd


def reference(cfg, tr, shapes, seed, clip, i, x, old, device, control: Optional[str] = None,
              encodes: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The plain reference's step i of the last window from latents x (and
    the previous x0): the DiT's output over the CFG batch, the guided
    prediction and the blended next latents;
    on the any-length path also window 1's conditioning latent, from window
    1's own last step. Weights are drawn again from the seed; every VAE
    latent is encoded again from the clip (`encodes`, when given, keeps them
    for a second call). `control` ("fp8", "int4") computes the DiT's and the
    branch's matrix products in that precision instead of the
    configuration's own and holds what the program holds in bf16 (their
    activations, the loop's latents) in fp8 (`quant.Control`)."""
    import reference.cogvideox as ref
    from reference.dpm import DPMStep, cfg_scale
    from reference.quant import Control, Quantizer, int8_qk
    from reference.vae_encoder import Encoder

    srv = cfg["serving"]
    quant = Quantizer("int8") if srv.get("w8a8") else None
    attn_qk = int8_qk() if srv["use_flash"] == "int8" else None
    ctl = None if control is None else Control(control)
    encodes = {} if encodes is None else encodes
    sd = reference_weights(cfg, shapes, seed, device)
    enc = Encoder(sd["vae"], cfg["vae"], device=device)
    text = torch.cat([clip.negative, clip.prompt]).float()
    bcfg = dict(cfg["transformer"], num_layers=cfg["branch"]["num_layers"])
    anyl = "stride" in tr

    def encode(key, video):
        if key not in encodes:
            encodes[key] = enc.latents(video)
        return encodes[key]

    def window_latents(w: int, image_lat):
        s, e = window_span(tr, w)
        video, masks = clip.video[:, s:e], clip.masks[:, s:e]
        masked = encode(f"masked{w}", video * (masks < 0.5)[..., None])
        clean = encode(f"clean{w}", video)
        m = masks
        for dim, n in zip((1, 2, 3), masked.shape[1:4]):
            m = m.index_select(dim, torch.arange(n, device=m.device) * m.shape[dim] // n)
        image_lat = torch.cat([image_lat, torch.zeros_like(masked[:, 1:])], dim=1)
        return masked, clean, m, image_lat

    def step(k, steps_left, x, old, sde, noise0, lat, resample):
        masked, clean, mask_lat, image_lat = lat
        st = DPMStep(cfg["scheduler"], tr["steps"], k)
        t = torch.full((2,), st.t, device=device)
        x2 = torch.cat([x, x])
        cond = torch.cat([masked, mask_lat[..., None]], dim=-1)
        feats = ref.branch_features(sd["branch"], bcfg, x2, torch.cat([cond, cond]), text, t,
                                    device=device, quant=quant, attn_qk=attn_qk, control=ctl)
        pred = ref.dit_forward(sd["transformer"], cfg["transformer"],
                               torch.cat([x2, torch.cat([image_lat, image_lat])], dim=-1), text,
                               t, device=device, feats=feats,
                               mask_lat=torch.cat([mask_lat, mask_lat]), quant=quant,
                               attn_qk=attn_qk, resample=resample, control=ctl)
        del feats
        u, c = pred.chunk(2)
        scale = cfg_scale(st.t, steps_left, tr["guidance_scale"], tr["dynamic_cfg"])
        x_next, _ = st(x, u + scale * (c - u), old, sde)
        x_next = st.blend(x_next, clean, noise0, mask_lat)
        return pred, u + scale * (c - u), (x_next if ctl is None else ctl.act(x_next))

    out = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        image_lat = encode("image", clip.image[:, None])
        if anyl:
            # window 1's only step, from its clean latents noised to the last timestep
            lat1 = window_latents(0, image_lat)
            k = tr["steps"] - 1
            a = float(DPMStep(cfg["scheduler"], tr["steps"], k).a)
            x1 = (a ** 0.5 * lat1[1].double() + (1 - a) ** 0.5 * clip.noise_w1.double()).float()
            _, _, lat_w1 = step(k, 1, x1, None, clip.sde[-1], clip.noise_w1, lat1, "own")
            image_lat = out["image_w2"] = overlap_latent(tr, lat_w1)
            del lat1
        lat = window_latents(n_windows(tr) - 1, image_lat)
        del enc
        t1 = time.perf_counter()
        out["raw"], out["pred"], out["x_next"] = step(i, tr["steps"], x, old, clip.sde[i],
                                                      clip.noise0, lat, "zero" if anyl else None)
    print(f"note reference_s {time.perf_counter() - t0:.1f} (last window's encodes done at "
          f"{t1 - t0:.1f})", file=sys.stderr)
    return out


W8A8_RANGE = "vpbench.w8a8"


def trace_hooks(session: Session):
    """A `record_function` range around every W8A8 projection's call."""
    from videopainter_tpu_torch.ops.basic import Int8Linear

    from ..trace import range_hooks
    return range_hooks([m for model in (session.pipe.transformer, session.pipe.branch)
                        for m in model.modules() if isinstance(m, Int8Linear)], W8A8_RANGE)


def setup(cell, seed: int, device, rehearse: bool = False) -> Session:
    s = Session(cell, seed, device, rehearse)
    s.run_steps(steps=s.tr["warmup_steps"])   # the cell's own shapes, both DPM orders
    return s


def window(session: Session, *, seconds: Optional[float] = None, steps: Optional[int] = None):
    """The measured steps, recorded for the check."""
    session.sched.log = []
    return session.run_steps(seconds=seconds, steps=steps)


def metrics(session: Session, clock) -> Dict[str, float]:
    return {"serve_step_s": clock.elapsed / clock.steps}
