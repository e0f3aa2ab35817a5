"""Driver of VideoPainter's branch training (SFT) step on one card:
`make_branch_train_step`'s `train_step`, the VAE prep included, with the
frozen bf16 DiT and VAE, the float32 branch and AdamW.

Set-up builds the step from the seeded weights (the branch drawn as a
resumed job's, its projections not zero, so every leaf trains), then drives
the same step object through its first `first_steps` steps: the parameters
before them, the optimizer's first moment after the first (the clipped
gradient times 1 - beta1) and the parameters after them are copied to the
host for the check. The window continues that object, one fresh clip from
the seed a step, until the window's time is up; every step ends with a
device synchronise and a host clock reading. After the window the plain
reference follows the first steps from the same weights, clips and draws.

Traffic keys: frames, height, width, hole, batch, first_steps, lr, betas,
eps, weight_decay, max_grad_norm, noised_image_dropout,
inpainting_loss_weight; `rehearsal` overrides them for the CPU rehearsal.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional

import torch

from .. import clip as clipmod
from .. import weights
from ..counts import Attn, Gemm, Work
from ..loop import StepClock
from .denoise import merged

BF16 = torch.bfloat16
VAE_RANGE = "vpbench.vae_encode"
MASTERS = {"bf16_masters": BF16}   # the controls: the branch's masters one precision lower


def _configs(cfg: dict):
    from videopainter_tpu_torch.config import (BranchConfig, SchedulerConfig,
                                               TransformerConfig, VAEConfig)
    tcfg = TransformerConfig.from_dict(cfg["transformer"])
    bcfg = BranchConfig.from_transformer(tcfg, num_layers=cfg["branch"]["num_layers"])
    return tcfg, bcfg, VAEConfig.from_dict(cfg["vae"]), SchedulerConfig.from_dict(cfg["scheduler"])


def draw_weights(shapes, seed: int, device, frozen=BF16) -> Dict[str, dict]:
    """The frozen DiT and VAE in their served type (bf16), the branch's
    float32 masters."""
    gen = weights.generator(seed, device, 0)
    out = {k: weights.draw(shapes[k], gen, device=device,
                           dtype=torch.float32 if k == "branch" else BF16) for k in shapes}
    if frozen != BF16:   # the served bf16 values, held in a wider type
        out = {k: v if k == "branch" else {n: t.to(frozen) for n, t in v.items()}
               for k, v in out.items()}
    return out


def make_batch(cfg: dict, tr: dict, seed: int, i: int, device, dtype=BF16) -> dict:
    """Step i's clip: its own stream of the seed, so every step's rows differ."""
    t = cfg["transformer"]
    c = clipmod.make(weights.generator(seed, device, 16 + i), frames=tr["frames"],
                     height=tr["height"], width=tr["width"], steps=1, hole=tr["hole"],
                     text_len=t["max_text_seq_length"], text_dim=t["text_embed_dim"],
                     vae=cfg["vae"], device=device)
    video = c.video.to(BF16).to(dtype)
    keep = (1 - c.masks[..., None]).to(dtype)
    return {"pixel_values": video, "conditioning_pixel_values": video * keep,
            "masks": c.masks.to(dtype), "prompt_embeds": c.prompt.to(BF16).to(dtype)}


def optimizer_args(tr: dict) -> dict:
    return dict(lr=tr["lr"], betas=tuple(tr["betas"]), eps=tr["eps"],
                weight_decay=tr["weight_decay"], max_grad_norm=tr["max_grad_norm"])


class Session:
    def __init__(self, cell, seed: int, device, rehearse: bool):
        from videopainter_tpu_torch.models import (AutoencoderKLCogVideoX, CogVideoXBranch,
                                                   CogVideoXTransformer3D)
        from videopainter_tpu_torch.schedulers import CogVideoXDDIMScheduler
        from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                                     make_branch_train_step, make_optimizer)

        self.cell, self.seed, self.device = cell, seed, device
        self.cfg = cfg = merged(cell.config, cell.config.get("rehearsal") if rehearse else None)
        self.tr = tr = merged(cell.traffic, cell.traffic.get("rehearsal") if rehearse else None)
        tcfg, bcfg, vcfg, scfg = _configs(cfg)
        frozen = getattr(torch, cfg["serving"]["dtype"])
        mods = {"transformer": CogVideoXTransformer3D(tcfg, device="meta", dtype=frozen),
                "branch": CogVideoXBranch(bcfg, device="meta", dtype=torch.float32),
                "vae": AutoencoderKLCogVideoX(vcfg, device="meta", dtype=frozen)}
        self.shapes = {k: weights.shapes_of(m) for k, m in mods.items()}
        sd = draw_weights(self.shapes, seed, device, frozen)
        for k, m in mods.items():
            m.load_state_dict(sd[k], strict=True, assign=True)
        del sd
        self.vae = mods["vae"]
        self.optimizer = make_optimizer(**optimizer_args(tr))
        self.state = init_branch_train_state(mods["branch"], self.optimizer)
        self.names = sorted(self.state.trainable)
        step_cfg = BranchTrainConfig(
            height=tr["height"], width=tr["width"], mask_add=True, use_flash=True, remat=True,
            noised_image_dropout=tr["noised_image_dropout"],
            inpainting_loss_weight=tr["inpainting_loss_weight"],
            max_grad_norm=tr["max_grad_norm"])
        self.step = make_branch_train_step(mods["transformer"], mods["branch"], self.vae,
                                           CogVideoXDDIMScheduler(scfg), self.optimizer, step_cfg)
        self.modules = mods
        self.gen = weights.generator(seed, device, 2)   # the steps' VAE-prep draws
        self.done = 0
        self.clock = StepClock(device)
        self.losses: List[float] = []

    def one_step(self):
        batch = make_batch(self.cfg, self.tr, self.seed, self.done, self.device,
                           getattr(torch, self.cfg["serving"]["dtype"]))
        self.state, metrics = self.step(self.state, batch, self.gen)
        self.done += 1
        return metrics

    def leaves(self) -> List[torch.Tensor]:
        return [self.state.trainable[n] for n in self.names]

    def first_steps(self):
        """The step's first steps, through the window's own call, with what
        the check reads of them copied to the host."""
        host = lambda xs: [x.detach().to("cpu", copy=True) for x in xs]
        self.theta0 = host(self.leaves())
        for i in range(self.tr["first_steps"]):
            metrics = self.one_step()
            self.losses.append(float(metrics["total_loss"]))
            if i == 0:   # the clipped gradient, as the optimizer's first moment holds it
                b1 = self.tr["betas"][0]
                self.grad1 = [m / (1 - b1) for m in host(self.state.opt_state["mu"])]
        self.theta_n = host(self.leaves())

    def run_steps(self, *, seconds: Optional[float] = None, steps: Optional[int] = None):
        self.clock.start(seconds=seconds, steps=steps)
        while not self.clock.done:
            self.clock.run(lambda: (self.one_step(), self.clock.tick()))
        return self.clock

    # -- what a step does, counted from shapes ------------------------------------
    def work(self) -> Work:
        """Forward of the DiT and the branch, and the backward the branch's
        gradients need: through the DiT's blocks after the first injection
        (activation gradients only: one product per forward GEMM, four per
        attention's two), through the branch's blocks and projections (input
        and weight gradients). Recomputation is not counted."""
        t, b, tr = self.cfg["transformer"], self.cfg["branch"], self.tr
        p = t["patch_size"]
        lat = clipmod.latent_shape(tr["frames"], tr["height"], tr["width"], self.cfg["vae"])
        s_vid = lat[0] * (lat[1] // p) * (lat[2] // p)
        s = t["max_text_seq_length"] + s_vid
        d, heads, hd = (t["num_attention_heads"] * t["attention_head_dim"],
                        t["num_attention_heads"], t["attention_head_dim"])
        m = tr["batch"] * s
        n_dit, n_br = t["num_layers"], b["num_layers"]
        blocks = lambda count: [Gemm(m, d, d, count=4 * count), Gemm(m, 4 * d, d, count=count),
                                Gemm(m, d, 4 * d, count=count)]
        attn = lambda count: Attn(tr["batch"] * heads, s, s, hd, count=count)
        gemms = blocks(n_dit + n_br) + blocks(n_dit - 1) + blocks(2 * n_br)
        gemms.append(Gemm(tr["batch"] * s_vid, d, d, count=3 * n_br))   # branch projections
        return Work(gemms, [attn(n_dit + n_br), attn(2 * (n_dit - 1 + n_br))])

    # -- the comparison -------------------------------------------------------------
    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """Free the program, then let the reference follow the first steps.
        With `control` (a key of MASTERS), also the reference with the
        branch's masters and AdamW in that type, put in the program's place."""
        got = {"losses": self.losses, "grad1": self.grad1,
               "change": [b - a for a, b in zip(self.theta0, self.theta_n)]}
        theta0 = self.theta0
        self.free_program()
        ref = reference(self.cfg, self.tr, self.shapes, self.seed, self.names, theta0,
                        self.device)
        out = compare(got, ref)
        if control is None:
            return out
        if control not in MASTERS:
            raise ValueError(f"unknown control {control!r}; this driver has {sorted(MASTERS)}")
        ctl = reference(self.cfg, self.tr, self.shapes, self.seed, self.names, theta0,
                        self.device, master=MASTERS[control])
        return {"step": 1, "program": out, "control": compare(ctl, ref)}

    def free_program(self):
        for a in ("step", "state", "optimizer", "modules", "vae"):
            setattr(self, a, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The first steps' worst loss gap (relative), and by the worst leaf the
    gap between the norms of the first clipped gradient, and of the
    parameters' change over the first steps, against the reference's norm
    of that leaf or of the median leaf, whichever is larger; over the leaves
    whose reference gradient is not nought to rounding."""
    from reference.train import leaf_norms, moving, relative_leaf_gap

    keep = moving(leaf_norms(ref["grad1"]))
    return {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                                    ref["losses"])),
            "grad_rel_err": relative_leaf_gap(got["grad1"], ref["grad1"], keep),
            "change_rel_err": relative_leaf_gap(got["change"], ref["change"], keep)}


def reference(cfg, tr, shapes, seed, names, theta0, device, master=torch.float32) -> dict:
    """The plain reference's first steps from the same weights, clips and
    prep draws: each step's loss, the first clipped gradient, the branch's
    change over the steps. `master` bf16 is the control: the branch's
    masters and AdamW's moments and arithmetic one precision lower."""
    from reference import train as rt
    from reference.vae_encoder import Encoder

    t0 = time.perf_counter()
    sd = draw_weights(shapes, seed, device)
    dit = sd["transformer"]
    enc = Encoder(sd["vae"], cfg["vae"], device=device)
    leaves = [sd["branch"][n].to(master).requires_grad_(True) for n in names]
    opt = rt.AdamW(leaves, dtype=master, **optimizer_args(tr))
    gen = weights.generator(seed, device, 2)
    abar = rt.schedule_abar(cfg["scheduler"], device)
    bcfg = cfg["branch"]["num_layers"]
    losses, grad1 = [], None
    for i in range(tr["first_steps"]):
        b = make_batch(cfg, tr, seed, i, device)
        with torch.no_grad():
            prep = rt.prepare(enc, b["pixel_values"].float(),
                              b["conditioning_pixel_values"].float(), b["masks"].float(), gen,
                              sched_abar=abar,
                              num_train_timesteps=cfg["scheduler"]["num_train_timesteps"],
                              dropout=tr["noised_image_dropout"], device=device,
                              latent_dtype=getattr(torch, cfg["serving"]["dtype"]))
        fb = dict(sd["branch"], **{n: p.float() for n, p in zip(names, leaves)})
        loss, grads = rt.loss_and_grads(dit, fb, names, cfg["transformer"], bcfg, prep,
                                        b["prompt_embeds"].float(), abar,
                                        tr["inpainting_loss_weight"], device)
        if master != torch.float32:   # the gradient reaches the bf16 leaves through the cast
            grads = [g.to(master) for g in grads]
        clipped = opt.step(leaves, grads)
        losses.append(loss)
        if grad1 is None:
            grad1 = [g.float().cpu() for g in clipped]
        del prep, grads
    change = [p.detach().float().cpu() - a for p, a in zip(leaves, theta0)]
    print(f"note reference_s {time.perf_counter() - t0:.1f}", file=sys.stderr)
    return {"losses": losses, "grad1": grad1, "change": change}


def trace_hooks(session: Session):
    """A `record_function` range around every call of the VAE's encoder."""
    from ..trace import range_hooks
    return range_hooks([session.vae.encoder], VAE_RANGE)


def setup(cell, seed: int, device, rehearse: bool = False) -> Session:
    s = Session(cell, seed, device, rehearse)
    s.first_steps()
    return s


def window(session: Session, *, seconds: Optional[float] = None, steps: Optional[int] = None):
    return session.run_steps(seconds=seconds, steps=steps)


def metrics(session: Session, clock) -> Dict[str, float]:
    return {"train_step_s": clock.elapsed / clock.steps}
