"""The end-to-end branch / LoRA training loop.

Counterpart of `videopainter_tpu/training/trainer.py` (reference main loop:
optimizer, per-step metric logging of loss, inpainting_loss, lr and gradient
norms, checkpoint rotation, periodic pipeline validation logged as videos,
first-batch visual sanity dump, resume from the latest checkpoint).

`train(..., mesh=)` is the multi-card loop (the counterpart of the JAX
package's `shard_train_setup` + `train(mesh=)`), run by every rank of the
mesh: the backbone and the branch are made tensor-parallel over `model`
(`shard_train_setup`), every rank draws the same global batches and keeps
its `data` slice (`train_branch.py`), the optimizer state is split
ZeRO-2-style over `data`. Rank 0 logs, writes the first-batch dump and the
checkpoints; a checkpoint is gathered to the one-card layout first (every
rank takes part), so a run resumes on any mesh, one card included.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch


class Logger:
    """wandb when importable+configured, JSONL fallback otherwise."""

    def __init__(self, output_dir: str, project: str = "videopainter-tpu",
                 run_name: Optional[str] = None, use_wandb: bool = True):
        self.jsonl = open(os.path.join(output_dir, "train_log.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(project=project, name=run_name, dir=output_dir)
            except Exception:
                self.wandb = None

    def log(self, metrics: Dict[str, Any], step: int):
        rec = {k: float(v) for k, v in metrics.items()
               if isinstance(v, (int, float, np.floating)) or
               (hasattr(v, "shape") and tuple(getattr(v, "shape", (1,))) == ())}
        rec["step"] = step
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()
        if self.wandb is not None:
            self.wandb.log(rec, step=step)

    def close(self):
        self.jsonl.close()

    def log_video(self, name: str, video01: np.ndarray, step: int, fps: int = 8):
        if self.wandb is not None:
            frames = (video01 * 255).clip(0, 255).astype(np.uint8)
            self.wandb.log({name: self.wandb.Video(
                frames.transpose(0, 3, 1, 2), fps=fps)}, step=step)


@dataclass
class TrainerConfig:
    output_dir: str = "runs/branch"
    max_train_steps: int = 10000
    learning_rate: float = 1e-5
    optimizer: str = "adamw"  # adam | adamw | prodigy | adafactor
    lr_scheduler: str = "cosine_with_restarts"  # HF get_scheduler surface
    lr_warmup_steps: int = 100
    lr_num_cycles: int = 1
    lr_power: float = 1.0  # polynomial scheduler exponent
    gradient_accumulation_steps: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_weight_decay: float = 1e-4
    adam_epsilon: float = 1e-8
    prodigy_beta3: Optional[float] = None
    prodigy_decouple: bool = True
    prodigy_use_bias_correction: bool = False
    prodigy_safeguard_warmup: bool = False
    batch_size: int = 1
    checkpointing_steps: int = 500
    checkpoints_total_limit: Optional[int] = 5
    validating_steps: int = 256
    log_every: int = 10
    resume_from_checkpoint: Optional[str] = "latest"
    seed: int = 42
    mode: str = "branch"  # or "lora"
    tracker_name: str = "videopainter-tpu"  # wandb project
    runs_name: Optional[str] = None         # wandb run name


def dump_first_batch(batch: Dict, out_dir: str) -> None:
    """First-batch visual sanity dump."""
    try:
        import cv2
    except ImportError:
        return
    img = lambda x: np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)
    for j in range(min(2, batch["pixel_values"].shape[1])):
        px = ((img(batch["pixel_values"][0, j]) + 1) * 127.5).clip(0, 255)
        cd = ((img(batch["conditioning_pixel_values"][0, j]) + 1) * 127.5).clip(0, 255)
        mk = np.repeat(img(batch["masks"][0, j])[..., None] * 255, 3, -1)
        combo = np.hstack([px, cd, mk]).astype(np.uint8)
        cv2.imwrite(os.path.join(out_dir, f"training_sample_{j}.png"),
                    cv2.cvtColor(combo, cv2.COLOR_RGB2BGR))


def _checkpoint_state(state) -> dict:
    return {"step": int(state.step), "trainable": state.trainable, "opt_state": state.opt_state}


def _restore_one_card(path: str, state) -> dict:
    """Read a checkpoint into a one-card state in place. One written under a
    mesh (gathered to the one-card layout) holds no optimizer layout fields:
    they are taken from `state`'s own."""
    from .checkpoint import _copy_into, restore_checkpoint
    from .optim import LAYOUT_KEYS

    target = _checkpoint_state(state)
    saved = restore_checkpoint(path)
    if isinstance(saved.get("opt_state"), dict):
        for key in LAYOUT_KEYS:
            if key in target["opt_state"] and key not in saved["opt_state"]:
                saved["opt_state"][key] = target["opt_state"][key]
    return _copy_into(target, saved)


def shard_train_setup(mesh, transformer, trainable=None):
    """Tensor-parallel placement of the frozen backbone and (a branch module
    as) the trainable over the mesh's `model` axis, in place. The VAE stays
    replicated; the optimizer state is split when the state is made
    (`init_branch_train_state(..., mesh)`)."""
    from ..parallel.sharding import shard_params

    shard_params(transformer, mesh)
    if trainable is not None and hasattr(trainable, "transformer_blocks"):
        shard_params(trainable, mesh)


def full_state_dict(module) -> dict:
    """`module`'s state dict with its tensor-parallel tensors gathered whole
    (a collective over `model`; every rank calls it)."""
    from ..parallel.sharding import gather_tp, tp_slot

    out = {}
    for name, t in module.state_dict().items():
        slot = tp_slot(module, name)
        out[name] = t if slot is None else gather_tp(t, *slot)
    return out


def _tp_slots(module, names):
    """{name: (slot, dim)} of the tensor-parallel parameters of `module`."""
    from ..parallel.sharding import tp_slot

    if module is None:
        return {}
    out = {n: tp_slot(module, n) for n in names}
    return {n: v for n, v in out.items() if v is not None}


def _state_to_full(state, optimizer, slots) -> dict:
    """The train state in the one-card layout: ZeRO-2 parts gathered over
    `data`, tensor-parallel parts over `model`. Every rank calls it."""
    from ..parallel.sharding import gather_tp

    names = sorted(state.trainable) if isinstance(state.trainable, dict) else []
    opt = state.opt_state
    if optimizer.zero is not None:
        opt = optimizer.zero.gather_state(opt)
    if slots:
        opt = dict(opt)
        for key, value in opt.items():
            if isinstance(value, list) and len(value) == len(names):
                opt[key] = [_gather_like(v, slots.get(n)) for v, n in zip(value, names)]
        trainable = {n: gather_tp(p, *slots[n]) if n in slots else p
                     for n, p in state.trainable.items()}
    else:
        trainable = state.trainable
    return {"step": int(state.step), "trainable": trainable, "opt_state": opt}


def _gather_like(t, slot_dim):
    """A per-parameter state tensor gathered over `model` when it is split
    along its parameter's axis (moments shaped as the parameter)."""
    from ..parallel.sharding import gather_tp

    if slot_dim is None or not torch.is_tensor(t):
        return t
    slot, dim = slot_dim
    return gather_tp(t, slot, dim) if t.ndim > dim and t.shape[dim] == len(slot.index) else t


def _state_from_full(full: dict, state, optimizer, slots):
    """This rank's train state from a one-card-layout checkpoint."""
    from ..parallel.sharding import take_tp

    names = sorted(state.trainable) if isinstance(state.trainable, dict) else []
    opt = dict(full["opt_state"])
    if slots:
        for key, value in opt.items():
            if isinstance(value, list) and len(value) == len(names):
                opt[key] = [take_tp(v, *slots[n]) if n in slots and torch.is_tensor(v)
                            and v.ndim > slots[n][1] and v.shape[slots[n][1]] == slots[n][0].full
                            else v for v, n in zip(value, names)]
    if optimizer.zero is not None:
        opt = optimizer.zero.scatter_state(opt, state.opt_state)
    with torch.no_grad():
        for n, p in state.trainable.items():
            src = full["trainable"][n]
            p.copy_(take_tp(src, *slots[n]) if n in slots else src)
    return type(state)(step=int(full["step"]), trainable=state.trainable,
                       opt_state=_into(state.opt_state, opt))


def _into(target, source):
    """`source`'s values copied into `target`'s tensors where both hold one."""
    if isinstance(target, dict):
        return {k: _into(target[k], source[k]) if k in source else target[k] for k in target}
    if isinstance(target, list) and isinstance(source, list) and len(target) == len(source):
        return [_into(t, s) for t, s in zip(target, source)]
    if torch.is_tensor(target) and torch.is_tensor(source) and target.shape == source.shape:
        with torch.no_grad():
            target.copy_(source)
        return target
    return source


def train(transformer, branch, vae, scheduler, data_iter, tcfg: TrainerConfig, bcfg,
          validation_fn=None, initial_trainable=None, mesh=None):
    """Run the training loop on the modules' device. `data_iter` yields
    collated batches of tensors with prompt_embeds already computed.
    `initial_trainable`: the branch module (mode "branch") or a LoRA tree
    (mode "lora"). `validation_fn(trainable, step) -> video01 | None` runs the
    full pipeline periodically. Returns the final train state."""
    from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
    from .optim import make_lr_schedule, make_optimizer
    from .train_branch import (BranchTrainState, init_branch_train_state,
                               make_branch_train_step, make_lora_train_step)

    rank0 = mesh is None or not torch.distributed.is_initialized() \
        or torch.distributed.get_rank() == 0
    os.makedirs(tcfg.output_dir, exist_ok=True)
    logger = (Logger(tcfg.output_dir, project=tcfg.tracker_name, run_name=tcfg.runs_name)
              if rank0 else None)
    schedule = make_lr_schedule(tcfg.lr_scheduler, tcfg.learning_rate,
                                warmup_steps=tcfg.lr_warmup_steps,
                                total_steps=tcfg.max_train_steps,
                                num_cycles=tcfg.lr_num_cycles, power=tcfg.lr_power)
    optimizer = make_optimizer(
        schedule=schedule, optimizer=tcfg.optimizer,
        betas=(tcfg.adam_beta1, tcfg.adam_beta2), eps=tcfg.adam_epsilon,
        weight_decay=tcfg.adam_weight_decay, max_grad_norm=bcfg.max_grad_norm,
        prodigy_beta3=tcfg.prodigy_beta3, prodigy_decouple=tcfg.prodigy_decouple,
        prodigy_use_bias_correction=tcfg.prodigy_use_bias_correction,
        prodigy_safeguard_warmup=tcfg.prodigy_safeguard_warmup,
        accumulate_steps=tcfg.gradient_accumulation_steps)

    if initial_trainable is None:
        raise ValueError("initial_trainable (the branch module or a LoRA tree) required")
    if mesh is not None:
        shard_train_setup(mesh, transformer, initial_trainable)
    trainable_module = initial_trainable if hasattr(initial_trainable, "named_parameters") \
        else None
    state = init_branch_train_state(initial_trainable, optimizer, mesh)
    slots = _tp_slots(trainable_module, state.trainable) if mesh is not None else {}

    start_step = 0
    if tcfg.resume_from_checkpoint:
        path = (latest_checkpoint(tcfg.output_dir)
                if tcfg.resume_from_checkpoint == "latest" else tcfg.resume_from_checkpoint)
        if path:
            if mesh is None:
                restored = _restore_one_card(path, state)
                state = BranchTrainState(step=int(restored["step"]),
                                         trainable=restored["trainable"],
                                         opt_state=restored["opt_state"])
            else:
                state = _state_from_full(restore_checkpoint(path), state, optimizer, slots)
            start_step = state.step
            print(f"resumed from {path} at step {start_step}")

    make_step = make_branch_train_step if tcfg.mode == "branch" else make_lora_train_step
    step_fn = make_step(transformer, branch, vae, scheduler, optimizer, bcfg, mesh=mesh)

    device = next(vae.parameters()).device
    generator = torch.Generator(device=device).manual_seed(tcfg.seed)
    t0 = time.time()
    try:
        for step in range(start_step, tcfg.max_train_steps):
            # gradient accumulation: k micro-batches per optimizer step; the
            # optimizer averages the gradients and runs its chain (the clip
            # included) on the k-th call. `step` counts optimizer steps.
            for micro in range(tcfg.gradient_accumulation_steps):
                batch = next(data_iter)
                if step == start_step and micro == 0 and rank0:
                    dump_first_batch(batch, tcfg.output_dir)
                state, metrics = step_fn(state, batch, generator)
            state = state._replace(step=step + 1)

            if step % tcfg.log_every == 0 and rank0:
                metrics = {k2: float(v) for k2, v in metrics.items()}
                metrics["lr"] = float(schedule(step))
                metrics["steps_per_sec"] = tcfg.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                logger.log(metrics, step)

            if (step + 1) % tcfg.checkpointing_steps == 0:
                ckpt = (_checkpoint_state(state) if mesh is None
                        else _state_to_full(state, optimizer, slots))
                if rank0:
                    save_checkpoint(tcfg.output_dir, step + 1, ckpt,
                                    total_limit=tcfg.checkpoints_total_limit)

            if validation_fn is not None and (step + 1) % tcfg.validating_steps == 0:
                try:  # a failed validation must not kill training
                    video01 = validation_fn(state.trainable, step + 1)
                    if video01 is not None and rank0:
                        logger.log_video("validation", video01, step + 1)
                except Exception:
                    print(f"[warn] validation failed at step {step + 1}:\n"
                          f"{traceback.format_exc()}")
    finally:
        if logger is not None:
            logger.close()
    return state
