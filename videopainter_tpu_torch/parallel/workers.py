"""Rank functions for `launch.run_local`: the multi-rank checks of the CPU
tests (`tests/test_torch_parallel.py`, `tests/test_torch_ring_attention.py`,
`tests/test_torch_parallel_training.py`) and of chip_smoke.py's phase 13.

Each takes one picklable spec (plain dicts, numpy arrays, config dicts),
builds what it needs on its rank, runs it on a mesh of the spec's shape
(`spec["mesh"]` = (data, seq, model)), or without a mesh when that is None
(the one-process reference, called directly), and returns numpy arrays and
counts. They import torch and this package only.

Models come from `spec["models"]`: {"tcfg": TransformerConfig dict, "bcfg":
BranchConfig dict or None, "vcfg": VAEConfig dict or None, "dtype":
"float32" | "bfloat16"} plus either "state" ({"transformer", "branch",
"vae"}: numpy state dicts, e.g. from `convert.from_jax`) or "seed" (seeded
random weights made on the device, the branch initialised from the
backbone, `bias_std` > 0 also drawing the block biases, which
`init_random_` leaves at zero). "quantize": W8A8 block projections
(`quantize.quantize_transformer_int8`).

Inputs may be seeded instead of given: `spec["clip"]` (pipeline_rank),
`spec["inputs"]["seed"]` (dit_rank) and `spec["batch"]["seed"]` (train_rank)
draw them on the device from a generator (`flagship.random_clip`), so a
full-size input never travels to the ranks.

`spec["control"]` breaks one rule of the tensor-parallel code on purpose,
for a check whose limit the break must fail: "bias_every_rank" adds a
row-parallel bias on every rank before the sum; "local_amax" quantizes a
row-parallel W8A8 input with its local amax, without the MAX over `model`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import _kernels
from . import comm
from .mesh import AXES, axis_rank, axis_size, make_mesh, use_mesh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().float().cpu().numpy()


def _t(x, device, dtype=None):
    t = x.to(device) if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def setup(spec: Dict):
    """(device, mesh or None) of a rank: the card of the spec's device, a
    mesh of the spec's shape when there is one."""
    device = torch.device(spec.get("device", "cpu"))
    if device.type == "cuda":
        from .. import set_numerics
        torch.cuda.set_device(0)
        set_numerics(conv_tf32=True)
    torch.manual_seed(0)
    mesh = None
    if spec.get("mesh") is not None:
        mesh = make_mesh(*spec["mesh"], device=device.type)
    return device, mesh


def build_models(spec: Dict, device):
    """(transformer, branch or None, vae or None) as `spec["models"]` says."""
    from ..config import BranchConfig, TransformerConfig, VAEConfig
    from ..models import AutoencoderKLCogVideoX, CogVideoXBranch, CogVideoXTransformer3D

    m = spec["models"]
    dtype = _DTYPES[m.get("dtype", "float32")]
    tcfg = TransformerConfig.from_dict(m["tcfg"])
    ctors = {"transformer": lambda **kw: CogVideoXTransformer3D(tcfg, **kw)}
    if m.get("bcfg") is not None:
        bcfg = BranchConfig.from_dict(m["bcfg"])
        ctors["branch"] = lambda **kw: CogVideoXBranch(bcfg, **kw)
    if m.get("vcfg") is not None:
        vcfg = VAEConfig.from_dict(m["vcfg"])
        ctors["vae"] = lambda **kw: AutoencoderKLCogVideoX(vcfg, **kw)
    dtypes = {k: dtype for k in ctors}
    if m.get("branch_dtype"):
        dtypes["branch"] = _DTYPES[m["branch_dtype"]]
    out = {}
    if "state" in m:
        for k, ctor in ctors.items():
            mod = ctor(device=device, dtype=dtypes[k])
            mod.load_state_dict({n: torch.as_tensor(np.asarray(v))
                                 for n, v in m["state"][k].items()}, strict=False)
            out[k] = mod
    else:
        gen = torch.Generator(device=device).manual_seed(m["seed"])
        for k, ctor in ctors.items():
            mod = ctor(device="meta", dtype=dtypes[k]).to_empty(device=device)
            out[k] = mod.init_random_(gen)
        if "branch" in out:
            out["branch"].init_from_transformer(out["transformer"])
            for lin in out["branch"].branch_blocks:   # a trained branch's are not zero
                lin.weight.data.normal_(0.0, m.get("branch_proj_std", 0.02), generator=gen)
        if m.get("bias_std"):
            with torch.no_grad():
                for k in ("transformer", "branch"):
                    for name, p in out.get(k, torch.nn.Module()).named_parameters():
                        if "transformer_blocks" in name and name.endswith("bias"):
                            p.normal_(0.0, m["bias_std"], generator=gen)
    if m.get("quantize"):
        from ..quantize import quantize_transformer_int8
        out["transformer"] = quantize_transformer_int8(out["transformer"], free_source=True)
    return out["transformer"], out.get("branch"), out.get("vae")


@contextlib.contextmanager
def control(name: Optional[str]):
    """Break one tensor-parallel rule for the duration (module note)."""
    if name is None:
        yield
        return
    from ..ops import basic

    saved = (basic._tp_out, comm.all_reduce_)
    if name == "bias_every_rank":
        def tp_out(tp, y, bias):
            if tp is not None and tp.kind == "row":
                y = y if bias is None else y + bias.to(y.dtype)
                return comm.reduce_from(y, tp.group)
            return y if bias is None else y + bias.to(y.dtype)
        basic._tp_out = tp_out
    elif name == "local_amax":
        real = comm.all_reduce_

        def all_reduce_(x, group, op="sum"):
            return x if op == "max" else real(x, group, op)
        comm.all_reduce_ = all_reduce_
    else:
        raise ValueError(f"unknown control {name!r}")
    try:
        yield
    finally:
        basic._tp_out, comm.all_reduce_ = saved


def _shard(mesh, *modules):
    from .sharding import shard_params
    for mod in modules:
        if mesh is not None and mod is not None:
            shard_params(mod, mesh)


def _report(out: Dict, mesh) -> Dict:
    out["comm"] = {k: dict(v) for k, v in comm.COUNTS.items()}
    out["routes"] = dict(comm.ROUTES)
    out["launches"] = dict(_kernels.LAUNCHES)
    out["rank"] = dist.get_rank() if dist.is_initialized() else 0
    return out


def _clip(c: Dict, device, b: int = 1) -> Dict:
    """`b` seeded clips (`flagship.random_clip`) stacked: video, masks, image,
    prompt and negative prompt embeddings."""
    from ..flagship import random_clip

    gen = torch.Generator(device=device).manual_seed(c["seed"])
    clips = [random_clip(gen, frames=c["frames"], height=c["height"], width=c["width"],
                         text_len=c["text_len"], text_dim=c["text_dim"], device=device)
             for _ in range(b)]
    return {k: torch.cat([x[k] for x in clips]) for k in clips[0]}


def _scheduler(spec):
    from ..config import SchedulerConfig
    from ..schedulers import CogVideoXDDIMScheduler, CogVideoXDPMScheduler

    kind, cfg = spec.get("scheduler", ("dpm", None))
    scfg = SchedulerConfig.from_dict(cfg) if cfg else SchedulerConfig.cogvideox_5b_inference()
    return (CogVideoXDPMScheduler if kind == "dpm" else CogVideoXDDIMScheduler)(scfg)


def pipeline_rank(spec: Dict) -> Dict:
    """The dual-stream pipeline on this rank (`spec["pipeline"]`: "single",
    the default, or "anyl", the any-length one): the backbone and branch
    tensor-parallel over the mesh's `model` axis, `spec["seq"]` ("seq" for
    sequence parallelism, "ring" for ring attention, None), `spec["call"]`
    the pipeline's keyword arguments (numpy arrays, or lists of them; a
    `generator_seed` becomes the generator). Returns {"out": the whole
    result, "comm", "launches", ...}."""
    from ..pipelines import CogVideoXI2VDualInpaintAnyLPipeline, CogVideoXI2VDualInpaintPipeline

    device, mesh = setup(spec)
    transformer, branch, vae = build_models(spec, device)
    _shard(mesh, transformer, branch)
    cls = (CogVideoXI2VDualInpaintAnyLPipeline if spec.get("pipeline") == "anyl"
           else CogVideoXI2VDualInpaintPipeline)
    pipe = cls(transformer, branch, vae, _scheduler(spec), device=device)
    dtype = _DTYPES[spec["models"].get("dtype", "float32")]
    call = {}
    for k, v in spec["call"].items():
        if isinstance(v, np.ndarray):
            v = _t(v, device, dtype)
        elif isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            v = [_t(x, device, dtype) for x in v]
        call[k] = v
    if spec.get("clip") is not None:
        clip = _clip(spec["clip"], device)
        call.update(video=clip["video"].to(dtype), masks=clip["masks"].to(dtype),
                    image=clip["image"].to(dtype),
                    prompt_embeds=clip["prompt_embeds"].to(dtype),
                    negative_prompt_embeds=clip["negative_prompt_embeds"].to(dtype))
    if "generator_seed" in call:
        call["generator"] = torch.Generator(device=device).manual_seed(call.pop("generator_seed"))
    seq = spec.get("seq")
    if seq is not None:
        call["seq_axis"] = AXES.seq
        if seq == "ring":
            call["ring_mesh"] = mesh
    comm.reset_counts()
    _kernels.reset_launches()
    with control(spec.get("control")), \
            (use_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        out = pipe(dtype=dtype, **call)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out = out if isinstance(out, np.ndarray) else _np(out)
    return _report({"out": out}, mesh)


def dit_rank(spec: Dict) -> Dict:
    """One backbone forward on this rank (`spec["inputs"]`: hidden, text,
    timestep, and the optional rope), tensor-parallel over `model`,
    sequence-parallel per `spec["seq"]`, `spec["use_flash"]`; with
    `spec["grad"]` also the gradient of sum(sample^2) w.r.t. the hidden
    input (summed over `seq`: each rank holds its share)."""
    device, mesh = setup(spec)
    transformer, _, _ = build_models(spec, device)
    _shard(mesh, transformer)
    dtype = _DTYPES[spec["models"].get("dtype", "float32")]
    inp = spec["inputs"]
    if "seed" in inp:
        gen = torch.Generator(device=device).manual_seed(inp["seed"])
        inp = dict(inp, hidden=torch.randn(inp["hidden_shape"], generator=gen, device=device),
                   text=torch.randn(inp["text_shape"], generator=gen, device=device))
    hidden = _t(inp["hidden"], device, dtype).requires_grad_(bool(spec.get("grad")))
    text = _t(inp["text"], device, dtype)
    t = _t(inp["timestep"], device)
    rope = None if inp.get("rope") is None else tuple(_t(r, device) for r in inp["rope"])
    kw = dict(rope=rope, use_flash=spec.get("use_flash", False))
    seq = spec.get("seq")
    if seq is not None:
        kw["seq_axis"] = AXES.seq
        if seq == "ring":
            kw["ring_mesh"] = mesh
    comm.reset_counts()
    _kernels.reset_launches()
    with control(spec.get("control")), \
            (use_mesh(mesh) if mesh is not None else contextlib.nullcontext()), \
            torch.set_grad_enabled(bool(spec.get("grad"))):
        sample = transformer(hidden, text, t, **kw).sample
        out = {"sample": _np(sample)}
        if spec.get("grad"):
            (sample.float() ** 2).sum().backward()
            g = hidden.grad
            if mesh is not None and axis_size(mesh, AXES.seq) > 1:
                comm.all_reduce_(g, mesh.get_group(AXES.seq))
            out["grad_hidden"] = _np(g)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return _report(out, mesh)


def ring_rank(spec: Dict) -> Dict:
    """`ring_joint_attention` (or `ring_attention` without text) on this
    rank's shard of the numpy q / k / v [B, H, S_text + S_vid, D]; with
    `spec["dout"]` also the gradients, each rank's share of the text ones
    (sum them over the ranks). Returns this rank's outputs and gradients."""
    from .ring_attention import ring_attention, ring_joint_attention

    device, mesh = setup(spec)
    n, r = axis_size(mesh, AXES.seq), axis_rank(mesh, AXES.seq)
    dtype = _DTYPES[spec.get("dtype", "float32")]
    st = spec["text_len"]
    full = {k: _t(spec[k], device, dtype) for k in ("q", "k", "v")}
    sv = full["q"].shape[2] - st
    lo, hi = r * sv // n, (r + 1) * sv // n
    text = {k: x[:, :, :st].clone().requires_grad_() for k, x in full.items()}
    vid = {k: x[:, :, st + lo:st + hi].clone().requires_grad_() for k, x in full.items()}
    use_flash = spec.get("use_flash", False)
    comm.reset_counts()
    _kernels.reset_launches()
    if st:
        out_t, out_v = ring_joint_attention(text["q"], vid["q"], text["k"], vid["k"],
                                            text["v"], vid["v"], mesh, use_flash=use_flash)
    else:
        out_t, out_v = None, ring_attention(vid["q"], vid["k"], vid["v"], mesh,
                                            use_flash=use_flash)
    out = {"out_text": _np(out_t), "out_vid": _np(out_v), "lo": lo, "hi": hi}
    if spec.get("dout") is not None:
        dout = _t(spec["dout"], device, dtype)
        loss = (out_v * dout[:, :, st + lo:st + hi]).sum()
        if st:   # the replicated text output: each rank carries 1/n of its loss
            loss = loss + (out_t * dout[:, :, :st]).sum() / n
        loss.backward()
        out["grads_vid"] = {k: _np(x.grad) for k, x in vid.items()}
        if st:
            out["grads_text"] = {k: _np(x.grad) for k, x in text.items()}
    return _report(out, mesh)


def _batch(batch: Dict, device, dtype) -> Dict:
    """A training batch: given (numpy) or seeded ({"seed", "b", clip sizes})."""
    if "seed" not in batch:
        return {k: _t(v, device, dtype) for k, v in batch.items()}
    clip = _clip(batch, device, batch["b"])
    keep = 1 - clip["masks"][..., None]
    return {"pixel_values": clip["video"].to(dtype),
            "conditioning_pixel_values": (clip["video"] * keep).to(dtype),
            "masks": clip["masks"].to(dtype), "prompt_embeds": clip["prompt_embeds"].to(dtype)}


def _checksum(params) -> int:
    """An order-free integer hash of the bits of a list of tensors (equal
    bits, equal hash)."""
    total = 0
    for p in params:
        bits = p.detach().contiguous().view(-1).view(torch.int32 if p.element_size() == 4
                                                    else torch.int16).long()
        w = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.long) % 65521 + 1
        total = (total + int((bits * w).sum().item())) % (1 << 61)
    return total


def train_rank(spec: Dict) -> Dict:
    """Branch-SFT steps on this rank: `spec["batch"]` the global batch
    (numpy), `spec["bcfg"]` BranchTrainConfig keywords, `spec["steps"]`,
    `spec["optimizer"]` make_optimizer keywords, `spec["generator_seed"]`,
    `spec["seq"]` as in `dit_rank`. Returns each step's metrics, the first
    step's synced gradient (flattened, rank 0 only unless
    `spec["all_grads"]`), a checksum of the parameters after each step, the
    optimizer state's element count on this rank and the final
    parameters (`spec["return_params"]`)."""
    from ..training import BranchTrainConfig, init_branch_train_state, make_branch_train_step
    from ..training.optim import make_optimizer

    device, mesh = setup(spec)
    transformer, branch, vae = build_models(spec, device)
    _shard(mesh, transformer, branch)
    dtype = _DTYPES[spec.get("batch_dtype", spec["models"].get("dtype", "float32"))]
    batch = _batch(spec["batch"], device, dtype)
    cfg_kw = dict(spec["bcfg"])
    ring_mesh = None
    if spec.get("seq") is not None:
        cfg_kw["seq_axis"] = AXES.seq
        ring_mesh = mesh if spec["seq"] == "ring" else None
    cfg = BranchTrainConfig(**cfg_kw)
    opt = make_optimizer(**spec.get("optimizer", {}))
    state = init_branch_train_state(branch, opt, mesh)
    step = make_branch_train_step(transformer, branch, vae, _scheduler(spec), opt, cfg,
                                  ring_mesh=ring_mesh, mesh=mesh)
    grads = []
    update = opt.update_

    def recording_update(params, g, st):
        if not grads:
            grads.append(torch.cat([x.detach().float().reshape(-1) for x in g]).cpu())
        return update(params, g, st)
    opt.update_ = recording_update
    gen = torch.Generator(device=device).manual_seed(spec.get("generator_seed", 0))
    comm.reset_counts()
    _kernels.reset_launches()
    metrics, sums = [], []
    leaves = [state.trainable[k] for k in sorted(state.trainable)]
    for _ in range(spec.get("steps", 1)):
        state, m = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        sums.append(_checksum(leaves))
    if device.type == "cuda":
        torch.cuda.synchronize()
    rank = dist.get_rank() if dist.is_initialized() else 0
    opt_numel = sum(t.numel() for v in state.opt_state.values() if isinstance(v, list)
                    for t in v if torch.is_tensor(t))
    out = {"metrics": metrics, "checksums": sums, "opt_numel": opt_numel,
           "grad": grads[0].numpy() if (rank == 0 or spec.get("all_grads")) else None}
    if spec.get("return_params"):
        from ..training.trainer import full_state_dict
        out["params"] = {k: v.float().cpu().numpy() for k, v in full_state_dict(branch).items()
                         if k in state.trainable}
    return _report(out, mesh)


def trainer_rank(spec: Dict) -> Dict:
    """`training.trainer.train(mesh=...)` on this rank (the loop as users run
    it: checkpoints, resume), with `spec` as `train_rank`'s plus
    "trainer" (TrainerConfig keywords). Returns the final parameters (whole),
    the per-step log (rank 0's train_log.jsonl) and the optimizer state's
    element count on this rank."""
    import json
    import os

    from ..training import BranchTrainConfig
    from ..training.trainer import TrainerConfig, full_state_dict, train

    device, mesh = setup(spec)
    transformer, branch, vae = build_models(spec, device)
    dtype = _DTYPES[spec.get("batch_dtype", spec["models"].get("dtype", "float32"))]
    batch = _batch(spec["batch"], device, dtype)
    cfg_kw = dict(spec["bcfg"])
    if spec.get("seq") is not None:
        cfg_kw["seq_axis"] = AXES.seq
    tcfg = TrainerConfig(**spec["trainer"])

    def batches():
        while True:
            yield batch
    comm.reset_counts()
    _kernels.reset_launches()
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        state = train(transformer, branch, vae, _scheduler(spec), batches(), tcfg,
                      BranchTrainConfig(**cfg_kw), initial_trainable=branch, mesh=mesh)
    params = full_state_dict(branch) if mesh is not None else branch.state_dict()
    log_path = os.path.join(tcfg.output_dir, "train_log.jsonl")
    log = [json.loads(line) for line in open(log_path)] if os.path.exists(log_path) else []
    opt_numel = sum(t.numel() for v in state.opt_state.values() if isinstance(v, list)
                    for t in v if torch.is_tensor(t))
    out = {"params": {k: v.float().cpu().numpy() for k, v in params.items()
                      if k in state.trainable},
           "log": log, "opt_numel": opt_numel, "step": int(state.step),
           "checksum": _checksum([state.trainable[k] for k in sorted(state.trainable)])}
    return _report(out, mesh)


def cli_rank(argv) -> Dict:
    """The training CLI's `main(argv)` on this rank (the process group is
    already up, as torchrun's would be)."""
    import os

    from ..training import cli
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        state = cli.main(list(argv))
    return {"step": int(state.step), "rank": dist.get_rank(),
            "checksum": _checksum([state.trainable[k] for k in sorted(state.trainable)])}


def mesh_rank(shape) -> Dict:
    """The mesh of `shape` on this rank: its dims, this rank's coordinates,
    the sizes of its groups, and a sum over each axis."""
    mesh = make_mesh(*shape, device="cpu")
    out = {"names": tuple(mesh.mesh_dim_names), "shape": tuple(mesh.shape),
           "coords": tuple(axis_rank(mesh, a) for a in mesh.mesh_dim_names)}
    for a in mesh.mesh_dim_names:
        x = torch.tensor([float(dist.get_rank())])
        out[f"sum_{a}"] = float(comm.all_reduce_(x, mesh.get_group(a))[0])
    return out


class _GradTap:
    """Stands in for the optimizer: keeps the (synced) gradients."""
    zero = None

    def init(self, params, names=None, zero=None):
        return {}

    def update_(self, params, grads, state):
        self.grads = [g.detach().clone() for g in grads]
        return state


def grad_step_rank(spec: Dict) -> Dict:
    """The branch grad step on this rank, on prepared global tensors
    (`spec["prepared"]`: noisy, image latents, branch cond, latent mask,
    model input, timesteps, numpy) and `spec["embeds"]`: the rank takes its
    `data` slice, runs the step (`spec["seq"]`, `spec["bcfg"]`) and returns
    the metrics and the synced gradients by name, tensor-parallel ones
    gathered whole. With `spec["lora"]` ({target: {"lora_A", "lora_B"}},
    numpy, whole) the ID-LoRA step instead, gradients named
    "<target>.<factor>"."""
    from ..pipelines.common import prepare_rope
    from ..training import (BranchTrainConfig, init_branch_train_state, make_branch_train_step,
                            make_lora_train_step)
    from .sharding import gather_tp, tp_slot

    device, mesh = setup(spec)
    transformer, branch, vae = build_models(spec, device)
    _shard(mesh, transformer, branch)
    cfg_kw = dict(spec["bcfg"])
    ring_mesh = None
    if spec.get("seq") is not None:
        cfg_kw["seq_axis"] = AXES.seq
        ring_mesh = mesh if spec["seq"] == "ring" else None
    cfg = BranchTrainConfig(**cfg_kw)
    tap = _GradTap()
    if spec.get("lora") is not None:
        tree = {t: {k: _t(v, device) for k, v in ab.items()} for t, ab in spec["lora"].items()}
        state = init_branch_train_state(tree, tap, mesh)
        step = make_lora_train_step(transformer, branch, vae, _scheduler(spec), tap, cfg,
                                    ring_mesh=ring_mesh, mesh=mesh)
        names = [f"{t}.{k}" for t in sorted(tree) for k in sorted(tree[t])]
    else:
        state = init_branch_train_state(branch, tap, mesh)
        step = make_branch_train_step(transformer, branch, vae, _scheduler(spec), tap, cfg,
                                      ring_mesh=ring_mesh, mesh=mesh)
        names = sorted(state.trainable)
    prep = [_t(x, device) for x in spec["prepared"]]
    embeds = _t(spec["embeds"], device)
    if mesh is not None and axis_size(mesh, AXES.data) > 1:
        n, r = axis_size(mesh, AXES.data), axis_rank(mesh, AXES.data)
        b = embeds.shape[0]
        prep = [x[r * b // n:(r + 1) * b // n] for x in prep]
        embeds = embeds[r * b // n:(r + 1) * b // n]
    rope = prepare_rope(transformer.cfg, cfg.height, cfg.width, prep[4].shape[1],
                        vae.cfg.spatial_compression_ratio, device=device)
    comm.reset_counts()
    with (use_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        _, m = step.grad_step(state, *prep, embeds, rope)
    grads = {}
    for name, g in zip(names, tap.grads):
        slot = tp_slot(branch, name) if mesh is not None and spec.get("lora") is None else None
        grads[name] = _np(g if slot is None else gather_tp(g, *slot))
    return _report({"metrics": {k: float(v) for k, v in m.items()}, "grads": grads}, mesh)


def cases_rank(cases) -> list:
    """Several rank functions in a row on one set of ranks:
    [(name of a function of this module, its spec), ...] -> their results."""
    out = []
    for name, spec in cases:
        out.append(globals()[name](spec))
        if torch.cuda.is_available():   # the case's models go back to the allocator
            import gc
            gc.collect()
            torch.cuda.empty_cache()
    return out
