"""The port's spans (`videopainter_tpu_torch/utils/profiling.py` `annotate`)
on the CPU at tiny widths.

- With no profiler active a span is one shared null context, whatever its
  name; under a profiler it is a `record_function` range of that name.
- Under a CPU `torch.profiler`, the denoise loop writes one `denoise.step` a
  step, closed before the caller's `progress_fn`, with every DiT and branch
  block's two `dit.adaln` and one `attn` inside it.
- A branch-SFT step writes `train.step` holding, in this order, the VAE
  prep's `vae.encode` spans (each holding `vae.norm` spans), `train.backward`
  (with the checkpoints' recompute reopening `dit.adaln` and `attn`) and
  `train.optimizer`.
- The loop's latents and the step's updated branch are bit-identical with
  and without the profiler.
"""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videopainter_tpu_torch.config import SchedulerConfig, TransformerConfig
from videopainter_tpu_torch.flagship import build_models
from videopainter_tpu_torch.pipelines.common import (DenoiseConfig, DenoiseInputs,
                                                     make_denoise_fn, prepare_rope)
from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler
from videopainter_tpu_torch.tools import smoke_chip_train as sct
from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                             make_branch_train_step)
from videopainter_tpu_torch.utils import annotate


SPANS = ("denoise.step", "dit.adaln", "attn", "train.step", "train.backward",
         "train.optimizer", "vae.encode", "vae.norm")
STEPS = 3
DIT_LAYERS, BRANCH_LAYERS = 2, 2
LAT = (1, 3, 4, 6, 16)   # [B, T, h, w, C] latents of a 9 x 32 x 48 clip


def spans_of(prof) -> dict:
    """{name: [(start, end), ...]} of the port's spans in a finished profile,
    in microseconds, by start."""
    out = {}
    for e in prof.events():
        if e.name in SPANS:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def inside(span, outer) -> bool:
    return outer[0] <= span[0] and span[1] <= outer[1]


def profiled(fn):
    """fn() under a CPU profiler: (its result, the spans it wrote)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, spans_of(prof)


# -- the primitive ----------------------------------------------------------------

def test_a_span_without_a_profiler_is_one_shared_null_context():
    a, b = annotate("denoise.step"), annotate("vae.norm")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:   # reentrant: spans nest
            pass


def test_a_span_under_a_profiler_is_a_range_of_its_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = annotate("attn")
        with span:
            torch.ones(4).add_(1)
    assert not isinstance(span, contextlib.nullcontext)
    assert len(spans_of(prof)["attn"]) == 1
    assert annotate("attn") is annotate("dit.adaln")   # off again once the profiler ends


# -- the denoise loop --------------------------------------------------------------

@pytest.fixture(scope="module")
def denoise_case():
    """A tiny dual-mode loop (DiT and branch of two blocks each, batched CFG,
    replace_gt) and its inputs."""
    tcfg = TransformerConfig.tiny(in_channels=16, out_channels=16, sample_height=8,
                                  sample_width=12, num_layers=DIT_LAYERS)
    dit, branch = build_models(torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.float32, tcfg=tcfg, branch_layers=BRANCH_LAYERS)
    sched = CogVideoXDPMScheduler(SchedulerConfig.cogvideox_5b_inference())
    g = torch.Generator().manual_seed(1)
    arr = lambda *s: torch.randn(s, generator=g)   # noqa: E731
    mask = torch.zeros(LAT[:4])
    mask[:, :, 1:3, 2:5] = 1
    inputs = DenoiseInputs(latents=arr(*LAT), image_latents=arr(*LAT),
                           masked_video_latents=arr(*LAT), mask=mask,
                           prompt_embeds=arr(2, 5, 12), noise=arr(*LAT),
                           video_latents=arr(*LAT))
    dcfg = DenoiseConfig(num_inference_steps=STEPS, do_cfg=True, use_dynamic_cfg=True,
                         guidance_scale=6.0, conditioning_scale=1.0, replace_gt=True,
                         mask_add=True, mask_background=False, add_first=False, mode="dual")
    marks = []

    def progress(i):
        with torch.profiler.record_function("progress"):
            marks.append(i)

    fn = make_denoise_fn(dit, branch, sched, dcfg, sched.timesteps(STEPS), progress_fn=progress)
    rope = prepare_rope(tcfg, 32, 48, LAT[1])
    run = lambda: fn(inputs, rope, torch.Generator().manual_seed(2))[0]   # noqa: E731
    return run, marks


def test_denoise_writes_a_step_span_holding_each_blocks_adaln_and_attention(denoise_case):
    run, _ = denoise_case
    _, spans = profiled(run)
    steps = spans["denoise.step"]
    assert len(steps) == STEPS
    blocks = DIT_LAYERS + BRANCH_LAYERS
    for name, per_block in (("dit.adaln", 2), ("attn", 1)):
        assert len(spans[name]) == STEPS * per_block * blocks, name
        for step in steps:
            assert sum(inside(s, step) for s in spans[name]) == per_block * blocks, name
    assert not {"train.step", "vae.encode"} & set(spans)


def test_denoise_step_span_closes_before_progress_fn(denoise_case):
    run, marks = denoise_case
    marks.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    progress = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.name == "progress")
    steps = spans_of(prof)["denoise.step"]
    assert marks == list(range(STEPS)) and len(progress) == STEPS
    for step, mark in zip(steps, progress):
        assert step[1] <= mark[0]


def test_denoise_latents_are_bit_identical_under_the_profiler(denoise_case):
    run, _ = denoise_case
    plain = run()
    traced, _ = profiled(run)
    assert torch.equal(plain, traced)


# -- the training step ---------------------------------------------------------------

def train_once():
    """One branch-SFT step (remat, 9 x 64 x 96, the smoke tool's widths) on a
    fresh build from seed 0; returns the updated branch leaves."""
    args = sct.parse_args(["--smoke"])
    t = sct.build(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    cfg = BranchTrainConfig(height=args.height, width=args.width, mask_add=True, remat=True,
                            use_flash=True)
    step = make_branch_train_step(t["transformer"], t["branch"], t["vae"], t["scheduler"],
                                  t["optimizer"], cfg)
    state = init_branch_train_state(t["trainable"], t["optimizer"])
    state, _ = step(state, t["batch"], torch.Generator().manual_seed(4))
    return {k: v.detach().clone() for k, v in state.trainable.items()}


@pytest.fixture(scope="module")
def train_runs():
    plain = train_once()
    traced, spans = profiled(train_once)
    return plain, traced, spans


def test_train_step_spans_nest_in_order(train_runs):
    _, _, spans = train_runs
    (step,), (bwd,), (opt,) = (spans[n] for n in ("train.step", "train.backward",
                                                   "train.optimizer"))
    encodes = spans["vae.encode"]
    assert len(encodes) == 3   # the noised first frame, the video, the masked video
    assert all(inside(s, step) for s in encodes + [bwd, opt])
    assert max(e[1] for e in encodes) <= bwd[0] and bwd[1] <= opt[0]
    norms = spans["vae.norm"]
    assert norms and all(any(inside(n, e) for e in encodes) for n in norms)
    # each encode holds the same norms: (2 a resnet block + norm_out) per encoder call
    assert len({sum(inside(n, e) for n in norms) for e in encodes[1:]}) == 1
    # the per-block checkpoints rerun the blocks' forward inside the backward
    for name in ("dit.adaln", "attn"):
        assert any(inside(s, bwd) for s in spans[name]), name


def test_train_step_update_is_bit_identical_under_the_profiler(train_runs):
    plain, traced, _ = train_runs
    assert plain.keys() == traced.keys()
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
