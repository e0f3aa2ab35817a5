"""The readers of the program's spans (`adaln_ms.serve`,
`attn_prep_ms.serve`, `step_idle_ms.*`, `backward_ms.train`,
`optimizer_ms.train`, `vae_norm_ms.train`) on hand-built Chrome traces: one
of two served steps, one of a training step, each with program ranges,
launches tied to kernels by correlation id, and idle gaps inside and
between the step spans. Each reader gives its value from the kernels
launched in its span, and nothing where the program opened no such span
(as a program without the spans does)."""

import json

import _paths  # noqa: F401
import pytest

from vpbench import cli, spec, trace

SERVE, TRAIN = "i2v-bf16-denoise", "i2v-train-branch"
SERVE_METRICS = ["adaln_ms.serve", "attn_prep_ms.serve", "step_idle_ms.serve"]
TRAIN_METRICS = ["backward_ms.train", "optimizer_ms.train", "vae_norm_ms.train",
                 "step_idle_ms.train"]


def rng(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts}


def launch(corr, t, name, start, end, cat="kernel"):
    """A launch at host time t and the device operation it made."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t, "dur": 2,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": name, "ts": start, "dur": end - start,
             "args": {"correlation": corr}}]


# Two served steps, 0-450 and 500-950 us. Device busy: 30-70, 110-280,
# 320-400, 520-580, 610-740, 900-990; the gap 400-520 lies between the
# steps (midpoint 460), 990-1000 after them.
SERVE_PROGRAM = [rng("denoise.step", 0, 450), rng("denoise.step", 500, 950),
                 rng("dit.adaln", 10, 60), rng("dit.adaln", 510, 560),
                 rng("attn", 100, 300), rng("attn", 600, 800)]
SERVE_EVENTS = (
    [rng(trace.WINDOW, 0, 1000)]
    + launch(1, 20, "vectorized_layer_norm_kernel", 30, 70)          # AdaLN
    + launch(2, 110, "vectorized_layer_norm_kernel", 110, 130)       # QK norm
    + launch(3, 120, "flash_fwd_wgmma_kernel", 130, 230)
    + launch(4, 130, "nvjet_tst_192x192_64x4", 230, 280)             # to_out
    + launch(5, 310, "elementwise_kernel", 320, 400)                 # the feed-forward's
    + launch(6, 520, "vectorized_layer_norm_kernel", 520, 580)       # AdaLN
    + launch(7, 610, "unrolled_elementwise_kernel", 610, 640)        # RoPE
    + launch(8, 620, "flash_fwd_wgmma_kernel", 640, 740)
    + launch(9, 900, "Memcpy DtoD (Device -> Device)", 900, 990, "gpu_memcpy"))

# One training step, 0-850 us: three encodes' worth in one `vae.encode`,
# two `vae.norm`, the backward, the optimizer; the harness's next clip at
# 950-990. Device busy: 30-130, 160-190, 250-350, 410-690, 730-800, 950-990.
TRAIN_PROGRAM = [rng("train.step", 0, 850), rng("vae.encode", 10, 300),
                 rng("vae.norm", 20, 100), rng("vae.norm", 150, 200),
                 rng("train.backward", 400, 700), rng("train.optimizer", 720, 840)]
TRAIN_EVENTS = (
    [rng(trace.WINDOW, 0, 1000)]
    + launch(1, 30, "RowwiseMomentsCUDAKernel", 30, 130)             # GroupNorm statistics
    + launch(2, 160, "elementwise_kernel", 160, 190)                 # SiLU
    + launch(3, 250, "sm90_xmma_fprop_implicit_gemm", 250, 350)      # conv
    + launch(4, 410, "flash_dkv_wgmma_kernel", 410, 600)
    + launch(5, 420, "nvjet_tst_128x272", 600, 690)
    + launch(6, 730, "multi_tensor_apply_kernel", 730, 780)
    + launch(7, 740, "elementwise_kernel", 780, 800)
    + launch(8, 950, "normal_kernel", 950, 990))                     # the next clip's draw


def run_of(tmp_path, cell, events, steps):
    p = tmp_path / f"{cell}.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return cli.RunView(spec.load_cell(cell), steps, 1e-3, session=None,
                       trace=trace.parse(str(p)))


def read(metric, run):
    return spec.metric_reader(metric)(run)


def test_the_span_metrics_are_the_cells_own():
    serve = [m["name"] for m in spec.load_cell(SERVE).per_layer]
    train = [m["name"] for m in spec.load_cell(TRAIN).per_layer]
    assert set(SERVE_METRICS) <= set(serve) and not set(TRAIN_METRICS) & set(serve)
    assert set(TRAIN_METRICS) <= set(train) and not set(SERVE_METRICS) & set(train)


@pytest.mark.parametrize("metric,ms", [
    ("adaln_ms.serve", (40 + 60) / 2e3),        # the two AdaLN launches
    ("attn_prep_ms.serve", (20 + 30) / 2e3),    # QK norm and RoPE; not flash, not GEMM
    ("step_idle_ms.serve", (30 + 40 + 40 + 30 + 160) / 2e3)])   # not 400-520, not 990-1000
def test_serving_readers(tmp_path, metric, ms):
    run = run_of(tmp_path, SERVE, SERVE_EVENTS + SERVE_PROGRAM, steps=2)
    assert read(metric, run) == pytest.approx(ms)


@pytest.mark.parametrize("metric,ms", [
    ("backward_ms.train", (190 + 90) / 1e3),
    ("optimizer_ms.train", (50 + 20) / 1e3),
    ("vae_norm_ms.train", (100 + 30) / 1e3),    # not the conv launched in the encode
    ("step_idle_ms.train", (30 + 30 + 60 + 60 + 40) / 1e3)])    # not 800-950, 990-1000
def test_training_readers(tmp_path, metric, ms):
    run = run_of(tmp_path, TRAIN, TRAIN_EVENTS + TRAIN_PROGRAM, steps=1)
    assert read(metric, run) == pytest.approx(ms)


@pytest.mark.parametrize("cell,metric", [(SERVE, m) for m in SERVE_METRICS]
                         + [(TRAIN, m) for m in TRAIN_METRICS])
def test_readers_find_nothing_without_the_programs_spans(tmp_path, cell, metric):
    events = SERVE_EVENTS if cell == SERVE else TRAIN_EVENTS
    run = run_of(tmp_path, cell, events, steps=1)
    assert read(metric, run) is None
    assert read(metric, cli.RunView(spec.load_cell(cell), 1, 1e-3, None, None)) is None


def test_a_span_that_launched_nothing_reads_zero(tmp_path):
    run = run_of(tmp_path, TRAIN, TRAIN_EVENTS + [rng("train.optimizer", 860, 870)], steps=1)
    assert read("optimizer_ms.train", run) == 0.0
