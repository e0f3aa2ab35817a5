"""The CogVideoX1.5-5B-I2V cell, `i2v15-hd-denoise`, on the CPU at its
rehearsal's tiny widths (9 frames: 3 latent frames padded to 4):

- with the program run in float32 (its weights the same bf16 values), one
  recorded step matches `reference/cogvideox15.py` to rounding; in the served
  bf16 the numbers lie within the cell's limits;
- a broken step (a state left unchanged, a dropped CFG half, an altered
  answer) comes out not correct;
- the step's work is counted with 3-D patches: 45,106 tokens at the cell's
  shape, B1's bound 50.6 ms, 3.10e15 operations a step;
- `patch_ms.serve15` reads the kernels launched in `dit.patch` spans of a
  hand-built trace, and nothing where the program opened none;
- the cell reports cell 1's readers of the served step's layers
  (`elementwise_ms.serve`, `adaln_ms.serve`, `attn_prep_ms.serve`,
  `step_idle_ms.serve`), which read a trace in it as they read it in cell 1;
- the driver stops at once where the program's `TransformerConfig` has no
  `patch_size_t` (a program that predates CogVideoX 1.5);
- on the card, set-up soaks it with served steps after the warm-up.
"""

import dataclasses
import json

import _paths  # noqa: F401
import pytest
import torch

from test_harness_faults import altered_answer, dropped_half, unchanged_state
import test_harness_spans as spans
from test_harness_spans import launch, rng
from vpbench import cli, spec, trace
from vpbench.counts import Attn, PEAK_OPS

CELL = "i2v15-hd-denoise"


def run_check(seed, dtype=None):
    cell = spec.load_cell(CELL)
    if dtype is not None:
        cell.config["rehearsal"].setdefault("serving", {})["dtype"] = dtype
    drv = spec.driver(cell.traffic)
    s = drv.setup(cell, seed, torch.device("cpu"), rehearse=True)
    assert drv.window(s, steps=3).steps == 3
    assert s.inputs.pad_frames == 1 and s.inputs.latents.shape[1] == 4
    cli.reference_numerics()
    return cell, s.check()


def test_float32_program_matches_the_reference():
    _, got = run_check(1701, "float32")
    assert all(v < 1e-4 for k, v in got.items() if k != "cfg_share"), got


def test_served_bf16_program_is_within_its_limits():
    cell, got = run_check(1702)
    assert set(cell.checks) <= set(got)
    assert all(0 < got[k] <= cell.checks[k] for k in cell.checks), (got, cell.checks)


@pytest.mark.parametrize("fault", [unchanged_state, dropped_half, altered_answer])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell = spec.load_cell(CELL)
    drv = spec.driver(cell.traffic)
    s = drv.setup(cell, 7, torch.device("cpu"), rehearse=True)
    drv.window(s, steps=3)
    judged = cli.judge(cell.checks, cli.run_check(s))
    assert not all(c["value"] <= c["limit"] for c in judged.values()), judged


def test_the_cells_work_is_counted_with_3d_patches():
    cell = spec.load_cell(CELL)
    drv = spec.driver(cell.traffic)

    class Clip:   # the cell's noise: 21 + 1 latent frames of 96 x 170
        noise0 = torch.empty((1, 22, 96, 170, 16), device="meta")
    s = drv.Session.__new__(drv.Session)
    s.cfg, s.clip = cell.config, Clip()
    w = s.work()
    assert {a.sq for a in w.attns} == {45_106}
    assert Attn(2 * 48, 45_106, 45_106, 64).bound_s() * 1e3 == pytest.approx(50.6, abs=0.05)
    assert w.ops() == pytest.approx(3.10e15, rel=5e-3)
    assert w.bound_s() == pytest.approx(w.ops() / PEAK_OPS["bf16"])


# One served step, 0-500 us: the branch's embed, a block, the DiT's embed and
# head inside `dit.patch`; the block's kernels outside it.
EVENTS = ([rng(trace.WINDOW, 0, 600), rng("denoise.step", 0, 500),
           rng("dit.patch", 10, 40), rng("dit.patch", 300, 330), rng("dit.patch", 450, 480)]
          + launch(1, 12, "nvjet_tst_64x8_64x16", 20, 30)                  # branch patch embed
          + launch(2, 100, "flash_fwd_wgmma_kernel", 100, 250)
          + launch(3, 305, "elementwise_kernel", 310, 320)                 # time embedding
          + launch(4, 455, "vectorized_layer_norm_kernel", 460, 475))      # norm_out


def run_of(tmp_path, events):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return cli.RunView(spec.load_cell(CELL), 1, 6e-4, session=None, trace=trace.parse(str(p)))


def test_patch_ms_reads_the_kernels_launched_in_dit_patch(tmp_path):
    cell = spec.load_cell(CELL)
    assert "patch_ms.serve15" in [m["name"] for m in cell.per_layer]
    read = spec.metric_reader("patch_ms.serve15")
    assert read(run_of(tmp_path, EVENTS)) == pytest.approx((10 + 10 + 15) / 1e3)
    no_span = [e for e in EVENTS if e["name"] != "dit.patch"]
    assert read(run_of(tmp_path, no_span)) is None


@pytest.mark.parametrize("metric", ["elementwise_ms.serve", *spans.SERVE_METRICS])
def test_the_served_layers_are_read_in_the_cell(tmp_path, metric):
    listed = {m["name"]: m.get("workloads") for m in spec.load_cell(CELL).per_layer}
    assert CELL in listed[metric]
    events = spans.SERVE_EVENTS + spans.SERVE_PROGRAM
    got = spans.read(metric, spans.run_of(tmp_path, CELL, events, steps=2))
    assert got is not None
    assert got == spans.read(metric, spans.run_of(tmp_path, spans.SERVE, events, steps=2))


def test_the_driver_refuses_a_program_without_patch_size_t(monkeypatch):
    import videopainter_tpu_torch.config as pcfg

    fields = [(f.name, f.type, f) for f in dataclasses.fields(pcfg.TransformerConfig)
              if f.name != "patch_size_t"]
    old = dataclasses.make_dataclass("TransformerConfig", fields, frozen=True)
    monkeypatch.setattr(pcfg, "TransformerConfig", old)
    cell = spec.load_cell(CELL)
    with pytest.raises(SystemExit, match="no patch_size_t"):
        spec.driver(cell.traffic).setup(cell, 1, torch.device("cpu"), rehearse=True)


@pytest.mark.parametrize("rehearse", [False, True])
def test_set_up_soaks_the_card_after_the_warm_up(monkeypatch, rehearse):
    """On the card, set-up serves steps for SOAK_S seconds after the mix's
    warm-up steps, so the window starts from the steady serving state; a
    rehearsal runs the warm-up alone."""
    from vpbench.drivers import denoise15

    calls = []

    class Recorder:
        def __init__(self, cell, seed, device, rehearse):
            self.tr = cell.traffic

        def run_steps(self, **kw):
            calls.append(kw)

    monkeypatch.setattr(denoise15, "Session", Recorder)
    cell = spec.load_cell(CELL)
    denoise15.setup(cell, 1, torch.device("cpu"), rehearse=rehearse)
    want = [{"steps": cell.traffic["warmup_steps"]}]
    if not rehearse:
        want.append({"seconds": denoise15.SOAK_S})
    assert calls == want
