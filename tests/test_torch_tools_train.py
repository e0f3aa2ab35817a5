"""The port's training smoke (videopainter_tpu_torch/tools/smoke_chip_train)
on the CPU at `--smoke` widths (2 layers, 2 heads of 16, 9 x 64 x 96).

- `measure` with `--fixed-noise` gives a finite loss curve that falls at
  every step. The learning rate is 1e-3 here: at the tool's default 1e-5 a
  tiny model's bf16 forward rounds a step's change away. At full width and
  1e-5 the card's AdamW run does not fall at every step: 2.1948, then 4.5069
  after the first update, 1.8502 after the twentieth (TRAIN_SMOKE_cuda.json,
  `bf16_backbone_49f_overfit`). The tool's gate asks only that the last loss
  be below the first, and `measure` raises where it is not (tested here).
- Its first loss equals, bit for bit, `make_branch_train_step`'s first step
  on a second build from the same seed and the same step generator; the
  precomputed-latents and two-level-remat options leave that loss unchanged.
- The ladder records a simulated `torch.OutOfMemoryError` as "OOM" (and a
  timeout as "timeout") and goes on to the next depth.
- The section names equal those the JAX tool writes (its main, run from a
  copy of tools/smoke_chip_train.py with its rungs stubbed) for every flag
  combination.
- LoRA mode with a W8A8 backbone, Adafactor and bf16 weights, with
  `--validate` writing its three PNGs.
"""

import importlib.util
import itertools
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from videopainter_tpu_torch.tools import smoke_chip_train as sct

REPO = Path(__file__).resolve().parents[1]
SMOKE_LR = 1e-3


def run_measure(argv):
    args = sct.parse_args(["--smoke"] + argv)
    t = sct.build(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    return sct.measure(t, args, argv), args


def test_fixed_noise_loss_falls_and_first_loss_matches_the_step():
    from videopainter_tpu_torch.training import (BranchTrainConfig, init_branch_train_state,
                                                 make_branch_train_step)

    (rec, state, metrics), args = run_measure(["--steps", "3", "--fixed-noise", "--lr",
                                               str(SMOKE_LR)])
    curve = rec["loss_curve"]
    assert len(curve) == 4 and np.isfinite(curve).all()
    assert all(b < a for a, b in zip(curve, curve[1:])), curve
    assert rec["loss_first"] == curve[0] and rec["loss_last"] == curve[-1]
    assert state.step == 4 and len(metrics) == 4 and len(rec["step_walls_s"]) == 3
    assert rec["first_step_s"] > 0 and np.isfinite(rec["grad_norm"])
    # the JAX tool's keys, `compile_s` renamed `first_step_s`
    assert {"step_s", "init_s", "loss_first", "loss_last", "loss_curve", "grad_norm", "dims",
            "first_step_s", "peak_memory_gib"} <= set(rec)
    assert rec["dims"].startswith("9f x 64x96, batch 1, bf16 frozen + fp32 branch (adamw)")

    t = sct.build(args, torch.Generator().manual_seed(0), torch.device("cpu"))
    cfg = BranchTrainConfig(height=64, width=96, mask_add=True, remat=True, use_flash=True)
    step = make_branch_train_step(t["transformer"], t["branch"], t["vae"], t["scheduler"],
                                  t["optimizer"], cfg)
    _, m = step(init_branch_train_state(t["trainable"], t["optimizer"]), t["batch"],
                torch.Generator().manual_seed(4))
    assert float(m["total_loss"]) == rec["loss_first"]


def test_fixed_noise_gate_refuses_a_loss_that_does_not_fall():
    """The control of the overfit gate: at lr 0 the loss stays where it was."""
    with pytest.raises(AssertionError, match="overfit gate"):
        run_measure(["--steps", "2", "--fixed-noise", "--lr", "0"])


@pytest.mark.parametrize("flag", [["--precomputed-latents"], ["--remat-chunk", "1"]])
def test_options_keep_the_first_loss(flag):
    (base, _, _), _ = run_measure(["--steps", "0"])
    (rec, _, _), _ = run_measure(["--steps", "0"] + flag)
    assert rec["loss_first"] == base["loss_first"]
    assert rec["precomputed_latents"] == ("--precomputed-latents" in flag)


def test_lora_int8_adafactor_with_validation(tmp_path):
    from PIL import Image

    (rec, state, _), _ = run_measure(["--steps", "1", "--mode", "lora", "--int8-backbone",
                                      "--optimizer", "adafactor", "--bf16-branch", "--validate",
                                      "--validate-steps", "2", "--artifacts", str(tmp_path)])
    assert np.isfinite([rec["loss_first"], rec["loss_last"], rec["grad_norm"]]).all()
    assert "int8 W8A8 frozen" in rec["dims"] and "LoRA" in rec["dims"]
    assert all(ab["lora_A"].dtype == torch.bfloat16 for ab in state.trainable.values())
    val = rec["validation"]
    assert val["finite"] and len(val["frames_png"]) == 3
    for p in val["frames_png"]:
        img = np.asarray(Image.open(p))
        assert img.shape == (64, 3 * 96, 3) and img.dtype == np.uint8


def test_write_png_round_trips(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).random((5, 7, 3))
    sct.write_png(str(tmp_path / "x.png"), rgb)
    got = np.asarray(Image.open(tmp_path / "x.png"))
    np.testing.assert_array_equal(got, (rgb * 255 + 0.5).astype(np.uint8))


# -- the ladder ------------------------------------------------------------------------------

def test_ladder_records_oom_and_goes_on(capsys):
    calls = []

    def runner(cmd, capture_output=True, text=True, timeout=None, cwd=None):
        layers = int(cmd[cmd.index("--layers") + 1])
        calls.append(layers)
        if layers == 42:
            return types.SimpleNamespace(
                returncode=1, stdout="",
                stderr="torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 9 GiB")
        if layers == 32:
            raise subprocess.TimeoutExpired(cmd, timeout)
        return types.SimpleNamespace(returncode=0, stderr="",
                                     stdout=json.dumps({"layers": layers, "ok": True}) + "\n")

    args = sct.parse_args(["--steps", "20", "--fixed-noise"])
    section = sct.ladder(args, runner)
    assert calls == [42, 32, 28]
    assert [r.get("error") for r in section["rungs"]] == ["OOM", "timeout", None]
    assert section["best"] == {"layers": 28, "ok": True}
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == section["rungs"]


def test_ladder_writes_sections(tmp_path, monkeypatch, capsys):
    out = tmp_path / "smoke.json"
    out.write_text(json.dumps({"earlier": {"rungs": [], "best": None}}))
    monkeypatch.setattr(sct, "ladder", lambda args: {"rungs": [{"layers": 42, "ok": True}],
                                                     "best": {"layers": 42, "ok": True}})
    monkeypatch.setattr(sct, "resolve_device", lambda d: torch.device("cpu"))
    assert sct.main(["--steps", "20", "--remat-chunk", "7", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert set(got) == {"earlier", "bf16_backbone_49f_rc7"}
    assert got["bf16_backbone_49f_rc7"]["best"]["layers"] == 42


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """The JAX tool loaded from a copy, so that its TRAIN_SMOKE.json lands
    beside the copy."""
    d = tmp_path_factory.mktemp("jax_tool") / "tools"
    d.mkdir()
    shutil.copy(REPO / "tools" / "smoke_chip_train.py", d / "smoke_chip_train.py")
    spec = importlib.util.spec_from_file_location("jax_smoke_chip_train",
                                                  d / "smoke_chip_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.run_rung = lambda layers, steps, **kw: {"layers": layers, "ok": True}
    return mod, d.parent / "TRAIN_SMOKE.json"


FLAGS = [["--int8-backbone"], ["--optimizer", "adafactor"], ["--bf16-branch"],
         ["--mode", "lora"], ["--fixed-noise"], ["--precomputed-latents"],
         ["--remat-chunk", "7"], ["--frames", "9"]]


def test_section_names_match_the_jax_tool(jax_tool, monkeypatch, capsys):
    mod, path = jax_tool
    for n in range(len(FLAGS) + 1):
        for combo in itertools.combinations(FLAGS, n):
            argv = [a for flag in combo for a in flag]
            if path.exists():
                path.unlink()
            monkeypatch.setattr(sys, "argv", ["smoke_chip_train.py"] + argv)
            mod.main()
            (jax_name,) = json.loads(path.read_text())
            assert sct.section_name(sct.parse_args(argv)) == jax_name, argv
    capsys.readouterr()


def test_rung_argv_round_trips():
    args = sct.parse_args(["--steps", "20", "--int8-backbone", "--optimizer", "adafactor",
                           "--bf16-branch", "--remat-chunk", "7", "--lr", "1e-4"])
    again = sct.parse_args(sct.rung_argv(42, args))
    assert again.layers == 42
    for k in ("steps", "int8_backbone", "optimizer", "bf16_branch", "remat_chunk", "lr",
              "mode", "fixed_noise", "precomputed_latents", "frames", "device"):
        assert getattr(again, k) == getattr(args, k), k
    assert sct.section_name(again) == sct.section_name(args)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        sct.main(["--layers", "2"])
