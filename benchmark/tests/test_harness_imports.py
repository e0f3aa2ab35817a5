"""What a run loads, and where it refuses to run: after a rehearsal no
module whose top-level name (compared whole) is jax, jaxlib, flax, optax or
videopainter_tpu is loaded; without a card the measurement path exits with
code 2 and prints no result; a checkout of only BENCHMARK.json and the
benchmark's files fails."""

import json
import os
import shutil
import subprocess
import sys

import _paths
import pytest

from vpbench import cli

RUN = [sys.executable, os.path.join(_paths.BENCH, "run.py")]


def _run(args, cwd=_paths.ROOT, env=None):
    return subprocess.run(RUN[:1] + [os.path.join(cwd, "benchmark", "run.py")] + args, cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


@pytest.mark.parametrize("cell", ["i2v-bf16-denoise", "i2v-train-branch"])
def test_rehearsal_loads_no_jax(cell):
    r = _run(["--workload", cell, "--seed", "2147483999", "--rehearse"])
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["rehearsal"] and line["forbidden_modules"] == []
    assert "metrics" not in line


def test_measuring_without_a_card_fails_and_prints_no_result():
    r = _run(["--workload", "i2v-bf16-denoise", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(_paths.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(_paths.ROOT, "BENCHMARK.json"), tmp_path)
    r = _run(["--workload", "i2v-bf16-denoise", "--seed", "1", "--rehearse"], cwd=str(tmp_path),
             env={"PYTHONPATH": ""})
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "videopainter_tpu_torch_like", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert "videopainter_tpu" not in cli.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in cli.forbidden_modules()
