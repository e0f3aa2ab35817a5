"""The port (videopainter_tpu_torch) stands alone: importing it and every
submodule pulls in neither JAX nor the JAX package, and builds no kernel."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, json, pkgutil, sys
import videopainter_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from videopainter_tpu_torch import _kernels
print(json.dumps({
    "modules": names,
    "bad": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                  or m == "videopainter_tpu" or m.startswith("videopainter_tpu.")),
    "launches": _kernels.LAUNCHES, "libs": sorted(_kernels._LIBS)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 26, res["modules"]
    assert res["bad"] == [], f"the port imported {res['bad']}"
    assert res["launches"] == {"flash_fwd": 0, "flash_int8_fwd": 0,
                               "flash_int8_uniform_fwd": 0} and res["libs"] == []
    for name in ("quantize", "models.lora", "ops.flash_attention_int8",
                 "pipelines.inpaint_anyl", "tools.bench_int8_attn"):
        assert f"videopainter_tpu_torch.{name}" in res["modules"]
