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
    "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "videopainter_tpu", "optax", "orbax",
                                         "flax")),
    "launches": _kernels.LAUNCHES, "libs": sorted(_kernels._LIBS)}))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(res["modules"]) >= 90, res["modules"]
    assert res["bad"] == [], f"the port imported {res['bad']}"
    assert res["launches"] == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                               "flash_int8_fwd": 0, "flash_int8_uniform_fwd": 0,
                               "connected_components": 0, "qk_norm_rope": 0,
                               "qk_norm_rope_bwd": 0, "group_norm_stats": 0,
                               "group_norm_apply": 0, "adaln_fwd": 0, "adaln_bwd": 0}
    assert res["libs"] == []
    for name in ("quantize", "models.lora", "ops.flash_attention_int8", "ops.qk_prep",
                 "pipelines.inpaint_anyl", "tools.bench_int8_attn", "schedulers.ddim",
                 "training", "training.train_branch", "training.optim", "training.masks",
                 "training.data", "training.checkpoint", "training.trainer",
                 "training.validation", "training.cli", "models.text_encoder", "models.vae",
                 "flagship", "infer.inpaint", "infer.edit", "infer.first_frame",
                 "pipelines.variants", "pipelines.generation", "utils.profiling",
                 "convert.safetensors_io", "evaluate", "evaluate.metrics", "evaluate.lpips",
                 "evaluate.extractors", "evaluate.flow_util", "evaluate.datasets",
                 "evaluate.harness", "evaluate.eval_edit", "evaluate.cli", "evaluate.sweep",
                 "segmentation", "segmentation.modules", "segmentation.hiera",
                 "segmentation.sam_heads", "segmentation.memory", "segmentation.predictor",
                 "segmentation.image_predictor", "segmentation.convert", "native", "app.app",
                 "data_utils.download", "utils.memory", "utils.numerics", "parallel",
                 "parallel.mesh", "parallel.comm", "parallel.launch", "parallel.sharding",
                 "parallel.sequence", "parallel.ring_attention", "parallel.inference",
                 "parallel.workers", "tools.bench", "tools.smoke_chip_train",
                 "tools.sweep_int8_blocks", "tools.bench_vae_decode",
                 "tools.convert_checkpoint"):
        assert f"videopainter_tpu_torch.{name}" in res["modules"]


def test_port_sources_name_no_jax_import():
    """No source line of the port (or chip_smoke.py) imports JAX, the JAX
    package, or the JAX-based optimizer / checkpoint libraries."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|videopainter_tpu)\b")
    files = list((REPO / "videopainter_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    hits = [f"{f.relative_to(REPO)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert hits == []
