"""The cells the tests drive: those of BENCHMARK.json, and the held-back
`anyl-w8a8-denoise`, whose configuration, mix and limits are in the tree
while its entry waits for a later benchmark change (PERF.md, Open
questions). A held-back cell is loaded from a copy of BENCHMARK.json that
has its entries, beside a link to the benchmark's files."""

import atexit
import json
import os
import shutil
import tempfile

import _paths

from vpbench import spec

HELD_BACK = {
    "configs": [{"name": "cogvideox5b-i2v-anyl-w8a8",
                 "source": "https://huggingface.co/THUDM/CogVideoX-5b-I2V",
                 "file": "benchmark/configs/cogvideox5b-i2v-anyl-w8a8.json", "reduced": [],
                 "why": "held back"}],
    "workloads": [{"name": "anyl-w8a8-denoise", "config": "cogvideox5b-i2v-anyl-w8a8",
                   "traffic": "clip81-win49-stride32-dpm50", "chips": 1, "why": "held back"}],
}
SERVING = ["i2v-bf16-denoise", "anyl-w8a8-denoise"]
ALL = SERVING + ["i2v-train-branch"]
_root = []


def _held_back_root() -> str:
    if not _root:
        root = tempfile.mkdtemp(prefix="vpbench_cells_")
        atexit.register(shutil.rmtree, root, True)
        os.symlink(_paths.BENCH, os.path.join(root, "benchmark"))
        with open(os.path.join(_paths.ROOT, "BENCHMARK.json")) as f:
            b = json.load(f)
        for key, entries in HELD_BACK.items():
            b[key] += entries
        with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
            json.dump(b, f)
        _root.append(root)
    return _root[0]


def load(name: str) -> spec.Cell:
    if name in {w["name"] for w in HELD_BACK["workloads"]}:
        return spec.load_cell(name, root=_held_back_root())
    return spec.load_cell(name)
