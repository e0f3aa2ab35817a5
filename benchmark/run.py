#!/usr/bin/env python3
"""Entry point of the benchmark of the PyTorch / CUDA port; see
`vpbench/cli.py` for the command line and `BENCHMARK.json` for the cells."""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every build and kernel cache at a fixed path inside the checkout
_CACHE = os.path.join(ROOT, "build", "bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(_CACHE, sub)
os.environ["USE_FLAX"] = "0"   # transformers would otherwise look for JAX
os.environ.setdefault("OMP_NUM_THREADS", "4")

sys.path[:0] = [HERE, ROOT]

from vpbench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
