"""Build and load the port's hand-written CUDA kernels; count their launches.

Each source under `csrc/` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into a shared library with a plain C interface, loaded through `ctypes`
(`flash_fwd.cu`: the bf16 flash forward; `flash_bwd.cu`: its backward, the dQ
and the dK/dV kernel; `flash_int8_fwd.cu`: the int8 flash forward and its
uniform-scale precursor).
Libraries land in `build/torch_kernels/` at the root of the checkout (listed
in `.gitignore`), named by a hash of the source and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built or loaded
when a module is imported.

`LAUNCHES` holds one plain integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                            "flash_int8_fwd": 0, "flash_int8_uniform_fwd": 0}
BUILD_LOGS: Dict[str, str] = {}   # nvcc/ptxas output of each build (registers, spills)
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()            # guards _SOURCE_LOCKS
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}   # one build per source at a time


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}_{h}.so"


def load(source: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; `signatures` maps each C
    function to its ctypes argtypes (restype is int, a cudaError_t). Threads
    loading different sources build them side by side (one nvcc each)."""
    with _LOCK:
        source_lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with source_lock:
        if source in _LIBS:
            return _LIBS[source]
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port's kernels run only on the card")
        out = _lib_path(source)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            BUILD_LOGS[source] = r.stdout
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{source} (rc {r.returncode}):"
                                   f"\n{r.stdout}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[source] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
