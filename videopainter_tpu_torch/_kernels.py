"""Build and load the port's hand-written CUDA kernels; count their launches.

Each source under `csrc/` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

into a shared library with a plain C interface, loaded through `ctypes`:
`flash_fwd_wgmma.cu`, the bf16 flash forward, `flash_dq_wgmma.cu` and
`flash_dkv_wgmma.cu`, its dQ and dK/dV backward, `flash_int8_wgmma.cu`,
the int8 flash forward, and `flash_int8_uniform_wgmma.cu`, its uniform-scale
precursor (warp-specialised Hopper kernels: TMA, mbarriers, wgmma; their
common PTX in `hopper.cuh`, the two int8 kernels' common parts in
`int8_wgmma.cuh`). Three sources have no Pallas counterpart:
`connected_components.cu`, the connected-components labelling of SAM2's
mask post-processing (the reference's own CUDA kernel),
`qk_norm_rope.cu`, attention's per-head QK LayerNorm and RoPE, forward and
backward (the JAX package leaves that prep to XLA's fusion), and
`group_norm_silu.cu`, the VAE's GroupNorm with the SiLU after it: split-group
fp32 statistics and a fused apply (`ops/group_norm.py`), in place of the
eager fp32 copy, `F.group_norm`, cast back and SiLU (the JAX package's
`group_norm` and `silu` are XLA's fusion too).
Libraries land in `build/torch_kernels/` at the root of the checkout (listed
in `.gitignore`), named by a hash of the source, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is reused. Nothing
is built or loaded when a module is imported.

`LAUNCHES` holds one plain integer per kernel; a wrapper adds one where it
launches its kernel and nowhere else. Beside it, `PADDING` counts the work
the denoise loop spends on padding: the latent frames the pipeline pads so
that a CogVideoX 1.5 clip's frames pair up into patches, and the video
tokens whose patch holds one, over each step's CFG batch
(`pipelines/common.py`). `reset_launches` zeroes both.
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
                            "flash_int8_fwd": 0, "flash_int8_uniform_fwd": 0,
                            "connected_components": 0, "qk_norm_rope": 0,
                            "qk_norm_rope_bwd": 0, "group_norm_stats": 0,
                            "group_norm_apply": 0}
PADDING: Dict[str, int] = {"latent_frames": 0, "tokens": 0}
BUILD_LOGS: Dict[str, str] = {}   # nvcc/ptxas output of each build (registers, spills)
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()            # guards _SOURCE_LOCKS
_SOURCE_LOCKS: Dict[str, threading.Lock] = {}   # one build per source at a time


def reset_launches() -> None:
    for counts in (LAUNCHES, PADDING):
        for k in counts:
            counts[k] = 0


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
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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


# negative return codes of the C entry points (hopper.cuh's ERR_*)
_ENTRY_ERRORS = {-1: "cuTensorMapEncodeTiled not found in libcuda",
                 -2: "cuTensorMapEncodeTiled refused a TMA tensor map (strides or alignment)",
                 -3: "the kernel's register count cannot feed setmaxnreg"}


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t (or negative entry-point code)
    returned by a launch."""
    if rc < 0:
        raise RuntimeError(f"{what}: {_ENTRY_ERRORS.get(rc, 'entry point error')} ({rc})")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
