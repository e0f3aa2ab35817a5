"""What the quality-gate tools share: their record of the run, PSNR that is
never infinite, strict JSON, the decoded-pixel and perceptual legs, and the
reference cache of the step-skip gate.

Every artifact of `gate_int8_flagship`, `gate_skip_flagship` and
`smoke_chip_anyl` carries `environment(...)`: the card's name and power
limit (`nvidia-smi`), the torch and CUDA versions, the git commit, the
argv, the launches of each kernel (`_kernels.LAUNCHES`) and the peak
device memory. A PSNR of two
bit-identical outputs is written as null beside `"identical": true`, and
every artifact goes through `json.dump(..., allow_nan=False)`.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import _kernels, card_line

REPO = Path(__file__).resolve().parents[2]
GOLDENS = REPO / "tests" / "goldens"
MIN_PSNR_DB = 35.0   # the gate bar of the JAX package's bench.py
reset_launches = _kernels.reset_launches
# the seed of the weights every gate tool builds (`flagship.build_pipeline`):
# the same model in all three, so scales one calibrates apply to the others
WEIGHTS_SEED = 0


def _rect(t, h, w, h0, h1, w0, w1) -> np.ndarray:
    m = np.zeros((t, h, w), np.float32)
    m[:, h0:h1, w0:w1] = 1.0
    return m


# latent-grid hole geometries of the step-skip gate's robustness leg, as the
# JAX package's tools/gate_skip_flagship.py draws them: name -> fn(T, H, W) ->
# [T, H, W] float mask (1 = hole)
MASK_GEOMS = {
    # a central rectangle of about 26 % of the area (15:45 x 22:68 of the
    # flagship's 60 x 90 grid)
    "rect": lambda t, h, w: _rect(t, h, w, h // 4, 3 * h // 4,
                                  round(w * 11 / 45), round(w * 34 / 45)),
    # an off-centre tall narrow hole of about 19 % of the area
    "tall": lambda t, h, w: _rect(t, h, w, int(h * 0.083), int(h * 0.917),
                                  int(w * 0.111), int(w * 0.333)),
}


def git_commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "-C", str(REPO), "rev-parse", "HEAD"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def launches() -> Dict[str, int]:
    """The kernels' launch counts."""
    return dict(_kernels.LAUNCHES)


class LegLaunches:
    """The launches of each leg of a run: `mark(name)` records the kernels
    launched since the previous mark (nonzero counts only)."""

    def __init__(self):
        self.legs: Dict[str, Dict[str, int]] = {}
        self._last = dict(_kernels.LAUNCHES)

    def mark(self, name: str) -> Dict[str, int]:
        now = dict(_kernels.LAUNCHES)
        leg = {k: now[k] - self._last.get(k, 0) for k in now if now[k] != self._last.get(k, 0)}
        self.legs[name] = leg
        self._last = now
        return leg


def peak_memory_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def environment(device: torch.device, argv=None) -> Dict:
    return {"card": card_line() if device.type == "cuda" else None,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else "cpu"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "git_commit": git_commit(),
            "argv": list(sys.argv[1:] if argv is None else argv)}


def finish(result: Dict, device: torch.device, argv=None) -> Dict:
    """Add the environment, the launches and the peak memory to `result`."""
    result["environment"] = environment(device, argv)
    result["launches"] = launches()
    result["peak_memory_gib"] = peak_memory_gib(device)
    return result


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Wall seconds of a block, the device synchronised at both ends."""

    def __init__(self, device: torch.device):
        self.device, self.s = device, 0.0

    def __enter__(self):
        sync(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.s = time.perf_counter() - self.t0


def _np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float64)


def psnr_db(got, ref, data_range: Optional[float] = None) -> Optional[float]:
    """PSNR of `got` against `ref` over `data_range` (default: the range of
    `ref`, as the JAX tools compute it), in float64 (`evaluate.metrics`);
    None where the two are bit-identical."""
    from ..evaluate.metrics import psnr

    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    rng = float(ref.max() - ref.min()) if data_range is None else float(data_range)
    p = psnr(got, ref, data_range=rng)
    return p if math.isfinite(p) else None


def put_psnr(entry: Dict, key: str, got, ref, data_range: Optional[float] = None) -> Dict:
    """entry[key] = PSNR of got against ref; null and `"identical": true`
    when they are bit-identical (a null PSNR means nothing else)."""
    entry[key] = psnr_db(got, ref, data_range)
    if entry[key] is None:
        entry["identical"] = True
    return entry


def latent_stats(got, ref) -> Dict:
    """PSNR, cosine and relative L1 of a trajectory's final latents against
    the reference's (float64)."""
    g, r = _np64(got).ravel(), _np64(ref).ravel()
    out = put_psnr({}, "psnr_db", g, r)
    out["cosine"] = float(g @ r / (np.linalg.norm(g) * np.linalg.norm(r) + 1e-12))
    out["rel_l1"] = float(np.abs(g - r).mean() / (np.abs(r).mean() + 1e-12))
    return out


def _walk(x, path=""):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _walk(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _walk(v, f"{path}[{i}]")
    else:
        yield path, x


def check_finite(result: Dict) -> None:
    """Raise unless every number of `result` is finite (None is allowed)."""
    bad = [p for p, v in _walk(result) if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        raise ValueError(f"non-finite values at {bad}")


def write_artifact(path: str, result: Dict) -> None:
    """Strict JSON (no NaN or Infinity), checked before the file is opened."""
    text = json.dumps(result, indent=1, allow_nan=False)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(text + "\n")


def read_artifact(path) -> Dict:
    """A JSON artifact read strictly: NaN or Infinity in it raise."""
    def refuse(constant):
        raise ValueError(f"{path} holds the non-JSON constant {constant}")
    with open(path) as f:
        return json.load(f, parse_constant=refuse)


def emit(record: Dict) -> None:
    """One strict-JSON line on stdout, flushed (a long run's progress)."""
    print(json.dumps(record, allow_nan=False), flush=True)


def run_module_rung(module: str, argv, timeout: float,
                    runner=None) -> Tuple[Optional[Dict], Dict]:
    """`python -m module *argv` from the root of the checkout, as one rung of
    a ladder: (its last JSON line, {}) when it exits 0 with one, else (None,
    {"error": "OOM" | "error" | "timeout", "tail": ...})."""
    runner = runner or subprocess.run
    try:
        res = runner([sys.executable, "-m", module] + list(argv), capture_output=True,
                     text=True, timeout=timeout, cwd=str(REPO))
    except subprocess.TimeoutExpired:
        return None, {"error": "timeout"}
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode == 0 and lines:
        return json.loads(lines[-1]), {}
    err = (res.stderr or res.stdout)[-2000:]
    oom = "OutOfMemoryError" in err or "CUDA out of memory" in err
    return None, {"error": "OOM" if oom else "error", "tail": err[-300:]}


# -- decoded pixels and perceptual legs ----------------------------------------------------------

@torch.no_grad()
def decode01(vae, latents: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Final latents [B, T, h, w, C] through the VAE decode (tiling as the
    VAE is set), clipped to [-1, 1] and mapped to [0, 1], float32."""
    dev = next(vae.parameters()).device
    z = latents.to(dev, dtype) / vae.cfg.scaling_factor
    return (torch.clamp(vae.decode(z).float(), -1, 1) / 2 + 0.5)


def put_pixel_metrics(entry: Dict, got01: torch.Tensor, ref01: torch.Tensor, *,
                      ssim: bool = True) -> Dict:
    """entry["pixel_psnr_db"] over the whole clip and entry["pixel_ssim"],
    the frame-mean SSIM (float64, `evaluate.metrics`), of [0, 1] frames
    [B, T, H, W, 3]."""
    from ..evaluate.metrics import frame_ssim

    put_psnr(entry, "pixel_psnr_db", got01, ref01, data_range=1.0)
    if ssim:
        entry["pixel_ssim"] = float(torch.cat([frame_ssim(got01[b], ref01[b])
                                               for b in range(ref01.shape[0])]).mean())
    return entry


class Perceptual:
    """LPIPS (SqueezeNet trunk) and CLIP temporal consistency with the seeded
    weights committed under tests/goldens (`lpips.npz`'s `sd::` entries,
    `clip_tiny/`): random features, so their scale is anchored by the 35 dB
    white-noise control, not comparable to pretrained values."""

    def __init__(self, device: torch.device, goldens: Path = GOLDENS):
        from ..evaluate.extractors import ClipExtractor
        from ..evaluate.lpips import LPIPS, convert_lpips_state_dict

        with np.load(goldens / "lpips.npz") as z:
            sd = {k[4:]: z[k] for k in z.files if k.startswith("sd::")}
        self.lpips = LPIPS(device="meta").to_empty(device=device)
        self.lpips.load_state_dict(convert_lpips_state_dict(sd))
        self.lpips.eval()
        self.clip = ClipExtractor(str(goldens / "clip_tiny"), device=device)
        self.device = device

    @torch.no_grad()
    def lpips_mean(self, a01: torch.Tensor, b01: torch.Tensor, chunk: int = 8) -> float:
        """Mean LPIPS over the frames of [T, H, W, 3] clips in [0, 1]."""
        from ..evaluate.lpips import lpips_forward
        from ..utils.numerics import full_fp32

        vals = []
        with full_fp32():
            for i in range(0, a01.shape[0], chunk):
                a = a01[i:i + chunk].to(self.device, torch.float32) * 2 - 1
                b = b01[i:i + chunk].to(self.device, torch.float32) * 2 - 1
                vals.append(lpips_forward(self.lpips, a, b))
        return float(torch.cat(vals).mean())

    def temporal_consistency(self, v01: torch.Tensor) -> float:
        from ..evaluate.metrics import temporal_consistency
        return temporal_consistency(self.clip.image_embeds(v01))

    def anchor(self, ref01: torch.Tensor, seed: int = 0) -> Dict:
        """White noise at exactly the 35 dB bar added to the reference pixels
        [T, H, W, 3]: its PSNR, LPIPS and both clips' temporal consistency."""
        rng = np.random.RandomState(seed)
        sigma = 10.0 ** (-MIN_PSNR_DB / 20.0)   # data range 1
        ref_np = ref01.float().cpu().numpy()
        noisy = np.clip(ref_np + rng.normal(0, sigma, ref_np.shape).astype(np.float32), 0, 1)
        noisy = torch.from_numpy(noisy).to(ref01.device)
        return {"psnr_db": psnr_db(noisy, ref01, 1.0),
                "lpips": self.lpips_mean(noisy, ref01),
                "temporal_consistency_ref": self.temporal_consistency(ref01),
                "temporal_consistency_noise": self.temporal_consistency(noisy)}


# -- the reference cache ---------------------------------------------------------------------------

class RefCache:
    """Final latents kept in an .npz across runs, each under the whole
    configuration that made it ("kind=...|layers=...|steps=...|dims=...|
    seed=...|geom=...|mode=..."): a trajectory is only ever reused for the
    very configuration that produced it."""

    def __init__(self, path: Optional[str]):
        self.path, self.entries = path, {}
        if path and os.path.exists(path):
            with np.load(path) as z:
                self.entries = {k: z[k] for k in z.files}

    @staticmethod
    def key(**config) -> str:
        return "|".join(f"{k}={config[k]}" for k in sorted(config))

    def get(self, key: str):
        """(latents, wall seconds) or None."""
        if key not in self.entries:
            return None
        return self.entries[key], float(self.entries["wall_s::" + key])

    def put(self, key: str, latents: np.ndarray, wall_s: float) -> None:
        self.entries[key] = np.asarray(latents, np.float32)
        self.entries["wall_s::" + key] = np.asarray(wall_s, np.float64)
        if self.path:
            tmp = self.path + ".tmp.npz"
            np.savez(tmp, **self.entries)
            os.replace(tmp, self.path)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()
