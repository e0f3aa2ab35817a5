"""The device trace of a traced run, reduced to what the per-layer metrics
read: every device operation (kernel, memcpy, memset) with its start and
end, the host ranges the benchmark opened (`record_function`), and which
range launched which kernel (the profiler's correlation ids).

The trace is `torch.profiler`'s Chrome trace, written under `build/` in the
checkout and read back as JSON. Times are microseconds on the profiler's
clock, on which host and device events are aligned.
"""

from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "vpbench.window"


@dataclass
class Op:
    name: str
    start: float
    end: float
    corr: Optional[int] = None


@dataclass
class Trace:
    device: List[Op]                      # device operations, by start
    ranges: Dict[str, List[Tuple[float, float]]]   # host ranges by name
    launches: Dict[int, float]            # correlation id -> host launch time
    host: List[Op] = field(default_factory=list)   # host operators, by start
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def in_window(self) -> List[Op]:
        lo, hi = self.window
        return [o for o in self.device if o.end > lo and o.start < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        lo, hi = self.window
        busy, cur_s, cur_e = 0.0, None, None
        for o in self.in_window():
            s, e = max(o.start, lo), min(o.end, hi)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the window, longest first."""
        lo, hi = self.window
        out, t = [], lo
        for o in self.in_window():
            if o.start > t:
                out.append((t, o.start))
            t = max(t, o.end)
        if hi > t:
            out.append((t, hi))
        return sorted(out, key=lambda g: g[0] - g[1])

    def launched_in(self, name: str) -> List[Op]:
        """Device operations launched while a host range called `name` was
        open (matched by the launch's correlation id and time)."""
        spans = sorted(self.ranges.get(name, []))
        starts = [s for s, _ in spans]
        out = []
        for o in self.in_window():
            t = self.launches.get(o.corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                out.append(o)
        return out

    def host_at(self, t: float) -> str:
        """The innermost host operator or CUDA runtime call running at time t."""
        best = None
        i = bisect.bisect_right([o.start for o in self.host], t)
        for o in self.host[max(0, i - 2000):i]:
            if o.start <= t <= o.end and (best is None or o.end - o.start < best.end - best.start):
                best = o
        return best.name if best is not None else "python (no operator or runtime call)"


def parse(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, ranges, launches = [], [], {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev.get("dur", 0.0))
        args = ev.get("args", {}) or {}
        if cat in DEVICE_CATS:
            device.append(Op(ev["name"], ts, ts + dur, args.get("correlation")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            if "correlation" in args:
                launches[args["correlation"]] = ts
            host.append(Op(ev["name"], ts, ts + dur))
        elif cat == "user_annotation":
            ranges.setdefault(ev["name"], []).append((ts, ts + dur))
        elif cat == "cpu_op":
            host.append(Op(ev["name"], ts, ts + dur))
    device.sort(key=lambda o: o.start)
    host.sort(key=lambda o: o.start)
    win = ranges.get(WINDOW)
    if not win:
        raise RuntimeError(f"the trace {path} has no {WINDOW} range")
    return Trace(device, ranges, launches, host, (min(s for s, _ in win), max(e for _, e in win)))


def kernel_class(name: str) -> str:
    """The kernel classes of the flagship profile: attention (the flash
    kernels by name), int8 or bf16 GEMM, convolution, other (norms,
    elementwise, reductions, copies)."""
    n = name.lower()
    if "flash_int8" in n:
        return "attention_int8"
    if "flash_fwd" in n or "flash_dq" in n or "flash_dkv" in n:
        return "attention"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "cublas", "sm90_", "nvjet")):
        return "gemm_int8" if any(s in n for s in ("i8", "s8", "imma", "int8")) else "gemm"
    if "conv" in n or "cudnn" in n:
        return "conv"
    return "other"


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) and the
    longest idle gaps, named by the host operator running at the gap."""
    by_name: Dict[str, float] = {}
    for o in trace.in_window():
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [[trace.host_at(0.5 * (a + b)), (b - a) / 1e6] for a, b in trace.gaps()[:top]]
    return {"device_ops": [[n[:200], s] for n, s in ops], "idle_gaps": gaps}


def range_hooks(modules, name: str):
    """Forward hooks that open a `record_function` range called `name`
    around every call of each of `modules` (traced runs only); returns their
    handles."""
    import torch

    def pre(mod, args):
        mod._vpbench_range = torch.profiler.record_function(name)
        mod._vpbench_range.__enter__()

    def post(mod, args, out):
        mod._vpbench_range.__exit__(None, None, None)

    handles = []
    for m in modules:
        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    return handles


def profile_window(out_path: str):
    """A `torch.profiler.profile` over host and device; the caller runs the
    window inside it and then calls `finish`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)


def finish(prof, out_path: str) -> Trace:
    prof.export_chrome_trace(out_path)
    return parse(out_path)
