"""The benchmark's command:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` on the card(s) it asks for and prints, as
the last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks`: each number compared with its limit. The same numbers
end standard error.

    python3 benchmark/run.py --workload <cell> --seed <n> --rehearse

runs the same path at the configuration's tiny widths on the CPU, through
three steps and the check, and stops before measuring: it prints the
numbers compared and no result. Without --rehearse, a run without the cards
the cell asks for exits with code 2 and prints no result.

    python3 benchmark/run.py --workload <cell> --seed <n> --control [--rehearse]

runs three unmeasured steps and prints the compared numbers of the program
and of the cell's control (its reference one precision lower, put in the
program's place) on the same step; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "videopainter_tpu")
TRACE_DIR = os.path.join(spec.ROOT, "build", "bench_trace")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark may not load (the JAX package's name is a prefix of the
    port's, so a prefix test would be wrong)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclass
class RunView:
    """What a per-layer metric's reader reads."""
    cell: spec.Cell
    steps: int
    window_s: float                 # host clock, the measured window
    session: object                 # the driver's session (work counted from shapes)
    trace: Optional[object] = None  # trace.Trace of the traced window

    @property
    def step_s(self) -> float:
        return self.window_s / self.steps


def reference_numerics():
    """The reference computes in float32 without TF32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def control_kind(cell) -> str:
    """The cell's control: the mix's where it names one (a training mix's
    masters), else the configuration's (its precision one step lower)."""
    return cell.traffic.get("control", cell.config["control"])


def judge(checks: dict, numbers: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers that have a limit; the
    others are printed as notes."""
    for name, value in numbers.items():
        if name not in checks:
            print(f"note {name} {value!r}", file=sys.stderr)
    out = {}
    for name, limit in checks.items():
        if name not in numbers:
            raise RuntimeError(f"the check {name!r} has no number")
        out[name] = {"value": numbers[name], "limit": limit}
    return out


def print_checks(judged: dict):
    for name, c in judged.items():
        ok = c["value"] == c["value"] and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr, flush=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny widths on the CPU, stop before measuring")
    ap.add_argument("--control", action="store_true",
                    help="no window: a few steps, then the numbers of the program and of the "
                         "configuration's control (its reference one precision lower)")
    args = ap.parse_args(argv)

    import torch

    cell = spec.load_cell(args.workload)
    if args.rehearse:
        device = torch.device("cpu")
    elif args.control:
        if not torch.cuda.is_available():
            print("the control readings need a CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        if args.seconds is None:
            ap.error("--seconds is required")
        device = torch.device("cuda", 0)
    from videopainter_tpu_torch import _kernels, set_numerics
    set_numerics(conv_tf32=True)
    drv = spec.driver(cell.traffic)

    session = drv.setup(cell, args.seed, device, rehearse=args.rehearse)
    if args.control:
        drv.window(session, steps=3)
        reference_numerics()
        kind = control_kind(cell)
        print(json.dumps({"control": kind, "seed": args.seed, **session.check(control=kind)}))
        return 0
    if args.rehearse:
        clock = drv.window(session, steps=3)
        judged = judge(cell.checks, run_check(session))
        print_checks(judged)
        print(json.dumps({"rehearsal": True, "steps": clock.steps,
                          "correct": all(c["value"] <= c["limit"] for c in judged.values()),
                          "forbidden_modules": forbidden_modules(), "checks": judged}))
        return 0

    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    _kernels.reset_launches()
    tr = None
    if args.trace:
        from . import trace as tracemod
        path = os.path.join(TRACE_DIR, f"{cell.name}.json")
        prof = tracemod.profile_window(path)
        hooks = drv.trace_hooks(session) if hasattr(drv, "trace_hooks") else []
        with prof:
            with torch.profiler.record_function(tracemod.WINDOW):
                clock = drv.window(session, seconds=args.seconds)
        for h in hooks:
            h.remove()
        tr = tracemod.finish(prof, path)
    else:
        clock = drv.window(session, seconds=args.seconds)
    launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
    print("launches a step: " + json.dumps({k: v / clock.steps for k, v in launches.items()}),
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated()
    view = RunView(cell, clock.steps, clock.elapsed, session, tr)
    if args.trace:
        metrics = spec.read_metrics(cell.per_layer, view)
    else:
        values = dict(drv.metrics(session, clock), setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise RuntimeError(f"the driver reports no {m['name']}")
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    judged = judge(cell.checks, run_check(session))
    correct = all(c["value"] <= c["limit"] for c in judged.values())   # NaN fails
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": clock.steps,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        from . import trace as tracemod
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tracemod.breakdown(tr)
    result["checks"] = judged
    print_checks(judged)
    print(json.dumps(result), flush=True)
    return 0


def run_check(session) -> dict:
    reference_numerics()
    return session.check()
