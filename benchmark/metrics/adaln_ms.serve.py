"""adaln_ms.serve: device milliseconds a served step spends in the kernels
launched inside the program's `dit.adaln` spans: every DiT and branch
block's two AdaLN norms, with their modulation linears and the float32
modulation (`ops/norms.py` `LayerNormZero`), tied to the spans by the
profiler's correlation ids. Where the program opens no such span, nothing
is read."""

SPAN = "dit.adaln"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    return sum(o.end - o.start for o in run.trace.launched_in(SPAN)) / 1e3 / run.steps
