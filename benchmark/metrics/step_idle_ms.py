"""step_idle_ms.<kind>: device-idle milliseconds a step inside the
program's step spans: each idle gap of the traced window (`Trace.gaps`)
whose midpoint lies inside a `denoise.step` span (`.serve`, in the cells
that report `serve_step_s`) or a `train.step` span (`.train`, in those that
report `train_step_s`), summed over the window's steps. The idle between
the spans (the step clock's synchronise, the next clip's draw) is left out.
Where the program opens no such span, nothing is read."""

STEP_SPANS = {"serve_step_s": "denoise.step", "train_step_s": "train.step"}


def read(run):
    if run.trace is None:
        return None
    spans = [s for m in run.cell.end_to_end if m["name"] in STEP_SPANS
             for s in run.trace.ranges.get(STEP_SPANS[m["name"]], [])]
    if not spans:
        return None
    idle = sum(b - a for a, b in run.trace.gaps()
               if any(s <= 0.5 * (a + b) <= e for s, e in spans))
    return idle / 1e3 / run.steps
