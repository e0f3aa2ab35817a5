"""backward_ms.train: device milliseconds a training step spends in the
kernels launched inside the program's `train.backward` span: the backward
through the DiT and the branch with the per-block checkpoints' recompute.
Where the program opens no such span, nothing is read."""

SPAN = "train.backward"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    return sum(o.end - o.start for o in run.trace.launched_in(SPAN)) / 1e3 / run.steps
