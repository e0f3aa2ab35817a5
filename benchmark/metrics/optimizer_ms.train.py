"""optimizer_ms.train: device milliseconds a training step spends in the
kernels launched inside the program's `train.optimizer` span: the gradient
norm, the clip and AdamW's update of the float32 branch. Where the program
opens no such span, nothing is read."""

SPAN = "train.optimizer"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    return sum(o.end - o.start for o in run.trace.launched_in(SPAN)) / 1e3 / run.steps
