"""device_idle.<kind>: the share of the traced window of steps in which no
device operation runs (one minus the union of their intervals over the
window), in %."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
