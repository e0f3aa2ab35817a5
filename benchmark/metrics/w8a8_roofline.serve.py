"""w8a8_roofline.serve: the W8A8 projections' least time at the chip's
peaks (`vpbench.counts.w8a8_bound_s`: the larger of their int8 operations
at 1,979 TOP/s and their bytes, the bf16 activation read, the int8 weight
and its scales read and the bf16 output written once, at 3.35 TB/s) over
the device time of every kernel launched inside an `Int8Linear` call (the
ranges the driver's forward hooks open), both a step, in %. Where no such
call ran, nothing is read."""

from vpbench.counts import w8a8_bound_s
from vpbench.drivers.denoise import W8A8_RANGE


def read(run):
    if run.trace is None:
        return None
    t = sum(o.end - o.start for o in run.trace.launched_in(W8A8_RANGE)) / 1e6
    gemms = [g for g in run.session.work().gemms if g.prec == "int8"]
    if t <= 0 or not gemms:
        return None
    return 100.0 * w8a8_bound_s(gemms) * run.steps / t
