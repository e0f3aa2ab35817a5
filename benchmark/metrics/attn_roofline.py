"""attn_roofline.<kind>: the attention work's least time at the chip's
peaks (each call's products, counted from shapes by the driver's `work()`:
the forward's Q.K^T and P.V, in training also the backward's four;
recomputation not counted) over the device time of the attention kernels,
both a step, in %. The kernels are picked by the name patterns below (B1's
forward, B4's int8 forward, B2's dQ and B3's dK / dV); where none ran,
nothing is read."""

PATTERNS = ("flash_fwd", "flash_int8", "flash_dq", "flash_dkv")


def read(run):
    if run.trace is None:
        return None
    t = sum(o.end - o.start for o in run.trace.in_window()
            if any(p in o.name.lower() for p in PATTERNS)) / 1e6
    if t <= 0:
        return None
    return 100.0 * run.session.work().attn_bound_s() * run.steps / t
