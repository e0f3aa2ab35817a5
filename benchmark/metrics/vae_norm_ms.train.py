"""vae_norm_ms.train: device milliseconds a training step spends in the
kernels launched inside the program's `vae.norm` spans: each GroupNorm of
the VAE's resnet blocks and of its `norm_out`, with the SiLU after it, in
the step's three encodes. Where the program opens no such span, nothing is
read."""

SPAN = "vae.norm"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    return sum(o.end - o.start for o in run.trace.launched_in(SPAN)) / 1e3 / run.steps
