"""vae_encode_ms.train: device milliseconds a training step spends in the
kernels launched inside the VAE encoder's forward (its three encodes a
step: the noised first frame, the video, the masked video), tied to the
ranges the driver's forward hooks open by the profiler's correlation ids.
Where no encode ran, nothing is read."""

from vpbench.drivers.train_branch import VAE_RANGE


def read(run):
    if run.trace is None:
        return None
    ops = run.trace.launched_in(VAE_RANGE)
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e3 / run.steps
