"""elementwise_ms.<kind>: device milliseconds a step spends in kernels that
are neither GEMM, attention nor convolution (norms, AdaLN modulation, RoPE,
adds, casts, the W8A8 quantize passes, in training also the optimizer
update and the loss), by the flagship profile's kernel classes."""

from vpbench.trace import kernel_class


def read(run):
    if run.trace is None:
        return None
    ms = sum(o.end - o.start for o in run.trace.in_window() if kernel_class(o.name) == "other")
    return ms / 1e3 / run.steps
