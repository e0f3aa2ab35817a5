"""attn_prep_ms.serve: device milliseconds a served step spends in the
kernels of class "other" (`vpbench.trace.kernel_class`: no GEMM, no flash
kernel) launched inside the program's `attn` spans, one a `joint_attention`
call: the text / video join, the QK norms, RoPE, the head layout's copies.
Where the program opens no such span, nothing is read."""

from vpbench.trace import kernel_class

SPAN = "attn"


def read(run):
    if run.trace is None or SPAN not in run.trace.ranges:
        return None
    ms = sum(o.end - o.start for o in run.trace.launched_in(SPAN)
             if kernel_class(o.name) == "other") / 1e3
    return ms / run.steps
