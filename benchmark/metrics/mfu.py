"""mfu.<kind>: the share of the chip's dense peak that a step reaches (a
served denoise step, a branch-SFT step). The least time the peaks allow for
the step's DiT and branch work, counted from shapes by the driver's
`work()` (`vpbench.counts`: GEMMs and attention, each at the peak of its
precision; for training the forward and the backward the branch's
gradients need, recomputation not counted), over the measured time of a
step (the traced window over its steps), in %."""


def read(run):
    return 100.0 * run.session.work().bound_s() / run.step_s
