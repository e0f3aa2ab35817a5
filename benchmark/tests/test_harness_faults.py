"""The rest of a run with the timed path broken underneath, at tiny widths
on the CPU (the harness's look for a card skipped): `correct` must come out
false for each fault the cell can have. One chip, so there is no exchange
between chips to leave out; the training cell's batch is one clip, so it
has no half to leave out. A serving step's batch is its CFG pair: a step
that leaves the unconditional half out and lets the conditional half stand
for both gets the guided direction wholly wrong (`cfg_rel_err` reads 1)."""

import _paths  # noqa: F401
import pytest
import torch

from _cells import SERVING, load
from vpbench import cli, spec


def unchanged_state(monkeypatch):
    """A denoise step returns its latents, a training step its parameters and
    optimizer state, unchanged."""
    from videopainter_tpu_torch.schedulers import CogVideoXDPMScheduler
    from videopainter_tpu_torch.training.optim import Optimizer
    real = CogVideoXDPMScheduler.step

    def step(self, coeffs, i, model_output, old, sample, noise=None):
        _, x0 = real(self, coeffs, i, model_output, old, sample, noise)
        return sample, x0
    monkeypatch.setattr(CogVideoXDPMScheduler, "step", step)
    monkeypatch.setattr(Optimizer, "update_", lambda self, params, grads, state: state)


def _patch_dit(monkeypatch, edit):
    from videopainter_tpu_torch.models import CogVideoXTransformer3D
    real = CogVideoXTransformer3D.forward

    def forward(self, hidden_states, encoder_hidden_states, timestep, **kw):
        out = real(self, hidden_states, encoder_hidden_states, timestep, **kw)
        return out._replace(sample=edit(out.sample))
    monkeypatch.setattr(CogVideoXTransformer3D, "forward", forward)


def dropped_half(monkeypatch):
    """The CFG batch's unconditional half left out: the conditional half's
    output stands for both."""
    def edit(s):
        _, c = s.chunk(2)
        return torch.cat([c, c])
    _patch_dit(monkeypatch, edit)


def altered_answer(monkeypatch):
    def edit(s):
        s = s.clone()
        s[:, 0] = s[:, 0] + s[:, 0].float().std().to(s.dtype)
        return s
    _patch_dit(monkeypatch, edit)


CASES = ([(c, f) for c in SERVING for f in (unchanged_state, dropped_half, altered_answer)]
         + [("i2v-train-branch", f) for f in (unchanged_state, altered_answer)])


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_a_broken_step_is_not_correct(cell_name, fault, monkeypatch):
    fault(monkeypatch)
    cell = load(cell_name)
    drv = spec.driver(cell.traffic)
    s = drv.setup(cell, 7, torch.device("cpu"), rehearse=True)
    drv.window(s, steps=3)
    judged = cli.judge(cell.checks, cli.run_check(s))
    assert not all(c["value"] <= c["limit"] for c in judged.values()), judged

