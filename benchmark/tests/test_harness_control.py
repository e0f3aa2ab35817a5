"""Each cell's control on the card, at the cell's own size: the
configuration's reference one precision lower, put in the program's place,
must come out not correct against the cell's limits, while the program on
the same seed and step comes out correct. Needs a CUDA device (the cells'
kernels have no CPU mode at that size); skips without one.

    python -m pytest benchmark/tests/test_harness_control.py -m cuda
"""

import _paths  # noqa: F401
import pytest
import torch

from vpbench import cli, spec

CELLS = ["i2v-bf16-denoise", "i2v-train-branch"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(cell_name, card):
    from videopainter_tpu_torch import set_numerics

    set_numerics(conv_tf32=True)
    cell = spec.load_cell(cell_name)
    drv = spec.driver(cell.traffic)
    s = drv.setup(cell, 2147483647, card)
    drv.window(s, steps=3)
    cli.reference_numerics()
    got = s.check(control=cli.control_kind(cell))
    within = lambda numbers: all(numbers[k] <= v for k, v in cell.checks.items())
    assert within(got["program"]), got
    assert not within(got["control"]), got
