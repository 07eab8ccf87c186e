"""The controls: the reference one precision below the configuration's
(`check.CONTROL_BITS`: TF32 for float32, fp8 for bfloat16), put in the
program's place, fails each cell's limits.  On the CPU at a small size;
on the card (`cuda`) at the cell's own size, where the program's own
numbers pass them too."""

import pytest

from portbench import calibrate, spec
from portbench.run import ROOT

from .tiny import TINY, cell

CELLS = sorted(TINY)


def _one(c):
    return calibrate.train_seed if c.traffic["driver"] == "train" else calibrate.serve_seed


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits(name):
    import torch

    c = cell(name)
    line = _one(c)(c, 2**31 + 23, torch.device("cpu"), True)
    assert any(line["control"][k] > limit for k, limit in c.limits.items()), line


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_at_the_cells_size_the_program_passes_and_the_control_fails(card, name):
    c = spec.load(ROOT, name)
    line = _one(c)(c, 2**31 + 29, card, True)
    assert all(line["program"][k] <= limit for k, limit in c.limits.items()), line
    assert any(line["control"][k] > limit for k, limit in c.limits.items()), line
