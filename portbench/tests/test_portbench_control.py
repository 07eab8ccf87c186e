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


def test_a_float32_training_reference_is_float64_and_its_control_moves_it():
    """The float32 branch of `check.training_reference`: float64 from the
    same int16 audio and seed, and TF32 rounding (`CONTROL_BITS`) moves
    every number; a precision with no reference is refused."""
    import types

    import numpy as np
    import torch

    from portbench import calibrate, check
    from portbench.reference.specs import MODELS

    rng = np.random.default_rng(3)
    corpus = types.SimpleNamespace(clean=[(rng.standard_normal(n) * 3000).astype(np.int16) for n in (4000, 5200)],
                                   noise=[(rng.standard_normal(16000) * 3000).astype(np.int16)])
    ini = {"model": {"compute_dtype": "float32"}, "data": {"snr": 0},
           "training": {"batch_size": 2, "lr": 0.0015, "warmup_steps": 10000}}
    layers, cpu = MODELS["FullyCNNV3"], torch.device("cpu")
    batches = [[0, 1], [1, 0], [0, 1]]
    p0, bn0, ref = check.training_reference(layers, 7, ini, corpus, batches, cpu)
    assert all(v.dtype == torch.float64 for d in ref.params.values() for v in d.values())
    assert check.train_numbers(calibrate.as_program(p0, bn0, ref), p0, bn0, ref)["grad_err"] < 1e-12
    bits = check.CONTROL_BITS["float32"]
    control = check.training_reference(layers, 7, ini, corpus, batches, cpu, bits, bits)
    assert all(v.dtype == torch.float32 for d in control[2].params.values() for v in d.values())
    moved = check.train_numbers(calibrate.as_program(*control), p0, bn0, ref)
    assert all(v > 1e-9 for v in moved.values()) and moved["grad_err"] > 1e-5, moved
    with pytest.raises(ValueError, match="float16"):
        check.training_reference(layers, 7, dict(ini, model={"compute_dtype": "float16"}), corpus, batches, cpu)
