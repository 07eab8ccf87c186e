"""The work counts: against a direct count at a small size, and from the
frozen specs alone (the program's model, its bin blocking and its
packing do not move them)."""

import pytest
import torch
import torch.nn.functional as F

from portbench import work
from portbench.reference.specs import F_BINS, MODELS, in_channels, param_count


def _real_pairs_direct(kh, kw, frames):
    """(output, tap) pairs with a real input: a conv of ones over ones
    with TF SAME zero padding sums exactly them."""
    x = F.pad(torch.ones(1, 1, frames, F_BINS, dtype=torch.float64),
              ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    return int(F.conv2d(x, torch.ones(1, 1, kh, kw, dtype=torch.float64)).sum())


@pytest.mark.parametrize("net", sorted(MODELS))
@pytest.mark.parametrize("frames", [1, 3, 9])
def test_forward_and_training_flop_match_a_direct_count(net, frames):
    layers = MODELS[net]
    macs = [c * lay.out_ch * _real_pairs_direct(*lay.kernel, frames) for lay, c in zip(layers, in_channels(layers))]
    assert work.forward_flop(layers, frames) == 2 * sum(macs)
    assert work.train_flop(layers, frames) == 2 * (2 * sum(macs) + sum(macs[1:]))


@pytest.mark.parametrize("net", sorted(MODELS))
def test_dw_work_is_the_canonical_weight_gradient(net):
    """Products of conv2d_weight over real inputs: dW[o, i, 0, j] sums
    z[i, t, f + j - lo] * dy[o, t, f] over the (t, f) whose z is real."""
    layers, rows, frames = MODELS[net], 3, 5
    for (lay, c), (flop, nbytes) in zip(work.inner(layers), work.dw_work(layers, rows, frames, 2)):
        kw = lay.kernel[1]
        pairs = _real_pairs_direct(1, kw, frames)  # per (input, output) channel, per row
        assert flop == 2 * rows * c * lay.out_ch * pairs
        assert nbytes == 2 * rows * frames * F_BINS * (c + lay.out_ch) + 4 * kw * c * lay.out_ch


@pytest.mark.parametrize("net", sorted(MODELS))
def test_frozen_specs_are_the_programs_models(net):
    from fullycnnspeechenhancement_torch.models import get_model

    ours, theirs = MODELS[net], get_model(net)
    assert [(l.name, l.out_ch, l.kernel, l.use_norm, l.use_act, l.skip_from, l.add_from) for l in ours] == [
        (s.name, s.out_ch, tuple(s.kernel), s.use_norm, s.use_act, s.skip_from, s.add_from) for s in theirs.layers
    ]
    assert param_count(ours) == theirs.param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_work_ignores_the_programs_packing(dtype):
    """The packed stack's weights (3xTF32 halves, bf16 fragments, padding)
    differ by mode; the yardstick reads the specs only."""
    from fullycnnspeechenhancement_torch.models import V2
    from fullycnnspeechenhancement_torch.ops.rced_stack import pack_inference_stack

    params, bn = V2.init(torch.Generator().manual_seed(0))
    packed = pack_inference_stack(V2, params, bn, dtype)
    flop, nbytes = work.stack_work(MODELS["FullyCNNV2"], [100])
    inner = work.inner(MODELS["FullyCNNV2"])
    assert packed.c_in == inner[0][1] and packed.c_out == inner[-1][0].out_ch
    assert flop == sum(work.layer_macs(l, c, 100) for l, c in inner) * 2
    weights = sum(l.kernel[1] * c * l.out_ch + l.out_ch for l, c in inner)
    assert nbytes == 4 * 100 * F_BINS * (packed.c_in + packed.c_out) + 4 * weights
