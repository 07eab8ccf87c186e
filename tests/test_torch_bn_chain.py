"""The BN chain of the blocked training step (`ops/bn_chain.py`) on the CPU:
its CPU path bit for bit the chain `models/blocked.py` ran before the
kernels, and the closed-form Function on the kernels' plain twins against
autograd of the plain chain in float64; and the benchmark's reader of the
kernels' roofline share (`portbench/metrics/bn_chain_roofline.py`) on
synthetic readings.  The kernels themselves are held on the card
(`tests/test_torch_cuda.py`, `-k bn_chain`)."""

from types import SimpleNamespace

import pytest
import torch

from fullycnnspeechenhancement_torch.models import blocked, blocks, get_model
from fullycnnspeechenhancement_torch.ops import bn_chain
from test_torch_cuda import (  # noqa: F401
    NAMES,
    assert_chain_close,
    chain_case,
    chain_errors,
    one_cpu_thread_per_worker,
    plain_reference,
    run_chain,
)

DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _chain_before(y, p, s, batch, *, skip=None, add=None, relu=True, reduce=None):
    """The chain after a BN layer's conv as `apply_blocked` wrote it inline
    before `ops/bn_chain.py` existed, kept as the witness that the CPU path
    is unchanged."""
    B, T, nb, fc = y.shape
    cout = p["b"].shape[0]
    fb = fc // cout
    dt = y.dtype
    mdt = torch.promote_types(torch.float32, dt)
    y = y + p["b"].repeat(fb).to(dt)
    y32 = y.to(mdt).reshape(B, T, nb, fb, cout)
    mean, var = blocks.moments_from_sums(
        (y32 * batch.m_bn).sum(dim=(0, 1, 2, 3)), (y32 * y32 * batch.m_bn).sum(dim=(0, 1, 2, 3)),
        batch.n, reduce,
    )
    new_state = blocks.updated_bn_state(s, mean, var)
    scale, shift = blocks.bn_scale_shift(p, mean, var)
    y = y * scale.repeat(fb).to(dt) + shift.repeat(fb).to(dt)
    if skip is not None:
        y = y + skip
    if relu:
        y = torch.relu(y)
    if add is not None:
        y = y + add
    y = (y.reshape(B, T, nb, fb, cout) * batch.mask4[..., None]).reshape(B, T, nb, fb * cout)
    return y, new_state


def _two_ranks(t):
    """A summing `reduce` stub: two ranks holding the same rows."""
    return t + t


def _layers(name):
    """(C, link, relu) of the model's blocked BN layers."""
    out = []
    for spec in get_model(name).layers:
        if spec.use_norm:
            link = "skip" if spec.skip_from else "add" if spec.add_from else "none"
            out.append((spec.out_ch, link, spec.use_act))
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_cpu_path_is_the_chain_before_bit_for_bit(name, dtype):
    """`bn_chain` on CPU tensors gives the chain's former output, BN state
    and every gradient bit for bit, for each BN layer of V1/V2/V3 (its
    channels, skip or residual and ReLU), with the batch-max and the
    per-utterance masks, and launches nothing."""
    before = _counts()
    for i, (C, link, relu) in enumerate(_layers(name)):
        for mask in ("batch_max", "utterance"):
            case = chain_case(C, 2, 6, dtype, mask=mask, link=link, seed=i)
            got = run_chain(bn_chain.bn_chain, case, relu=relu)
            ref = run_chain(_chain_before, case, relu=relu)
            assert torch.equal(got[0], ref[0]), (name, i, mask)
            for k in ref[1]:
                assert torch.equal(got[1][k], ref[1][k]), (name, i, mask, k)
            for k in ref[2]:
                assert torch.equal(got[2][k], ref[2][k]), (name, i, mask, k)
    assert _counts() == before


@pytest.mark.parametrize("reduce", [None, _two_ranks], ids=["one_rank", "two_ranks"])
@pytest.mark.parametrize("link", ["none", "skip", "add", "both"])
@pytest.mark.parametrize("mask", ["batch_max", "utterance", "none"])
def test_closed_form_matches_autograd_in_float64(mask, link, reduce):
    """The Function on the kernels' plain twins (`chain_closed_form` on the
    CPU) against autograd of `chain_plain` in float64: output, BN state and
    the gradients of y, b, gamma, beta and the sources, within 1e-9 (the
    same arithmetic in another order); the bias's gradient, 0 but for
    rounding, within 1e-9 of ||dbeta||."""
    case = chain_case(12, 3, 7, torch.float64, mask=mask, link=link, seed=3, reduce=reduce)
    got = run_chain(bn_chain.chain_closed_form, case)
    ref = run_chain(bn_chain.chain_plain, case)
    assert_chain_close(got, ref, torch.float64)
    # the output and every gradient but the bias's are live
    assert (ref[0] != 0).float().mean() > 0.3
    assert all(v.abs().max() > 1e-3 for k, v in ref[2].items() if k != "b")


def test_closed_form_without_relu_matches_autograd_in_float64():
    """A BN layer without its ReLU (no variant has one; the chain takes it):
    the skip's gradient passes everywhere."""
    case = chain_case(10, 2, 5, torch.float64, link="both", seed=4)
    assert_chain_close(run_chain(bn_chain.chain_closed_form, case, relu=False),
                       run_chain(bn_chain.chain_plain, case, relu=False), torch.float64)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("fault", ["no_frame_mask", "skip_after_relu"])
def test_planted_faults_fail_the_check(fault, dtype):
    """The check that holds the chain to the plain chain in float64 sees a
    dropped frame mask and a skip added after the ReLU, in every dtype."""
    case = chain_case(12, 3, 7, dtype, link="skip", seed=5)
    got = run_chain(bn_chain.chain_closed_form, case)
    assert_chain_close(got, plain_reference(case), dtype)
    with pytest.raises(AssertionError):
        assert_chain_close(got, plain_reference(case, fault=fault), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("link", ["skip", "add"])
def test_closed_form_twins_in_the_card_dtypes(dtype, link):
    """In the compute dtypes of the card the twins (float32 arithmetic,
    one rounding) sit within CHAIN_TOL of the plain chain in float64, and
    nearer to it than the plain chain in the same dtype."""
    case = chain_case(15, 2, 9, dtype, link=link, seed=6)
    ref = plain_reference(case)
    got = run_chain(bn_chain.chain_closed_form, case)
    assert_chain_close(got, ref, dtype)
    mine, plain = chain_errors(got, ref), chain_errors(run_chain(bn_chain.chain_plain, case), ref)
    print(dtype, "twins", mine, "plain", plain)
    assert max(mine.values()) <= max(plain.values())


def test_twin_sums_are_the_plain_moments():
    """The moments twin is the plain chain's masked sums, and the grad-sums
    twin gives dbeta and dgamma."""
    case = chain_case(9, 2, 6, torch.float64, mask="utterance", link="skip", seed=7)
    y, p, batch = case["y"], case["p"], case["batch"]
    s = bn_chain.moments_twin(y, p["b"], batch)
    B, T = y.shape[:2]
    x = (y + p["b"].repeat(8)).reshape(B, T, 17, 8, 9)
    torch.testing.assert_close(s[0], (x * batch.m_bn).sum(dim=(0, 1, 2, 3)), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(s[1], (x * x * batch.m_bn).sum(dim=(0, 1, 2, 3)), rtol=1e-12, atol=1e-12)
    _, _, grads = run_chain(bn_chain.chain_plain, case)
    mean, var = blocks.moments_from_sums(s[0], s[1], batch.n)
    gs = bn_chain.grad_sums_twin(case["g"], y, case["skip"], p["b"], p["gamma"], p["beta"], mean, var, True, 129)
    torch.testing.assert_close(gs[0], grads["beta"], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(gs[1], grads["gamma"], rtol=1e-10, atol=1e-12)


def test_reduce_plan_covers_the_rows_in_order():
    for rows in (1, 7, 528, 529, 12 * 70, 64 * 384, 4 * 64 * 512):
        per, blocks_ = bn_chain.reduce_plan(rows)
        assert (blocks_ - 1) * per < rows <= blocks_ * per
        assert blocks_ <= bn_chain.REDUCE_BLOCKS


@pytest.mark.parametrize("bad", ["channels", "param", "skip"])
def test_bn_chain_checks_its_inputs(bad):
    case = chain_case(8, 1, 3, torch.float32, link="skip")
    y, p, skip = case["y"], dict(case["p"]), case["skip"]
    if bad == "channels":
        p = {k: torch.zeros(65) for k in p}
        y = torch.zeros(1, 3, 17, 8 * 65)
        skip = None
    elif bad == "param":
        p["gamma"] = p["gamma"][:4]
    else:
        skip = skip[:, :2]
    with pytest.raises(ValueError):
        bn_chain.chain_closed_form(y, p, case["state"], case["batch"], skip=skip)


def test_apply_blocked_takes_the_chain_in_training_mode(monkeypatch):
    """A training-mode forward sends each BN layer through `bn_chain` (the
    kernels on the card), with autograd on or off (the in-training
    validation's); eval mode keeps `chain_plain`."""
    calls = []
    real = blocked.bn_chain

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(blocked, "bn_chain", counting)
    model = get_model("FullyCNNV2")
    params, state = model.init(torch.Generator().manual_seed(0))
    x = torch.rand(1, 4, 129, 1)
    n_bn = sum(s.use_norm for s in model.layers)
    with torch.no_grad():
        blocked.apply_blocked(model, params, state, x, is_training=False)
    assert not calls
    with torch.no_grad():
        blocked.apply_blocked(model, params, state, x, is_training=True)
    assert len(calls) == n_bn == 15
    blocked.apply_blocked(model, params, state, x, is_training=True)
    assert len(calls) == 2 * n_bn


def _counts():
    return (bn_chain.launches_moments, bn_chain.launches_apply, bn_chain.launches_grad_sums,
            bn_chain.launches_grad_apply)


def _readings(by_kernel, steps):
    from portbench.drivers import Readings
    from portbench.reference.specs import MODELS

    trace = SimpleNamespace(kernel_s=lambda needles: sum(
        s for n, s in by_kernel.items() if any(x in n for x in needles)))
    return Readings(MODELS["FullyCNNV2"], "bfloat16", 5.0, trace, steps, [], None)


def test_roofline_reader_counts_each_bn_layer_once_a_tensor():
    from portbench.metrics import bn_chain_roofline
    from portbench.reference.specs import MODELS

    layers = MODELS["FullyCNNV2"]
    # V2: 15 BN layers of 253 channels, its 7 decoders (114 channels) with a skip
    assert sum(lay.out_ch for lay in layers if lay.use_norm) == 253
    skip = sum(lay.out_ch for lay in layers if lay.use_norm and lay.skip_from)
    assert skip == 114
    assert bn_chain_roofline.least_bytes(layers, 64, 281, 2) == 64 * 281 * 129 * 2 * (5 * 253 + skip)


def test_roofline_reader_shares_the_named_kernels_time():
    from portbench import peaks
    from portbench.metrics import bn_chain_roofline
    from portbench.reference.specs import MODELS

    need = 2 * bn_chain_roofline.least_bytes(MODELS["FullyCNNV2"], 64, 281, 2) / peaks.PEAK_BYTES_S
    r = _readings({"void (anonymous namespace)::bn_chain_apply_kernel<__nv_bfloat16>(...)": need,
                   "bn_chain_sum_partials_kernel(float const*, ...)": need,
                   "elementwise_kernel<...>": 5.0}, [(64, 281), (64, 281)])
    assert abs(bn_chain_roofline.read(r) - 50.0) < 1e-9


def test_roofline_reader_reads_nothing_without_the_kernels():
    """The parent has no such kernel: the reader returns None, not an error."""
    from portbench.drivers import Readings
    from portbench.metrics import bn_chain_roofline
    from portbench.reference.specs import MODELS

    assert bn_chain_roofline.read(_readings({"elementwise_kernel": 1.0}, [(64, 281)])) is None
    assert bn_chain_roofline.read(_readings({"bn_chain_apply_kernel": 1.0}, [])) is None
    untraced = Readings(MODELS["FullyCNNV2"], "bfloat16", 5.0, None, [(64, 281)], [], None)
    assert bn_chain_roofline.read(untraced) is None
