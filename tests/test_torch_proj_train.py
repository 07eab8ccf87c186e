"""The final (1, 129) projection of the blocked training step
(`ops/proj_train.py`).

On the CPU: its CPU path bit for bit the projection `models/blocked.py`
ran before the kernels, `apply_blocked`'s one branch (bf16 to
`proj_train`, float32 and float64 to `proj_plain`), the Toeplitz twin of
the kernels' formulation against `proj_plain` in float64, dW's launch plan,
and the benchmark's reader of the kernels' roofline share
(`portbench/metrics/proj_train_roofline.py`) on synthetic readings.

On the card (skipped without CUDA): the forward, dX, dW and db kernels
against `proj_plain` in float64 on the same bf16 values, the pad band of
dX, the launch counters, repeats bit for bit, a planted fault, the raises,
and a V2 bf16 blocked step with the kernels against the one with cuDNN:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_proj_train.py
"""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from fullycnnspeechenhancement_torch.models import blocked, get_model
from fullycnnspeechenhancement_torch.models.blocks import tf_same_pads
from fullycnnspeechenhancement_torch.ops import proj_train
from fullycnnspeechenhancement_torch.ops.blocked_dw import conv_nhwc
from test_torch_cuda import NAMES, numpy_params, one_cpu_thread_per_worker  # noqa: F401

F_DIM = 129
DTYPES = [torch.float32, torch.bfloat16, torch.float64]
# On the card, each result against the float64 plain projection on the same
# bf16 values: |got - ref| <= rtol |ref| + atol max|ref|.  Each result is a
# float32 sum rounded once to bf16: half an ulp, up to 2^-8 of the value
# just above a power of 2, so rtol is one ulp's 2^-7; the float32 sums' own
# error is under 1e-5 of their terms' magnitudes, which atol covers where a
# sum cancels.  (The float32 Toeplitz twin rounded to bf16 reads 0.3-0.5 of
# this bound on the CPU; a kernel shifted by one tap about 400.)
PROJ_TOL = (2.0**-7, 1e-3)


def _channels(name):
    """C, the projection's input channels, of the model `name`."""
    return get_model(name).layers[-2].out_ch


def _case(name, B, T, dtype, device="cpu", seed=0, fb=8):
    """(z [B, T, NB, fb*C] with a zero pad band, w [1, C, 1, 129], b [1],
    dy [B, T, F, 1]), all in `dtype`."""
    gen = torch.Generator().manual_seed(seed)
    C = _channels(name)
    nb = -(-F_DIM // fb)
    z = torch.randn(B, T, nb * fb, C, generator=gen)
    z[:, :, F_DIM:] = 0
    w = torch.randn(1, C, 1, F_DIM, generator=gen) * (1.0 / (C * F_DIM) ** 0.5)
    b = torch.randn(1, generator=gen) * 0.1
    dy = torch.randn(B, T, F_DIM, 1, generator=gen)
    return tuple(t.to(device=device, dtype=dtype) for t in (z.reshape(B, T, nb, fb * C), w, b, dy))


def _before(z, w, b, f_dim):
    """The projection as `apply_blocked` wrote it inline before
    `ops/proj_train.py` existed, kept as the witness that the CPU path is
    unchanged."""
    cin = w.shape[1]
    xn = blocked.unblock_output(z, f_dim, cin)
    y = conv_nhwc(xn, w.permute(2, 3, 1, 0), tf_same_pads((1, w.shape[3])))
    return y + b


def _grads(fn, z, w, b, dy, dtype=None):
    """(y, dz, dw, db) of fn on leaves of z, w, b (cast to `dtype`)."""
    leaves = [t.detach().to(dtype or t.dtype).requires_grad_(True) for t in (z, w, b)]
    y = fn(*leaves, F_DIM)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy.to(y.dtype)))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_cpu_path_is_the_projection_before_bit_for_bit(name, dtype):
    z, w, b, dy = _case(name, 2, 5, dtype, seed=1)
    want = _grads(_before, z, w, b, dy)
    for fn in (proj_train.proj_train, proj_train.proj_plain):
        got = _grads(fn, z, w, b, dy)
        assert all(torch.equal(g, r) for g, r in zip(got, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_apply_blocked_takes_one_branch_on_the_dtype(monkeypatch, dtype):
    """bf16 goes through `proj_train` (the kernels on the card), float32 and
    float64 straight to `proj_plain` (cuDNN on the card), once a forward,
    and the model's output is the projection's."""
    calls = []

    def counting(name, fn):
        def call(*a, **k):
            calls.append(name)
            out = fn(*a, **k)
            calls.append(out)
            return out

        return call

    monkeypatch.setattr(blocked, "proj_train", counting("proj_train", proj_train.proj_train))
    monkeypatch.setattr(blocked, "proj_plain", counting("proj_plain", proj_train.proj_plain))
    model = get_model("FullyCNNV2")
    params, state = model.init(torch.Generator().manual_seed(0))
    x = torch.rand(2, 6, F_DIM, 1).to(dtype)
    y, _ = blocked.apply_blocked(model, params, state, x, is_training=True)
    assert calls[0] == ("proj_train" if dtype == torch.bfloat16 else "proj_plain")
    assert len(calls) == 2 and calls[1] is y
    assert y.shape == (2, 6, F_DIM, 1) and y.dtype == dtype


@pytest.mark.parametrize("fb", [8, 4])
@pytest.mark.parametrize("name", NAMES)
def test_toeplitz_twin_matches_plain_in_float64(name, fb):
    """The kernels' formulation (a product with one Toeplitz band over the
    blocked (bin, channel) positions) and its autograd (dX against the
    band's transpose, its pad band 0; dW by the band's diagonal sums) are
    the conv's."""
    z, w, b, dy = _case(name, 3, 7, torch.float64, seed=2, fb=fb)
    got = _grads(proj_train.proj_toeplitz, z, w, b, dy)
    want = _grads(proj_train.proj_plain, z, w, b, dy)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)
    C = w.shape[1]
    assert not got[1].reshape(3, 7, -1, C)[:, :, F_DIM:].any()


def test_toeplitz_band_holds_each_tap_on_its_diagonal():
    z, w, b, _ = _case("FullyCNNV2", 1, 1, torch.float64)
    band = proj_train.band(w, 136, F_DIM)
    C, lo = 10, 64
    for f_in, c, f_out in [(0, 0, 0), (3, 7, 60), (128, 9, 128), (70, 2, 6), (5, 5, 69)]:
        assert band[f_in * C + c, f_out] == w[0, c, 0, f_in - f_out + lo]
    assert band[0, 65] == 0 and band[128 * C, 63] == 0  # beyond the kernel's reach
    assert not band[F_DIM * C:].any()  # the pad band


@pytest.mark.parametrize("rows", [1, 7, 375, 24576, 100_000])
@pytest.mark.parametrize("columns", [1088, 1360, 1632])
def test_dw_plan_covers_the_rows_in_whole_stages(rows, columns):
    plan = proj_train.dw_plan(rows, columns, 132)
    assert plan.tiles == -(-columns // proj_train.DW_COLS)
    assert plan.rows_per_split % proj_train.DW_ROWS == 0
    assert plan.splits * plan.rows_per_split >= rows > (plan.splits - 1) * plan.rows_per_split
    assert plan.tiles * plan.splits <= max(plan.tiles, proj_train.DW_BLOCKS_PER_SM * 132)


# --- the benchmark's reader


def _readings(by_kernel, steps, trace=True):
    from portbench.drivers import Readings
    from portbench.reference.specs import MODELS

    summary = SimpleNamespace(kernel_s=lambda needles: sum(
        s for n, s in by_kernel.items() if any(x in n for x in needles)))
    return Readings(MODELS["FullyCNNV2"], "bfloat16", 5.0, summary if trace else None, steps, [], None)


def test_roofline_reader_counts_three_passes_over_the_projection():
    from portbench.metrics import proj_train_roofline
    from portbench.reference.specs import MODELS

    flop, nbytes = proj_train_roofline.least_work(MODELS["FullyCNNV2"], 64, 384, 2)
    assert flop == 3 * 2 * 64 * 384 * 10 * 12_481
    assert nbytes == 2 * 64 * 384 * 129 * 33 + 4 * 129 * 10


def test_roofline_reader_shares_the_named_kernels_time():
    from portbench import peaks, work
    from portbench.metrics import proj_train_roofline
    from portbench.reference.specs import MODELS

    need = work.roofline_s(*proj_train_roofline.least_work(MODELS["FullyCNNV2"], 64, 281, 2),
                           peaks.PEAK_FLOP_S["bfloat16"], peaks.PEAK_BYTES_S)
    r = _readings({"(anonymous namespace)::proj_train_fwd_kernel(...)": need,
                   "(anonymous namespace)::proj_train_dw_reduce_kernel(...)": 3 * need,
                   "rced_proj_kernel(...)": 7.0, "void_convolve_common_engine_float_NHWC": 9.0},
                  [(64, 281), (64, 281)])
    assert abs(proj_train_roofline.read(r) - 50.0) < 1e-9


def test_roofline_reader_reads_nothing_without_the_kernels():
    """The parent has no such kernel: the reader returns None, not an error."""
    from portbench.metrics import proj_train_roofline

    assert proj_train_roofline.read(_readings({"rced_proj_kernel": 1.0}, [(64, 281)])) is None
    assert proj_train_roofline.read(_readings({"proj_train_fwd_kernel": 1.0}, [])) is None
    assert proj_train_roofline.read(_readings({"proj_train_fwd_kernel": 1.0}, [(64, 281)], trace=False)) is None


# --- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _counts():
    return proj_train.launches_fwd, proj_train.launches_dx, proj_train.launches_dw


def proj_errors(got, want):
    """Per result (y, dz, dw, db): the largest |got - ref| over rtol |ref| +
    atol max|ref| (PROJ_TOL), so 1 is the tolerance."""
    rtol, atol = PROJ_TOL
    out = {}
    for key, g, r in zip(("y", "dz", "dw", "db"), got, want):
        g, r = g.double(), r.double()
        bound = rtol * r.abs() + atol * r.abs().max()
        out[key] = ((g - r).abs() / bound).max().item()
    return out


def assert_proj_close(got, want):
    errs = proj_errors(got, want)
    bad = {k: v for k, v in errs.items() if not v <= 1.0}
    assert not bad, f"past the tolerance {PROJ_TOL} (1 = the bound): {bad}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 384), (1, 7), (3, 125)], ids=["cell", "1x7", "3x125"])
@pytest.mark.parametrize("name", NAMES)
def test_kernels_match_plain_in_float64_on_cuda(cuda_device, name, shape):
    z, w, b, dy = _case(name, *shape, torch.bfloat16, cuda_device, seed=3)
    before = _counts()
    got = _grads(proj_train.proj_train, z, w, b, dy)
    torch.cuda.synchronize()
    assert _counts() == tuple(n + 1 for n in before)
    assert_proj_close(got, _grads(proj_train.proj_plain, z, w, b, dy, torch.float64))
    C = w.shape[1]
    assert not got[1].reshape(*shape, -1, C)[:, :, F_DIM:].any()  # dX's pad band
    assert got[1].dtype == got[2].dtype == got[3].dtype == torch.bfloat16


@pytest.mark.cuda
def test_forward_alone_launches_only_the_forward_on_cuda(cuda_device):
    z, w, b, _ = _case("FullyCNNV2", 2, 40, torch.bfloat16, cuda_device)
    before = _counts()
    with torch.no_grad():
        proj_train.proj_train(z, w, b, F_DIM)
    assert _counts() == (before[0] + 1, before[1], before[2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 125), (64, 384)], ids=["3x125", "cell"])
def test_kernels_repeat_bit_for_bit_on_cuda(cuda_device, shape):
    """Fixed-order sums, no atomics: two runs give the same bits."""
    z, w, b, dy = _case("FullyCNNV2", *shape, torch.bfloat16, cuda_device, seed=4)
    first, second = (_grads(proj_train.proj_train, z, w, b, dy) for _ in range(2))
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.cuda
def test_check_sees_a_tap_shifted_on_cuda(cuda_device):
    """The comparison above fails against a plain projection whose kernel is
    shifted by one tap."""
    z, w, b, dy = _case("FullyCNNV2", 3, 125, torch.bfloat16, cuda_device, seed=5)
    got = _grads(proj_train.proj_train, z, w, b, dy)
    assert_proj_close(got, _grads(proj_train.proj_plain, z, w, b, dy, torch.float64))
    shifted = torch.roll(w, 1, dims=3)
    with pytest.raises(AssertionError):
        assert_proj_close(got, _grads(proj_train.proj_plain, z, shifted, b, dy, torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float32", "odd_channels", "misaligned", "bins"])
def test_kernels_raise_instead_of_falling_back_on_cuda(cuda_device, bad):
    z, w, b, _ = _case("FullyCNNV2", 2, 6, torch.bfloat16, cuda_device)
    f_dim = F_DIM
    if bad == "float32":
        z, w, b = z.float(), w.float(), b.float()
    elif bad == "odd_channels":
        z = torch.zeros(2, 6, 17, 8 * 9, dtype=torch.bfloat16, device=cuda_device)
        w = torch.zeros(1, 9, 1, F_DIM, dtype=torch.bfloat16, device=cuda_device)
    elif bad == "misaligned":
        z = torch.zeros(z.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:].view(z.shape)
    else:
        f_dim = 120
    before = _counts()
    with pytest.raises(ValueError):
        proj_train.proj_train(z, w, b, f_dim)
    assert _counts() == before


def _step_grads(cuda_device, dtype, project=None, monkeypatch=None):
    """The leaves' gradients of a V2 blocked training forward and backward at
    8 x 96 frames in `dtype`, optionally with the projection replaced."""
    from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy

    if project is not None:
        monkeypatch.setattr(blocked, "proj_train", project)
    model = get_model("FullyCNNV2")
    params, state = params_from_numpy(*numpy_params("FullyCNNV2", 3, centred_bn=True), device=cuda_device)
    leaves = [t.requires_grad_(True) for v in params.values() for t in v.values()]
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.rand(8, 96, F_DIM, 1, device=cuda_device, generator=gen).to(dtype)
    fm = (torch.arange(96, device=cuda_device) < 80).float()[None]
    y, _ = blocked.apply_blocked(model, params, state, x, is_training=True, frame_mask=fm, dw_pallas=True)
    grads = torch.autograd.grad(y.float().square().sum(), leaves)
    return torch.cat([g.reshape(-1).double() for g in grads])


@pytest.mark.cuda
def test_blocked_step_with_the_kernels_against_cudnn_on_cuda(cuda_device, monkeypatch):
    """A V2 bf16 step through the kernels (one launch of each) against the
    same step with the projection on cuDNN: the gradients within the
    training cell's `grad_err` limit; a float32 step launches none."""
    limits = os.path.join(os.path.dirname(__file__), "..", "portbench", "limits", "rced16-train-cached.json")
    with open(limits) as fh:
        grad_err = json.load(fh)["grad_err"]
    before = _counts()
    kernels = _step_grads(cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    assert _counts() == tuple(n + 1 for n in before)
    cudnn = _step_grads(cuda_device, torch.bfloat16, proj_train.proj_plain, monkeypatch)
    err = ((kernels - cudnn).norm() / cudnn.norm()).item()
    assert torch.isfinite(kernels).all() and err < grad_err
    monkeypatch.undo()
    before = _counts()
    _step_grads(cuda_device, torch.float32)
    assert _counts() == before
