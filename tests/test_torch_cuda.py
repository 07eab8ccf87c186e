"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor the JAX package, so a machine with a card
and without JAX runs it (the tests' conftest imports JAX, hence
`--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Without CUDA every test here skips.  `numpy_params` is also the parameter
draw of the port's parity tests against the JAX package.
"""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.ops import blocked_dw, freq_conv, rced_stack
from fullycnnspeechenhancement_torch.probes import all_probes
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy

NAMES = ["FullyCNN", "FullyCNNV2", "FullyCNNV3"]
PROBES = {p.name: (m, p) for m, p in all_probes()}


def numpy_params(name, seed):
    """(params, bn_state) as the JAX package holds them (HWIO kernels), drawn
    with numpy from the model's layer specs: Glorot-range kernels, and
    non-trivial biases, BN affine and BN statistics."""
    rng = np.random.default_rng(seed)
    params, bn, ch = {}, {}, 1
    for spec in get_model(name).layers:
        kh, kw = spec.kernel
        lim = np.sqrt(6.0 / (kh * kw * (ch + spec.out_ch)))
        p = {
            "w": rng.uniform(-lim, lim, (kh, kw, ch, spec.out_ch)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(spec.out_ch)).astype(np.float32),
        }
        if spec.use_norm:
            p["gamma"] = (1 + 0.1 * rng.standard_normal(spec.out_ch)).astype(np.float32)
            p["beta"] = (0.1 * rng.standard_normal(spec.out_ch)).astype(np.float32)
            bn[spec.name] = {
                "mean": rng.random(spec.out_ch).astype(np.float32),
                "var": (1 + rng.random(spec.out_ch)).astype(np.float32),
            }
        params[spec.name] = p
        ch = spec.out_ch
    return params, bn


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread_per_worker():
    """The tier-1 run puts six pytest workers on the CPU, and torch's
    default of one thread per core in each of them oversubscribes it
    (measured on an 8-core host: the port's test files took 216 s with the
    default and 50 s with one thread each).  Port test files import this
    fixture, so it applies to their modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _packed(name, seed, device):
    params, bn = params_from_numpy(*numpy_params(name, seed), device=device)
    return rced_stack.pack_inference_stack(get_model(name), params, bn)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T", [70, 45])
def test_kernel_matches_plain_on_cuda(cuda_device, name, T):
    """T=45 is not a multiple of the JAX kernel's 32-frame tile."""
    packed = _packed(name, 1, cuda_device)
    x = torch.rand(2, packed.c_in, T, 129, generator=torch.Generator().manual_seed(T)).to(cuda_device)
    before = rced_stack.launches
    got = rced_stack.stack_forward(packed, x)
    torch.cuda.synchronize()
    assert rced_stack.launches == before + 1
    torch.testing.assert_close(got, rced_stack.stack_forward_plain(packed, x), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda_device):
    packed = _packed("FullyCNNV2", 0, cuda_device)
    x = torch.rand(1, 4, packed.c_in, 129, device=cuda_device).transpose(1, 2)
    before = rced_stack.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        rced_stack.stack_forward(packed, x)
    assert rced_stack.launches == before


def _dw_inputs(B, T, ci, co, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(B, T, 17, ci, generator=g).to(device)
    dy = torch.randn(B, T, 17, co, generator=g).to(device)
    return z, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 80, 96), (64, 512, 184, 200)], ids=["ragged", "v2_layer"])
def test_blocked_dw_matches_plain_on_cuda(cuda_device, shape):
    """B*T = 111 rows leaves ragged stages and splits; 64 x 512 is V2's
    encode_8 at the 8 s bucket.  f32 sums over up to 557k terms in another
    order: atol 1e-4 * max|plain|."""
    B, T, ci, co = shape
    z, dy = _dw_inputs(B, T, ci, co, cuda_device)
    before = blocked_dw.launches
    got = blocked_dw.blocked_dw(z, dy, 4, 2)
    torch.cuda.synchronize()
    assert blocked_dw.launches == before + 1
    ref = blocked_dw.blocked_dw_plain(z, dy, 4, 2)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    # no atomics: a second launch repeats the first bit for bit
    assert torch.equal(blocked_dw.blocked_dw(z, dy, 4, 2), got)


@pytest.mark.cuda
def test_blocked_freq_conv_gradients_match_autograd_on_cuda(cuda_device):
    z0, g = _dw_inputs(2, 9, 24, 16, cuda_device, seed=1)
    w0 = 0.1 * torch.randn(1, 4, 24, 16, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    torch.backends.cudnn.allow_tf32 = False
    grads = []
    for fn in (
        lambda z, w: blocked_dw.blocked_freq_conv(z, w, 2),
        lambda z, w: blocked_dw.conv_nhwc(z, w, ((0, 0), (2, 1))),
    ):
        z, w = z0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(z, w) * g).sum().backward()
        grads.append((z.grad, w.grad))
    (dzc, dwc), (dzr, dwr) = grads
    torch.testing.assert_close(dzc, dzr, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dwc, dwr, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "strided", "taps"])
def test_blocked_dw_raises_instead_of_falling_back(cuda_device, bad):
    z, dy = _dw_inputs(2, 5, 16, 24, cuda_device)
    kb = 4
    if bad == "float64":
        z, dy = z.double(), dy.double()
    elif bad == "strided":
        z = z.transpose(0, 1)
        dy = dy.transpose(0, 1)
    else:
        kb = blocked_dw.MAX_KB + 1
    before = blocked_dw.launches
    with pytest.raises(ValueError):
        blocked_dw.blocked_dw(z, dy, kb, 2)
    assert blocked_dw.launches == before


def _close_to_plain(got, ref):
    """f32 sums of up to 352 terms in another order: rtol 1e-5, atol 1e-5 *
    max|plain|."""
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_kernel_matches_plain_on_cuda(cuda_device, name):
    """Each probe at its script's shapes: one launch, equal to the plain
    version on the card."""
    module, probe = PROBES[name]
    arrays = module.inputs(np.random.default_rng(0))
    args = [torch.as_tensor(arrays[a], device=cuda_device) for a in probe.args]
    counter = "stack_launches" if probe.kernel == "freq_conv_stack" else "launches"
    before = getattr(freq_conv, counter)
    got = probe(*args)
    torch.cuda.synchronize()
    assert getattr(freq_conv, counter) == before + 1
    _close_to_plain(got, probe(*args, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [(25, 23, 7), (10, 12, 7), (21, 19, 5), (12, 10, 11)])
def test_freq_conv_matches_plain_on_v2_layers_on_cuda(cuda_device, layer):
    """V2 inner-layer shapes on NCHW activations [B, C, T, 129] viewed as
    [B, T, 129, C], T = 37 frames; the output keeps the NCHW order."""
    cin, cout, kw = layer
    g = torch.Generator().manual_seed(kw)
    x = torch.randn(3, cin, 37, 129, generator=g).to(cuda_device).permute(0, 2, 3, 1)
    w = torch.randn(kw, cin, cout, generator=g).to(cuda_device)
    got = freq_conv.freq_conv(x, w)
    torch.cuda.synchronize()
    assert got.permute(0, 3, 1, 2).is_contiguous()
    _close_to_plain(got, freq_conv.freq_conv_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,K,lo,dil,circular,period,valid,relu,scale",
    [(600, 11, None, 1, False, 0, 0, False, 1.0), (600, 5, 7, 3, False, 100, 37, True, 0.5),
     (517, 3, -2, 1, True, 0, 0, False, 1.0), (1000, 13, 6, 1, True, 250, 129, True, 1e-2),
     (7, 13, None, 1, False, 0, 0, False, 1.0), (7, 2, 3, 6, True, 0, 0, False, 1.0)],
)
def test_freq_conv_options_match_plain_on_cuda(cuda_device, P, K, lo, dil, circular, period,
                                               valid, relu, scale):
    """Several tiles of 256 positions with zero or wrapped halos, masks
    whose period is not the tile, taps wider than the row."""
    g = torch.Generator().manual_seed(P + K)
    x = torch.randn(2, 3, P, 6, generator=g).to(cuda_device)
    w = torch.randn(K, 6, 9, generator=g).to(cuda_device)
    opts = dict(lo=lo, dilation=dil, circular=circular, period=period, valid=valid, relu=relu,
                scale=scale)
    got = freq_conv.freq_conv(x, w, **opts)
    torch.cuda.synchronize()
    _close_to_plain(got, freq_conv.freq_conv_plain(x, w, **opts))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_freq_conv_stack_matches_chained_launches_on_cuda(cuda_device, depth):
    """The chain in one launch against `depth` launches of freq_conv: the
    same sums in the same order, plus exact zeros."""
    g = torch.Generator().manual_seed(depth)
    x = torch.rand(32, 8 * 256, generator=g).to(cuda_device)
    w = (0.05 * torch.rand(11, 32, 32, generator=g)).to(cuda_device)
    got = freq_conv.freq_conv_stack(x, w, depth)
    h = x
    for _ in range(depth):
        h = freq_conv.freq_conv(h.t()[None, None], w, circular=True, period=256, valid=129,
                                relu=True)[0, 0].t()
    torch.cuda.synchronize()
    _close_to_plain(got, h)
    _close_to_plain(got, freq_conv.freq_conv_stack_plain(x, w, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "taps", "w_shape", "stack_strided", "stack_halo"])
def test_freq_conv_raises_instead_of_falling_back(cuda_device, bad):
    x = torch.rand(1, 2, 129, 5, device=cuda_device)
    w = torch.rand(11, 5, 6, device=cuda_device)
    xs = torch.rand(4, 512, device=cuda_device)
    ws = torch.rand(11, 4, 4, device=cuda_device)
    calls = {
        "float64": lambda: freq_conv.freq_conv(x.double(), w.double()),
        "taps": lambda: freq_conv.freq_conv(x, torch.rand(14, 5, 6, device=cuda_device)),
        "w_shape": lambda: freq_conv.freq_conv(x, w[:, :4]),
        "stack_strided": lambda: freq_conv.freq_conv_stack(xs.t().contiguous().t(), ws, 2),
        "stack_halo": lambda: freq_conv.freq_conv_stack(xs, ws, 2, valid=253),
    }
    before = (freq_conv.launches, freq_conv.stack_launches)
    with pytest.raises(ValueError):
        calls[bad]()
    assert (freq_conv.launches, freq_conv.stack_launches) == before
