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

from fullycnnspeechenhancement_torch.models import blocks, get_model
from fullycnnspeechenhancement_torch.ops import blocked_dw, bn_chain, freq_conv, rced_edges, rced_stack
from fullycnnspeechenhancement_torch.probes import all_probes
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy

NAMES = ["FullyCNN", "FullyCNNV2", "FullyCNNV3"]
PROBES = {p.name: (m, p) for m, p in all_probes()}


def numpy_params(name, seed, centred_bn=False):
    """(params, bn_state) as the JAX package holds them (HWIO kernels), drawn
    with numpy from the layer specs of the model `name` names (or of the
    ModelDef `name` is): Glorot-range kernels, and
    non-trivial biases, BN affine and BN statistics.  BN means are U(0, 1),
    or U(-0.5, 0.5) with `centred_bn`: the uncentred shift leaves most of
    V2's and all of V3's inner stack at 0 on inputs in [0, 1), while the
    centred one keeps every layer's ReLUs alive."""
    rng = np.random.default_rng(seed)
    params, bn, ch = {}, {}, 1
    for spec in (get_model(name) if isinstance(name, str) else name).layers:
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
                "mean": (rng.random(spec.out_ch) - (0.5 if centred_bn else 0.0)).astype(np.float32),
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


def assert_live(ref, share=0.1):
    """A stack output that can tell a right kernel from a wrong one: more
    than `share` of it nonzero and more than `share` of it distinct values
    (not the zeros or bias-only constants of ReLUs that never fire)."""
    n = ref.numel()
    assert (ref != 0).sum().item() > share * n, "the stack's output is mostly 0"
    assert ref.unique().numel() > share * n, "the stack's output takes few distinct values"


def _packed(name, seed, device):
    params, bn = params_from_numpy(*numpy_params(name, seed, centred_bn=True), device=device)
    return rced_stack.pack_inference_stack(get_model(name), params, bn)


# (B, T): the JAX kernel's test shapes (T=45 is not a multiple of its
# 32-frame tile), the 1.5 s and 30 s requests, and a batch of 8 s
STACK_SHAPES = [(2, 70), (2, 45), (1, 124), (1, 1999)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,B,T", [(n, B, T) for n in NAMES for B, T in STACK_SHAPES] + [("FullyCNNV2", 4, 499)]
)
def test_kernel_matches_plain_on_cuda(cuda_device, name, B, T):
    packed = _packed(name, 1, cuda_device)
    x = torch.rand(B, packed.c_in, T, 129, generator=torch.Generator().manual_seed(T)).to(cuda_device)
    before = rced_stack.launches
    got = rced_stack.stack_forward(packed, x)
    torch.cuda.synchronize()
    assert rced_stack.launches == before + 1
    ref = rced_stack.stack_forward_plain(packed, x)
    assert_live(ref)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_kernel_repeats_bit_for_bit_on_cuda(cuda_device, name):
    """No atomics and a fixed order of products: two launches agree."""
    packed = _packed(name, 2, cuda_device)
    x = torch.rand(3, packed.c_in, 97, 129, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    assert_live(rced_stack.stack_forward_plain(packed, x))
    assert torch.equal(rced_stack.stack_forward(packed, x), rced_stack.stack_forward(packed, x))


@pytest.mark.cuda
def test_kernel_wrapper_raises_instead_of_falling_back(cuda_device):
    packed = _packed("FullyCNNV2", 0, cuda_device)
    x = torch.rand(1, 4, packed.c_in, 129, device=cuda_device).transpose(1, 2)
    before = rced_stack.launches
    with pytest.raises(ValueError, match="contiguous float32"):
        rced_stack.stack_forward(packed, x)
    assert rced_stack.launches == before


# (name, B, T) of the edge kernels: a frame, a ragged few, a 2 s request,
# a 32 s one, at B = 1 and 4, and a 416 s call (25,999 frames)
EDGE_SHAPES = [(n, B, T) for n in NAMES for B in (1, 4) for T in (1, 7, 124, 2001)] + [
    (n, 1, 25999) for n in NAMES]


def _edge_inputs(e, B, T, device, seed):
    g = torch.Generator().manual_seed(seed)
    mag = (10 * torch.rand(B, T, 129, generator=g)).to(device)
    z = (torch.rand(B, e.proj_channels, T, 129, generator=g) - 0.5).to(device)
    return mag, z


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,T", EDGE_SHAPES)
def test_edge_kernels_match_plain_on_cuda(cuda_device, name, B, T):
    """Layer 1 and the projection against their plain versions (cuDNN with
    TF32 off) within 1e-5 * max|plain|: the same float32 products, summed
    in another order."""
    e = _packed(name, 1, cuda_device).edges
    mag, z = _edge_inputs(e, B, T, cuda_device, seed=T)
    before = (rced_edges.launches_first, rced_edges.launches_proj)
    y1, out = rced_edges.first_forward(e, mag), rced_edges.proj_forward(e, z)
    torch.cuda.synchronize()
    assert (rced_edges.launches_first, rced_edges.launches_proj) == (before[0] + 1, before[1] + 1)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        ref1, ref = rced_edges.first_plain(e, mag), rced_edges.proj_plain(e, z)
    assert_live(ref1)
    assert y1.shape == ref1.shape and out.shape == ref.shape == (B, T, 129)
    for got, want in ((y1, ref1), (out, ref)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_edge_kernels_repeat_bit_for_bit_on_cuda(cuda_device, name):
    """No atomics and a fixed order of products: two launches agree."""
    e = _packed(name, 2, cuda_device).edges
    mag, z = _edge_inputs(e, 3, 97, cuda_device, seed=9)
    assert torch.equal(rced_edges.first_forward(e, mag), rced_edges.first_forward(e, mag))
    assert torch.equal(rced_edges.proj_forward(e, z), rced_edges.proj_forward(e, z))


@pytest.mark.cuda
def test_edge_wrappers_raise_instead_of_falling_back(cuda_device):
    e = _packed("FullyCNNV2", 0, cuda_device).edges
    before = (rced_edges.launches_first, rced_edges.launches_proj)
    with pytest.raises(ValueError, match="contiguous"):
        rced_edges.first_forward(e, torch.rand(1, 129, 5, device=cuda_device).transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        rced_edges.proj_forward(e, torch.rand(1, 10, 5, 129, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError, match="edge weights on cpu"):
        rced_edges.proj_forward(_packed("FullyCNNV2", 0, "cpu").edges, torch.rand(1, 10, 5, 129, device=cuda_device))
    assert (rced_edges.launches_first, rced_edges.launches_proj) == before


@pytest.mark.cuda
def test_engine_request_runs_the_three_kernels_and_no_cudnn_conv(cuda_device):
    """One fused request launches each edge kernel and the stack kernel
    once, and its device trace holds no cuDNN convolution."""
    from torch.profiler import ProfilerActivity, profile

    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    engine = InferenceEngine(Config(model=ModelConfig(net_work="FullyCNNV2", fused_inference=True)), device="cuda")
    sig = (0.1 * np.random.default_rng(0).standard_normal(3 * 8000)).astype(np.float32)
    engine.denoise_array(sig)  # builds the kernels

    def counts():
        return rced_edges.launches_first, rced_stack.launches, rced_edges.launches_proj

    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.denoise_array(sig)
    assert counts() == tuple(n + 1 for n in before)
    names = {ev.name for ev in prof.events()}
    assert any("rced_stack_kernel" in n for n in names), "the trace holds no device kernel"
    assert any("rced_first_kernel" in n for n in names) and any("rced_proj_kernel" in n for n in names)
    assert not [n for n in names if "cudnn_convolution" in n or "implicit_convolve" in n]


def _dw_inputs(B, T, ci, co, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(B, T, 17, ci, generator=g).to(device)
    dy = torch.randn(B, T, 17, co, generator=g).to(device)
    return z, dy


# V2's 14 inner layers in blocked form at fb 8: (Ci, Co) = 8 x its channels
V2_DW_SHAPES = [(80, 96), (96, 112), (112, 120), (120, 152), (152, 168), (168, 184), (184, 200),
                (200, 184), (184, 168), (168, 152), (152, 120), (120, 112), (112, 96), (96, 80)]
# (B, T, Ci, Co, KB, dc): B*T = 111 rows leave ragged stages and splits
DW_CASES = (
    [(3, 37, ci, co, 4, 2) for ci, co in V2_DW_SHAPES]
    + [(3, 37, 72, 88, kb, dc) for kb in range(1, 9) for dc in sorted({0, kb - 1})]
    + [(3, 37, 21, 13, 4, 2), (64, 512, 184, 200, 4, 2)]
)
DW_IDS = (
    [f"v2_{ci}x{co}" for ci, co in V2_DW_SHAPES]
    + [f"kb{kb}_dc{dc}" for kb in range(1, 9) for dc in sorted({0, kb - 1})]
    + ["ci21_co13", "v2_layer"]
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_CASES, ids=DW_IDS)
def test_blocked_dw_matches_plain_on_cuda(cuda_device, case):
    """V2's 14 (Ci, Co) pairs, KB 1..8 with dc at both ends, a Ci and Co
    that are not multiples of 4 (the kernel's scalar staging), and 64 x
    512, V2's encode_8 at the 8 s bucket.  f32 sums over up to 557k terms
    in another order: atol 1e-4 * max|plain|."""
    B, T, ci, co, kb, dc = case
    z, dy = _dw_inputs(B, T, ci, co, cuda_device)
    before = blocked_dw.launches
    got = blocked_dw.blocked_dw(z, dy, kb, dc)
    torch.cuda.synchronize()
    assert blocked_dw.launches == before + 1
    ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    # no atomics: a second launch repeats the first bit for bit
    assert torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got)


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
    """Several tiles a row with zero or wrapped halos, masks whose period
    is not the tile, taps wider than the row."""
    g = torch.Generator().manual_seed(P + K)
    x = torch.randn(2, 3, P, 6, generator=g).to(cuda_device)
    w = torch.randn(K, 6, 9, generator=g).to(cuda_device)
    opts = dict(lo=lo, dilation=dil, circular=circular, period=period, valid=valid, relu=relu,
                scale=scale)
    got = freq_conv.freq_conv(x, w, **opts)
    torch.cuda.synchronize()
    _close_to_plain(got, freq_conv.freq_conv_plain(x, w, **opts))


# (B, R, P, C, D, layout): V2 layer shapes at T = 37 to 499 frames in the
# port's NCHW activations and in NHWC; D not a multiple of 8, D = 1, and
# D = 45 (two passes of n8 tiles); 64 x 499 rows run on persistent blocks
V2_CONV_SHAPES = [
    (2, 64, 129, 23, 25, "nchw"), (2, 64, 129, 23, 25, "nhwc"), (1, 499, 129, 10, 12, "nchw"),
    (3, 70, 129, 25, 23, "nhwc"), (2, 64, 129, 19, 1, "nchw"), (1, 80, 129, 12, 1, "nhwc"),
    (2, 64, 129, 21, 19, "nchw"), (1, 37, 129, 14, 45, "nhwc"), (64, 499, 129, 25, 23, "nchw"),
]


def _conv_input(shape, seed, device):
    B, R, P, C, _, layout = shape
    g = torch.Generator().manual_seed(seed)
    if layout == "nchw":
        return torch.randn(B, C, R, P, generator=g).to(device).permute(0, 2, 3, 1)
    return torch.randn(B, R, P, C, generator=g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", V2_CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kw", [5, 11])
def test_freq_conv_tensor_cores_match_plain_on_v2_shapes_on_cuda(cuda_device, shape, kw):
    """The 3xTF32 kernel on NCHW and NHWC views at V2 widths, T >= 37
    frames (whole rows of 129 bins a tile, two m16 tiles a warp at D <=
    24, persistent blocks at 64 x 499): one launch, y in x's dimension
    order, equal to the plain version."""
    x = _conv_input(shape, kw, cuda_device)
    w = torch.randn(kw, shape[3], shape[4], generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = freq_conv.launches
    got = freq_conv.freq_conv(x, w)
    torch.cuda.synchronize()
    assert freq_conv.launches == before + 1
    order = sorted(range(4), key=lambda i: x.stride(i), reverse=True)
    assert got.permute(order).is_contiguous()
    _close_to_plain(got, freq_conv.freq_conv_plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [7, 129, 16_384])
@pytest.mark.parametrize("K,lo", [(11, None), (1, 3), (4, -5)])
def test_freq_conv_circular_rows_on_cuda(cuda_device, P, K, lo):
    """Circular rows shorter than an m16 tile, of one V2 row, and of the
    roll layout's 64 frames (tiles that cut across frames)."""
    g = torch.Generator().manual_seed(P + K)
    x = torch.rand(32, P, generator=g).to(cuda_device).t()[None, None]
    w = torch.rand(K, 24, 32, generator=g).to(cuda_device).transpose(1, 2)[:, :, :20]
    _close_to_plain(freq_conv.freq_conv(x, w, lo=lo, circular=True),
                    freq_conv.freq_conv_plain(x, w, lo=lo, circular=True))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_freq_conv_dilated_stride0_weights_on_cuda(cuda_device, layout):
    """min.k4's form: two taps 6 bins apart that share one weight matrix
    through a stride-0 view, lo = 3."""
    x = _conv_input((1, 64, 129, 25, 25, layout), 6, cuda_device)
    w = torch.rand(25, 25, generator=torch.Generator().manual_seed(6)).to(cuda_device)[None].expand(2, 25, 25)
    opts = dict(lo=3, dilation=6)
    _close_to_plain(freq_conv.freq_conv(x, w, **opts), freq_conv.freq_conv_plain(x, w, **opts))


@pytest.mark.cuda
@pytest.mark.parametrize("period,valid", [(256, 129), (64, 17), (48, 0)])
def test_freq_conv_skips_masked_tiles_on_cuda(cuda_device, period, valid):
    """Masks whose dead lanes fill whole m16 tiles (skipped, written as
    zeros) and leave partial ones (computed, then masked), with ReLU and a
    scale; the plan counts the skipped tiles."""
    g = torch.Generator().manual_seed(period + valid)
    x = torch.randn(16, 16 * 256, generator=g).to(cuda_device).t()[None, None]
    w = torch.randn(11, 16, 16, generator=g).to(cuda_device)
    opts = dict(circular=True, period=period, valid=valid, relu=True, scale=0.25)
    got = freq_conv.freq_conv(x, w, **opts)
    ref = freq_conv.freq_conv_plain(x, w, **opts)
    plan = freq_conv.launch_plan(x, w, **{k: v for k, v in opts.items() if k != "scale"})
    p = torch.arange(16 * 256).view(-1, 16)
    assert plan.skipped_tiles == int((~(p % period < valid).any(1)).sum())
    assert plan.skipped_tiles > 0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * max(ref.abs().max().item(), 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv.vA", "roll.k2", "min.min2_k5"])
def test_freq_conv_repeats_bit_for_bit_on_cuda(cuda_device, name):
    """No atomics and a fixed order of products: two launches agree, also
    on persistent blocks (V2's encode_8 at 64 x 499 rows)."""
    module, probe = PROBES[name]
    arrays = module.inputs(np.random.default_rng(1))
    args = [torch.as_tensor(arrays[a], device=cuda_device) for a in probe.args]
    assert torch.equal(probe(*args), probe(*args))
    x = _conv_input((64, 499, 129, 23, 25, "nchw"), 2, cuda_device)
    w = torch.randn(11, 23, 25, generator=torch.Generator().manual_seed(3)).to(cuda_device)
    assert freq_conv.launch_plan(x, w).buffers == 2
    assert torch.equal(freq_conv.freq_conv(x, w), freq_conv.freq_conv(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_freq_conv_stack_matches_chained_launches_on_cuda(cuda_device, depth):
    """The chain in one launch (3xTF32 tensor cores, a cluster of two blocks
    a frame) against `depth` launches of freq_conv (3xTF32 tensor cores),
    and both against the plain version."""
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


@pytest.fixture(params=[2, 1], ids=["cluster2", "cluster1"])
def stack_cluster(request, monkeypatch):
    """Both plans of freq_conv_stack: a cluster of two blocks a frame (each
    half of the output channels), and one block a frame."""
    monkeypatch.setattr(freq_conv, "STACK_CLUSTER", request.param)
    freq_conv.replan()
    yield request.param
    monkeypatch.undo()
    freq_conv.replan()


def _chain_inputs(C, K, frames, seed, device, layout="plain"):
    """x in [0, 1) and weights in [0, 1) * 2 / (C K), so each layer keeps
    the activations' scale; w as [K, C, C] contiguous, or as the probes'
    strided views: k3's transpose of [K, Cout, Cin], roll2's im2col
    [Cout, K * Cin] viewed as [K, Cin, Cout]."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(C, frames * 256, generator=g).to(device)
    w = (2.0 / (C * K) * torch.rand(K, C, C, generator=g)).to(device)
    if layout == "k3":
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "im2col":
        w = w.permute(2, 0, 1).reshape(C, K * C).reshape(C, K, C).permute(1, 2, 0)
    return x, w


def _chained(x, w, depth, scale=1.0):
    h = x
    for _ in range(depth):
        h = freq_conv.freq_conv(h.t()[None, None], w, circular=True, period=256, valid=129,
                                relu=True, scale=scale)[0, 0].t()
    return h


@pytest.mark.cuda
@pytest.mark.parametrize("C", [3, 8, 20, 32])
@pytest.mark.parametrize("K", [1, 5, 11, 13])
def test_freq_conv_stack_matches_plain_across_the_domain_on_cuda(cuda_device, stack_cluster, C, K):
    """64 frames, depth 3, im2col-strided weights: one launch, equal to the
    plain version and to chained freq_conv launches, under both plans (C =
    3 and 8 have one n8 tile: one block a frame either way)."""
    x, w = _chain_inputs(C, K, 64, C * 100 + K, cuda_device, "im2col")
    plan = freq_conv.stack_launch_plan(x, w)
    assert plan.cluster == min(stack_cluster, -(-C // 8)) and plan.grid == 64 * plan.cluster
    before = freq_conv.stack_launches
    got = freq_conv.freq_conv_stack(x, w, 3, scale=0.5)
    torch.cuda.synchronize()
    assert freq_conv.stack_launches == before + 1
    ref = freq_conv.freq_conv_stack_plain(x, w, 3, scale=0.5)
    assert_live(ref)
    _close_to_plain(got, ref)
    _close_to_plain(got, _chained(x, w, 3, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["plain", "k3", "im2col"])
@pytest.mark.parametrize("depth", [1, 16])
def test_freq_conv_stack_deep_chains_on_cuda(cuda_device, stack_cluster, layout, depth):
    """roll2's shape (C = 32, 64 frames, K = 11) at depth 1 and 16, each
    weight layout, both plans."""
    x, w = _chain_inputs(32, 11, 64, depth, cuda_device, layout)
    got = freq_conv.freq_conv_stack(x, w, depth)
    ref = freq_conv.freq_conv_stack_plain(x, w, depth)
    assert_live(ref)
    _close_to_plain(got, ref)
    _close_to_plain(got, _chained(x, w, depth))


@pytest.mark.cuda
@pytest.mark.parametrize("mb,ksplit", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_freq_conv_stack_other_warp_plans_on_cuda(cuda_device, monkeypatch, mb, ksplit):
    """One m16 tile a warp, fewer K splits, no K split, at roll2's shape."""
    monkeypatch.setattr(freq_conv, "STACK_MB", mb)
    monkeypatch.setattr(freq_conv, "STACK_KSPLIT", ksplit)
    freq_conv.replan()
    try:
        x, w = _chain_inputs(32, 11, 64, 7, cuda_device, "im2col")
        plan = freq_conv.stack_launch_plan(x, w)
        assert (plan.mb, plan.ksplit, plan.cluster) == (mb, ksplit, 2)
        _close_to_plain(freq_conv.freq_conv_stack(x, w, 4), freq_conv.freq_conv_stack_plain(x, w, 4))
    finally:
        monkeypatch.undo()
        freq_conv.replan()


@pytest.mark.cuda
def test_freq_conv_stack_repeats_bit_for_bit_on_cuda(cuda_device, stack_cluster):
    x, w = _chain_inputs(32, 11, 64, 3, cuda_device, "im2col")
    assert torch.equal(freq_conv.freq_conv_stack(x, w, 16), freq_conv.freq_conv_stack(x, w, 16))


@pytest.mark.cuda
def test_freq_conv_stack_refused_cluster_raises_and_launches_nothing(cuda_device, monkeypatch):
    """A cluster of 16 blocks (C = 128 has 16 n8 tiles), past the 8 the card
    takes without a non-portable opt-in: the card refuses it already in
    the occupancy query (cudaOccupancyMaxActiveClusters) that plans the
    launch, before the kernel is launched (whose C entry refuses more
    than 8 blocks too).  The call raises, nothing is counted and nothing
    falls back."""
    monkeypatch.setattr(freq_conv, "STACK_CLUSTER", 16)
    freq_conv.replan()
    try:
        x, w = _chain_inputs(128, 1, 4, 0, cuda_device)
        before = freq_conv.stack_launches
        with pytest.raises(RuntimeError, match="freq_conv_stack"):
            freq_conv.freq_conv_stack(x, w, 2)
        assert freq_conv.stack_launches == before
    finally:
        monkeypatch.undo()
        freq_conv.replan()


@pytest.mark.cuda
@pytest.mark.parametrize("C,K", [(60, 11), (56, 13), (144, 1), (51, 11)])
def test_freq_conv_stack_wide_channels_grow_the_cluster_on_cuda(cuda_device, C, K):
    """The widest C the float32 SIMT design took: a cluster of 2 does not
    fit them, so the plan runs 3 to 8 blocks a frame, each writing every
    peer."""
    x, w = _chain_inputs(C, K, 8, C + K, cuda_device, "k3")
    plan = freq_conv.stack_launch_plan(x, w)
    assert plan.cluster > 2 and plan.smem_bytes <= freq_conv.SMEM_BYTES
    got = freq_conv.freq_conv_stack(x, w, 3)
    ref = freq_conv.freq_conv_stack_plain(x, w, 3)
    assert_live(ref)
    _close_to_plain(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bad", ["float64", "taps", "w_shape", "c_taps", "stack_strided", "stack_halo", "stack_smem"]
)
def test_freq_conv_raises_instead_of_falling_back(cuda_device, bad):
    x = torch.rand(1, 2, 129, 5, device=cuda_device)
    w = torch.rand(11, 5, 6, device=cuda_device)
    xs = torch.rand(4, 512, device=cuda_device)
    ws = torch.rand(11, 4, 4, device=cuda_device)
    calls = {
        "float64": lambda: freq_conv.freq_conv(x.double(), w.double()),
        "taps": lambda: freq_conv.freq_conv(x, torch.rand(14, 5, 6, device=cuda_device)),
        "w_shape": lambda: freq_conv.freq_conv(x, w[:, :4]),
        # C * K = 316 * 13: its split weights alone outgrow a block's shared memory
        "c_taps": lambda: freq_conv.freq_conv(torch.rand(1, 1, 129, 316, device=cuda_device),
                                              torch.rand(13, 316, 1, device=cuda_device)),
        "stack_strided": lambda: freq_conv.freq_conv_stack(xs.t().contiguous().t(), ws, 2),
        "stack_halo": lambda: freq_conv.freq_conv_stack(xs, ws, 2, valid=253),
        # C = 96 at K = 13: half the split weight fragments outgrow a block
        "stack_smem": lambda: freq_conv.freq_conv_stack(torch.rand(96, 512, device=cuda_device),
                                                        torch.rand(13, 96, 96, device=cuda_device), 2),
    }
    before = (freq_conv.launches, freq_conv.stack_launches)
    with pytest.raises(ValueError):
        calls[bad]()
    assert (freq_conv.launches, freq_conv.stack_launches) == before


# -- the bf16 operand modes ---------------------------------------------------

# The bf16 stack: each layer rounds its float32 input to bf16.  Where two
# correct computations of a layer differ in the last bit of a float32 sum
# (another order of summation) and the value lies at a rounding boundary
# of bf16, the next layer's operand differs by one bf16 ulp (2^-7 of it),
# and the difference spreads through the later layers.  So a whole stack
# is held to: the median difference at float32's level (1e-6 of max|ref|:
# almost every operand agrees), and no difference past BF16_STACK_MAX of
# max|ref| (a few operands one ulp off; tests/test_torch_bf16.py prints
# up to 2.8e-3 of max between this package and JAX).  A single layer rounds only its input,
# which both sides are given, and is held at float32's tolerance.
BF16_STACK_MEDIAN = 1e-6
BF16_STACK_MAX = 2.0**-6


def assert_bf16_stack_close(got, ref):
    """`got` within a bf16 stack's tolerance of `ref` (see BF16_STACK_*);
    the median is taken over the elements where `ref` is not 0."""
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    scale = ref.abs().max().item()
    err = (got - ref).abs()
    assert err.max().item() <= BF16_STACK_MAX * scale, (err.max().item(), scale)
    assert err[ref != 0].median().item() <= BF16_STACK_MEDIAN * scale, (err[ref != 0].median().item(), scale)


def one_layer_model(kw, cin, cout, link=None):
    """A model with one inner (1, kw) layer between layer 1 (cin channels)
    and the (1, 129) projection; `link` "skip" or "add" makes it read
    layer 1 again (pre- or post-ReLU; needs cout == cin)."""
    from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef

    return ModelDef(f"one_{kw}_{cin}_{cout}_{link}", (
        ConvSpec("a", cin, (8, 5)),
        ConvSpec("b", cout, (1, kw), skip_from="a" if link == "skip" else None,
                 add_from="a" if link == "add" else None),
        ConvSpec("c", 1, (1, 129), use_norm=False, use_act=False),
    ))


# (kw, cin, cout, link): every n8 tile count, kw at 1, 5 and the kernel's
# 13, K from 1 chunk of 16 (kw 1, cin 8) to 16, and the skip and the add
ONE_LAYER_CASES = [(1, 8, 8, None), (5, 10, 12, None), (13, 19, 32, None), (7, 25, 23, None),
                   (9, 20, 20, "skip"), (9, 18, 18, "add"), (11, 12, 3, None)]


def _stack_counts():
    """rced_stack's launch counts: 3xTF32, bf16 wgmma."""
    return rced_stack.launches, rced_stack.launches_bf16_wgmma


def _bf16_packed(model, params, bn, device):
    p, s = params_from_numpy(params, bn, device=device)
    return rced_stack.pack_inference_stack(model, p, s, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ONE_LAYER_CASES, ids=lambda c: "_".join(map(str, c)))
def test_kernel_bf16_one_layer_matches_plain_on_cuda(cuda_device, case):
    """One layer: the wgmma kernel and the plain bf16 mode round the same
    input and weights, products are exact, sums float32 in another order:
    rtol 1e-4, atol 1e-5 * max|plain|."""
    model = one_layer_model(*case)
    packed = _bf16_packed(model, *numpy_params(model, 3, centred_bn=True), cuda_device)
    x = torch.rand(2, packed.c_in, 45, 129, generator=torch.Generator().manual_seed(4)).to(cuda_device)
    before = _stack_counts()
    got = rced_stack.stack_forward(packed, x)
    torch.cuda.synchronize()
    assert _stack_counts() == (before[0], before[1] + 1)
    ref = rced_stack.stack_forward_plain(packed, x)
    assert_live(ref)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5 * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,B,T", [(n, B, T) for n in NAMES for B, T in STACK_SHAPES] + [("FullyCNNV2", 4, 499)]
)
def test_kernel_bf16_matches_plain_on_cuda(cuda_device, name, B, T):
    """Whole stacks in the bf16 mode against the plain bf16 mode (see
    BF16_STACK_*), and within 0.05 * max of the float32 stack (the JAX
    package's bound for its bf16 mode, tests/test_pallas.py)."""
    params, bn = params_from_numpy(*numpy_params(name, 1, centred_bn=True), device=cuda_device)
    packed = rced_stack.pack_inference_stack(get_model(name), params, bn, "bfloat16")
    x = torch.rand(B, packed.c_in, T, 129, generator=torch.Generator().manual_seed(T)).to(cuda_device)
    before = rced_stack.launches_bf16_wgmma
    got = rced_stack.stack_forward(packed, x)
    torch.cuda.synchronize()
    assert rced_stack.launches_bf16_wgmma == before + 1
    ref = rced_stack.stack_forward_plain(packed, x)
    assert_live(ref)
    assert_bf16_stack_close(got, ref)
    f32 = rced_stack.stack_forward_plain(_packed(name, 1, cuda_device), x)
    assert (got - f32).abs().max() <= 0.05 * f32.abs().max()


@pytest.mark.cuda
def test_kernel_bf16_repeats_and_raises_instead_of_falling_back(cuda_device):
    """Two launches agree bit for bit; a bf16 input, or a float32 pack
    called in the bf16 mode, raises and launches nothing."""
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", 2, centred_bn=True), device=cuda_device)
    model = get_model("FullyCNNV2")
    packed = rced_stack.pack_inference_stack(model, params, bn, "bfloat16")
    x = torch.rand(3, packed.c_in, 97, 129, generator=torch.Generator().manual_seed(9)).to(cuda_device)
    assert torch.equal(rced_stack.stack_forward(packed, x), rced_stack.stack_forward(packed, x))
    before = _stack_counts()
    with pytest.raises(ValueError, match="contiguous float32"):
        rced_stack.stack_forward(packed, x.to(torch.bfloat16))
    mag = torch.rand(1, 20, 129, device=cuda_device)
    with pytest.raises(ValueError, match="packed for float32"):
        rced_stack.fused_inference_forward(model, params, bn, mag, packed=_packed("FullyCNNV2", 2, cuda_device),
                                           dtype="bfloat16")
    assert _stack_counts() == before


def _dw_inputs_bf16(B, T, ci, co, device, seed=0, offset=0):
    """bf16 z and dy; `offset` values into their storage, so that the
    kernel sees pointers aligned to 2 * offset bytes modulo 16."""
    out = []
    for t in _dw_inputs(B, T, ci, co, "cpu", seed):
        buf = torch.empty(t.numel() + offset, dtype=torch.bfloat16)
        v = buf[offset:].view(t.shape)
        v.copy_(t)
        out.append(v.to(device) if offset == 0 else buf.to(device)[offset:].view(t.shape))
    return out


# (B, T, Ci, Co, KB, dc, offset): V2's 14 layers; KB 1..8 with dc at both
# ends; channels that are even but not multiples of 8 and odd, and
# pointers 4- and 2-byte aligned (these four on the 3xTF32 kernel); V2's
# encode_8 at 64 x 512
DW_BF16_CASES = (
    [(3, 37, ci, co, 4, 2, 0) for ci, co in V2_DW_SHAPES]
    + [(3, 37, 72, 88, kb, dc, 0) for kb in range(1, 9) for dc in sorted({0, kb - 1})]
    + [(3, 37, 20, 14, 4, 2, 0), (3, 37, 21, 13, 4, 2, 0), (3, 37, 80, 96, 4, 2, 2),
       (3, 37, 80, 96, 4, 2, 1), (64, 512, 184, 200, 4, 2, 0)]
)
DW_BF16_IDS = (
    [f"v2_{ci}x{co}" for ci, co in V2_DW_SHAPES]
    + [f"kb{kb}_dc{dc}" for kb in range(1, 9) for dc in sorted({0, kb - 1})]
    + ["ci20_co14", "ci21_co13", "align4", "align2", "v2_layer"]
)


def _dw_launches():
    """blocked_dw's launch counts: 3xTF32, bf16 wgmma."""
    return blocked_dw.launches, blocked_dw.launches_bf16


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_BF16_CASES, ids=DW_BF16_IDS)
def test_blocked_dw_bf16_matches_plain_on_cuda(cuda_device, case):
    """bf16 z and dy: every product is exact in float32, so the kernel
    differs from the plain version (which promotes to float32) only in the
    order of float32 sums over up to 557k terms: rtol 1e-4, atol 1e-4 *
    max|plain|, as the float32 instance.  Channels that are multiples of 8
    on 16-byte aligned pointers go to the wgmma kernel, the others to the
    3xTF32 kernel on float32 copies."""
    B, T, ci, co, kb, dc, offset = case
    z, dy = _dw_inputs_bf16(B, T, ci, co, cuda_device, offset=offset)
    wgmma = ci % 8 == 0 and co % 8 == 0 and offset % 8 == 0
    before = _dw_launches()
    got = blocked_dw.blocked_dw(z, dy, kb, dc)
    torch.cuda.synchronize()
    assert _dw_launches() == (before[0] + (not wgmma), before[1] + wgmma)
    assert got.dtype == torch.float32
    ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    assert torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got)


# (B, T, Ci, Co, KB, dc): V2's 14 layers at 64 x 8 s; channels not
# multiples of 64 (a tile mostly past C), one tile, and one stage a split
DW_WGMMA_CASES = (
    [(64, 512, ci, co, 4, 2) for ci, co in V2_DW_SHAPES]
    + [(3, 37, 24, 16, 4, 2), (3, 37, 200, 184, 4, 2), (3, 37, 72, 88, 8, 3), (1, 8, 8, 8, 1, 0),
       (2, 9, 136, 8, 5, 4)]
)
DW_WGMMA_IDS = ([f"v2_{ci}x{co}_64x512" for ci, co in V2_DW_SHAPES]
                + ["ci24_co16", "ci200_co184", "ci72_co88_kb8", "one_stage", "ci136_co8_kb5"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", DW_WGMMA_CASES, ids=DW_WGMMA_IDS)
def test_blocked_dw_wgmma_matches_plain_on_cuda(cuda_device, case):
    """The wgmma kernel (one launch, none of the other kernels) against the
    plain version within DW_TOL, and a second launch equal bit for bit."""
    B, T, ci, co, kb, dc = case
    z, dy = _dw_inputs_bf16(B, T, ci, co, cuda_device)
    assert blocked_dw.takes_wgmma(z, dy, kb)
    before = _dw_launches()
    got = blocked_dw.blocked_dw(z, dy, kb, dc)
    torch.cuda.synchronize()
    assert _dw_launches() == (before[0], before[1] + 1)
    ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    assert torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got)


@pytest.mark.cuda
def test_blocked_dw_bf16_odd_fb_runs_the_float32_kernel_on_cuda(cuda_device):
    """A bf16 pair at an odd blocked_fb (V2's first inner layer at fb 7:
    Ci 70, Co 84, NB 19) is not the wgmma kernel's: blocked_dw runs the
    3xTF32 kernel on float32 copies, one float32 launch and no bf16 one,
    within DW_TOL of the plain version and repeated bit for bit."""
    from fullycnnspeechenhancement_torch.models.blocked import _block_index_map

    fb, model = 7, get_model("FullyCNNV2")
    spec = model.layers[1]
    J, dc = _block_index_map(spec.kernel[1], fb)
    kb, nb = J.shape[0], -(-129 // fb)
    g = torch.Generator().manual_seed(7)
    z = torch.randn(3, 37, nb, fb * model.layers[0].out_ch, generator=g).to(torch.bfloat16).to(cuda_device)
    dy = torch.randn(3, 37, nb, fb * spec.out_ch, generator=g).to(torch.bfloat16).to(cuda_device)
    assert not blocked_dw.takes_wgmma(z, dy, kb)
    before = _dw_launches()
    got = blocked_dw.blocked_dw(z, dy, kb, dc)
    torch.cuda.synchronize()
    assert _dw_launches() == (before[0] + 1, before[1])
    ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    assert torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got)


@pytest.mark.cuda
def test_blocked_dw_bf16_raises_on_mixed_dtypes_on_cuda(cuda_device):
    """A bf16 z with a float32 dy (and the reverse) raises before any
    launch."""
    z, dy = _dw_inputs_bf16(2, 9, 24, 16, cuda_device)
    before = _dw_launches()
    for pair in ((z, dy.float()), (z.float(), dy)):
        with pytest.raises(ValueError):
            blocked_dw.blocked_dw(*pair, 4, 2)
    assert _dw_launches() == before


@pytest.mark.cuda
def test_blocked_freq_conv_bf16_rounds_dw_to_bf16_on_cuda(cuda_device):
    """Under bf16 the Function's dW is the kernel's float32 dW rounded to
    bf16 (JAX's `dw.astype(wb.dtype)`), and a mixed pair raises."""
    z0, g = (t.to(torch.bfloat16) for t in _dw_inputs(2, 9, 24, 16, cuda_device, seed=1))
    w0 = (0.1 * torch.randn(1, 4, 24, 16, generator=torch.Generator().manual_seed(2))).to(cuda_device)
    w = w0.clone().requires_grad_()
    z = z0.clone().requires_grad_()
    (blocked_dw.blocked_freq_conv(z, w.to(torch.bfloat16), 2).float() * g.float()).sum().backward()
    assert w.grad.dtype == torch.float32 and z.grad.dtype == torch.bfloat16
    assert torch.equal(w.grad, blocked_dw.blocked_dw(z0, g, 4, 2).to(torch.bfloat16).float())
    before = _dw_launches()
    with pytest.raises(ValueError, match="two float32 or two bfloat16"):
        blocked_dw.blocked_dw(z0, g.float(), 4, 2)
    assert _dw_launches() == before


def _dp_case(dtype):
    rng = np.random.default_rng(90)
    lens = (7200, 5600, 6400, 4000)
    mix = np.zeros((4, 7200), np.float32)
    clean = np.zeros((4, 7200), np.float32)
    for i, n in enumerate(lens):
        c = 0.4 * np.sin(2 * np.pi * (300 + 150 * i) * np.arange(n) / 8000)
        clean[i, :n] = c
        mix[i, :n] = c + 0.2 * rng.standard_normal(n)
    params, bn = numpy_params("FullyCNNV2", seed=91, centred_bn=True)
    return {
        "net": "FullyCNNV2", "params": params, "bn": bn,
        "model": dict(blocked_compute=True, blocked_fb=8, dw_pallas=True, compute_dtype=dtype),
        "train": dict(batch_size=4, lr=1e-3, warmup_steps=100),
        "batches": [(mix, clean, np.asarray(lens, np.int32))],
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dp_step_on_cuda_matches_cpu_plain(cuda_device, tmp_path, dtype):
    """Two gloo ranks sharing the card run one DP step of V2 (blocked, fb 8,
    dw_pallas): each launches the dW kernel 14 times on its rows, the
    ranks end bit for bit equal, and in float32 the result matches the
    single-process step on the CPU (its plain dW): loss rtol 1e-4, BN
    statistics rtol 1e-4 atol 1e-6, Adam's mu within 1e-2 of its global
    scale (the tolerances tests/test_torch_dp.py holds the port against
    JAX with)."""
    from torch_dp_ranks import dp_step_on_device, run_step_case, spawn

    case = _dp_case(dtype)
    spawn(dp_step_on_device, 2, tmp_path, (case, str(cuda_device), str(tmp_path)))
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    for part in ("params", "bn", "mu"):
        for key, v in r0[part].items():
            np.testing.assert_array_equal(r1[part][key], v, err_msg=f"ranks differ: {part} {key}")
    for r in (r0, r1):
        assert r["launches"] == 14 and r["step"] == 1 and np.isfinite(r["loss"]).all()
    if dtype != "float32":
        return
    ref = run_step_case(None, case, "cpu")
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=1e-4)
    for key, v in ref["bn"].items():
        np.testing.assert_allclose(r0["bn"][key], v, rtol=1e-4, atol=1e-6, err_msg=str(key))
    scale = max(np.abs(v).max() for v in ref["mu"].values())
    err = max(np.abs(r0["mu"][k] - v).max() for k, v in ref["mu"].items()) / scale
    assert err < 1e-2, f"Adam mu off by {err:.3e} of its global scale"


# -- the BN chain of the blocked training step (ops/bn_chain.py) ------------


def chain_case(C, B, T, dtype, device="cpu", *, mask="batch_max", link="none", seed=0, reduce=None):
    """One BN layer's chain at C channels over B x T frames in the blocked
    layout (129 bins in 17 blocks of 8): the conv output y before its bias
    (its pad band holds values too, which the chain must ignore), the
    layer's parameters (float64 where `dtype` is, else float32) and BN
    state, the skip source and the residual per `link` ("none", "skip",
    "add", "both"), an output gradient g and the forward's Batch over the
    frame mask `mask`: "batch_max" ([1, T], the first 70% of the frames),
    "utterance" ([B, T], a length a row, the last row one frame) or
    "none"; `reduce` the data-parallel sum."""
    gen = torch.Generator().manual_seed(seed)
    shape = (B, T, 17, 8 * C)
    pdt = torch.float64 if dtype == torch.float64 else torch.float32

    def draw(*size, scale=1.0, shift=0.0):
        return torch.randn(*size, generator=gen, dtype=torch.float64) * scale + shift

    y = draw(*shape, scale=0.8, shift=0.3)
    p = {"b": draw(C, scale=0.1), "gamma": draw(C, scale=0.1, shift=1.0), "beta": draw(C, scale=0.1)}
    state = {"mean": torch.rand(C, generator=gen, dtype=torch.float64),
             "var": 1 + torch.rand(C, generator=gen, dtype=torch.float64)}
    skip = draw(*shape) if link in ("skip", "both") else None
    add = draw(*shape) if link in ("add", "both") else None
    g = draw(*shape)
    frames = torch.arange(T)
    if mask == "batch_max":
        fm = (frames < max(1, int(0.7 * T))).float()[None]
    elif mask == "utterance":
        lengths = torch.randint(1, T + 1, (B,), generator=gen)
        lengths[-1] = 1
        fm = (frames[None] < lengths[:, None]).float()
    else:
        fm = None
    dev = torch.device(device)

    def on(t, dt):
        return None if t is None else t.to(device=dev, dtype=dt)

    case = {"y": on(y, dtype), "p": {k: on(v, pdt) for k, v in p.items()},
            "state": {k: on(v, pdt) for k, v in state.items()}, "skip": on(skip, dtype), "add": on(add, dtype),
            "g": on(g, dtype), "frame_mask": on(fm, torch.float32), "reduce": reduce}
    case["batch"] = _chain_batch(case)
    return case


def _chain_batch(case, frame_mask=...):
    y = case["y"]
    B, T = y.shape[:2]
    fm = case["frame_mask"] if frame_mask is ... else frame_mask
    return bn_chain.make_batch(B, T, 129, 8, y.dtype, y.device, is_training=True, frame_mask=fm)


def run_chain(fn, case, *, relu=True, batch=None):
    """`fn` (`bn_chain.bn_chain`, `chain_plain` or `chain_closed_form`) on
    `case` -> (out, new BN state, {name: gradient against case["g"]}) for
    y, b, gamma, beta and the sources the case has."""
    leaves = {"y": case["y"].clone().requires_grad_(True)}
    leaves.update({k: v.clone().requires_grad_(True) for k, v in case["p"].items()})
    for k in ("skip", "add"):
        if case[k] is not None:
            leaves[k] = case[k].clone().requires_grad_(True)
    p = {k: leaves[k] for k in ("b", "gamma", "beta")}
    out, state = fn(leaves["y"], p, case["state"], case["batch"] if batch is None else batch,
                    skip=leaves.get("skip"), add=leaves.get("add"), relu=relu, reduce=case["reduce"])
    grads = torch.autograd.grad(out, list(leaves.values()), grad_outputs=case["g"])
    return out.detach(), state, dict(zip(leaves, grads))


def _skip_after_relu(y, p, s, batch, *, skip=None, add=None, relu=True, reduce=None):
    return bn_chain.chain_plain(y, p, s, batch, skip=None, add=skip, relu=relu, reduce=reduce)


def plain_reference(case, *, relu=True, fault=None):
    """`run_chain` of the plain chain (`chain_plain`) in float64 on the
    case's values, or of a plain chain with a planted fault:
    "no_frame_mask" (the moments over every frame) or "skip_after_relu"."""
    ref = dict(case)
    for k in ("y", "skip", "add", "g"):
        ref[k] = None if case[k] is None else case[k].double()
    ref["p"] = {k: v.double() for k, v in case["p"].items()}
    ref["state"] = {k: v.double() for k, v in case["state"].items()}
    ref["batch"] = _chain_batch(ref, None if fault == "no_frame_mask" else ...)
    return run_chain(_skip_after_relu if fault == "skip_after_relu" else bn_chain.chain_plain, ref, relu=relu)


# The chain against the plain chain in float64 on the same values, by each
# result's distance ||got - ref|| / ||ref||.  float64: the same arithmetic
# in another order.  float32 and bf16: where u, the value before the ReLU,
# lies within a float32 rounding of 0, the kernels' ReLU decision can
# differ from float64's, and that element's gradient by all of |g|: at V2's
# 64 x 384 frames a few elements of 10^8, about 3e-4 of a gradient's norm.
# bf16 adds the one rounding of each result from float32 (2^-9 relative at
# most, about 1e-3 of a norm); the plain chain in bf16 rounds after the
# bias, the scale, the shift and the skip and after each backward
# operation, and its ReLU decisions follow those roundings (2-4% of a
# gradient's norm from float64 on the CPU tests' cases), so it is no
# yardstick for the kernels.  The bias's gradient is 0 but for rounding on
# both sides (the bias moves no output of a training-mode BN), so it is
# held to the same share of ||dbeta||, a gradient of its order (the cases'
# BN scales are near 1).  The running statistics move by 1% of the
# batch's, which the sums' tests hold directly.
CHAIN_TOL = {torch.float64: 1e-9, torch.float32: 1e-3, torch.bfloat16: 1e-2}


def chain_errors(got, ref):
    """{result: distance} of two `run_chain` results (CHAIN_TOL)."""
    out, state, grads = got
    r_out, r_state, r_grads = ref
    d = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()  # noqa: E731
    errs = {"out": d(out, r_out)}
    errs.update({f"state_{k}": d(state[k], r_state[k]) for k in r_state})
    for k, v in r_grads.items():
        if k != "b":
            errs[f"d{k}"] = d(grads[k], v)
    errs["db"] = ((grads["b"].double() - r_grads["b"].double()).norm() / r_grads["beta"].double().norm()).item()
    return errs


def assert_chain_close(got, ref, dtype):
    """Raise unless every distance of `chain_errors` is within CHAIN_TOL."""
    errs = chain_errors(got, ref)
    bad = {k: v for k, v in errs.items() if not v <= CHAIN_TOL[dtype]}
    assert not bad, f"past {CHAIN_TOL[dtype]}: {bad}"


def _chain_counts():
    return (bn_chain.launches_moments, bn_chain.launches_apply, bn_chain.launches_grad_sums,
            bn_chain.launches_grad_apply)


# (C, link) of BN layers: V2's layer 1, its widest encoder, its widest
# decoder (a skip) and its last; V3's residual layer; V1's widest
BN_CHAIN_LAYERS = [(10, "none"), (25, "none"), (23, "skip"), (10, "skip"), (8, "add"), (32, "none")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("mask", ["batch_max", "utterance", "none"])
@pytest.mark.parametrize("C, link", BN_CHAIN_LAYERS)
def test_bn_chain_matches_plain_on_cuda(cuda_device, C, link, mask, dtype):
    """The kernels (one call of each stage) against the plain chain in
    float64 at a small shape (45 frames, a 70% batch-max mask, per-utterance
    masks down to one frame, no mask): output, BN state and every
    gradient within CHAIN_TOL."""
    case = chain_case(C, 3, 45, dtype, cuda_device, mask=mask, link=link, seed=C)
    before = _chain_counts()
    got = run_chain(bn_chain.bn_chain, case)
    torch.cuda.synchronize()
    assert _chain_counts() == tuple(n + 1 for n in before)
    assert_chain_close(got, plain_reference(case), dtype)


# V2's BN layers at the training cell's batch, 64 x 384 frames
BN_CHAIN_V2 = [(10, "none"), (25, "none"), (23, "skip"), (10, "skip")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("C, link", BN_CHAIN_V2)
def test_bn_chain_matches_plain_at_v2_size_on_cuda(cuda_device, C, link, dtype):
    """At 64 x 384 frames with the batch-max mask, against the plain chain
    in float64; in bf16 also nearer to it than the plain chain in bf16 is
    (in float32 both sit at rounding's level)."""
    case = chain_case(C, 64, 384, dtype, cuda_device, link=link, seed=100 + C)
    ref = plain_reference(case)
    got = run_chain(bn_chain.bn_chain, case)
    assert_chain_close(got, ref, dtype)
    plain = chain_errors(run_chain(bn_chain.chain_plain, case), ref)
    mine = chain_errors(got, ref)
    print(f"C={C} {link} {dtype}: kernels {mine}, plain chain {plain}")
    if dtype == torch.bfloat16:
        assert max(mine.values()) <= max(plain.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(3, 45), (64, 384)], ids=["small", "v2"])
def test_bn_chain_sums_match_their_twins_on_cuda(cuda_device, shape, dtype):
    """The moments and the gradient's sums from the kernels against their
    twins in float64 on the same values: float32 sums over up to 10^7
    values in a fixed order, held at 1e-5 of their norm.  The gradient's
    sums are taken without the ReLU here: where u lies within a float32
    rounding of 0 the kernels' ReLU decision may differ from float64's
    and move a channel's sum by a whole |g| (CHAIN_TOL's tests hold the
    ReLU)."""
    case = chain_case(23, *shape, dtype, cuda_device, link="skip", seed=7)
    y, p, batch, skip, g = case["y"], case["p"], case["batch"], case["skip"], case["g"]
    s = bn_chain.moments(y, p["b"], batch)
    ref = bn_chain.moments_twin(y.double(), p["b"].double(), batch)
    for i in range(2):
        assert ((s[i].double() - ref[i]).norm() / ref[i].norm()).item() < 1e-5
    mean, var = blocks.moments_from_sums(s[0], s[1], batch.n)
    gs = bn_chain.grad_sums(g, y, skip, p["b"], p["gamma"], p["beta"], mean, var, False, 129)
    gref = bn_chain.grad_sums_twin(g.double(), y.double(), skip.double(), p["b"].double(), p["gamma"].double(),
                                   p["beta"].double(), mean.double(), var.double(), False, 129)
    for i in range(2):
        assert ((gs[i].double() - gref[i]).norm() / gref[i].norm()).item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["no_frame_mask", "skip_after_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_bn_chain_check_sees_planted_faults_on_cuda(cuda_device, dtype, fault):
    """The check above fails against a plain chain with a dropped frame
    mask or a skip added after the ReLU."""
    case = chain_case(23, 4, 64, dtype, cuda_device, link="skip", seed=9)
    got = run_chain(bn_chain.bn_chain, case)
    assert_chain_close(got, plain_reference(case), dtype)
    with pytest.raises(AssertionError):
        assert_chain_close(got, plain_reference(case, fault=fault), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(3, 45), (64, 384)], ids=["small", "v2"])
def test_bn_chain_repeats_bit_for_bit_on_cuda(cuda_device, shape, dtype):
    """Two runs give the same output, BN state and gradients, bit for bit
    (fixed-order sums, no atomics)."""
    case = chain_case(23, *shape, dtype, cuda_device, mask="utterance", link="skip", seed=11)
    a, b = run_chain(bn_chain.bn_chain, case), run_chain(bn_chain.bn_chain, case)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "channels", "misaligned"])
def test_bn_chain_raises_instead_of_falling_back_on_cuda(cuda_device, bad):
    case = chain_case(8, 2, 6, torch.float32, cuda_device)
    y, p = case["y"], case["p"]
    if bad == "float64":
        y = y.double()
    elif bad == "channels":
        p = {k: torch.zeros(65, device=cuda_device) for k in p}
        y = torch.zeros(2, 6, 17, 8 * 65, device=cuda_device)
    else:
        y = torch.zeros(y.numel() + 1, device=cuda_device)[1:].view(y.shape)
    before = _chain_counts()
    with pytest.raises(ValueError):
        bn_chain.bn_chain(y, p, case["state"], case["batch"])
    assert _chain_counts() == before


@pytest.mark.cuda
def test_blocked_step_runs_every_bn_layer_through_the_kernels_on_cuda(cuda_device):
    """A bf16 training forward and backward of V2 in the blocked form calls
    each stage once a BN layer (15), with finite gradients."""
    model = get_model("FullyCNNV2")
    params, state = params_from_numpy(*numpy_params("FullyCNNV2", 3, centred_bn=True), device=cuda_device)
    for v in params.values():
        for t in v.values():
            t.requires_grad_(True)
    x = torch.rand(2, 40, 129, 1, device=cuda_device).to(torch.bfloat16)
    fm = (torch.arange(40, device=cuda_device) < 30).float()[None]
    before = _chain_counts()
    from fullycnnspeechenhancement_torch.models.blocked import apply_blocked

    y, _ = apply_blocked(model, params, state, x, is_training=True, frame_mask=fm, dw_pallas=True)
    leaves = [t for v in params.values() for t in v.values()]
    grads = torch.autograd.grad(y.float().square().sum(), leaves)
    torch.cuda.synchronize()
    assert _chain_counts() == tuple(n + 15 for n in before)
    assert all(torch.isfinite(g).all() for g in grads)
