"""The fused forward's edge kernels (`ops/rced_edges.py`, `csrc/rced_edges.cu`)
on the CPU: the wrappers' plain path against `conv2d_same`, the fused
forward against the JAX package's, the checks that make the wrappers
raise, the launch plans, the work counts, and both kernels emulated in
plain torch.

The emulations follow each kernel's own index arithmetic in float64, over
an image of a block's shared memory: layer 1's staged rows (zeros outside
the input) and weight pairs, each thread's (frame group, bin) item and its
4 x C register tile, the tap column and time-tap order of its sums and the
store rule; the projection's two zeroed channel buffers of 32 rows 153
floats apart, each warp's bin group and tap range widened to multiples of
4, its 8-bin window slid 4 taps at a time, and the store rule.  A read
outside the image raises.  The kernels themselves run against their plain
versions on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.ops import fused_inference_forward as j_fused

from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
from fullycnnspeechenhancement_torch.ops import rced_edges as re_, rced_stack
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import NAMES, numpy_params, one_cpu_thread_per_worker  # noqa: F401

FIRST_ROW = 141  # csrc kFirstRow
FIRST_HALO = 6
PROJ_ROW = 153  # csrc kProjRow
PROJ_HALO = 12


def _edges(name, seed=0):
    params, bn = params_from_numpy(*numpy_params(name, seed, centred_bn=True))
    return rced_stack.pack_inference_stack(get_model(name), params, bn).edges


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).random(shape), dtype=torch.float32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, 3, 8, 9, 124])
def test_plain_path_is_conv2d_same(name, B, T):
    """On a CPU tensor the wrappers are `conv2d_same` (+ ReLU) on the
    folded weights, bit for bit, and launch nothing."""
    e = _edges(name, seed=T)
    mag = _rand((B, T, 129), seed=B * 1000 + T)
    before = (re_.launches_first, re_.launches_proj)
    y = re_.first_forward(e, mag)
    ref = conv2d_same(mag[:, None], e.w1, e.b1)
    ref = torch.relu(ref) if e.first.use_act else ref
    assert y.shape == (B, e.channels, T, 129) and y.is_contiguous()
    assert torch.equal(y, ref)
    z = _rand((B, e.proj_channels, T, 129), seed=T)
    out = re_.proj_forward(e, z)
    assert out.shape == (B, T, 129)
    assert torch.equal(out, conv2d_same(z, e.w_last, e.b_last)[:, 0])
    assert (re_.launches_first, re_.launches_proj) == before


@pytest.mark.parametrize("name,T", [(n, 9) for n in NAMES] + [("FullyCNNV2", 40)])
def test_fused_forward_matches_jax(name, T):
    """The fused forward through the edge wrappers, on the CPU, against the
    JAX package's fused forward (interpret mode)."""
    jp, jb = numpy_params(name, 3, centred_bn=True)
    tp, tb = params_from_numpy(jp, jb)
    mag = np.random.default_rng(T).random((2, T, 129)).astype(np.float32)
    ref = np.asarray(j_fused(j_get_model(name), jp, jb, mag, t_tile=32))
    got = rced_stack.fused_inference_forward(get_model(name), tp, tb, torch.as_tensor(mag))
    assert got.shape == (2, T, 129)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "which,bad,match",
    [
        ("first", lambda: torch.zeros(1, 5, 129, dtype=torch.float64), "float32"),
        ("first", lambda: torch.zeros(1, 5, 128), r"\[n, n, 129\]"),
        ("first", lambda: torch.zeros(5, 129), r"\[n, n, 129\]"),
        ("first", lambda: torch.zeros(1, 0, 129), r"\[n, n, 129\]"),
        ("first", lambda: torch.zeros(1, 5, 129, device="meta"), "cpu or cuda"),
        ("proj", lambda: torch.zeros(1, 10, 5, 129, dtype=torch.bfloat16), "float32"),
        ("proj", lambda: torch.zeros(1, 9, 5, 129), r"\[n, 10, n, 129\]"),
        ("proj", lambda: torch.zeros(10, 5, 129), r"\[n, 10, n, 129\]"),
        ("proj", lambda: torch.zeros(1, 10, 5, 129, device="meta"), "cpu or cuda"),
    ],
)
def test_wrappers_raise_on_inputs_they_do_not_take(which, bad, match):
    e = _edges("FullyCNNV2")
    fn = re_.first_forward if which == "first" else re_.proj_forward
    before = (re_.launches_first, re_.launches_proj)
    with pytest.raises(ValueError, match=match):
        fn(e, bad())
    assert (re_.launches_first, re_.launches_proj) == before


def _model(first, last):
    return ModelDef("edge", (first, ConvSpec("mid", 4, (1, 5)), last))


LAST = ConvSpec("last", 1, (1, 129), use_norm=False, use_act=False)


@pytest.mark.parametrize(
    "model,match",
    [
        (_model(ConvSpec("first", 4, (9, 5)), LAST), "layer 1 first"),
        (_model(ConvSpec("first", 4, (8, 15)), LAST), "layer 1 first"),
        (_model(ConvSpec("first", 33, (8, 5)), LAST), "layer 1 first"),
        (_model(ConvSpec("first", 4, (8, 5)), ConvSpec("last", 1, (1, 127), use_norm=False, use_act=False)),
         "last layer last"),
        (_model(ConvSpec("first", 4, (8, 5)), ConvSpec("last", 2, (1, 129), use_norm=False, use_act=False)),
         "last layer last"),
        (_model(ConvSpec("first", 4, (8, 5)), ConvSpec("last", 1, (1, 129), use_norm=False)), "activation"),
    ],
)
def test_pack_rejects_edges_the_kernels_do_not_take(model, match):
    params, bn = model.init(torch.Generator().manual_seed(0))
    folded = rced_stack.fold_bn_inference(model, params, bn)
    with pytest.raises(ValueError, match=match):
        re_.pack_edges(folded[0], folded[-1])


def test_pack_takes_smaller_time_kernels_and_odd_channels():
    """kh < 8 pads the time taps with zero weights; an odd channel count
    pads a pair with a zero channel."""
    model = _model(ConvSpec("first", 5, (3, 4)), LAST)
    params, bn = model.init(torch.Generator().manual_seed(1))
    e = rced_stack.pack_inference_stack(model, params, bn).edges
    fw = e.first_w.view(4, 3, 8, 2)  # [kw, pair, tap, channel of the pair]
    assert torch.equal(fw[:, :, 3:], torch.zeros_like(fw[:, :, 3:]))
    assert torch.equal(fw[:, 2, :, 1], torch.zeros(4, 8))
    assert torch.equal(fw[2, 1, 1, 0], e.w1[2, 0, 1, 2])  # tap column 2, channel 2, time tap 1
    assert e.first_b.shape == (6,) and e.first_b[5] == 0
    assert e.proj_w.view(4, 132)[:, 129:].abs().sum() == 0


def test_launch_plans():
    """A 2 s request spreads over 31 and 20 blocks; a 416 s call takes 8
    frames a block and all 17 bin groups a block."""
    assert re_.first_plan(1, 124) == re_.FirstPlan(1, 4, 160, 31)
    assert re_.first_plan(1, 499) == re_.FirstPlan(1, 4, 160, 125)
    assert re_.first_plan(1, 999) == re_.FirstPlan(2, 8, 288, 125)
    assert re_.first_plan(1, 25999) == re_.FirstPlan(2, 8, 288, 3250)
    assert re_.first_plan(64, 499) == re_.FirstPlan(2, 8, 288, 4032)
    assert re_.proj_plan(1, 124) == re_.ProjPlan(4, 5, 128, 20)
    assert re_.proj_plan(1, 999) == re_.ProjPlan(4, 5, 128, 160)
    assert re_.proj_plan(1, 2001) == re_.ProjPlan(9, 2, 288, 126)
    assert re_.proj_plan(1, 4001) == re_.ProjPlan(17, 1, 544, 126)
    assert re_.proj_plan(1, 25999) == re_.ProjPlan(17, 1, 544, 813)
    assert re_.proj_plan(64, 499) == re_.ProjPlan(17, 1, 544, 1024)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T", [1, 5, 40])
def test_edge_macs_count_real_products(name, T):
    """The multiply-adds that meet a real input, against a count by
    convolving ones."""
    e = _edges(name)
    ones = torch.ones(1, 1, T, 129, dtype=torch.float64)
    counts = [
        int(conv2d_same(ones, torch.ones(1, 1, *w.shape[2:], dtype=torch.float64),
                        torch.zeros(1, dtype=torch.float64)).sum().item())
        for w in (e.w1, e.w_last)
    ]
    assert re_.edge_macs(e, T) == (counts[0] * e.channels, counts[1] * e.proj_channels)


def test_edge_macs_of_a_long_call():
    """V2 over a 416 s call (25,999 frames): 2.89 G and 3.24 G."""
    e = _edges("FullyCNNV2")
    assert re_.edge_macs(e, 25999) == (2_888_786_640, 3_244_935_190)


# -- the kernels, emulated ---------------------------------------------------


def _read(img, idx):
    assert int(idx.min()) >= 0 and int(idx.max()) < img.shape[-1], "a read outside the staged image"
    return torch.gather(img, -1, idx)


def emulate_first(e, mag, groups=None):
    """`rced_first_kernel` over every block at once, float64."""
    B, T, _ = mag.shape
    C, (kh, kw) = e.channels, e.w1.shape[2:]
    top, lo, nch = (kh - 1) // 2, (kw - 1) // 2, -(-e.channels // 2)
    plan = re_.first_plan(B, T)
    groups = plan.groups if groups is None else groups
    tile = groups * re_.FRAMES
    threads = -(-groups * 129 // 32) * 32
    nbx = -(-T // tile)
    # staged rows, one image a block
    rows = tile + re_.MAX_KH - 1
    el = torch.arange(rows * FIRST_ROW)
    r, q = el // FIRST_ROW, el % FIRST_ROW - FIRST_HALO
    t = torch.arange(nbx)[:, None] * tile - top + r[None]  # [nbx, el]
    ok = (t >= 0) & (t < T) & (q >= 0) & (q < 129)
    src = mag.double()[:, t.clamp(0, T - 1), q.clamp(0, 128)[None].expand_as(t)]  # [B, nbx, el]
    img = torch.where(ok[None], src, torch.zeros((), dtype=torch.float64)).reshape(B * nbx, -1)
    w = e.first_w.double().view(kw, nch, re_.MAX_KH // 2, 4)  # float4s: (tap 2i2, 2i2 + 1) x (2k, 2k + 1)
    bias = e.first_b.double()
    items = groups * 129
    item = torch.arange(threads).clamp(max=items - 1)
    g, f = item // 129, item % 129
    acc = bias[None, None, :].repeat(threads, re_.FRAMES, 1)[None].repeat(B * nbx, 1, 1, 1)  # [blk, thr, r, 2nch]
    base = g * re_.FRAMES * FIRST_ROW + f + FIRST_HALO - lo
    for j in range(kw):
        xv = torch.stack([_read(img, (base + s * FIRST_ROW + j)[None].expand(B * nbx, -1))
                          for s in range(re_.FRAMES + re_.MAX_KH - 1)], dim=-1)  # [blk, thr, 11]
        for k in range(nch):
            for i2 in range(re_.MAX_KH // 2):
                ww = w[j, k, i2]
                for tap, (wa, wb) in ((2 * i2, (ww[0], ww[1])), (2 * i2 + 1, (ww[2], ww[3]))):
                    xs = xv[..., tap: tap + re_.FRAMES]  # frames r read time row r + tap
                    acc[..., 2 * k] += xs * wa
                    acc[..., 2 * k + 1] += xs * wb
    if e.first.use_act:
        acc = acc.clamp(min=0)
    out = torch.full((B, C, nbx * tile, 129), float("nan"), dtype=torch.float64)
    acc = acc.view(B, nbx, threads, re_.FRAMES, 2 * nch)[:, :, :items, :, :C]
    tt = (torch.arange(nbx)[:, None, None] * tile + g[:items, None] * re_.FRAMES
          + torch.arange(re_.FRAMES)[None, None])  # [nbx, items, r]
    ff = f[:items][None, :, None].expand_as(tt)
    out[:, :, tt, ff] = acc.permute(0, 4, 1, 2, 3)
    return out[:, :, :T]


def emulate_proj(e, z, warps=None):
    """`rced_proj_kernel` over every block at once, float64."""
    B, C, T, _ = z.shape
    plan = re_.proj_plan(B, T)
    warps = plan.warps if warps is None else warps
    chunks = -(-re_.BIN_GROUPS // warps)
    tiles = -(-T // re_.PROJ_FRAMES)
    zp = torch.zeros(B, C, tiles * re_.PROJ_FRAMES, 129, dtype=torch.float64)
    zp[:, :, :T] = z.double()
    # each channel's buffer: 32 rows of 153 floats, zero but the 129 bins
    buf = torch.zeros(B, tiles, C, re_.PROJ_FRAMES, PROJ_ROW, dtype=torch.float64)
    buf[..., PROJ_HALO: PROJ_HALO + 129] = zp.view(B, C, tiles, re_.PROJ_FRAMES, 129).transpose(1, 2)
    w = e.proj_w.double().view(C, re_.PROJ_TAPS_PADDED)
    out = torch.full((B, tiles * re_.PROJ_FRAMES, 129), float("nan"), dtype=torch.float64)
    for group in range(chunks * warps):
        if group >= re_.BIN_GROUPS:
            continue  # a warp past the last group stages and waits, and computes nothing
        f0 = re_.GROUP_BINS * group
        fmax = min(f0 + 7, 128)
        j0 = max(0, 64 - fmax) & ~3
        j1 = (min(128, 64 + 128 - f0) + 4) & ~3
        start = PROJ_HALO + f0 - 64  # the lane's row pointer, from its row's start
        assert start + j0 >= 0 and start + j1 + 7 < PROJ_ROW, "a read outside the lane's row"
        acc = torch.zeros(B, tiles, re_.PROJ_FRAMES, re_.GROUP_BINS, dtype=torch.float64)
        for c in range(C):
            row = buf[:, :, c]
            for j in range(j0, j1, 4):
                for tap in range(4):
                    a = start + j + tap
                    acc += row[..., a: a + re_.GROUP_BINS] * w[c, j + tap]
        acc = acc + e.b_last.double()
        n = min(re_.GROUP_BINS, 129 - f0)
        out.view(B, tiles, re_.PROJ_FRAMES, 129)[..., f0: f0 + n] = acc[..., :n]
    return out[:, :T]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("B,T,groups", [(1, 1, None), (2, 9, None), (1, 37, 2), (3, 13, 2)])
def test_first_kernel_emulated_matches_plain(name, B, T, groups):
    e = _edges(name, seed=5)
    mag = _rand((B, T, 129), seed=T)
    got = emulate_first(e, mag, groups)
    ref = _first_ref64(e, mag)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def _first_ref64(e, mag):
    y = conv2d_same(mag.double()[:, None], e.w1.double(), e.b1.double())
    return torch.relu(y) if e.first.use_act else y


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("B,T,warps", [(1, 1, None), (2, 33, None), (1, 40, 1), (1, 31, 17), (1, 7, 5)])
def test_proj_kernel_emulated_matches_plain(name, B, T, warps):
    e = _edges(name, seed=6)
    z = _rand((B, e.proj_channels, T, 129), seed=T) - 0.5
    got = emulate_proj(e, z, warps)
    ref = conv2d_same(z.double(), e.w_last.double(), e.b_last.double())[:, 0]
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_proj_tap_ranges_cover_every_real_product():
    """Each bin group's taps, widened to multiples of 4, hold every tap
    whose input bin is real for a real bin of the group: 13,856 products a
    channel and frame, of the 12,481 real."""
    done = 0
    for group in range(re_.BIN_GROUPS):
        f0 = 8 * group
        fmax = min(f0 + 7, 128)
        j0 = max(0, 64 - fmax) & ~3
        j1 = (min(128, 192 - f0) + 4) & ~3
        assert j1 <= re_.PROJ_TAPS_PADDED
        for f in range(f0, fmax + 1):
            real = [j for j in range(129) if 0 <= f + j - 64 < 129]
            assert j0 <= min(real) and max(real) < j1
        done += 8 * (j1 - j0)
    assert done == 13_856
