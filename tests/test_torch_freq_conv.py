"""`freq_conv`'s tensor-core kernel (ops/csrc/freq_conv.cu), emulated in
plain torch on the CPU: its launch plan (`freq_conv_plan`), its staged
images of the input and the weights, its offset table (`tap_offsets`), its
3xTF32 arithmetic chunk by chunk and its write rule, against the plain
version and the Pallas probes in interpret mode.  The kernel itself is held
against the plain version on the card in test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_torch.ops import freq_conv as fc
from fullycnnspeechenhancement_torch.probes import all_probes
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401
from test_torch_probes import SMALL, _jax_probe

PROBES = {p.name: (m, p) for m, p in all_probes()}
CONV_PROBES = sorted(n for n, (_, p) in PROBES.items() if p.kernel == "freq_conv")
FLUSH_CHUNKS = 8  # csrc kFlushChunks


def _plan(x, w, options, n_sms=fc.N_SMS):
    B, R, P, C = x.shape
    K, _, D = w.shape
    return fc.freq_conv_plan(
        B, R, P, C, D, K, dilation=options.get("dilation", 1), position_stride=x.stride(2),
        channel_stride=x.stride(3), period=options.get("period", 0), valid=options.get("valid", 0),
        n_sms=n_sms,
    )


def _items(plan):
    """(row, first position) of every item, in the kernel's order."""
    i = np.arange(plan.items)
    return i // plan.items_per_row, (i % plan.items_per_row) * plan.tile


def weight_fragments(bm, plan):
    """The kernel's weight region before its split: B [chunks * 8, groups *
    nt * 8] (zero past C * K and D) in fragment order, slot ((ng * chunks +
    ch) * nt + n) * 32 + 4g + t holding (B[8ch + t, d], B[8ch + t + 4, d])
    for d = 8 (ng * nt + n) + g, as `copy_weights` lays it out: [slots,
    2]."""
    v = bm.view(plan.chunks, 2, 4, plan.groups, plan.nt, 8)  # [ch, h, t, ng, n, g]
    return v.permute(3, 0, 4, 5, 2, 1).reshape(-1, 2)


def fragment_matrix(slots, plan):
    """B as the mma reads it back from the slots: lane (g, t) of n tile
    (ng, n) at chunk ch has b0 = B[8ch + t, n0 + g], b1 = B[8ch + t + 4,
    n0 + g]."""
    v = slots.view(plan.groups, plan.chunks, plan.nt, 8, 4, 2)  # [ng, ch, n, g, t, h]
    return v.permute(1, 5, 4, 0, 2, 3).reshape(plan.chunks * 8, -1)


def emulate(x, w, plan, lo=None, dilation=1, circular=False, period=0, valid=0, relu=False,
            scale=1.0, passes=3):
    """The kernel in plain torch, all items at once.  For each item, a
    float32 image of its input buffer (NaN where the kernel writes nothing,
    so a read there poisons the sum) filled as the staging loops fill it;
    the weights laid out in fragment order, split, and read back as the
    mma reads them; A gathered through `tap_offsets` at m * ps; each
    operand split as the kernel splits it; per K split, per k8 chunk the
    products small*big, big*small, big*big (passes=1: big*big alone) added
    in float32 into sums flushed every FLUSH_CHUNKS chunks, then split 0's
    sum plus the others in order; then the write rule (skipped m16 tiles
    write zeros, positions past P and channels past D nothing).  Returns
    (y, times each output element was written, m16 tiles multiplied)."""
    B, R, P, C = x.shape
    K, _, D = w.shape
    lo = (K - 1) // 2 if lo is None else lo
    rows = B * R
    xr = x.reshape(rows, P, C)
    S, span, cm = plan.row_stride, plan.span, plan.channel_major
    ps = 1 if cm else S
    kpad, dpad = plan.chunks * 8, plan.groups * plan.nt * 8

    row, p0 = (torch.as_tensor(v) for v in _items(plan))
    q = p0[:, None] - lo + torch.arange(span)[None, :]  # [items, span]
    real = torch.ones_like(q, dtype=torch.bool) if circular else (q >= 0) & (q < P)
    vals = xr[row[:, None], q % P]  # [items, span, C]
    vals = torch.where(real[..., None], vals, torch.zeros(()))
    image = torch.full((plan.items, plan.buf_floats), float("nan"))
    s, c = torch.meshgrid(torch.arange(span), torch.arange(C), indexing="ij")
    image[:, (c * S + s if cm else s * S + c).reshape(-1)] = vals.reshape(plan.items, -1)

    bm = torch.zeros(kpad, dpad)
    bm[: C * K, :D] = w.reshape(K * C, D)
    slots = weight_fragments(bm, plan)
    b_big, b_small = (fragment_matrix(part, plan) for part in fc.split_tf32(slots.contiguous()))
    off = torch.as_tensor(fc.tap_offsets(C, K, dilation, cm, S)).long()

    m = torch.arange(plan.tile)
    a = image[:, off[None, :] + (m * ps)[:, None]]  # [items, tile, kpad]
    a_big, a_small = fc.split_tf32(a.contiguous())
    per_split = -(-plan.chunks // plan.ksplit)
    total = None
    for ks in range(plan.ksplit):
        part = torch.zeros(plan.items, plan.tile, dpad)
        end = min(plan.chunks, (ks + 1) * per_split)
        for c0 in range(ks * per_split, end, FLUSH_CHUNKS):
            acc = torch.zeros_like(part)
            for ch in range(c0, min(c0 + FLUSH_CHUNKS, end)):
                k = slice(8 * ch, 8 * ch + 8)
                if passes == 3:
                    acc = acc + a_small[..., k] @ b_big[k]
                    acc = acc + a_big[..., k] @ b_small[k]
                acc = acc + a_big[..., k] @ b_big[k]
            part = part + acc
        total = part if total is None else total + part

    p = p0[:, None] + m[None, :]  # [items, tile]
    live = torch.ones_like(p, dtype=torch.bool) if not period else p % period < valid
    # warp wm multiplies tiles wm + i * mwarps (i < mb) if any holds a live
    # position; a dead tile of such a warp is masked to zeros
    tile_live = (live & (p < P)).view(plan.items, plan.mtiles, 16).any(-1)
    pad = torch.zeros(plan.items, plan.mwarps * plan.mb - plan.mtiles, dtype=torch.bool)
    warp_live = torch.cat([tile_live, pad], 1).view(plan.items, plan.mb, plan.mwarps).any(1)
    computed = torch.cat([warp_live] * plan.mb, 1)[:, : plan.mtiles].repeat_interleave(16, dim=1)
    v = torch.where((live & computed)[..., None], total, torch.zeros(()))
    if relu:
        v = torch.relu(v)
    v = v * scale
    y = torch.full((rows, P, D), float("nan"))
    writes = torch.zeros(rows, P, D, dtype=torch.int64)
    it, mm = (p < P).nonzero(as_tuple=True)
    y[row[it], p[it, mm]] = v[it, mm, :D]
    writes.index_put_((row[it], p[it, mm]), torch.ones(len(it), D, dtype=torch.int64), accumulate=True)
    return y.view(B, R, P, D), writes.view(B, R, P, D), int(warp_live.sum()) * plan.mb


def _assert_close(got, ref):
    """The card tests' tolerance (PROBE_TOL): 3xTF32 keeps each product to
    about 2^-21 of itself and float32 sums run in another order, so rtol
    1e-5 and atol 1e-5 * max|plain|."""
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def _rand(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# (name, x view, w view, options): NHWC, NCHW, the roll layout, D = 1,
# dilation with stride-0 weights, circular with a negative lo, a row
# shorter than an m16 tile
CASES = {
    "nhwc_d25": (lambda: _rand((2, 3, 40, 5), 1), lambda: _rand((11, 5, 25), 2), {}),
    "nchw_d25": (lambda: _rand((2, 5, 3, 40), 3).permute(0, 2, 3, 1), lambda: _rand((7, 5, 25), 4), {}),
    "nchw_d1": (lambda: _rand((2, 6, 3, 33), 5).permute(0, 2, 3, 1), lambda: _rand((5, 6, 1), 6), {}),
    "nhwc_d1": (lambda: _rand((1, 4, 29, 9), 7), lambda: _rand((3, 9, 1), 8), {"lo": 0}),
    "roll_masked": (
        lambda: _rand((8, 4 * 64), 9).t()[None, None], lambda: _rand((11, 8, 8), 10).transpose(1, 2),
        {"circular": True, "period": 64, "valid": 29, "relu": True, "scale": 0.5},
    ),
    "roll_one_tap": (
        lambda: _rand((8, 2 * 64), 11).t()[None, None], lambda: _rand((1, 8, 8), 12).transpose(1, 2),
        {"lo": 3, "circular": True},
    ),
    "k4_stride0_dil6": (
        lambda: _rand((1, 3, 50, 5), 13), lambda: _rand((5, 6), 14)[None].expand(2, 5, 6),
        {"lo": 3, "dilation": 6},
    ),
    "circular_neg_lo": (
        lambda: _rand((1, 2, 45, 3), 15), lambda: _rand((3, 3, 9), 16),
        {"lo": -2, "dilation": 4, "circular": True},
    ),
    "short_row": (lambda: _rand((2, 3, 7, 6), 17), lambda: _rand((13, 6, 9), 18), {}),
    "d40_two_groups": (lambda: _rand((1, 2, 20, 3), 19), lambda: _rand((3, 3, 40), 20), {}),
    "nchw_129_bins": (lambda: _rand((2, 6, 3, 129), 21).permute(0, 2, 3, 1), lambda: _rand((5, 6, 10), 22), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_sms", [132, 1])
def test_emulated_kernel_matches_plain(case, n_sms):
    """Each output element written exactly once, and equal to the plain
    version: at 132 SMs (tiles cut to fill the card) and at 1 (long tiles;
    pairs of m16 tiles a warp on 129-bin rows)."""
    make_x, make_w, options = CASES[case]
    x, w = make_x(), make_w()
    plan = _plan(x, w, options, n_sms=n_sms)
    got, writes, computed = emulate(x, w, plan, **options)
    assert writes.eq(1).all()
    assert computed == plan.computed_tiles
    if case == "nchw_129_bins":
        assert plan.mb == (2 if n_sms == 1 else 1)
    ref = fc.freq_conv_plain(x, w, **options)
    assert torch.isfinite(got).all()
    _assert_close(got, ref)
    ref64 = fc.freq_conv_plain(x.double(), w.double(), **options)
    err = (got.double() - ref64).abs().max().item() / ref64.abs().max().item()
    assert err < 2e-6, err


def test_one_pass_tf32_misses_the_tolerance():
    """big*big alone (one TF32 product) falls outside the tolerance, so the
    emulation, and the card tests at the same tolerance, can tell the
    3xTF32 split from one pass."""
    make_x, make_w, options = CASES["nchw_d25"]
    x, w = make_x(), make_w()
    plan = _plan(x, w, options)
    ref = fc.freq_conv_plain(x, w, **options)
    _assert_close(emulate(x, w, plan, **options)[0], ref)
    with pytest.raises(AssertionError, match="not close"):
        _assert_close(emulate(x, w, plan, passes=1, **options)[0], ref)


def _probe_operands(name, shapes=None):
    module, probe = PROBES[name]
    arrays = module.inputs(np.random.default_rng(0), **(shapes or {}))
    args = [torch.as_tensor(arrays[a]) for a in probe.args]
    return probe, arrays, probe.operands(*args)


@pytest.mark.parametrize("name", CONV_PROBES)
def test_plan_fills_the_card_and_covers_each_position_once(name):
    """At each probe's script shape: at least 132 blocks; the items' tiles
    cover every position of every row once; blocks take items i, i + grid,
    ... so each item once; only m16 tiles with no live position skipped."""
    probe, _, (x, w) = _probe_operands(name)
    plan = _plan(x, w, probe.options)
    assert plan.grid >= 132 and plan.grid == plan.items and plan.buffers == 1
    assert plan.tile % 16 == 0 and plan.mb == 1 and plan.mtiles * plan.ksplit <= fc.MAX_WARPS
    assert plan.threads == 32 * plan.mtiles * plan.ksplit
    B, R, P, C = x.shape
    rows = B * R
    row, p0 = _items(plan)
    cover = np.zeros((rows, P), int)
    for r, p in zip(row, p0):
        cover[r, p : min(p + plan.tile, P)] += 1
    assert (cover == 1).all()
    taken = np.concatenate([np.arange(b, plan.items, plan.grid) for b in range(plan.grid)])
    assert sorted(taken) == list(range(plan.items))
    m_row = -(-P // 16)
    period, valid = probe.options.get("period", 0), probe.options.get("valid", 0)
    pos = np.arange(m_row * 16).reshape(m_row, 16)
    live = (pos < P) & ((pos % period < valid) if period else True)
    assert plan.skipped_tiles == rows * int((~live.any(1)).sum())
    assert plan.computed_tiles + plan.skipped_tiles == rows * m_row
    if name == "roll.k2":  # 7 of the 16 m16 tiles of each 256-lane frame
        assert plan.skipped_tiles == 7 * P // 256


def test_plan_at_v2_width_runs_whole_rows_on_persistent_blocks():
    """V2 64 x 8 s (NCHW, 31,936 rows of 129 bins): a tile of 144 (nine
    warps), persistent blocks with two input buffers; a single 8 s request (499 rows) gets one block per row."""
    x = torch.empty(64, 23, 499, 129).permute(0, 2, 3, 1)
    w = torch.empty(11, 23, 25)
    plan = _plan(x, w, {})
    assert (plan.tile, plan.mtiles, plan.ksplit, plan.items) == (144, 9, 1, 64 * 499)
    assert (plan.mb, plan.threads, plan.computed_tiles) == (1, 288, 64 * 499 * 9)
    # at most 24 output channels: five warps of two m16 tiles each, the
    # fifth's second tile past the row
    pair = _plan(x, w[:, :, :23], {})
    assert (pair.mb, pair.mwarps, pair.threads) == (2, 5, 160)
    assert (pair.computed_tiles, pair.skipped_tiles) == (64 * 499 * 10, 0)
    assert plan.buffers == 2 and plan.grid < plan.items
    assert plan.channel_major and plan.row_stride % 32 in (8, 24) and plan.row_stride >= plan.span
    assert plan.smem_bytes <= fc.SMEM_BYTES
    one = _plan(torch.empty(1, 23, 499, 129).permute(0, 2, 3, 1), w, {})
    assert one.tile == 144 and one.buffers == 1 and one.grid == one.items == 499


@pytest.mark.parametrize(
    "C,K,dil,cm,stride",
    [(25, 11, 1, False, 28), (25, 11, 1, True, 72), (5, 2, 6, False, 12), (32, 11, 1, True, 136),
     (3, 1, 1, True, 8)],
)
def test_tap_offsets_read_tap_j_of_channel_c_and_avoid_bank_conflicts(C, K, dil, cm, stride):
    """offset[j * C + c] is (tap j, channel c) at the staged layout's
    strides; padding repeats the last; an A load whose four k lie in one
    tap hits 32 distinct banks (lanes g = 0..7, t = 0..3 at offset[k0 +
    t] + g * ps)."""
    off = fc.tap_offsets(C, K, dil, cm, stride)
    ps, cs = (1, stride) if cm else (stride, 1)
    assert len(off) % 8 == 0 and len(off) >= C * K
    for j in range(K):
        for c in range(C):
            assert off[j * C + c] == c * cs + j * dil * ps
    assert (off[C * K :] == off[C * K - 1]).all()
    for k0 in range(0, C * K - 3, 8):
        if (k0 // C) == ((k0 + 3) // C):
            banks = {(off[k0 + t] + g * ps) % 32 for g in range(8) for t in range(4)}
            assert len(banks) == 32


def test_split_rounds_and_recovers_float32():
    """big and small are TF32 values, big + small is x within 2^-22 of
    it, and rounding (not truncation) leaves no bias."""
    x = torch.as_tensor(np.random.default_rng(0).random(100_000).astype(np.float32))
    big, small = fc.split_tf32(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (big.double() + small.double() - x.double()) / x.double()
    assert err.abs().max() <= 2.0**-22
    assert abs(err.mean().item()) < 1e-9


def test_plan_raises_past_the_kernels_limits():
    """A block keeps all of C * K's split weight fragments and its input
    rows in shared memory: past that the plan raises (C * K = 4108 at
    D = 1: 263 KB of fragments; and wide D), below it runs."""
    with pytest.raises(ValueError, match="shared memory"):
        fc.freq_conv_plan(1, 1, 129, 316, 1, 13)
    with pytest.raises(ValueError, match="shared memory"):
        fc.freq_conv_plan(1, 1, 129, 300, 800, 13)
    plan = fc.freq_conv_plan(1, 1, 129, 250, 1, 10)
    assert plan.smem_bytes <= fc.SMEM_BYTES


@pytest.mark.parametrize("name", ["conv.vA", "conv.vC", "roll.k2", "min.k4"])
def test_emulated_kernel_matches_pallas_probe(name):
    """At a small probe shape (test_torch_probes.SMALL), the emulated
    kernel on the probe's views against the Pallas probe in interpret
    mode."""
    module, probe = PROBES[name]
    short = module.__name__.rsplit(".", 1)[-1]
    arrays = module.inputs(np.random.default_rng(5), **SMALL[short])
    x, w = probe.operands(*[torch.as_tensor(arrays[a]) for a in probe.args])
    got, writes, _ = emulate(x, w, _plan(x, w, probe.options), **probe.options)
    assert writes.eq(1).all()
    ref = _jax_probe(name, arrays)
    out = probe.result(got).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
