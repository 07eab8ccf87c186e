"""`freq_conv_stack`'s tensor-core chain kernel (ops/csrc/freq_conv.cu),
emulated in plain torch on the CPU: its launch plan (`stack_plan`), each
block's image of its two shared-memory buffers (NaN where nothing is
staged, so a read there poisons the sums), the offset table and weight
fragments of its share of the output channels, the 3xTF32 split with its
flush every 8 chunks and K splits, the outputs written into every block of
the frame's cluster, the halo zeroed after layer 1, and the write rule;
against the plain version and the Pallas probes in interpret mode.  The
kernel itself is held against the plain version on the card in
test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_torch.ops import freq_conv as fc
from fullycnnspeechenhancement_torch.probes import roll
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401
from test_torch_freq_conv import FLUSH_CHUNKS, fragment_matrix, weight_fragments
from test_torch_probes import ROLL_CONSTS, SMALL, _interpret, _jax_probe, _pallas_defs

FRAME, VALID = fc.FRAME, fc.VALID


def _plan(C, N, K, valid=VALID, **consts):
    """stack_plan under the module constants `consts` (STACK_CLUSTER=...)."""
    saved = {k: getattr(fc, k) for k in consts}
    try:
        for k, v in consts.items():
            setattr(fc, k, v)
        return fc.stack_plan(C, N, K, valid=valid)
    finally:
        for k, v in saved.items():
            setattr(fc, k, v)


def stack_tap_offsets(C: int, K: int, row_stride: int, d0: int, dn: int) -> np.ndarray:
    """The kernel's A offsets (build_stack_tables) for the block whose
    output channels are [d0, d0 + dn), [chunks * 8] int32: k runs over
    those channels first (k < K * dn: tap k // dn, channel d0 + k % dn),
    then over the others, tap-outer and channel-inner in each part, so that
    the block's own chunks need nothing from its peers; offset[k] = c *
    row_stride + j, padded k repeat the last."""
    own, rest = K * dn, C - dn
    k = np.minimum(np.arange(-(-C * K // fc.K_CHUNK) * fc.K_CHUNK), C * K - 1)
    j = np.where(k < own, k // dn, (k - own) // max(rest, 1))
    c = np.where(k < own, d0 + k - j * dn, k - own - j * rest)
    c = np.where((k >= own) & (c >= d0), c + dn, c)
    return (c * row_stride + j).astype(np.int32)


def _halo(d0, dn, K, valid, rs):
    """Buffer entries of the halo: [0, lo) and [lo + valid, valid + K - 1)
    of the channel rows [d0, d0 + dn)."""
    lo = (K - 1) // 2
    e = torch.cat([torch.arange(lo), torch.arange(lo + valid, valid + K - 1)])
    return (torch.arange(d0, d0 + dn)[:, None] * rs + e[None, :]).reshape(-1)


def emulate_stack(x, w, depth, plan, frame=FRAME, valid=VALID, scale=1.0, passes=3):
    """The kernel in plain torch, all frames at once.  img[f, r, b] is
    block r's buffer b of frame f's cluster: layer 1's input staged into
    buffer 0 with its halo wrapped over N, the halo of the block's own rows
    of buffer 1 zeroed, the rest NaN.  Each block's weights are its n8 tiles' share of w in fragment
    order, split, read back as the mma reads them; A is gathered through
    `stack_tap_offsets` (the block's own channels first) at position m; per
    K split, over its share of the own chunks and then of the peers'
    chunks, per k8 chunk the products small*big, big*small, big*big
    (passes=1: big*big alone), flushed into float32 every FLUSH_CHUNKS
    chunks of each share; split 0's sum plus the others in order.  Live
    positions (m < valid) of the block's channels, masked, ReLU'd and
    scaled, go into the other buffer of the block, then its rows (live
    lanes and halo, in float4) into every peer's; before layer 2 each
    block zeros the halo of its own rows of buffer 0 (its peers' rows come
    with theirs); at the last layer into y, whose masked lanes are zeros.  Returns (y, times each element of y
    was written); asserts after every layer that the blocks' written
    buffers agree and that each live entry of each was written once."""
    C, N = x.shape
    K = w.shape[0]
    lo = (K - 1) // 2
    F, S, rs = N // frame, plan.cluster, plan.row_stride
    xrow = valid + K - 1
    img = torch.full((F, S, 2, plan.buf_floats), float("nan"))
    e = torch.arange(xrow)
    lanes = (torch.arange(F)[:, None] * frame + e[None, :] - lo) % N  # [F, xrow]
    entries = (torch.arange(C)[:, None] * rs + e[None, :]).reshape(-1)
    img[:, :, 0, entries] = x[:, lanes].permute(1, 0, 2).reshape(F, 1, -1)

    y = torch.full((C, N), float("nan"))
    writes = torch.zeros(C, N, dtype=torch.int64)
    masked = (torch.arange(F)[:, None] * frame + torch.arange(valid, frame)[None, :]).reshape(-1)
    live = (torch.arange(F)[:, None] * frame + torch.arange(valid)[None, :]).reshape(-1)
    kpad, dpad = plan.chunks * 8, plan.groups * plan.nt * 8
    row4 = 4 * -(-xrow // 4)  # the entries of a row a block copies into its peers
    out_entries = torch.arange(C)[:, None] * rs + lo + torch.arange(valid)[None, :]  # [C, valid]
    m = torch.arange(16 * plan.mtiles)
    blocks = []
    for r in range(S):
        d0 = 8 * plan.tiles * r
        dn = min(C - d0, 8 * plan.tiles)
        assert dn >= 1
        off = torch.as_tensor(stack_tap_offsets(C, K, rs, d0, dn)).long()
        j, c = off[: C * K] % rs, off[: C * K] // rs
        bm = torch.zeros(kpad, dpad)
        bm[: C * K, :dn] = w[j, c, d0 : d0 + dn]  # B[k, d] = w[j, c, d0 + d]
        slots = weight_fragments(bm, plan)
        own = K * dn // 8 if S > 1 else plan.chunks  # the chunks of the block's own channels
        shares = []
        for ks in range(plan.ksplit):  # (begin, end) of the own and the peers' share
            po, pp = -(-own // plan.ksplit), -(-(plan.chunks - own) // plan.ksplit)
            ob, pb = min(own, ks * po), min(plan.chunks, own + ks * pp)
            shares.append([(ob, min(own, ob + po)), (pb, min(plan.chunks, pb + pp))])
        rows = (torch.arange(d0, d0 + dn)[:, None] * rs + torch.arange(row4)[None, :]).reshape(-1)
        halo = _halo(d0, dn, K, valid, rs)
        img[:, r, 1, halo] = 0.0
        blocks.append((d0, dn, off, shares, rows, halo,
                       *(fragment_matrix(p, plan) for p in fc.split_tf32(slots.contiguous()))))
        y[d0 : d0 + dn, masked] = 0.0
        writes[d0 : d0 + dn, masked] += 1

    for layer in range(depth):
        src, dst = layer % 2, 1 - layer % 2
        last = layer == depth - 1
        if layer == 1:
            for r, (d0, dn, off, shares, rows, halo, *_) in enumerate(blocks):
                img[:, r, 0, halo] = 0.0
        stored = torch.zeros(F, S, plan.buf_floats, dtype=torch.int64)
        new = img[:, :, dst].clone()
        for r, (d0, dn, off, shares, rows, _, b_big, b_small) in enumerate(blocks):
            a = img[:, r, src][:, off[None, :] + m[:, None]]  # [F, 16 mtiles, kpad]
            a_big, a_small = fc.split_tf32(a.contiguous())
            total = None
            for share in shares:
                part = torch.zeros(F, len(m), dpad)
                for begin, end in share:
                    for c0 in range(begin, end, FLUSH_CHUNKS):
                        acc = torch.zeros_like(part)
                        for ch in range(c0, min(c0 + FLUSH_CHUNKS, end)):
                            k = slice(8 * ch, 8 * ch + 8)
                            if passes == 3:
                                acc = acc + a_small[..., k] @ b_big[k]
                                acc = acc + a_big[..., k] @ b_small[k]
                            acc = acc + a_big[..., k] @ b_big[k]
                        part = part + acc
                total = part if total is None else total + part
            v = torch.relu(total[:, :valid, :dn]) * scale  # [F, valid, dn]; rows past valid not written
            if last:
                y[d0 : d0 + dn, live] = v.permute(2, 0, 1).reshape(dn, -1)
                writes[d0 : d0 + dn, live] += 1
            else:
                at = out_entries[d0 : d0 + dn].reshape(-1)
                new[:, r, at] = v.permute(0, 2, 1).reshape(F, -1)
                stored[:, r, at] += 1
        if not last:
            for r, (d0, dn, off, shares, rows, *_) in enumerate(blocks):
                for q in range(S):
                    if q != r:
                        new[:, q, rows] = new[:, r, rows]
                        stored[:, q, rows] += 1
            img[:, :, dst] = new
            assert stored[..., out_entries.reshape(-1)].eq(1).all()
            for q in range(1, S):
                torch.testing.assert_close(img[:, q, dst], img[:, 0, dst], rtol=0, atol=0, equal_nan=True)
    return y, writes


def _assert_close(got, ref):
    """The card tests' tolerance (PROBE_TOL): 3xTF32 keeps each product to
    about 2^-21 of itself and float32 sums run in another order, so rtol
    1e-5 and atol 1e-5 * max|plain|."""
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


def _inputs(C, K, frames, seed):
    """x in [0, 1), w in [0, 1) and a scale of 2 / (C K), so each layer keeps
    the activations' scale over a chain of 16."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.random((C, frames * FRAME), dtype=np.float32))
    w = torch.as_tensor(rng.random((K, C, C), dtype=np.float32))
    return x, w, 2.0 / (C * K)


@pytest.mark.parametrize("depth", [1, 3, 16])
@pytest.mark.parametrize("frames", [1, 3])
@pytest.mark.parametrize("K", [1, 5, 11, 13])
@pytest.mark.parametrize("C", [3, 8, 32])
def test_emulated_chain_matches_plain(C, K, frames, depth):
    """Every element of y written once, equal to the plain version within
    PROBE_TOL, and within 2e-6 of max|y| of the plain version in float64."""
    x, w, scale = _inputs(C, K, frames, C * 1000 + K * 10 + frames)
    plan = _plan(C, x.shape[1], K)
    assert plan.cluster == (1 if C <= 8 else 2)
    got, writes = emulate_stack(x, w, depth, plan, scale=scale)
    assert writes.eq(1).all()
    ref = fc.freq_conv_stack_plain(x, w, depth, scale=scale)
    assert torch.isfinite(got).all() and (ref > 0).float().mean() > 0.3  # live, not ReLU zeros
    _assert_close(got, ref)
    ref64 = fc.freq_conv_stack_plain(x.double(), w.double(), depth, scale=scale)
    err = (got.double() - ref64).abs().max().item() / ref64.abs().max().item()
    assert err < 2e-6, err


@pytest.mark.parametrize(
    "consts",
    [dict(STACK_CLUSTER=1), dict(STACK_MB=1, STACK_KSPLIT=2), dict(STACK_MB=1, STACK_KSPLIT=1),
     dict(STACK_KSPLIT=1), dict(STACK_KSPLIT=2), dict(STACK_CLUSTER=4)],
    ids=["one_block", "one_tile_2_splits", "one_tile_no_split", "no_split", "pairs_2_splits", "cluster4"],
)
def test_emulated_other_plans_match_plain(consts):
    """One block a frame (the plan phase 14 of chip_smoke.py times beside
    the default), the other warp plans (one m16 tile a warp over 2 K
    splits or none, no K split, 2 K splits) and a cluster of four blocks,
    at C = 32: the same sums, each written once."""
    x, w, scale = _inputs(32, 11, 2, 5)
    plan = _plan(32, x.shape[1], 11, **consts)
    assert plan.cluster == consts.get("STACK_CLUSTER", 2)
    got, writes = emulate_stack(x, w, 4, plan, scale=scale)
    assert writes.eq(1).all()
    _assert_close(got, fc.freq_conv_stack_plain(x, w, 4, scale=scale))


def test_one_pass_tf32_chain_misses_the_tolerance():
    """big*big alone (one TF32 product) falls outside PROBE_TOL on a chain
    of 16, so the emulation, and the card tests at the same tolerance, can
    tell the 3xTF32 split from one pass."""
    x, w, scale = _inputs(32, 11, 1, 3)
    plan = _plan(32, x.shape[1], 11)
    ref = fc.freq_conv_stack_plain(x, w, 16, scale=scale)
    _assert_close(emulate_stack(x, w, 16, plan, scale=scale)[0], ref)
    with pytest.raises(AssertionError, match="not close"):
        _assert_close(emulate_stack(x, w, 16, plan, scale=scale, passes=1)[0], ref)


def test_plan_fills_the_card_at_roll2_shape():
    """x [32, 64 * 256], K = 11: a cluster of two blocks a frame, 128 blocks
    (on 132 SMs), each with 2 n8 tiles (16 channels), 9 m16 tiles a frame
    as 5 pairs (the tenth computed, not written) over 5 warps times 3 K
    splits of 15 chunks; the padded products are 10 x 4 x 44 m16n8k8 tiles
    a frame and layer, 1.265x the real ones (9 x 4 x 44 and 1.139x with
    one tile a warp)."""
    plan = _plan(32, 64 * FRAME, 11)
    assert plan.grid >= 128 and plan.grid <= fc.N_SMS
    assert (plan.cluster, plan.frames, plan.grid, plan.tiles, plan.nt, plan.groups) == (2, 64, 128, 2, 2, 1)
    assert (plan.mtiles, plan.mb, plan.units, plan.mwarps, plan.rounds, plan.ksplit) == (9, 2, 5, 5, 1, 3)
    assert plan.threads == 480 and plan.chunks == 44
    assert plan.padded_macs(16) == 64 * 16 * 10 * 4 * 44 * 16 * 8 * 8
    single = _plan(32, 64 * FRAME, 11, STACK_MB=1, STACK_KSPLIT=2)
    assert (single.units, single.mwarps, single.ksplit, single.threads) == (9, 9, 2, 576)
    assert single.padded_macs(16) == 64 * 16 * 9 * 4 * 44 * 16 * 8 * 8
    # layer 1: every tap of the live lanes; later layers: the taps that
    # meet a live lane (chip_smoke.py::chain_work), 1.4583e9 in all
    q = np.arange(VALID)[:, None] + np.arange(11)[None, :] - 5
    inner = int(((q >= 0) & (q < VALID)).sum())
    real = 64 * 32 * 32 * (VALID * 11 + 15 * inner)
    assert 1.1385 < single.padded_macs(16) / real < 1.1395
    assert 1.2650 < plan.padded_macs(16) / real < 1.2655
    one = _plan(32, 64 * FRAME, 11, STACK_CLUSTER=1)
    assert (one.cluster, one.grid, one.nt) == (1, 64, 4)
    assert plan.smem_bytes <= fc.SMEM_BYTES and one.smem_bytes <= fc.SMEM_BYTES


@pytest.mark.parametrize("C", [1, 3, 8, 9, 20, 32, 40, 50, 60])
@pytest.mark.parametrize("K", [1, 11, 13])
@pytest.mark.parametrize("consts", [{}, dict(STACK_MB=1)], ids=["mb2", "mb1"])
def test_plan_covers_each_tile_and_channel_once(C, K, consts):
    """Each m16 tile of a frame is computed and written by exactly one warp
    (unit u, tile u + i * units; indices past mtiles written by none), each
    output channel by exactly one block of the cluster; warps, shared
    memory and the row stride within the kernel's limits."""
    plan = _plan(C, 4 * FRAME, K, **consts)
    written = np.zeros(plan.mtiles, int)
    for r in range(plan.rounds):
        for wm in range(plan.mwarps):
            u = wm + r * plan.mwarps
            if u < plan.units:
                for i in range(plan.mb):
                    if u + i * plan.units < plan.mtiles:
                        written[u + i * plan.units] += 1
    assert (written == 1).all()
    channels = np.zeros(C, int)
    for r in range(plan.cluster):
        d0 = 8 * plan.tiles * r
        assert d0 < C
        channels[d0 : d0 + 8 * plan.tiles] += 1
    assert (channels == 1).all()
    assert plan.groups * plan.nt >= plan.tiles and plan.nt <= fc.MAX_NT
    assert plan.threads <= 32 * fc.STACK_MAX_WARPS and plan.cluster <= fc.MAX_STACK_CLUSTER
    assert plan.mb == 1 or plan.nt <= 2
    assert plan.row_stride % 32 in (8, 24) and plan.row_stride >= plan.span == 16 * plan.mtiles + K - 1
    assert plan.smem_bytes <= fc.SMEM_BYTES


def test_plan_takes_every_width_the_simt_design_took():
    """The float32 SIMT design kept all C * K * C weights and two buffers of
    C * (valid + K - 1) floats in one block: every C it took still plans
    (clusters of up to 8 where a block's share of 2 would not fit), and
    C = 60, K = 11 runs 4 blocks a frame."""
    for K in range(1, fc.MAX_K + 1):
        C = 1
        while 4 * ((C + 1) * K * -(-(C + 1) // 4) * 4 + 2 * ((C + 1) * (VALID + K - 1) + 4)) <= fc.SMEM_BYTES:
            C += 1
        for c in range(1, C + 1):
            fc.stack_plan(c, FRAME, K)
    assert fc.stack_plan(60, FRAME, 11).cluster == 4
    with pytest.raises(ValueError, match="shared memory"):
        fc.stack_plan(96, FRAME, 13)


@pytest.mark.parametrize("C,K,d0,dn", [(32, 11, 0, 16), (32, 11, 16, 16), (20, 13, 16, 4), (60, 11, 48, 12),
                                       (3, 5, 0, 3)])
def test_stack_offsets_take_own_channels_first_and_avoid_bank_conflicts(C, K, d0, dn):
    """Each (tap, channel) once: the block's own channels [d0, d0 + dn) for
    every tap first, then the others; padding repeats the last; at roll2's
    row stride an A load whose four k lie in one tap hits 32 distinct
    banks (lanes g = 0..7, t = 0..3 at offset[k0 + t] + g)."""
    rs = _plan(C, FRAME, K).row_stride
    off = stack_tap_offsets(C, K, rs, d0, dn)
    j, c = off % rs, off // rs
    assert len(off) % 8 == 0 and sorted(zip(j[: C * K], c[: C * K])) == [(a, b) for a in range(K) for b in range(C)]
    assert ((c[: K * dn] >= d0) & (c[: K * dn] < d0 + dn)).all()
    assert (j[: K * dn] == np.arange(K * dn) // dn).all()
    assert (off[C * K :] == off[C * K - 1]).all()
    if (C, K) == (32, 11):
        for k0 in range(0, C * K, 8):
            banks = {(int(off[k0 + t]) + g) % 32 for g in range(8) for t in range(4)}
            assert len(banks) == 32


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("name", ["roll.k3", "roll.im2col_stack(1)", "roll.im2col_stack(4)", "roll.im2col_stack(16)"])
def test_emulated_chain_matches_pallas_probe(name, C):
    """At a small probe shape (2 frames of 256 lanes, K = 11), the emulated
    kernel on the probe's views against the Pallas probe in interpret
    mode: C = 8 runs one block a frame, C = 16 a cluster of two."""
    probe = {p.name: p for p in roll.PROBES}[name]
    consts = dict(ROLL_CONSTS, C=C)
    arrays = roll.inputs(np.random.default_rng(9 + C), T_TILE=consts["T_TILE"], C=C, K=consts["K"])
    x, w = probe.operands(*[torch.as_tensor(arrays[a]) for a in probe.args])
    plan = _plan(C, x.shape[1], w.shape[0])
    assert plan.cluster == C // 8
    opts = probe.options
    got, writes = emulate_stack(x, w, opts["depth"], plan, frame=opts["frame"], valid=opts["valid"],
                                scale=opts.get("scale", 1.0))
    assert writes.eq(1).all()
    if C == SMALL["roll"]["C"]:
        ref = _jax_probe(name, arrays)
    elif name == "roll.k3":
        ref = _interpret(_pallas_defs("micro_pallas_roll.py", consts)["k3"], [arrays["x"], arrays["w"]],
                         (C, consts["N"]))
    else:
        depth = int(name[len("roll.im2col_stack(") : -1])
        kernel = _pallas_defs("micro_pallas_roll2.py", consts)["mk_stack"](depth)
        ref = _interpret(kernel, [arrays["x"], arrays["wcol"]], (C, consts["N"]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
