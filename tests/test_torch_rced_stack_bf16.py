"""The bf16 stack kernel on wgmma (`csrc/rced_stack.cu`,
`rced_stack_wgmma_kernel`) emulated in plain torch, on the CPU.

The emulation works in an image of one block's shared memory per frame
(bytes, filled with 0xff first, so anything read that nothing wrote is a
NaN in bf16 and in float32) and follows the kernel's own index arithmetic:
both shadows zeroed, the input load into shadow 0 and the input's float32
rows, each layer's chunk staged into its buffer, each wgmma operand read
through the descriptor the kernel builds (start, leading and stride-byte
offsets of a K-major operand without swizzle; A from the table in the chunk
plus 64 rows a tile, B at 32 n bytes an instruction), the edge warp's
ldmatrix addresses and mma.sync fragments for bin 128, the k16 products
exact and summed into float32, the accumulators mapped to (bin, channel)
as m64nNk16 and m16n8k16 lay them out, and the epilogues' reads, selects
and writes (dump addresses).  Against the plain bf16 mode, and
JAX's fused forward in interpret mode; the routing by shape.
"""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models.rced import ConvSpec as JConvSpec, ModelDef as JModelDef
from fullycnnspeechenhancement_tpu.ops import fused_inference_forward as j_fused

from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
from fullycnnspeechenhancement_torch.ops import rced_stack as rs
from fullycnnspeechenhancement_torch.ops.rced_stack import WgField
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_bf16 import dyadic_params
from test_torch_cuda import (  # noqa: F401
    NAMES,
    ONE_LAYER_CASES,
    assert_bf16_stack_close,
    assert_live,
    numpy_params,
    one_cpu_thread_per_worker,
    one_layer_model,
)

BF16 = torch.bfloat16
BINS = rs.F_DIM


def _packed(model, seed=1, dyadic=False):
    model = get_model(model) if isinstance(model, str) else model
    draw = dyadic_params(model, seed) if dyadic else numpy_params(model, seed, centred_bn=True)
    params, bn = params_from_numpy(*draw)
    return rs.pack_inference_stack(model, params, bn, "bfloat16")


def descriptor_read(img16, start, lbo, sbo, rows):
    """What wgmma reads of a K-major operand without swizzle, `rows` rows
    by k16, from `img16` ([frames, bytes / 2] bf16) under a descriptor of
    `start`, `lbo` and `sbo` bytes: element (r, k) at start + 16 (r % 8) +
    sbo (r // 8) + lbo (k // 8) + 2 (k % 8)."""
    r = torch.arange(rows)[:, None]
    k = torch.arange(16)[None, :]
    at = start + 16 * (r % 8) + sbo * (r // 8) + lbo * (k // 8) + 2 * (k % 8)
    return img16[:, at // 2]


def _views(img):
    return img.view(BF16), img.view(torch.float32), img.view(torch.int32)


def ldmatrix(img16, addr):
    """ldmatrix (.x2 or .x4) in plain torch: `addr` [matrices, 8] byte
    addresses of each 8 x 8 matrix's rows (lane 8 i + r gives row r of
    matrix i) -> [frames, matrices, 8 rows, 8] bf16."""
    at = addr[:, :, None] + 2 * torch.arange(8)
    return img16[:, at // 2]


def edge_tile(img16, sh_in, buf, e, i, n):
    """The edge warp's products of instruction i (table entry `e`) for bin
    rows 128..143 as the kernel loads them: A by ldmatrix.x4, lane L at row
    (e & 0xffff) + 128 + L % 8 + 8 ((L // 8) % 2) + (L // 16) (e >> 16);
    B per column group j by ldmatrix.x2, lane L < 16 at buf + 16 n ((L //
    8) % 2) + 16 (L % 8) + 32 n i + 128 j; then mma.sync.m16n8k16, whose A
    is [matrix 0 | matrix 2] over [matrix 1 | matrix 3] and whose B^T is
    [matrix 0 | matrix 1].  -> [frames, 16, n] in float64 (exact)."""
    lane = torch.arange(32)
    rows = (e & 0xFFFF) + (BINS - 1) + lane % 8 + 8 * ((lane // 8) % 2) + (lane // 16) * (e >> 16)
    a = ldmatrix(img16, (sh_in + 16 * rows).view(4, 8))
    a = torch.cat([torch.cat([a[:, 0], a[:, 2]], 2), torch.cat([a[:, 1], a[:, 3]], 2)], 1)  # [f, 16, 16]
    out = []
    for j in range(n // 8):
        lb = lane[:16]
        b = ldmatrix(img16, (buf + 16 * n * ((lb // 8) % 2) + 16 * (lb % 8) + 32 * n * i + 128 * j).view(2, 8))
        bt = torch.cat([b[:, 0], b[:, 1]], 2)  # [f, 8 columns, 16 k]
        out.append(a.double() @ bt.double().transpose(1, 2))
    return torch.cat(out, 2)


def emulate_wgmma_kernel(packed, x, trace=None):
    """The wgmma kernel in plain torch, all frames at once.  `trace`, a
    list, gets after the input load and after each layer's epilogue (the
    float32 values the epilogue computed for bins 0..128 and channels
    0..cout - 1, or the input; the shadow written, [frames, groups, rows,
    8] bf16; its number of groups)."""
    wg = packed.wg
    B, C, T, F = x.shape
    n = B * T
    img = torch.full((n, wg.smem_bytes), 0xFF, dtype=torch.uint8)
    i16, f32, i32 = _views(img)
    f32_base = wg.f32_offset // 4
    sh = [wg.shadow_offset(0), wg.shadow_offset(1)]
    img[:, sh[0] : sh[0] + 2 * wg.shadow_bytes] = 0  # both shadows
    # the input: channel c, row f of shadow 0; float32 rows where read later
    # value i of the input's padded channels is channel i // 129, bin
    # i % 129 (zero past C); float32 rows where a later epilogue reads it
    frames = x.permute(0, 2, 1, 3).reshape(n, C, F)
    groups_in = -(-C // 8)
    i = torch.arange(groups_in * 8 * BINS)
    c, f = i // BINS, i % BINS
    v = torch.zeros(n, groups_in * 8, BINS)
    v[:, :C] = frames
    i16[:, sh[0] // 2 + (rs.WG_LEAD + (c // 8) * rs.WG_ROWS + f) * 8 + c % 8] = v[:, c, f].to(BF16)
    if wg.in_f32 >= 0:
        real = c < C
        f32[:, f32_base + wg.in_f32 + c[real] * rs.WG_F32_ROW + f[real]] = v[:, c[real], f[real]]
    if trace is not None:
        trace.append((frames, _shadow(i16, sh[0], groups_in), groups_in))

    n_layers = len(packed.layers)
    for l, r in enumerate(wg.plan.tolist()):
        N, instr, cout = r[WgField.N], r[WgField.INSTR], r[WgField.COUT]
        buf = wg.buf_offsets[l & 1]
        img[:, buf : buf + r[WgField.CHUNK_BYTES]] = wg.weights[r[WgField.CHUNK] : r[WgField.CHUNK] + r[WgField.CHUNK_BYTES]]
        bias = f32[:, (buf + r[WgField.BIAS]) // 4 :][:, :N]
        table = i32[0, (buf + r[WgField.TABLE]) // 4 :][:instr].tolist()
        sh_in, sh_out = sh[l & 1], sh[(l + 1) & 1]
        # thread (warp w of the warpgroup, lane), n8 group j, half h
        w, lane, j, h = torch.meshgrid(torch.arange(4), torch.arange(32), torch.arange(N // 8), torch.arange(2),
                                       indexing="ij")
        g, q = lane // 4, lane % 4
        c0 = 8 * j + 2 * q
        parts = []
        for tile in range(rs.WG_TILES):
            acc = torch.zeros(n, rs.WG_M, N)
            for i, e in enumerate(table):
                start16 = (sh_in >> 4) + 64 * tile + (e & 0xFFFF)
                a = descriptor_read(i16, 16 * start16, 16 * (e >> 16), 128, rs.WG_M)
                b = descriptor_read(i16, buf + 32 * N * i, 16 * N, 128, N)
                acc += (a.double() @ b.double().transpose(1, 2)).float()
            # c[4j + 2h + e] is row 16 w + g + 8 h, column 8 j + 2 q + e
            m = 64 * tile + 16 * w + g + 8 * h
            parts.append((acc[:, m - 64 * tile, c0], acc[:, m - 64 * tile, c0 + 1], m, c0, torch.ones_like(m, dtype=torch.bool)))
        ys = []
        for acc0, acc1, m, c0, lands in parts:
            vals = []
            for acc_c, c_ in ((acc0, c0), (acc1, c0 + 1)):
                y = acc_c + bias[:, c_]
                rowf = c_.clamp(max=cout - 1) * rs.WG_F32_ROW
                if r[WgField.SKIP] >= 0:
                    y = y + f32[:, f32_base + r[WgField.SKIP] + rowf + m]
                if r[WgField.RELU]:
                    y = torch.relu(y)
                if r[WgField.ADD] >= 0:
                    y = y + f32[:, f32_base + r[WgField.ADD] + rowf + m]
                ok = lands & (c_ < cout)
                if r[WgField.OUT] >= 0:
                    at = torch.where(ok, r[WgField.OUT] + c_ * rs.WG_F32_ROW + m, wg.dump)
                    f32[:, f32_base + at.reshape(-1)] = y.reshape(n, -1)
                vals.append(torch.where(ok, y, 0.0))
                ys.append((y, m, c_, ok))
            if l + 1 < n_layers:
                jj = c0 // 8
                row = torch.where(lands, rs.WG_LEAD + jj * rs.WG_ROWS + m, rs.WG_LEAD + wg.groups * rs.WG_ROWS)
                word = (sh_out + row * 16 + 4 * (c0 % 8) // 2) // 2
                for k, val in enumerate(vals):
                    i16[:, (word + k).reshape(-1)] = val.to(BF16).reshape(n, -1)
        # the edge warp: lane (g, q) holds rows g and g + 8 of the m16
        # tile; row 0 is bin 128, and only lanes 0..3 (g == 0) land
        edge = torch.zeros(n, rs.WG_EDGE_M, N)
        for i, e in enumerate(table):
            edge += edge_tile(i16, sh_in, buf, e, i, N).float()
        g, q, c0 = g[:1], q[:1], c0[:1]
        m = torch.full_like(g, BINS - 1)
        for acc0, acc1, m, c0, lands in [(edge[:, g, c0], edge[:, g, c0 + 1], m, c0, g == 0)]:
            vals = []
            for acc_c, c_ in ((acc0, c0), (acc1, c0 + 1)):
                y = acc_c + bias[:, c_]
                rowf = c_.clamp(max=cout - 1) * rs.WG_F32_ROW
                if r[WgField.SKIP] >= 0:
                    y = y + f32[:, f32_base + r[WgField.SKIP] + rowf + m]
                if r[WgField.RELU]:
                    y = torch.relu(y)
                if r[WgField.ADD] >= 0:
                    y = y + f32[:, f32_base + r[WgField.ADD] + rowf + m]
                ok = lands & (c_ < cout)
                if r[WgField.OUT] >= 0:
                    at = torch.where(ok, r[WgField.OUT] + c_ * rs.WG_F32_ROW + m, wg.dump)
                    f32[:, f32_base + at.reshape(-1)] = y.reshape(n, -1)
                vals.append(torch.where(ok, y, 0.0))
                ys.append((y, m, c_, ok))
            if l + 1 < n_layers:
                row = torch.where(lands, rs.WG_LEAD + (c0 // 8) * rs.WG_ROWS + m, rs.WG_LEAD + wg.groups * rs.WG_ROWS)
                word = (sh_out + row * 16 + 4 * (c0 % 8) // 2) // 2
                for k, val in enumerate(vals):
                    i16[:, (word + k).reshape(-1)] = val.to(BF16).reshape(n, -1)
        if trace is not None:
            got = torch.full((n, cout, BINS), float("nan"))
            for y, m, c_, ok in ys:
                got[:, c_[ok], m[ok]] = y[:, ok]
            trace.append((got, _shadow(i16, sh_out, N // 8) if l + 1 < n_layers else None, N // 8))
    out = wg.out_f32 + torch.arange(packed.c_out)[:, None] * rs.WG_F32_ROW + torch.arange(BINS)[None, :]
    y = f32[:, f32_base + out]
    return y.reshape(B, T, packed.c_out, F).permute(0, 2, 1, 3)


def _shadow(i16, offset, groups):
    """Groups 0..groups - 1 of the shadow at `offset` and the 6 rows after
    the last, [frames, groups, WG_ROWS, 8] bf16 (row 0 is bin 0)."""
    start = offset // 2 + rs.WG_LEAD * 8
    return i16[:, start : start + groups * rs.WG_ROWS * 8].reshape(-1, groups, rs.WG_ROWS, 8).clone()


@pytest.mark.parametrize("name", NAMES)
def test_shadow_holds_each_layer_input_rounded_once(name):
    """Each shadow the emulated kernel writes (the input load, then every
    epilogue but the last) holds `_as_operand(value, "bfloat16")` of the
    float32 value it was computed from, bit for bit, for bins 0..128 and
    channels 0..c - 1; zeros in every group's 6 halo rows and in the
    padded channels."""
    packed = _packed(name)
    x = torch.as_tensor(np.random.default_rng(3).random((1, packed.c_in, 4, BINS)).astype(np.float32))
    trace = []
    emulate_wgmma_kernel(packed, x, trace)
    assert len(trace) == len(packed.layers) + 1
    for k, (val, shadow, groups) in enumerate(trace[:-1]):
        c = val.shape[1]
        want = rs._as_operand(val, "bfloat16").to(BF16)
        got = shadow.permute(0, 1, 3, 2).reshape(-1, groups * 8, rs.WG_ROWS)  # [frame, channel, row]
        assert torch.isfinite(val).all()
        assert torch.equal(got[:, :c, :BINS].view(torch.int16), want.view(torch.int16)), k
        assert not got[:, :, BINS:].float().any() and not got[:, c:].float().any(), k


@pytest.mark.parametrize("name", NAMES)
def test_b_tiles_read_through_descriptors_hold_the_rounded_weights(name):
    """Each layer's chunk, read as the kernel reads it: B of instruction i
    through the descriptor (start 32 n i, leading-byte offset 16 n,
    stride-byte offset 128) holds the folded weights of its two blocks
    (tap j, channels 8 g .. 8 g + 7) rounded to bf16 (zeros past cin and
    cout, and for a pad block); then the n float32 biases (zeros past
    cout) and the A table `wg_table` gives."""
    packed = _packed(name, seed=5)
    wg = packed.wg
    for lay, (w, b), r in zip(packed.layers, packed.folded, wg.plan.tolist()):
        N, instr = r[WgField.N], r[WgField.INSTR]
        chunk = wg.weights[r[WgField.CHUNK] : r[WgField.CHUNK] + r[WgField.CHUNK_BYTES]]
        i16 = chunk.view(BF16)[None]
        wr = w.to(BF16)
        for i, pair in enumerate(rs.wg_instructions(lay.cin, lay.kw)):
            got = descriptor_read(i16, 32 * N * i, 16 * N, 128, N)[0]  # [n, k]
            want = torch.zeros(N, 16, dtype=BF16)
            for half, blk in enumerate(pair):
                if blk is None:
                    continue
                j, g = blk
                ch = slice(8 * g, min(8 * g + 8, lay.cin))
                want[: lay.cout, 8 * half : 8 * half + ch.stop - ch.start] = wr[ch, j].t()
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (lay.name, i)
        bias = chunk[r[WgField.BIAS] : r[WgField.BIAS] + 4 * N].view(torch.float32)
        assert torch.equal(bias[: lay.cout], b) and not bias[lay.cout :].any()
        table = chunk[r[WgField.TABLE] : r[WgField.TABLE] + 4 * instr].view(torch.int32).numpy()
        np.testing.assert_array_equal(table, rs.wg_table(lay.cin, lay.kw))
        assert r[WgField.CHUNK] % 16 == 0 and r[WgField.CHUNK_BYTES] % 16 == 0


@pytest.mark.parametrize("cin,kw", [(8, 1), (8, 9), (10, 7), (23, 11), (25, 7), (19, 13), (32, 5)])
def test_instruction_plan_reproduces_a(cin, kw):
    """Each instruction's (start row, leading-byte offset) and each tile's
    64 rows reproduce A from a shadow image: row m (bin m) of half h reads
    channel 8 g + k of input bin m + j - lo for block (j, g), zero where
    that bin falls in the halo or the channel past cin; a pad block reads
    the first block again (its weights are zero).  Pairs never point
    backwards, and two taps of one group sit 16 bytes apart."""
    groups = -(-cin // 8)
    lo = (kw - 1) // 2
    shadow_bytes = (rs.WG_LEAD + groups * rs.WG_ROWS + rs.WG_SLACK) * 16
    img = torch.zeros(1, shadow_bytes, dtype=torch.uint8)
    xin = torch.as_tensor(np.random.default_rng(cin + kw).random((groups * 8, BINS)).astype(np.float32))
    xin[cin:] = 0
    i16 = img.view(BF16)
    c = torch.arange(groups * 8)[:, None]
    f = torch.arange(BINS)[None, :]
    i16[0, (rs.WG_LEAD + (c // 8) * rs.WG_ROWS + f) * 8 + c % 8] = xin.to(BF16)
    xpad = torch.zeros(groups * 8, BINS + 2 * rs.HALO)
    xpad[:, rs.HALO : rs.HALO + BINS] = xin.to(BF16).float()
    table = rs.wg_table(cin, kw)
    pairs = rs.wg_instructions(cin, kw)
    assert len(pairs) == -(-kw * groups // 2)
    for e, (a_blk, b_blk) in zip(table.tolist(), pairs):
        assert e >> 16 >= 0
        if a_blk is not None and b_blk is not None and a_blk[1] == b_blk[1]:
            assert e >> 16 == 1  # two taps of one group: overlapping core matrices
        for tile in range(rs.WG_TILES):
            a = descriptor_read(i16, 16 * (64 * tile + (e & 0xFFFF)), 16 * (e >> 16), 128, 64)[0].float()
            m = 64 * tile + torch.arange(64)
            live = m < BINS
            for half, blk in enumerate((a_blk, b_blk if b_blk is not None else a_blk)):
                j, g = blk
                want = xpad[8 * g : 8 * g + 8][:, (m[live] + j - lo + rs.HALO)].t()
                assert torch.equal(a[live, 8 * half : 8 * half + 8], want), (e, tile, half)


@pytest.mark.parametrize("name", NAMES)
def test_emulated_wgmma_kernel_matches_plain(name):
    """Whole stacks: the emulated kernel against the plain bf16 mode at a
    bf16 stack's tolerance (BF16_STACK_*)."""
    packed = _packed(name)
    x = torch.as_tensor(np.random.default_rng(4).random((2, packed.c_in, 5, BINS)).astype(np.float32))
    plain = rs.stack_forward_plain(packed, x)
    assert_live(plain)
    got = emulate_wgmma_kernel(packed, x)
    assert_bf16_stack_close(got, plain)


@pytest.mark.parametrize("case", ONE_LAYER_CASES, ids=lambda c: "_".join(map(str, c)))
def test_emulated_wgmma_kernel_one_layer_matches_plain(case):
    """One layer (every n8 tile count, kw 1 to 13, a single channel group
    and its overlapping taps, a pad block, the skip and the residual): both
    round the same input and weights, products exact, float32 sums in
    another order: rtol 1e-4, atol 1e-5 * max|plain|."""
    packed = _packed(one_layer_model(*case), seed=2, dyadic=True)
    x = torch.as_tensor(np.random.default_rng(5).random((1, packed.c_in, 6, BINS)).astype(np.float32))
    ref = rs.stack_forward_plain(packed, x)
    torch.testing.assert_close(emulate_wgmma_kernel(packed, x), ref, rtol=1e-4,
                               atol=1e-5 * ref.abs().max().item())


def test_emulated_wgmma_one_layer_matches_jax(monkeypatch):
    """One layer (kw 13, 19 -> 32 channels) through the fused forward, with
    the emulated kernel as its stack, against JAX's fused bf16 forward in
    interpret mode on multiples of 2^-6 (layer 1 and BN folding exact in
    both, so both round the same values; tests/test_torch_bf16.py::
    test_fused_bf16_one_layer_matches_jax): rtol 1e-4, atol 1e-5 *
    max|JAX|."""
    case = (13, 19, 32, None)
    model = one_layer_model(*case)
    jmodel = JModelDef(model.name, tuple(
        JConvSpec(s.name, s.out_ch, s.kernel, s.use_norm, s.use_act, s.skip_from, s.add_from)
        for s in model.layers))
    params, bn = dyadic_params(model, seed=13)
    mag = (np.random.default_rng(32).integers(0, 64, (1, 12, BINS)) / 64).astype(np.float32)
    ref = np.asarray(j_fused(jmodel, params, bn, mag, t_tile=32, dtype="bfloat16"))
    tp, tb = params_from_numpy(params, bn)
    packed = rs.pack_inference_stack(model, tp, tb, "bfloat16")
    monkeypatch.setattr(rs, "stack_forward", emulate_wgmma_kernel)
    got = rs.fused_inference_forward(model, tp, tb, torch.as_tensor(mag), packed=packed, dtype="bfloat16")
    assert_live(torch.as_tensor(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def _over_budget_model():
    """Seven 32-channel encoder layers whose outputs (and layer 1's) all
    stay live for a decoder's skips: 256 float32 rows, past two blocks an
    SM."""
    enc = [ConvSpec("e0", 32, (8, 5))] + [ConvSpec(f"e{i}", 32, (1, 5)) for i in range(1, 8)]
    dec = [ConvSpec(f"d{i}", 32, (1, 5), skip_from=f"e{7 - i}") for i in range(7)]
    return ModelDef("over_budget", tuple(enc + dec + [ConvSpec("last", 1, (1, 129), use_norm=False,
                                                                   use_act=False)]))


def test_routing_by_shape():
    """Every V1/V2/V3 bf16 pack is the wgmma kernel's, within two blocks an
    SM, and holds nothing of the 3xTF32 kernel's; float32 packs hold no
    wgmma pack.  A bf16 pack of a model whose float32 rows do not fit two
    blocks an SM raises, naming the limit; its float32 pack is made."""
    for name in NAMES:
        packed = _packed(name)
        assert packed.wg is not None and packed.weights is None and packed.koffs is None, name
        plan = rs.wgmma_launch_plan(packed, 64 * 501)
        assert packed.wg.smem_bytes <= rs.WG_SMEM_BUDGET and plan.blocks_per_sm >= 2
        assert plan.threads == 288 and plan.warpgroups == 2
        assert plan.grid == plan.blocks_per_sm * rs.SM_COUNT and plan.grid * plan.frames_per_block >= 64 * 501
        assert rs.wgmma_launch_plan(packed, 5).grid == 5
        params, bn = params_from_numpy(*numpy_params(name, 1))
        assert rs.pack_inference_stack(get_model(name), params, bn).wg is None
    model = _over_budget_model()
    params, bn = params_from_numpy(*numpy_params(model, 1, centred_bn=True))
    layers = rs.pack_inference_stack(model, params, bn).layers
    assert rs.wgmma_layout(layers, layers[0].cin) is None
    with pytest.raises(ValueError, match=f"{rs.WG_SMEM_BUDGET} B of shared memory"):
        _packed(model)
    assert _packed("FullyCNNV2").wg.smem_bytes == 106_736


def test_stack_forward_routes_and_never_falls_back(monkeypatch):
    """stack_forward takes `_launch_wgmma` for a bf16 pack and
    `_launch_mma_sync` for a float32 one, off the CPU (on a tensor neither
    on the CPU nor on a card, both launchers replaced by recorders); only
    a CPU tensor reaches the plain version."""
    calls = []
    monkeypatch.setattr(rs, "_launch_wgmma", lambda p, x: calls.append("wgmma"))
    monkeypatch.setattr(rs, "_launch_mma_sync", lambda p, x: calls.append("mma_sync"))
    monkeypatch.setattr(rs, "stack_forward_plain", lambda p, x: calls.append("plain"))
    v2 = _packed("FullyCNNV2")
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", 1))
    v2_f32 = rs.pack_inference_stack(get_model("FullyCNNV2"), params, bn)
    x = torch.empty(1, v2.c_in, 3, BINS, device="meta")
    rs.stack_forward(v2, x)
    rs.stack_forward(v2_f32, x)
    rs.stack_forward(v2, torch.empty(1, v2.c_in, 3, BINS))
    assert calls == ["wgmma", "mma_sync", "plain"]


def test_wgmma_padded_products_and_float32_rows():
    """V2's kernel computes 1.61x the products it needs (two m64 tiles and
    the edge warp's m16 for 129 bins, channels padded to 8 a tap, cout to
    8, an odd block count to even), 1.43x of them by wgmma; its float32 rows hold
    the input and encode_2..encode_7 (114 channels), the output reusing
    them."""
    packed = _packed("FullyCNNV2")
    every, by_wgmma, by_edge = rs.wgmma_padded_product_ratio(packed)
    assert by_wgmma == pytest.approx(1.4346, abs=1e-4) and every == pytest.approx(by_wgmma + by_edge)
    assert by_edge == pytest.approx(every / 9)
    wg = packed.wg
    assert wg.f32_rows == 114 and wg.in_f32 == 0 and wg.groups == 4
    names = [lay.name for lay in packed.layers]
    reads = {lay.skip_from for lay in packed.layers}
    for lay, r in zip(packed.layers, wg.plan.tolist()):
        assert (r[WgField.OUT] >= 0) == (lay.name in reads or lay.name == names[-1])
