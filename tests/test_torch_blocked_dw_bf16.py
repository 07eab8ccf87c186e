"""The bf16 dW kernel on wgmma (`csrc/blocked_dw.cu` dw_wgmma_kernel), on
the CPU: its launch plan, the routing of bf16 shapes between it and the
3xTF32 kernel on float32 copies, and the kernel emulated in torch.  The emulation
keeps a block's ring of stages as the kernel's shared memory, NaN where
nothing was written: TMA's boxes land there under the 128-byte (64-byte)
swizzle with zeros out of bounds, the z tails are zeroed once, and each
wgmma reads its operands through the kernel's descriptors (tap d's B
d 8-row groups on from tap 0's).  Products accumulate a k16 step at a
time into float32, each warpgroup flushes its own stages on the kernel's
schedule into its own slot, and the slots are added in order.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.ops.pallas_dw import blocked_dw_pallas, blocked_dw_reference

from fullycnnspeechenhancement_torch.ops import blocked_dw
from test_torch_blocked_dw import V2_DW_SHAPES
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401

BF16 = torch.bfloat16
ROWS = blocked_dw.STAGE_ROWS_WGMMA
CO_TILE = blocked_dw.TILE_CO_WGMMA
CONSUMERS = blocked_dw.WGMMA_CONSUMERS


def swizzle(addr: torch.Tensor, row_bytes: int) -> torch.Tensor:
    """The 128-byte (or, for 64-byte rows, 64-byte) swizzle TMA writes
    and wgmma reads under: the 16-byte chunk bits of a shared-memory byte
    address XOR the bits above the row (Swizzle<3,4,3>, <2,4,3>)."""
    chunks = {128: 7, 64: 3}[row_bytes]
    return addr ^ (((addr >> 7) & chunks) << 4)


def tma_box(mem, dst, x, c0, r0, n0, box_c, nbp):
    """A TMA box of the 3-D map (channels, rows, block positions) of x [R,
    NB, C] at (c0, r0, n0), (box_c, 8, nbp) elements, into `mem` (bf16
    slots of the ring) at byte `dst`: element (c, r, n) at [n][r][c] in
    rows of 2 box_c bytes, swizzled; zeros where it lies out of bounds."""
    R, NB, C = x.shape
    n, r, c = torch.arange(nbp), torch.arange(ROWS), torch.arange(box_c)
    nn, rr, cc = n0 + n, r0 + r, c0 + c
    vals = x[rr.clamp(max=R - 1)][:, nn.clamp(0, NB - 1)][:, :, cc.clamp(max=C - 1)].permute(1, 0, 2)
    inside = ((nn >= 0) & (nn < NB))[:, None, None] & (rr < R)[None, :, None] & (cc < C)[None, None, :]
    lin = ((n[:, None, None] * ROWS + r[None, :, None]) * box_c + c[None, None, :]) * 2
    mem[swizzle(dst + lin, 2 * box_c) // 2] = torch.where(inside, vals, torch.zeros((), dtype=vals.dtype))


def wgmma_operand(mem, start, width, row_bytes):
    """An MN-major wgmma operand [16 K, width M or N] read through a
    descriptor at byte `start` (on its swizzle pattern's boundary): K-row k
    at (k / 8) * SBO + (k % 8) * row_bytes, element m at 2 m within its
    atom, SBO = LBO = one 8-row group (the kernel's wg_desc)."""
    group = 8 * row_bytes
    k, m = torch.arange(16)[:, None], torch.arange(width)[None, :]
    atom = row_bytes // 2
    lin = (k // 8) * group + (k % 8) * row_bytes + (m // atom) * group + (m % atom) * 2
    assert start % group == 0
    return mem[swizzle(start + lin, row_bytes) // 2]


def stage_layout(plan, kb):
    """Byte offsets of one stage (csrc dw_wgmma_kernel): dy, z, z's tail,
    and the stage's size."""
    dy_bytes = ROWS * plan.nbp * CO_TILE * 2
    z_box = ROWS * plan.nbp * plan.tile_ci * 2
    tail = ROWS * (kb - 1) * plan.tile_ci * 2
    return dy_bytes, z_box, tail, blocked_dw.wgmma_stage_bytes(plan.nbp, kb)


def new_ring(plan, kb):
    """A block's ring as the kernel starts it: NaN, with each stage's z
    tail zeroed."""
    dy_bytes, z_box, tail, stage = stage_layout(plan, kb)
    mem = torch.full((plan.stages * stage // 2,), float("nan"), dtype=torch.float64)
    for slot in range(plan.stages):
        start = (slot * stage + dy_bytes + z_box) // 2
        mem[start : start + tail // 2] = 0.0
    return mem


def load_stage(mem, plan, kb, dc, z, dy, slot, r0, ci0, co0):
    """The producer's two boxes of one stage into `slot`."""
    dy_bytes, _, _, stage = stage_layout(plan, kb)
    tma_box(mem, slot * stage, dy, co0, r0, 0, CO_TILE, plan.nbp)
    tma_box(mem, slot * stage + dy_bytes, z, ci0, r0, -dc, plan.tile_ci, plan.nbp)


def stage_products(mem, plan, kb, slot):
    """[k16 steps, KB, 64 co, N ci] float64: each k16 step's product
    dy^T z_d, from the operands the kernel's descriptors read."""
    dy_bytes, _, _, stage = stage_layout(plan, kb)
    N = plan.tile_ci
    a0, b0 = slot * stage, slot * stage + dy_bytes
    steps = []
    for kk in range(ROWS * plan.nbp // 16):
        a = wgmma_operand(mem, a0 + 2 * kk * 8 * CO_TILE * 2, CO_TILE, 2 * CO_TILE)
        taps = [wgmma_operand(mem, b0 + (2 * kk + d) * 8 * N * 2, N, 2 * N) for d in range(kb)]
        steps.append(torch.stack([a.T @ b for b in taps]))
    return torch.stack(steps)


def flush_windows(n_stages, wg, nbp, flush_positions=blocked_dw.FLUSH_POSITIONS):
    """Consumer warpgroup wg's windows of own stages [j0, j1) (csrc: the
    second warpgroup's windows offset by half a window; one window, maybe
    empty, for a warpgroup without stages)."""
    F = max(1, flush_positions // (ROWS * nbp))
    offset = wg * (F // 2)
    n_own = (n_stages - wg + 1) // 2 if n_stages > wg else 0
    windows = -(-(n_own + offset) // F) if n_own + offset > F else 1
    return [(max(0, w * F - offset), min(n_own, (w + 1) * F - offset)) for w in range(windows)]


def emulated_dw(z, dy, kb, dc, plan, flush_positions=blocked_dw.FLUSH_POSITIONS):
    """dW [KB, Ci, Co] float32 as the kernel computes it under `plan`, for
    z [R, NB, Ci] and dy [R, NB, Co] (bf16 values, any float type)."""
    z, dy = z.double(), dy.double()
    R, nb, ci = z.shape
    co = dy.shape[2]
    N = plan.tile_ci
    tiles_ci, tiles_co = -(-ci // N), -(-co // CO_TILE)
    assert plan.tiles == tiles_ci * tiles_co and plan.rows_per_split % ROWS == 0
    part = torch.full((CONSUMERS * plan.splits, kb, tiles_ci * N, tiles_co * CO_TILE), float("nan"))
    for split in range(plan.splits):
        r_begin = split * plan.rows_per_split
        n_stages = -(-(min(r_begin + plan.rows_per_split, R) - r_begin) // ROWS)
        for x in range(tiles_ci):
            for y in range(tiles_co):
                ci0, co0 = x * N, y * CO_TILE
                mem = new_ring(plan, kb)
                products = []
                for s in range(n_stages):  # stage s overwrites stage s - stages, consumed before it
                    load_stage(mem, plan, kb, dc, z, dy, s % plan.stages, r_begin + ROWS * s, ci0, co0)
                    products.append(stage_products(mem, plan, kb, s % plan.stages))
                for wg in range(CONSUMERS):
                    out = part[split * CONSUMERS + wg, :, ci0 : ci0 + N, co0 : co0 + CO_TILE]
                    for w, (j0, j1) in enumerate(flush_windows(n_stages, wg, plan.nbp, flush_positions)):
                        acc = torch.zeros(kb, CO_TILE, N, dtype=torch.float32)
                        for j in range(j0, j1):
                            for step in products[wg + CONSUMERS * j]:
                                acc = (acc.double() + step).float()
                        out[...] = acc.transpose(1, 2) if w == 0 else out + acc.transpose(1, 2)
    total = torch.zeros(kb, ci, co, dtype=torch.float32)
    for slot in part[:, :, :ci, :co]:  # dw_reduce_kernel: the slots in order
        total = total + slot
    return total


def bf16_values(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape)).to(BF16)


# -- the plan -------------------------------------------------------------------


@pytest.mark.parametrize("kb", range(1, blocked_dw.MAX_KB + 1))
def test_plan_fits_a_block_and_covers_the_problem(kb):
    """V2's widest layer at fb 8, ragged rows, one stage, and NB 9 (fb 16): the ring fits shared
    memory with at least 3 stages, a stage is whole k16 chunks, the tiles
    cover Ci x Co, splits are whole stages, one wave where tiles allow."""
    for rows, nb, ci, co in ((32768, 17, 200, 184), (111, 17, 72, 88), (8, 3, 8, 8), (32768, 9, 96, 80)):
        plan = blocked_dw.wgmma_plan(rows, nb, ci, co, kb, sm_count=132)
        assert plan.nbp == nb + kb - 1 + (nb + kb - 1) % 2
        assert ROWS * plan.nbp % 16 == 0  # whole k16 chunks
        assert blocked_dw.WGMMA_MIN_STAGES <= plan.stages <= blocked_dw.WGMMA_MAX_STAGES
        assert plan.smem_bytes == blocked_dw.wgmma_smem_bytes(plan.nbp, kb, plan.stages) <= blocked_dw.SMEM_BYTES
        assert blocked_dw.wgmma_smem_bytes(plan.nbp, kb, plan.stages + 1) > blocked_dw.SMEM_BYTES or (
            plan.stages == blocked_dw.WGMMA_MAX_STAGES)
        assert plan.tile_ci == (64 if kb <= 4 else 32) and kb * plan.tile_ci // 2 <= 128  # accumulators
        assert plan.tiles * plan.tile_ci * CO_TILE >= ci * co
        assert plan.tiles == -(-ci // plan.tile_ci) * -(-co // CO_TILE)
        assert plan.rows_per_split % ROWS == 0
        assert (plan.splits - 1) * plan.rows_per_split < rows <= plan.splits * plan.rows_per_split
        assert plan.tiles * plan.splits <= 132


def test_stage_bytes_hold_both_operands_on_the_swizzle_pattern():
    for nb, kb in ((17, 4), (5, 1), (17, 8), (3, 2)):
        nbp = blocked_dw.wgmma_nbp(nb, kb)
        N = blocked_dw.tile_ci_wgmma(kb)
        stage = blocked_dw.wgmma_stage_bytes(nbp, kb)
        assert stage % 1024 == 0 and (ROWS * nbp * CO_TILE * 2) % 1024 == 0
        assert stage >= ROWS * nbp * CO_TILE * 2 + ROWS * (nbp + kb - 1) * N * 2


# -- the routing ------------------------------------------------------------------


def test_takes_wgmma_by_shape_alone():
    """Ci and Co multiples of 8, 16-byte aligned, nbp within a TMA box and
    a ring that fits: every V2 layer at fb 8; not odd or unaligned
    channels, unaligned pointers, float32, or NB too wide."""
    def pair(ci, co, nb=17, offset=0, dtype=BF16):
        zbuf = torch.zeros(3 * nb * ci + offset, dtype=dtype)
        return zbuf[offset:].view(1, 3, nb, ci), torch.zeros(1, 3, nb, co, dtype=dtype)

    for ci, co in V2_DW_SHAPES:
        assert blocked_dw.takes_wgmma(*pair(ci, co), 4)
    assert blocked_dw.takes_wgmma(*pair(8, 16, nb=3), 1)
    assert not blocked_dw.takes_wgmma(*pair(20, 14), 4)  # channels not multiples of 8
    assert not blocked_dw.takes_wgmma(*pair(21, 13), 4)
    assert not blocked_dw.takes_wgmma(*pair(80, 96, offset=1), 4)  # 2-byte aligned
    assert not blocked_dw.takes_wgmma(*pair(80, 96, offset=4), 4)  # 8-byte aligned
    assert blocked_dw.takes_wgmma(*pair(80, 96, offset=8), 4)  # 16-byte aligned
    assert not blocked_dw.takes_wgmma(*pair(80, 96, dtype=torch.float32), 4)
    assert not blocked_dw.takes_wgmma(*pair(8, 8, nb=256), 2)  # nbp 258 > a box
    assert not blocked_dw.takes_wgmma(*pair(8, 80, nb=129), 8)  # a 3-stage ring does not fit


@pytest.mark.parametrize("wgmma", [True, False], ids=["wgmma", "mma_sync"])
def test_blocked_dw_routes_by_shape_before_launching_and_never_falls_back(monkeypatch, wgmma):
    """The wrapper picks the kernel from the shape before the launch: a bf16
    pair the wgmma kernel does not take goes to the 3xTF32 kernel as
    float32 copies; a launch that fails raises, and the other kernel is
    not tried."""
    calls = []

    def launcher(name):
        def launch(z, dy, *args):
            calls.append((name, z.dtype, dy.dtype))
            raise RuntimeError(f"{name} launch failed")
        return launch

    monkeypatch.setattr(blocked_dw, "_checked", lambda z, dy, kb, dc: (3, 17, z.shape[3], dy.shape[3]))
    monkeypatch.setattr(blocked_dw, "_launch_wgmma", launcher("wgmma"))
    monkeypatch.setattr(blocked_dw, "_launch_mma_sync", launcher("mma_sync"))
    ci, co = (80, 96) if wgmma else (20, 14)
    z = torch.empty(1, 3, 17, ci, dtype=BF16, device="meta")
    dy = torch.empty(1, 3, 17, co, dtype=BF16, device="meta")
    with pytest.raises(RuntimeError, match="launch failed"):
        blocked_dw.blocked_dw(z, dy, 4, 2)
    if wgmma:
        assert calls == [("wgmma", BF16, BF16)]
    else:
        assert calls == [("mma_sync", torch.float32, torch.float32)]


def test_cpu_tensors_run_the_plain_version_in_both_functions():
    """`blocked_dw` on CPU tensors runs the plain version, on a bf16 pair
    of either route's shape (Ci, Co multiples of 8 or not), and launches
    nothing; a meta tensor raises."""
    rng = np.random.default_rng(4)
    before = (blocked_dw.launches, blocked_dw.launches_bf16)
    for ci, co in ((24, 16), (20, 14)):
        z, dy = bf16_values(rng, (2, 7, 5, ci)), bf16_values(rng, (2, 7, 5, co))
        assert torch.equal(blocked_dw.blocked_dw(z, dy, 4, 2), blocked_dw.blocked_dw_plain(z, dy, 4, 2))
    assert (blocked_dw.launches, blocked_dw.launches_bf16) == before
    with pytest.raises(ValueError, match="cpu or cuda"):
        blocked_dw.blocked_dw(z.to("meta"), dy.to("meta"), 4, 2)


# -- the staged image and the descriptors -------------------------------------------


@pytest.mark.parametrize("kb,dc", [(4, 2), (1, 0), (8, 5)])
def test_stage_image_is_what_tma_writes(kb, dc):
    """The last stage of a ragged split (rows past R) of a tile whose
    channels run past C: dy at [position][row][co] with zeros at positions
    past NB, rows past R and channels past Co; z shifted by dc with zero
    halos, then its zeroed tail; NaN only where nothing is written, and
    no wgmma read of a stage touches a NaN."""
    rng = np.random.default_rng(kb)
    R, nb, ci, co = 13, 5, 24, 40
    z, dy = bf16_values(rng, (R, nb, ci)).double(), bf16_values(rng, (R, nb, co)).double()
    plan = blocked_dw.wgmma_plan(R, nb, ci, co, kb, sm_count=132)._replace(stages=3)
    mem = new_ring(plan, kb)
    load_stage(mem, plan, kb, dc, z, dy, 1, 8, 0, 0)  # rows 8 .. 15 into slot 1; R = 13
    dy_bytes, z_box, tail, stage = stage_layout(plan, kb)
    nbp, N = plan.nbp, plan.tile_ci

    def unswizzled(start, positions, width):
        n, r, c = torch.arange(positions), torch.arange(ROWS), torch.arange(width)
        lin = ((n[:, None, None] * ROWS + r[None, :, None]) * width + c[None, None, :]) * 2
        return mem[swizzle(start + lin, 2 * width) // 2]

    want_dy = torch.zeros(nbp, ROWS, CO_TILE, dtype=torch.float64)
    want_dy[:nb, : R - 8, :co] = dy[8:].permute(1, 0, 2)
    torch.testing.assert_close(unswizzled(stage, nbp, CO_TILE), want_dy, rtol=0, atol=0)
    want_z = torch.zeros(nbp + kb - 1, ROWS, N, dtype=torch.float64)
    want_z[dc : dc + nb, : R - 8, :ci] = z[8:].permute(1, 0, 2)
    torch.testing.assert_close(unswizzled(stage + dy_bytes, nbp + kb - 1, N), want_z, rtol=0, atol=0)
    # everything else of the slot is unwritten
    written = torch.zeros_like(mem, dtype=torch.bool)
    written[(stage + torch.arange(dy_bytes + z_box + tail) // 2 * 2) // 2] = True
    slot = slice(stage // 2, 2 * stage // 2)
    assert torch.isnan(mem[slot][~written[slot]]).all() and not torch.isnan(mem[slot][written[slot]]).any()
    assert torch.isfinite(stage_products(mem, plan, kb, 1)).all()
    # slots 0 and 2 hold only their zeroed tails
    assert torch.isnan(mem[: stage // 2]).sum() == (stage - tail) // 2


def test_tap_descriptor_is_tap_0s_plus_d_groups():
    """Tap d's B descriptor starts d 8-row groups (d positions) after tap
    0's, which reads z at position n + d - dc against dy at n, row for
    row: the uniform tap shift of the flat K."""
    rng = np.random.default_rng(9)
    kb, dc, R, nb, ci, co = 4, 2, 8, 5, 16, 16
    z, dy = bf16_values(rng, (R, nb, ci)).double(), bf16_values(rng, (R, nb, co)).double()
    plan = blocked_dw.wgmma_plan(R, nb, ci, co, kb, sm_count=132)
    mem = new_ring(plan, kb)
    load_stage(mem, plan, kb, dc, z, dy, 0, 0, 0, 0)
    dy_bytes = stage_layout(plan, kb)[0]
    zpad = torch.zeros(R, plan.nbp + kb, ci, dtype=torch.float64)
    zpad[:, dc : dc + nb] = z
    for kk in range(ROWS * plan.nbp // 16):
        k = 16 * kk + torch.arange(16)
        n, r = k // ROWS, k % ROWS
        for d in range(kb):
            b = wgmma_operand(mem, dy_bytes + (2 * kk + d) * ROWS * plan.tile_ci * 2, plan.tile_ci,
                              2 * plan.tile_ci)
            torch.testing.assert_close(b[:, :ci], zpad[r, n + d], rtol=0, atol=0)


# -- the emulated kernel -------------------------------------------------------------


@pytest.mark.parametrize("kb", range(1, blocked_dw.MAX_KB + 1))
def test_emulated_kernel_matches_plain_in_f64(kb):
    """Every dc, 75 rows (ragged: the last split's last stage runs past R)
    in splits of 2 or 3 stages, tiles whose channels run past Ci and Co,
    and flushes every two stages of a warpgroup's own: the emulation holds
    the plain version in float64 to float32's precision, measured within
    2.0e-7 of max|plain|."""
    rng = np.random.default_rng(20 + kb)
    R, nb, ci, co = 75, 5, 24, 16
    z, dy = bf16_values(rng, (R, nb, ci)), bf16_values(rng, (R, nb, co))
    plan = blocked_dw.wgmma_plan(R, nb, ci, co, kb, sm_count=4)
    flush = 2 * ROWS * plan.nbp
    for dc in range(kb):
        ref = blocked_dw.blocked_dw_plain(z.double()[None], dy.double()[None], kb, dc)[0]
        got = emulated_dw(z, dy, kb, dc, plan, flush)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.double(), ref, rtol=0, atol=2e-6 * ref.abs().max().item())


def test_emulated_kernel_covers_several_tiles_and_splits():
    """Ci = 72 and Co = 88 (two tiles each, the second mostly past C), 45
    rows at NB = 17 in splits of one and two stages, the kernel's own flush
    period."""
    rng = np.random.default_rng(31)
    R, nb, ci, co, kb, dc = 45, 17, 72, 88, 4, 2
    z, dy = bf16_values(rng, (R, nb, ci)), bf16_values(rng, (R, nb, co))
    plan = blocked_dw.wgmma_plan(R, nb, ci, co, kb, sm_count=16)
    assert plan.tiles == 4 and plan.splits > 1
    ref = blocked_dw.blocked_dw_plain(z.double()[None], dy.double()[None], kb, dc)[0]
    got = emulated_dw(z, dy, kb, dc, plan)
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=2e-6 * ref.abs().max().item())


@pytest.mark.parametrize("rows_shape", [(4, 8), (8, 33)], ids=["rows32", "rows264"])
def test_emulated_kernel_matches_jax_on_bf16(rows_shape):
    """bf16 z and dy (tests/test_torch_bf16.py's shapes): the emulation
    against JAX's einsum reference and its Pallas kernel in interpret mode,
    all float32 sums of exact products in another order: rtol 1e-5, atol
    1e-6 * max|ref|."""
    B, T = rows_shape
    NB, CI, CO, kb, dc = 17, 16, 24, 4, 2
    rng = np.random.default_rng(2)
    z = jnp.asarray(rng.standard_normal((B, T, NB, CI)), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((B, T, NB, CO)), jnp.bfloat16)
    want = np.asarray(blocked_dw_reference(z, dy, kb, dc))[0]
    interp = np.asarray(blocked_dw_pallas(z, dy, kb, dc, interpret=True)).reshape(want.shape)
    tz = torch.as_tensor(np.asarray(z, np.float32)).reshape(B * T, NB, CI)
    tdy = torch.as_tensor(np.asarray(dy, np.float32)).reshape(B * T, NB, CO)
    plan = blocked_dw.wgmma_plan(B * T, NB, CI, CO, kb, sm_count=2)
    got = emulated_dw(tz, tdy, kb, dc, plan, flush_positions=2 * ROWS * plan.nbp).numpy()
    for ref in (want, interp):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


# -- the flush schedule ---------------------------------------------------------------


@pytest.mark.parametrize("n_stages", [0, 1, 2, 7, 50, 51, 200])
@pytest.mark.parametrize("flush_stages", [1, 2, 5, 25])
def test_flush_windows_cover_each_stage_once(n_stages, flush_stages):
    """Each warpgroup's windows cover its own stages once, in order, none
    longer than the flush period; the second warpgroup's first window is
    half a period shorter, so the two do not flush together; a warpgroup
    without stages still flushes (its zeros) once."""
    nbp = 20
    for wg in range(CONSUMERS):
        windows = flush_windows(n_stages, wg, nbp, flush_stages * ROWS * nbp)
        n_own = len(range(wg, n_stages, CONSUMERS))
        assert [j for j0, j1 in windows for j in range(j0, j1)] == list(range(n_own))
        assert all(0 <= j1 - j0 <= flush_stages for j0, j1 in windows)
        assert len(windows) >= 1 and (n_own == 0) == (windows == [(0, 0)])
        if wg == 1 and n_own > flush_stages:
            assert windows[0][1] == flush_stages - flush_stages // 2
    assert blocked_dw.FLUSH_POSITIONS // (ROWS * nbp) == 25  # V2's windows: 25 stages


def test_flush_period_bounds_the_error_of_truncated_sums():
    """Why the kernel flushes: sums kept in float32 and cut toward zero at
    each k16 step (as the tensor cores accumulate) drift from the exact
    sum as the window grows.  Over 10,000 k16 steps of like-signed terms,
    flushing every 256 steps (the kernel's 4096 K positions) stays within
    0.028 of DW_TOL (rtol 1e-4, atol 1e-4 * max), and one window over all
    of them reaches 1.01 of it."""
    rng = np.random.default_rng(7)
    steps = torch.as_tensor(np.abs(rng.standard_normal((10_000, 32)))).double() * 64

    def truncate(x):  # toward zero, to float32
        f = x.float()
        return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)

    def summed(period):
        total, acc = torch.zeros(32, dtype=torch.float32), torch.zeros(32, dtype=torch.float32)
        for i, step in enumerate(steps):
            acc = truncate(acc.double() + step)
            if (i + 1) % period == 0:
                total, acc = total + acc, torch.zeros_like(acc)
        return (total + acc).double()

    exact = steps.sum(0)
    tol = 1e-4 * exact.abs() + 1e-4 * exact.abs().max()
    period = blocked_dw.FLUSH_POSITIONS // 16  # k16 steps
    assert ((summed(period) - exact).abs() / tol).max() < 0.1
    assert ((summed(len(steps)) - exact).abs() / tol).max() > 0.5
