"""Frequency-only (1, K) convolution: one layer, and a chain of layers.

Counterpart of the Pallas TPU kernels in the repo-root probes
`benchmarks/micro_pallas_{conv,roll,roll2,min,min2}.py`, replaced by two
CUDA kernels written by hand for Hopper (`csrc/freq_conv.cu`; the source
says what bounds them and how their design answers).  The probes that
launch them are `fullycnnspeechenhancement_torch/probes/`.

`freq_conv(x, w)` is one layer on x viewed as [B, R, P, C] and w as
[K, C, D]:

    y[b, r, p, d] = sum_j sum_c w[j, c, d] * x[b, r, p + j * dilation - lo, c]

with a zero boundary (TF SAME for the default lo = (K - 1) // 2) or a
circular one over P, then, in this order, the position mask
(p % period < valid), ReLU and `scale`.  Both operands may be any strided
view (a stride of 0 repeats a tap), so NHWC, channels-before-frequency,
NCHW and the flat [C, N] roll layout need no copy; y comes back in x's
dimension order.

`freq_conv_stack(x, w, depth)` runs `depth` such layers with the same
[K, C, C] weights on the flat roll layout x [C, N] (frames of `frame`
lanes, the first `valid` of them live): circular over N, with the mask,
ReLU and `scale` after each layer.

Both kernels are 3xTF32 tensor-core GEMMs.  `freq_conv_plan` says how
`freq_conv` is launched (tile, items, grid, staging layout, shared
memory), and `tap_offsets` gives the offset table through which it reads
its A operand.  `stack_plan` says how the chain is launched: a cluster of
blocks a frame, each with its share of the output channels, exchanging
each layer's rows through distributed shared memory.  The wrappers cache
the plans per geometry, so a call does its checks, one `torch.empty` and
the launch.

Each wrapper runs its plain torch version on a CPU tensor and launches its
kernel (building it on first use) on a CUDA tensor, or raises; it never
falls back.  `launches` and `stack_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.ops import build

MAX_K = 13  # taps the kernels take
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
SM_SMEM_BYTES = 233_472  # shared memory of one SM; each block also takes 1 KiB
# freq_conv's kernel (csrc/freq_conv.cu): a warp per m16 tile of positions
# (or PAIR of them, sharing each B fragment, on tiles of PAIR_MTILES or
# more and fewer than MAX_NT n8 tiles) and K split, at most MAX_WARPS m16
# tiles a block; n8 tiles of output channels, up to MAX_NT a pass; K = C *
# taps in k8 chunks, all of whose split weights a block keeps in shared
# memory.
M_TILE = 16
N_TILE = 8
K_CHUNK = 8
MAX_WARPS = 9
MAX_NT = 4
PAIR = 2
PAIR_MTILES = 5
SPLIT_CHUNKS = 2  # k8 chunks a K split keeps at least
# Blocks are persistent where the items outnumber the blocks the card holds
# PERSISTENT_RATIO times.
PERSISTENT_RATIO = 8
N_SMS = 132  # an H100 SXM's SMs, for plans made without a card
# freq_conv_stack's kernel: a cluster of STACK_CLUSTER blocks a frame (each
# its share of the output channels' n8 tiles, where C has more than one;
# doubled up to MAX_STACK_CLUSTER where a block's share does not fit),
# STACK_MB m16 tiles a warp (only with at most 2 n8 tiles a pass), which
# share each B fragment load, and STACK_KSPLIT K splits, at most
# STACK_MAX_WARPS warps a block.
STACK_CLUSTER = 2
MAX_STACK_CLUSTER = 8  # the largest cluster the card takes without opting in
STACK_MB = 2
STACK_KSPLIT = 3
STACK_MAX_WARPS = 18
TF32_HALF_ULP = 0x1000
TF32_MASK = -8192  # 0xffffe000 as int32: clears the 13 low mantissa bits
# The flat roll layout of the probes: 129 live bins in frames of 256 lanes.
FRAME = 256
VALID = 129

# Kernel launches since the counts were last set to 0.
launches = 0  # freq_conv
stack_launches = 0  # freq_conv_stack

_lib: Optional[ctypes.CDLL] = None


def _lo(k: int, lo: Optional[int]) -> int:
    return (k - 1) // 2 if lo is None else lo


def freq_conv_plain(
    x: torch.Tensor, w: torch.Tensor, *, lo: Optional[int] = None, dilation: int = 1,
    circular: bool = False, period: int = 0, valid: int = 0, relu: bool = False,
    scale: float = 1.0,
) -> torch.Tensor:
    """Plain torch version of `freq_conv`: K shifted copies of x (zero-padded
    or rolled along P) contracted with w, in x's type."""
    K = w.shape[0]
    P = x.shape[2]
    lo = _lo(K, lo)
    y = None
    for j in range(K):
        s = j * dilation - lo  # tap j reads position p + s
        if circular:
            xs = torch.roll(x, -s, dims=2)
        else:
            xs = F.pad(x, (0, 0, max(0, -s), max(0, s)))[:, :, max(0, s) : max(0, s) + P]
        t = torch.einsum("brpc,cd->brpd", xs, w[j])
        y = t if y is None else y + t
    if period:
        live = torch.arange(P, device=x.device) % period < valid
        y = torch.where(live[:, None], y, torch.zeros((), dtype=y.dtype, device=y.device))
    if relu:
        y = torch.relu(y)
    return y * scale if scale != 1.0 else y


def freq_conv_stack_plain(
    x: torch.Tensor, w: torch.Tensor, depth: int, *, frame: int = FRAME, valid: int = VALID,
    scale: float = 1.0,
) -> torch.Tensor:
    """Plain torch version of `freq_conv_stack`: `depth` calls of
    `freq_conv_plain` on the [C, N] layout viewed as [1, 1, N, C]."""
    h = x
    for _ in range(depth):
        h = freq_conv_plain(
            h.t()[None, None], w, circular=True, period=frame, valid=valid,
            relu=True, scale=scale,
        )[0, 0].t()
    return h


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 `x` as freq_conv's kernel splits an operand:
    big is x rounded to TF32 (half an ulp added, the 13 low mantissa bits
    cleared), small the same of x - big (exact), so x = big + small +
    O(2^-22 |x|) with errors that lean neither way."""
    big = ((x.view(torch.int32) + TF32_HALF_ULP) & TF32_MASK).view(torch.float32)
    small = (((x - big).view(torch.int32) + TF32_HALF_ULP) & TF32_MASK).view(torch.float32)
    return big, small


def _stride_at_least(n: int, residues) -> int:
    """The least s >= n with s % 32 in `residues`."""
    s = max(n, 1)
    while s % 32 not in residues:
        s += 1
    return s


def tap_offsets(C: int, K: int, dilation: int, channel_major: bool, row_stride: int) -> np.ndarray:
    """The kernel's A offsets, [chunks * 8] int32: k = j * C + c (tap-outer,
    channel-inner) reads tap j of channel c, so A[m, k] = buf[offset[k] +
    m * ps] with offset[k] = c * cs + j * dilation * ps, where (ps, cs) =
    (1, row_stride) for channel-major staging and (row_stride, 1) for
    position-major; the padded k past C * K repeat the last offset (their
    weights are zero)."""
    ps, cs = (1, row_stride) if channel_major else (row_stride, 1)
    k = np.minimum(np.arange(-(-C * K // K_CHUNK) * K_CHUNK), C * K - 1)
    j, c = np.divmod(k, C)
    return (c * cs + j * dilation * ps).astype(np.int32)


class ConvPlan(NamedTuple):
    """How `freq_conv` launches its kernel on one geometry.

    Items are (row, tile of `tile` positions), `items_per_row` to a row; a
    block of `mwarps` x `ksplit` warps (one per `mb` m16 tiles and share of
    the k8 chunks) takes items blockIdx, blockIdx + grid, ...; with
    `buffers` = 2 (persistent blocks) it stages the next item's input
    while it computes this one.  The input is staged channel-major (rows
    of `span` positions, `row_stride` floats apart) or position-major (rows
    of C channels), following x's smaller stride; the weights as split B
    fragments, `nt` n8 tiles a pass in `groups` passes.  `computed_tiles`
    m16 tiles are multiplied (a warp's whole group of `mb`, if any of them
    holds a live position); `skipped_tiles` are not, and are written as
    zeros."""

    tile: int
    mtiles: int
    mb: int
    ksplit: int
    items_per_row: int
    items: int
    grid: int
    buffers: int
    blocks_per_sm: int
    channel_major: bool
    row_stride: int
    span: int
    chunks: int
    nt: int
    groups: int
    buf_floats: int
    smem_bytes: int
    computed_tiles: int
    skipped_tiles: int

    @property
    def mwarps(self) -> int:
        return -(-self.mtiles // self.mb)

    @property
    def threads(self) -> int:
        return 32 * self.mwarps * self.ksplit

    @property
    def padded_macs(self) -> int:
        """Multiply-adds the kernel's m16n8k8 tiles compute (each in three
        TF32 products)."""
        return self.computed_tiles * M_TILE * self.chunks * K_CHUNK * self.groups * self.nt * N_TILE


def model_blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Resident blocks per SM as shared memory and the SM's 2048 threads
    allow, without asking the card (registers not modelled)."""
    return max(0, min(SM_SMEM_BYTES // (smem_bytes + 1024), 2048 // threads, 32))


def freq_conv_plan(
    B: int, R: int, P: int, C: int, D: int, K: int, *, dilation: int = 1,
    position_stride: int = 1, channel_stride: int = 0, period: int = 0, valid: int = 0,
    n_sms: int = N_SMS, blocks_per_sm=None,
) -> ConvPlan:
    """The launch of `freq_conv` on x [B, R, P, C] (its P and C strides
    given) and w [K, C, D].

    - Tiles: the longest tile of at most MAX_WARPS m16 tiles that still
      gives `n_sms` items (one block per SM on the card), then shortened
      to spread a row's m16 tiles evenly over its items.  [1, 64, 129, 25]
      gets 3 tiles of 48 positions a row (192 blocks); the roll layout
      147 tiles of 112; V2's 64 x 499 rows one tile of 144.
    - Warps: one per m16 tile, times a K split over the k8 chunks that
      fills the block up to MAX_WARPS warps, SPLIT_CHUNKS chunks or more a
      split (the probes' short tiles: 3 x 3 warps at K = 11, 3 x 2 at
      K = 1), so staging and products do not wait on a few warps; or,
      unmasked and unsplit on tiles of PAIR_MTILES or more with at most 24
      output channels, one per PAIR of tiles (V2: 5 warps for 9 tiles, the
      last one's second tile computed and not written), which halves the
      B loads a product needs.  At 32 channels the pair needs 147
      registers and ran slower on the H100 (encode_8).
    - Blocks: one item each, unless the items outnumber PERSISTENT_RATIO
      times the blocks the card holds at two input buffers (V2's rows);
      then that many persistent blocks, each staging its weights once.
    - `blocks_per_sm(nt, mb, threads, smem_bytes)` gives the card's occupancy
      (the wrapper asks the CUDA occupancy calculator once per geometry);
      without it the plan models it from shared memory and threads.

    Raises ValueError where the kernel cannot run the geometry."""
    chunks = -(-C * K // K_CHUNK)
    n_tiles = -(-D // N_TILE)
    nt = min(MAX_NT, n_tiles)
    groups = -(-n_tiles // nt)
    slots = groups * chunks * nt * 32  # float4 B fragments, big and small
    rows = B * R
    m_row = -(-P // M_TILE)
    mtiles = 1
    for m in range(MAX_WARPS, 0, -1):
        if rows * -(-m_row // m) >= n_sms:
            mtiles = m
            break
    items_per_row = -(-m_row // mtiles)
    mtiles = -(-m_row // items_per_row)
    tile = M_TILE * mtiles
    items = rows * items_per_row

    channel_major = C == 1 or (P > 1 and abs(position_stride) <= abs(channel_stride))
    span = tile + (K - 1) * dilation
    if channel_major:
        row_stride = _stride_at_least(span, (8, 24))
        buf_floats = C * row_stride
    else:
        row_stride = _stride_at_least(C, (4, 12, 20, 28))
        buf_floats = span * row_stride
    mb = PAIR if mtiles >= PAIR_MTILES and nt < MAX_NT and not period else 1
    ksplit = 1 if groups > 1 or mb > 1 else max(1, min(MAX_WARPS // mtiles, chunks // SPLIT_CHUNKS))
    mwarps = -(-mtiles // mb)
    threads = 32 * mwarps * ksplit

    def smem(buffers):  # fragments, offsets, input buffers, split sums
        red = (ksplit - 1) * mwarps * nt * 4 * 32
        return 4 * (4 * slots + chunks * K_CHUNK + buffers * buf_floats + red)

    if smem(1) > SMEM_BYTES:
        raise ValueError(
            f"freq_conv: C={C}, D={D}, K={K}, dilation={dilation} need {smem(1)} B of shared memory"
        )
    occupancy = blocks_per_sm or (lambda nt_, mb_, threads_, smem_bytes: model_blocks_per_sm(threads_, smem_bytes))
    buffers, grid = 1, items
    if smem(2) <= SMEM_BYTES:
        slots_on_card = n_sms * occupancy(nt, mb, threads, smem(2))
        if items > PERSISTENT_RATIO * slots_on_card:
            buffers, grid = 2, max(1, min(items, slots_on_card))
    # per item, warp wm multiplies its mb tiles wm + i * mwarps (indices
    # past the item's on wm's rows) if any of them holds a live position
    p = np.arange(items_per_row * mtiles * M_TILE).reshape(items_per_row, mtiles, M_TILE)
    live = (p < P) & ((p % period < valid) if period else True)
    tile_live = live.any(axis=2)  # [items of a row, mtiles]
    real = np.arange(mtiles)[None, :] < m_row - np.arange(items_per_row)[:, None] * mtiles
    pad = np.zeros((items_per_row, mwarps * mb - mtiles), bool)
    warp_live = np.concatenate([tile_live, pad], 1).reshape(items_per_row, mb, mwarps).any(1)
    computed = int(warp_live.sum()) * mb
    skipped = int(real.sum()) - int((np.concatenate([real, pad], 1).reshape(items_per_row, mb, mwarps)
                                     & warp_live[:, None, :]).sum())
    return ConvPlan(
        tile=tile, mtiles=mtiles, mb=mb, ksplit=ksplit, items_per_row=items_per_row, items=items,
        grid=grid, buffers=buffers, blocks_per_sm=occupancy(nt, mb, threads, smem(buffers)),
        channel_major=channel_major, row_stride=row_stride, span=span, chunks=chunks, nt=nt,
        groups=groups, buf_floats=buf_floats, smem_bytes=smem(buffers),
        computed_tiles=rows * computed, skipped_tiles=rows * skipped,
    )


class StackPlan(NamedTuple):
    """How `freq_conv_stack` launches its kernel on one geometry.

    Each of the `frames` frames is run by a cluster of `cluster` blocks
    (`grid` blocks in all); block rank r computes the output channels of
    n8 tiles [r * tiles, (r + 1) * tiles), `nt` a pass in `groups` passes,
    and writes them into its own buffers and its peer's.  A frame's
    `mtiles` m16 tiles of positions are `units` units of `mb` tiles (u,
    u + units, ...), and warp (wm, ks) of the block's `mwarps` x `ksplit`
    computes units wm, wm + mwarps, ... (`rounds` of them) over K split
    ks.  A buffer holds C channel-major rows of `row_stride` floats (`span`
    of them read); `smem_bytes` of shared memory a block."""

    cluster: int
    frames: int
    grid: int
    tiles: int
    nt: int
    groups: int
    mtiles: int
    mb: int
    units: int
    mwarps: int
    rounds: int
    ksplit: int
    chunks: int
    row_stride: int
    span: int
    buf_floats: int
    smem_bytes: int
    blocks_per_sm: int
    clusters_on_card: Optional[int]

    @property
    def threads(self) -> int:
        return 32 * self.mwarps * self.ksplit

    def padded_macs(self, depth: int) -> int:
        """Multiply-adds the kernel's m16n8k8 tiles compute in a chain of
        `depth` layers (each in three TF32 products)."""
        per_block = self.units * self.mb * M_TILE * self.chunks * K_CHUNK * self.groups * self.nt * N_TILE
        return depth * self.grid * per_block


def stack_plan(
    C: int, N: int, K: int, *, frame: int = FRAME, valid: int = VALID, occupancy=None,
) -> StackPlan:
    """The launch of `freq_conv_stack` on x [C, N] and w [K, C, C], from the
    module constants (STACK_CLUSTER, STACK_MB, STACK_KSPLIT).

    - Clusters: one frame a cluster of STACK_CLUSTER blocks, each with an
      equal share of C's n8 tiles (fewer blocks where C has fewer tiles:
      one block at C <= 8).  At roll2's shape (C = 32, 64 frames) that is
      128 blocks of 2 n8 tiles.  Where a block's share of the split weights
      and its two buffers outgrow its shared memory (C > 50 at K = 11), the
      cluster doubles, up to MAX_STACK_CLUSTER, so the chain takes every C
      that the float32 SIMT design took.
    - Warps: one per unit of STACK_MB m16 tiles, times STACK_KSPLIT K
      splits of SPLIT_CHUNKS chunks or more, at most STACK_MAX_WARPS; past
      that, warps take several units.  129 live bins are 9 m16 tiles: 5
      pairs (the tenth tile computed and not written) times 3 K splits, 15
      warps, ran 5% faster on the H100 than 9 single tiles times 2 splits
      (chip_smoke.py phase 14), though they compute 11% more products.
    - `occupancy(nt, mb, threads, smem_bytes, cluster)` gives the card's
      (blocks per SM, clusters it holds at once); without it the plan models
      blocks per SM from shared memory and threads.

    Raises ValueError where the kernel cannot run the geometry."""
    chunks = -(-C * K // K_CHUNK)
    n_tiles = -(-C // N_TILE)
    mtiles = -(-valid // M_TILE)
    span = M_TILE * mtiles + K - 1
    row_stride = _stride_at_least(span, (8, 24))
    buf_floats = C * row_stride
    want = max(1, STACK_CLUSTER)
    while True:
        tiles = -(-n_tiles // want)
        cluster = -(-n_tiles // tiles)  # every block has a tile
        groups = -(-tiles // MAX_NT)
        nt = -(-tiles // groups)
        mb = max(1, min(STACK_MB, mtiles)) if nt <= 2 else 1
        units = -(-mtiles // mb)
        mwarps = min(units, STACK_MAX_WARPS)
        ksplit = max(1, min(STACK_KSPLIT, STACK_MAX_WARPS // mwarps, chunks // SPLIT_CHUNKS))
        red = (ksplit - 1) * mwarps * mb * nt * 4 * 32
        # split B fragments, offsets, two buffers, split sums, two mbarriers
        smem = 4 * (4 * groups * chunks * nt * 32 + chunks * K_CHUNK + 2 * buf_floats + red) + 16
        if smem <= SMEM_BYTES:
            break
        if tiles == 1 or want >= MAX_STACK_CLUSTER:
            raise ValueError(f"freq_conv_stack: C={C}, K={K}, valid={valid} need {smem} B of shared memory")
        want *= 2
    threads = 32 * mwarps * ksplit
    if occupancy is None:
        blocks_per_sm, clusters = model_blocks_per_sm(threads, smem), None
    else:
        blocks_per_sm, clusters = occupancy(nt, mb, threads, smem, cluster)
    frames = N // frame
    return StackPlan(
        cluster=cluster, frames=frames, grid=cluster * frames, tiles=tiles, nt=nt, groups=groups,
        mtiles=mtiles, mb=mb, units=units, mwarps=mwarps, rounds=-(-units // mwarps), ksplit=ksplit,
        chunks=chunks, row_stride=row_stride, span=span, buf_floats=buf_floats, smem_bytes=smem,
        blocks_per_sm=blocks_per_sm, clusters_on_card=clusters,
    )


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/freq_conv.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("freq_conv")
        lib.freq_conv_forward.restype = ctypes.c_int
        lib.freq_conv_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.freq_conv_blocks_per_sm.restype = ctypes.c_int
        lib.freq_conv_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.freq_conv_stack_forward.restype = ctypes.c_int
        lib.freq_conv_stack_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.freq_conv_stack_occupancy.restype = ctypes.c_int
        lib.freq_conv_stack_occupancy.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.freq_conv_error_string.restype = ctypes.c_char_p
        lib.freq_conv_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check_cuda(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} runs on cpu or cuda tensors, got {x.device} and {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 tensors")


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.freq_conv_error_string(rc).decode()} ({rc})")


@functools.lru_cache(maxsize=None)
def _n_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Launch(NamedTuple):
    plan: ConvPlan
    geom: ctypes.Array  # the kernel's Field array (csrc/freq_conv.cu)
    y_shape: Tuple[int, ...]  # y's allocation, outermost dimension first
    y_perm: Tuple[int, ...]  # ... permuted back to [B, R, P, D]


@functools.lru_cache(maxsize=1024)
def _launch(x_shape, x_stride, w_shape, w_stride, lo, dilation, circular, period, valid, relu,
            device: int) -> _Launch:
    """Checks, plan and kernel arguments of one geometry, made once: y is
    laid out in x's dimension order, and the card's SM count and
    occupancy are asked here, not on every call."""
    B, R, P, C = x_shape
    K, _, D = w_shape
    lo = _lo(K, lo)
    if not 1 <= K <= MAX_K or dilation < 1:
        raise ValueError(f"freq_conv takes 1 <= K <= {MAX_K} taps and dilation >= 1, got {K}, {dilation}")
    if min(B, R, P, C, D) < 1:
        raise ValueError(f"freq_conv got an empty tensor {x_shape}, {w_shape}")
    if period < 0 or (period and not 0 <= valid <= period):
        raise ValueError(f"freq_conv takes period >= 0 and 0 <= valid <= period, got {period}, {valid}")
    lib = load_library()

    def card_blocks_per_sm(nt, mb, threads, smem_bytes):
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.freq_conv_blocks_per_sm(nt, mb, device, threads, smem_bytes, ctypes.byref(n))
        _raise_on(lib, "freq_conv occupancy query", rc)
        return n.value

    plan = freq_conv_plan(
        B, R, P, C, D, K, dilation=dilation, position_stride=x_stride[2], channel_stride=x_stride[3],
        period=period, valid=valid, n_sms=_n_sms(device), blocks_per_sm=card_blocks_per_sm,
    )
    order = sorted(range(4), key=lambda i: x_stride[i], reverse=True)
    y_shape = tuple((B, R, P, D)[i] for i in order)
    y_perm = tuple(order.index(i) for i in range(4))
    y_stride = torch.empty(y_shape, device="meta").permute(y_perm).stride()
    fields = [
        B * R, R, P, C, D, K, *x_stride, *y_stride, *w_stride, lo, dilation, int(circular), period,
        valid, int(relu), plan.tile, plan.items_per_row, plan.items, int(plan.channel_major),
        plan.row_stride, plan.span, plan.chunks, plan.groups, plan.ksplit, plan.buf_floats,
        plan.buffers, plan.grid, plan.threads, plan.smem_bytes,
    ]
    return _Launch(plan, (ctypes.c_longlong * len(fields))(*fields), y_shape, y_perm)


class _StackLaunch(NamedTuple):
    plan: StackPlan
    geom: ctypes.Array  # the kernel's StackField array (csrc/freq_conv.cu)


@functools.lru_cache(maxsize=256)
def _stack_launch(C, N, K, frame, valid, w_stride, device: int) -> _StackLaunch:
    """Plan and kernel arguments of one chain geometry, made once; the
    card's occupancy is asked here, not on every call."""
    lib = load_library()

    def card_occupancy(nt, mb, threads, smem_bytes, cluster):
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.freq_conv_stack_occupancy(nt, mb, device, threads, smem_bytes, cluster,
                                               ctypes.byref(blocks), ctypes.byref(clusters))
        _raise_on(lib, "freq_conv_stack occupancy query", rc)
        return blocks.value, clusters.value

    plan = stack_plan(C, N, K, frame=frame, valid=valid, occupancy=card_occupancy)
    fields = [
        C, N, frame, valid, K, (K - 1) // 2, *w_stride, plan.cluster, plan.tiles, plan.groups,
        plan.mtiles, plan.units, plan.mwarps, plan.rounds, plan.ksplit, plan.chunks,
        plan.row_stride, plan.buf_floats, plan.grid, plan.threads, plan.smem_bytes,
    ]
    return _StackLaunch(plan, (ctypes.c_longlong * len(fields))(*fields))


def replan() -> None:
    """Forget the plans cached per geometry: the next call of each plans
    anew from the module's constants (PAIR_MTILES, PERSISTENT_RATIO,
    STACK_CLUSTER, ...)."""
    _launch.cache_clear()
    _stack_launch.cache_clear()


def launch_plan(x: torch.Tensor, w: torch.Tensor, *, lo: Optional[int] = None, dilation: int = 1,
                circular: bool = False, period: int = 0, valid: int = 0,
                relu: bool = False) -> ConvPlan:
    """The plan `freq_conv` launches on x and w with these options: on CUDA
    tensors the one it uses (the card's SM count and occupancy), on CPU
    tensors the one it would use on an H100 (occupancy modelled)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        B, R, P, C = x.shape
        K, _, D = w.shape
        return freq_conv_plan(B, R, P, C, D, K, dilation=dilation, position_stride=x.stride(2),
                              channel_stride=x.stride(3), period=period, valid=valid)
    _check_cuda("freq_conv", x, w)
    return _launch(tuple(x.shape), x.stride(), tuple(w.shape), w.stride(), lo, dilation,
                   bool(circular), period, valid, bool(relu), x.device.index).plan


def freq_conv(
    x: torch.Tensor, w: torch.Tensor, *, lo: Optional[int] = None, dilation: int = 1,
    circular: bool = False, period: int = 0, valid: int = 0, relu: bool = False,
    scale: float = 1.0,
) -> torch.Tensor:
    """One (1, K) frequency-conv layer: x [B, R, P, C], w [K, C, D] (any
    strides) -> [B, R, P, D], laid out in memory in x's dimension order.

    A CPU tensor runs `freq_conv_plain`.  A CUDA tensor launches the CUDA
    kernel or raises; it never falls back to the plain version."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return freq_conv_plain(
            x, w, lo=lo, dilation=dilation, circular=circular, period=period, valid=valid,
            relu=relu, scale=scale,
        )
    _check_cuda("freq_conv", x, w)
    if x.dim() != 4 or w.dim() != 3 or w.shape[1] != x.shape[3]:
        raise ValueError(f"freq_conv wants x [B, R, P, C] and w [K, C, D], got {tuple(x.shape)}, {tuple(w.shape)}")
    launch = _launch(tuple(x.shape), x.stride(), tuple(w.shape), w.stride(), lo, dilation,
                     bool(circular), period, valid, bool(relu), x.device.index)
    y = torch.empty(launch.y_shape, dtype=x.dtype, device=x.device).permute(launch.y_perm)
    global launches
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.freq_conv_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), ctypes.addressof(launch.geom),
            launch.plan.nt, launch.plan.mb, x.device.index, scale,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, "freq_conv", rc)
    launches += 1
    return y


def _check_stack(x: torch.Tensor, w: torch.Tensor, depth: int, frame: int, valid: int) -> None:
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("freq_conv_stack takes a contiguous [C, N] tensor")
    C, N = x.shape
    if w.dim() != 3 or w.shape[1:] != (C, C):
        raise ValueError(f"freq_conv_stack wants w [K, {C}, {C}], got {tuple(w.shape)}")
    K = w.shape[0]
    lo = (K - 1) // 2
    if not 1 <= K <= MAX_K or depth < 1:
        raise ValueError(f"freq_conv_stack takes 1 <= K <= {MAX_K} and depth >= 1, got {K}, {depth}")
    if not (1 <= valid <= frame and N >= frame and N % frame == 0):
        raise ValueError(f"freq_conv_stack wants N a multiple of frame >= valid >= 1, got {N}, {frame}, {valid}")
    if not (lo <= frame - valid and valid + K - 1 - lo <= frame):
        raise ValueError(
            f"freq_conv_stack: taps [-{lo}, {K - 1 - lo}] must fall in the masked lanes of a frame "
            f"({frame} lanes, {valid} live)"
        )


def stack_launch_plan(x: torch.Tensor, w: torch.Tensor, *, frame: int = FRAME,
                      valid: int = VALID) -> StackPlan:
    """The plan `freq_conv_stack` launches on x and w: on CUDA tensors the
    one it uses (the card's occupancy), on CPU tensors the one it would use
    on an H100 (occupancy modelled)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        _check_stack(x, w, 1, frame, valid)
        return stack_plan(x.shape[0], x.shape[1], w.shape[0], frame=frame, valid=valid)
    _check_cuda("freq_conv_stack", x, w)
    _check_stack(x, w, 1, frame, valid)
    return _stack_launch(x.shape[0], x.shape[1], w.shape[0], frame, valid, w.stride(), x.device.index).plan


def freq_conv_stack(
    x: torch.Tensor, w: torch.Tensor, depth: int, *, frame: int = FRAME, valid: int = VALID,
    scale: float = 1.0,
) -> torch.Tensor:
    """`depth` chained layers on the flat roll layout: x [C, N] (contiguous),
    w [K, C, C] (any strides) -> [C, N] contiguous.  Each layer is the TF
    SAME tap window (lo = (K - 1) // 2) circular over N, then masks lanes
    n % frame >= valid to 0, applies ReLU and multiplies by `scale`.

    A CPU tensor runs `freq_conv_stack_plain`.  A CUDA tensor launches the
    CUDA kernel (`stack_plan` says how) or raises; it never falls back to
    the plain version."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return freq_conv_stack_plain(x, w, depth, frame=frame, valid=valid, scale=scale)
    _check_cuda("freq_conv_stack", x, w)
    _check_stack(x, w, depth, frame, valid)
    C, N = x.shape
    launch = _stack_launch(C, N, w.shape[0], frame, valid, w.stride(), x.device.index)
    y = torch.empty_like(x)
    global stack_launches
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.freq_conv_stack_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), ctypes.addressof(launch.geom),
            launch.plan.nt, launch.plan.mb, depth, x.device.index, scale,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, "freq_conv_stack", rc)
    stack_launches += 1
    return y
