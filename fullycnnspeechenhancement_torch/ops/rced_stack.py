"""Fused inference forward of the R-CED inner conv stack.

Counterpart of `fullycnnspeechenhancement_tpu/ops/pallas_rced.py`, whose
Pallas TPU kernel `_stack_kernel` this module replaces with a CUDA kernel
written by hand for Hopper (`csrc/rced_stack.cu`; the source says what
bounds it and how its design answers).

The structure of the model family makes the fusion possible: only the
FIRST conv looks across time; every later layer but the last is a per-frame
(1, kw <= 13) frequency conv.  So:

  * batch norm folds into the weights (`fold_bn_inference`): y =
    gamma*(conv+b-mean)/sqrt(var+eps)+beta == conv_with(w*s) +
    (b-mean)*s + beta with s = gamma/sqrt(var+eps); the skip-add comes
    after BN and before the ReLU, so folding keeps the reference order;
  * layer 1 (the only conv with a time extent) runs on the folded weights
    with its ReLU in `rced_edges.first_forward`, a CUDA kernel of its own
    (`csrc/rced_edges.cu`) that writes the stack's input layout;
  * the inner layers run in one kernel launch that keeps every live tap of
    a frame in shared memory (`stack_forward`); taps that name layer 1
    read the kernel's input.  The kernel runs each layer as a GEMM on the
    tensor cores in 3xTF32: `pack_inference_stack` orders K = (tap, input
    channel), splits the weights into TF32 big and small parts and stores
    them in `mma.sync` fragment order, and gives the kernel each k's
    shared-memory offset (`tap_offsets`);
  * the final (1, 129) projection runs in `rced_edges.proj_forward`, the
    second kernel of that source, which writes the [B, T, 129] result.

`dtype="bfloat16"` is the JAX kernel's bf16 operand mode: each layer's
input is rounded to bf16 where it meets the folded bf16 weights; the
products are exact and summed in float32, and the slabs, biases, skips and
residuals stay float32.  Layer 1 and the last projection stay float32,
as in JAX, through the same edge kernels.  Its kernel is
`rced_stack_wgmma_kernel` (`pack_wgmma`: each layer's chunk of B tiles,
biases and A descriptor table, and the block's shared-memory map), which
takes every model whose shapes `wgmma_layout` takes, as it takes every
V1/V2/V3; `pack_inference_stack` refuses a bf16 pack of any other.

`stack_forward` is the kernels' wrapper: on a CPU tensor it runs
`stack_forward_plain`, the same arithmetic in plain torch; on a CUDA tensor
it launches the kernel of the pack's mode (building it on first use) or
raises.  `launches` (3xTF32) and `launches_bf16_wgmma` count kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.models.blocks import BN_EPSILON
from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
from fullycnnspeechenhancement_torch.ops import build, rced_edges

F_DIM = 129
HALO = 6  # zero bins on each side of a row's 129: covers kw <= 13
# Floats per channel row (csrc kRow): 129 bins, then 7 zeros that are this
# row's right halo and the next row's left halo.  8 mod 32, so the four
# channels of an in-tap k quad fall in four distinct 8-bank groups.
ROW = 136
M_TILES = 9  # m16 tiles over bins 0..143, one to a warp (csrc kMTiles)
M_PAD = 16 * M_TILES
THREADS = 32 * M_TILES
N_TILE = 8  # output channels per n8 tile
K_CHUNK = 8  # K per mma (m16n8k8)
DTYPES = ("float32", "bfloat16")
MAX_KW = 13
MAX_LAYERS = 16
MAX_COUT = 32  # four n8 tiles
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
SM_SMEM_BYTES = 233_472  # shared memory of one SM; each block also takes 1 KiB
SM_COUNT = 132  # an H100 SXM's SMs, for plans modelled without a card
# Floats after the last row: the padded bin 143 reads up to HALO + 6 + 143
# floats past its row's start.
SMEM_SLACK = 2 * HALO + M_PAD - ROW
TF32_MASK = -8192  # 0xffffe000 as int32: clears the 13 low mantissa bits
INPUT = "__input__"

# The bf16 kernel on wgmma (csrc `rced_stack_wgmma_kernel`): two m64
# tiles over bins 0..127, one warpgroup each, and an edge warp for bin 128
# (an m16 tile of mma.sync); a bf16 operand copy (the shadow) of each
# layer's input, [channel group of 8][bin row][8 channels], WG_ROWS rows a
# group (bins 0..128, then 6 zero rows that are the next group's left
# halo), WG_LEAD zero rows before group 0 and WG_SLACK after the last
# (read by the edge warp's padded rows; the first is the row an epilogue
# dumps values that must not land into); float32 rows of WG_F32_ROW
# floats for the values a later epilogue reads.
WG_TILES = 2
WG_M = 64
WG_EDGE_M = 16  # bins 128..143, of which 128 is real, by mma.sync
WG_THREADS = 128 * WG_TILES + 32
WG_LEAD = HALO
WG_ROWS = F_DIM + HALO
WG_SLACK = 16
WG_ROW_BYTES = 16  # one shadow row: 8 bf16 channels
WG_F32_ROW = 132  # 4 mod 32 floats: an epilogue's float32 loads and stores are free of bank conflicts
WG_REC = 12
# Two blocks an SM (each also takes 1 KiB): the most one block may use.
WG_SMEM_BUDGET = SM_SMEM_BYTES // 2 - 1024
WG_BARRIER_BYTES = 16  # two mbarriers, one for each weight buffer
# The A descriptor's leading-byte offset of an instruction's pad block (its
# weights are zero): 0, it reads its first block again.
WG_PAD_LBO = 0

# Kernel launches since the counts were last set to 0: the 3xTF32 kernel
# and the bf16 wgmma one.
launches = 0
launches_bf16_wgmma = 0

_lib: Optional[ctypes.CDLL] = None


def fold_bn_inference(model: ModelDef, params, bn_state):
    """-> list of (spec, w_folded OIHW, b_folded [Cout]) for inference-mode
    BN."""
    folded = []
    for spec in model.layers:
        p = params[spec.name]
        w, b = p["w"], p["b"]
        if spec.use_norm:
            s = bn_state[spec.name]
            scale = p["gamma"] * torch.rsqrt(s["var"] + BN_EPSILON)
            w = w * scale[:, None, None, None]
            b = (b - s["mean"]) * scale + p["beta"]
        folded.append((spec, w, b))
    return folded


@dataclasses.dataclass(frozen=True)
class InnerLayer:
    """One inner layer as the 3xTF32 kernel sees it.  Row offsets count
    channel rows of ROW floats in a block's shared memory; -1 means no tap,
    or, in a bf16 pack, which that kernel never reads, not placed."""

    name: str
    kw: int
    cin: int
    cout: int
    skip_from: Optional[str]
    add_from: Optional[str]
    use_act: bool
    w_off: int = -1  # floats into PackedStack.weights: B fragments, then biases
    k_off: int = -1  # ints into PackedStack.koffs: chunks * 8 A offsets
    in_row: int = -1
    out_row: int = -1
    skip_row: int = -1
    add_row: int = -1

    @property
    def k(self) -> int:
        return self.cin * self.kw

    @property
    def chunks(self) -> int:
        return -(-self.k // K_CHUNK)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // N_TILE)

    @property
    def b_off(self) -> int:
        # a lane's fragment of one tile: 4 float32 words
        return self.w_off + self.chunks * self.n_tiles * 32 * 4


@dataclasses.dataclass(frozen=True, eq=False)
class PackedStack:
    """A model's BN-folded weights, packed once for `fused_inference_forward`:
    for the 3xTF32 kernel (`dtype` "float32": `weights` to `smem_rows`) or
    for the bf16 wgmma kernel ("bfloat16": `wg`)."""

    first: Tuple[ConvSpec, torch.Tensor, torch.Tensor]  # layer 1, OIHW
    last: Tuple[ConvSpec, torch.Tensor, torch.Tensor]  # final projection
    layers: Tuple[InnerLayer, ...]
    folded: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # inner (w [cin, kw, cout], b)
    dtype: str = "float32"  # the operand mode, one of DTYPES
    weights: Optional[torch.Tensor] = None  # the kernel's B fragments and biases, float32 words
    koffs: Optional[torch.Tensor] = None  # the kernel's A offsets, int32
    plan: Optional[np.ndarray] = None  # [n_layers, 10] int32, the kernel's layer table
    in_row: int = -1
    out_row: int = -1
    smem_rows: int = 0
    wg: Optional["WgmmaStack"] = None  # the bf16 wgmma kernel's pack
    # layer 1 and the projection for their kernels (`rced_edges.pack_edges`)
    edges: Optional[rced_edges.EdgePack] = None

    @property
    def c_in(self) -> int:
        return self.layers[0].cin

    @property
    def c_out(self) -> int:
        return self.layers[-1].cout

    @property
    def smem_floats(self) -> int:
        return self.smem_rows * ROW + SMEM_SLACK


def _allocate_rows(layers, c_in, epilogue_reads_only=False):
    """Place each value (the input, each layer's output) at a row offset in
    shared memory for as long as it is live: a value dies after its last
    reader (the next layer, or a later skip/add).  First fit; an output
    never overlaps a value its own layer reads.  With
    `epilogue_reads_only` (the wgmma kernel's float32 rows) only the values
    a later epilogue reads (skip and residual sources, until their last
    reader) and the stack's output are placed.  Returns (rows of each
    placed value, rows used)."""
    last_use = {} if epilogue_reads_only else {INPUT: 0}
    for i, lay in enumerate(layers):
        if not epilogue_reads_only or i == len(layers) - 1:
            last_use[lay.name] = i + 1  # the last one: kept to the copy-out
        for ref in (lay.skip_from, lay.add_from):
            if ref is not None:
                last_use[ref] = max(last_use.get(ref, i), i)
    live = {}  # name -> (start, size)
    where = {}
    used = 0

    def place(name, size, now):
        nonlocal used
        for v in [v for v in live if last_use[v] < now]:
            del live[v]
        start = 0
        for s, z in sorted(live.values()):
            if start + size <= s:
                break
            start = max(start, s + z)
        live[name] = (start, size)
        where[name] = start
        used = max(used, start + size)

    if INPUT in last_use:
        place(INPUT, c_in, -1)
    for i, lay in enumerate(layers):
        if lay.name in last_use:
            place(lay.name, lay.cout, i)
    return where, used


def tap_offsets(cin: int, kw: int) -> np.ndarray:
    """The kernel's A offsets of one layer, [chunks * 8] int32: k =
    j * cin + ci (tap-outer, channel-inner) reads channel ci's row at tap
    j, so A[m, k] = in[offset[k] + m] with offset[k] = ci * ROW + HALO - lo
    + j; the padded k past cin * kw repeat the last offset (their weights
    are zero, and a repeated address is a broadcast, not a bank conflict)."""
    lo = (kw - 1) // 2
    k = np.minimum(np.arange(-(-cin * kw // K_CHUNK) * K_CHUNK), cin * kw - 1)
    j, ci = np.divmod(k, cin)
    return (ci * ROW + HALO - lo + j).astype(np.int32)


def gemm_weights(w: torch.Tensor, chunks: int, n_tiles: int) -> torch.Tensor:
    """w [cin, kw, cout] -> the layer's B [chunks * 8, n_tiles * 8]: row
    j * cin + ci holds w[ci, j], zeros past K and cout."""
    cin, kw, cout = w.shape
    b = torch.zeros(chunks * K_CHUNK, n_tiles * N_TILE, dtype=torch.float32, device=w.device)
    b[: cin * kw, :cout] = w.permute(1, 0, 2).reshape(cin * kw, cout)
    return b


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of float32 `x` as the kernel splits it: big is x with
    its 13 low mantissa bits cleared (a TF32 value), small the same of
    x - big (exact), so x = big + small + O(2^-20 |x|)."""
    big = (x.view(torch.int32) & TF32_MASK).view(torch.float32)
    small = ((x - big).view(torch.int32) & TF32_MASK).view(torch.float32)
    return big, small


def pack_fragments(b: torch.Tensor) -> torch.Tensor:
    """B [chunks * 8, n_tiles * 8] -> its 3xTF32 fragments, flat float32
    [chunks, n_tiles, 32 lanes, 4]: lane 4g + t of tile (c, n) holds big
    B[8c + t, 8n + g], big B[8c + t + 4, 8n + g], then the small parts of
    both, so its fragment is one 16-byte load."""
    kp, np_ = b.shape
    big, small = split_tf32(b.contiguous())
    parts = torch.stack([big, small])  # [s, K, N]
    parts = parts.view(2, kp // K_CHUNK, 2, 4, np_ // N_TILE, N_TILE)  # [s, c, h, t, n, g]
    return parts.permute(1, 4, 5, 3, 0, 2).reshape(-1).contiguous()  # [c, n, g, t, s, h]


def unpack_fragments(frag: torch.Tensor, chunks: int, n_tiles: int):
    """Inverse of `pack_fragments`: -> (big, small), each [chunks * 8,
    n_tiles * 8]."""
    parts = frag.view(chunks, n_tiles, N_TILE, 4, 2, 2).permute(4, 0, 5, 3, 1, 2)
    parts = parts.reshape(2, chunks * K_CHUNK, n_tiles * N_TILE)
    return parts[0], parts[1]


# -- the bf16 kernel on wgmma ---------------------------------------------------


def wg_block_row(j: int, g: int, kw: int) -> int:
    """The shadow row (counted from the lead) where the A of k8 block (tap
    j, channel group g) starts, the row bin 0 reads: bin f of tap j reads
    input bin f + j - lo of group g."""
    return WG_LEAD + g * WG_ROWS + j - (kw - 1) // 2


def wg_instructions(cin: int, kw: int):
    """The layer's k16 instructions: its k8 blocks (tap j, channel group g)
    tap-outer and group-inner, paired in that order, each pair ordered so
    that its second block starts at the later shadow row (a descriptor's
    leading-byte offset is unsigned); an odd count ends in a pad block
    (None) of zero weights.  -> [(first, second)] of (j, g) or None."""
    blocks = [(j, g) for j in range(kw) for g in range(-(-cin // 8))]
    if len(blocks) % 2:
        blocks.append(None)
    pairs = []
    for a, b in zip(blocks[::2], blocks[1::2]):
        if b is not None and wg_block_row(*b, kw) < wg_block_row(*a, kw):
            a, b = b, a
        pairs.append((a, b))
    return pairs


def wg_table(cin: int, kw: int) -> np.ndarray:
    """The A descriptor of each instruction for tile 0, [instructions]
    int32: the first block's start row | (the leading-byte offset in rows,
    the second block's row minus the first's, or WG_PAD_LBO) << 16.  A row
    is 16 bytes, a descriptor's unit, so both are its fields' values; tile
    t adds 64 t rows to the start."""
    out = []
    for a, b in wg_instructions(cin, kw):
        start = wg_block_row(*a, kw)
        lbo = WG_PAD_LBO if b is None else wg_block_row(*b, kw) - start
        out.append(start | lbo << 16)
    return np.asarray(out, dtype=np.int32)


def wg_b_tiles(w: torch.Tensor, n: int) -> torch.Tensor:
    """w [cin, kw, cout] -> the layer's B for wgmma, bf16 [instructions, 2
    halves, n // 8 column groups, 8 columns, 8 k]: K-major without
    swizzle, so one (half, column group) is a core matrix of 8 columns of
    16 bytes; half h of instruction i holds its block h's 8 channels (zeros
    past cin and cout, and for a pad block).  Its descriptor: leading-byte
    offset 16 n (between halves), stride-byte offset 128 (between column
    groups)."""
    cin, kw, cout = w.shape
    groups = -(-cin // 8)
    wp = torch.zeros(kw, groups * 8, n, dtype=torch.float32, device=w.device)
    wp[:, :cin, :cout] = w.permute(1, 0, 2)
    halves = []
    for pair in wg_instructions(cin, kw):
        for blk in pair:
            if blk is None:
                halves.append(torch.zeros(8, n, dtype=torch.float32, device=w.device))
            else:
                j, g = blk
                halves.append(wp[j, 8 * g : 8 * g + 8])  # [k, column]
    tiles = torch.stack(halves).view(-1, 2, 8, n // 8, 8)  # [i, h, k, column group, column]
    return tiles.permute(0, 1, 3, 4, 2).contiguous().to(torch.bfloat16)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(-1)


def pack_wg_chunk(w: torch.Tensor, bias: torch.Tensor, n: int) -> torch.Tensor:
    """One layer's chunk for the wgmma kernel, the bytes one bulk copy
    stages: its B tiles (`wg_b_tiles`), then n float32 biases (zeros past
    cout), then its A table (`wg_table`), zero-padded to 16 bytes."""
    cin, kw, cout = w.shape
    b = torch.zeros(n, dtype=torch.float32, device=w.device)
    b[:cout] = bias
    table = torch.as_tensor(wg_table(cin, kw), device=w.device)
    parts = [_bytes(wg_b_tiles(w, n)), _bytes(b), _bytes(table)]
    pad = -sum(p.numel() for p in parts) % 16
    parts.append(torch.zeros(pad, dtype=torch.uint8, device=w.device))
    return torch.cat(parts)


class WgField:
    """Columns of WgmmaStack.plan (csrc WgField): instructions, n (cout
    padded to 8), cout, the chunk's byte offset in `weights` and its bytes,
    float offsets (in the float32 rows) of the layer's float32 output, its
    skip and its residual source (-1: none), ReLU, cin, and the byte
    offsets of the biases and the A table within the chunk."""

    INSTR, N, COUT, CHUNK, CHUNK_BYTES, OUT, SKIP, ADD, RELU, CIN, BIAS, TABLE = range(WG_REC)


@dataclasses.dataclass(frozen=True, eq=False)
class WgmmaStack:
    """The wgmma kernel's pack of a bf16 stack and its shared-memory map
    (byte offsets from the block's base): two mbarriers, shadow 0 (layer
    l reads shadow l % 2 and writes the other), shadow 1, the float32
    rows (then 4 floats the epilogue dumps discarded values into), weight
    buffer 0 (even layers' chunks) and buffer 1 (odd layers')."""

    weights: torch.Tensor  # uint8, each layer's chunk at a 16-byte offset
    plan: np.ndarray  # [n_layers, WG_REC] int32 (WgField)
    groups: int  # channel groups of 8 a shadow holds
    f32_rows: int
    in_f32: int  # float offset of the input's float32 rows, -1 if none
    out_f32: int  # float offset of the stack's output
    buf_bytes: Tuple[int, int]

    @property
    def shadow_bytes(self) -> int:
        return (WG_LEAD + self.groups * WG_ROWS + WG_SLACK) * WG_ROW_BYTES

    def shadow_offset(self, s: int) -> int:
        return WG_BARRIER_BYTES + s * self.shadow_bytes

    @property
    def f32_offset(self) -> int:
        return WG_BARRIER_BYTES + 2 * self.shadow_bytes

    @property
    def dump(self) -> int:
        """Float offset of the float32 word discarded values are written to."""
        return self.f32_rows * WG_F32_ROW

    @property
    def buf_offsets(self) -> Tuple[int, int]:
        b0 = self.f32_offset + 4 * (self.dump + 4)
        return b0, b0 + self.buf_bytes[0]

    @property
    def smem_bytes(self) -> int:
        return self.buf_offsets[1] + self.buf_bytes[1]

    def layout(self) -> np.ndarray:
        """The kernel's map (csrc WgLayout): groups, shadow bytes, float32
        offset, dump, input and output float offsets, both buffers, total."""
        return np.array([self.groups, self.shadow_bytes, self.f32_offset, self.dump, self.in_f32,
                         self.out_f32, *self.buf_offsets, self.smem_bytes], dtype=np.int32)


def wgmma_layout(layers, c_in):
    """The shape test of the wgmma kernel, in one place: None unless every
    layer has at most 32 input and output channels and the block's shared
    memory fits two blocks an SM (WG_SMEM_BUDGET); else (float32 rows of
    each value that keeps them, float32 rows used, shadow groups, chunk
    bytes of each layer, bytes of the two weight buffers, shared-memory
    bytes)."""
    if any(lay.cin > MAX_COUT or lay.cout > MAX_COUT for lay in layers):
        return None
    rows, used = _allocate_rows(layers, c_in, epilogue_reads_only=True)
    groups = max(-(-lay.cin // 8) for lay in layers)
    chunk = []
    for lay in layers:
        n = lay.n_tiles * N_TILE
        instr = len(wg_instructions(lay.cin, lay.kw))
        chunk.append(instr * 32 * n + 4 * n + -(-4 * instr // 16) * 16)
    # global layer g's chunk lands in buffer g % 2: with an odd layer count
    # a layer's parity changes from frame to frame
    bufs = (max(chunk[0::2]), max(chunk[1::2], default=0)) if len(layers) % 2 == 0 else (max(chunk), max(chunk))
    probe = WgmmaStack(torch.empty(0), np.zeros((0, WG_REC), np.int32), groups, used, -1, 0, bufs)
    if probe.smem_bytes > WG_SMEM_BUDGET:
        return None
    return rows, used, groups, chunk, bufs, probe.smem_bytes


def pack_wgmma(layers, plain, c_in) -> Optional[WgmmaStack]:
    """The wgmma kernel's pack of inner `layers` with BN-folded weights
    `plain` ([(w [cin, kw, cout], b)]), or None where `wgmma_layout` does
    not take the shapes."""
    fit = wgmma_layout(layers, c_in)
    if fit is None:
        return None
    rows, used, groups, sizes, bufs, _ = fit

    def f32_at(name):
        return rows[name] * WG_F32_ROW if name is not None and name in rows else -1

    chunks, plan, off = [], [], 0
    for lay, (w, b), size in zip(layers, plain, sizes):
        n = lay.n_tiles * N_TILE
        chunk = pack_wg_chunk(w, b, n)
        assert chunk.numel() == size
        instr = len(wg_instructions(lay.cin, lay.kw))
        plan.append([instr, n, lay.cout, off, size, f32_at(lay.name), f32_at(lay.skip_from),
                     f32_at(lay.add_from), int(lay.use_act), lay.cin, instr * 32 * n, instr * 32 * n + 4 * n])
        chunks.append(chunk)
        off += size
    return WgmmaStack(
        weights=torch.cat(chunks), plan=np.asarray(plan, dtype=np.int32), groups=groups, f32_rows=used,
        in_f32=f32_at(INPUT), out_f32=f32_at(layers[-1].name), buf_bytes=bufs,
    )


def pack_inference_stack(model: ModelDef, params, bn_state, dtype: str = "float32") -> PackedStack:
    """Fold BN and pack the inner layers for the kernel of `dtype`: the
    3xTF32 kernel's fragments, offsets and plan ("float32"), or the wgmma
    kernel's pack (`pack_wgmma`, "bfloat16").

    Inner layers must be (1, kw <= 13) convs over 129 bins with at most 32
    output channels, at most 16 of them; in float32 their live taps must
    fit one block's shared memory, in bf16 `wgmma_layout` must take them.
    Layer 1 and the projection must be edges the edge kernels take
    (`rced_edges.pack_edges`)."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: the stack kernel takes one of {DTYPES}")
    folded = fold_bn_inference(model, params, bn_state)
    first, last, inner = folded[0], folded[-1], folded[1:-1]
    first_name = first[0].name
    if not 1 <= len(inner) <= MAX_LAYERS:
        raise ValueError(f"{model.name}: {len(inner)} inner layers, kernel takes 1..{MAX_LAYERS}")
    layers, plain, chunks, koffs = [], [], [], []
    w_off = k_off = 0
    c_in = cin = first[0].out_ch
    for spec, w, b in inner:
        kh, kw = spec.kernel
        if kh != 1 or not 1 <= kw <= MAX_KW:
            raise ValueError(f"inner layer {spec.name} has kernel {spec.kernel}; needs (1, <= {MAX_KW})")
        cout = spec.out_ch
        if cout > MAX_COUT:
            raise ValueError(f"inner layer {spec.name} has {cout} channels; the kernel takes <= {MAX_COUT}")

        def remap(ref):
            return INPUT if ref == first_name else ref

        lay = InnerLayer(spec.name, kw, cin, cout, remap(spec.skip_from), remap(spec.add_from), spec.use_act)
        w_cko = w[:, :, 0, :].permute(1, 2, 0).contiguous()  # [cin, kw, cout]
        plain.append((w_cko, b))
        if dtype == "float32":
            lay = dataclasses.replace(lay, w_off=w_off, k_off=k_off)
            bias = torch.zeros(lay.n_tiles * N_TILE, dtype=torch.float32, device=w.device)
            bias[:cout] = b
            chunks += [pack_fragments(gemm_weights(w_cko, lay.chunks, lay.n_tiles)), bias]
            koffs.append(tap_offsets(cin, kw))
            w_off = lay.b_off + bias.numel()
            k_off += koffs[-1].size
        layers.append(lay)
        cin = cout
    edges = rced_edges.pack_edges(first, last)

    if dtype == "bfloat16":
        wg = pack_wgmma(layers, plain, c_in)
        if wg is None:
            raise ValueError(
                f"{model.name}: the bf16 stack kernel takes layers of at most {MAX_COUT} input and output "
                f"channels whose block fits {WG_SMEM_BUDGET} B of shared memory (two blocks an SM)")
        return PackedStack(first=first, last=last, layers=tuple(layers), folded=tuple(plain), dtype=dtype,
                           wg=wg, edges=edges)

    rows, used = _allocate_rows(layers, c_in)
    if (used * ROW + SMEM_SLACK) * 4 > SMEM_BYTES:
        raise ValueError(f"{model.name}: live taps need {used} rows, over one block's shared memory")
    prev = INPUT
    placed = []
    for lay in layers:
        placed.append(
            dataclasses.replace(
                lay,
                in_row=rows[prev],
                out_row=rows[lay.name],
                skip_row=rows[lay.skip_from] if lay.skip_from else -1,
                add_row=rows[lay.add_from] if lay.add_from else -1,
            )
        )
        prev = lay.name

    def off_of(row):
        return row * ROW if row >= 0 else -1

    plan = np.array(
        [
            [
                lay.chunks, lay.n_tiles, lay.cout, off_of(lay.in_row), off_of(lay.out_row),
                off_of(lay.skip_row), off_of(lay.add_row), int(lay.use_act),
                lay.w_off, lay.k_off,
            ]
            for lay in placed
        ],
        dtype=np.int32,
    )
    return PackedStack(
        first=first,
        last=last,
        layers=tuple(placed),
        folded=tuple(plain),
        weights=torch.cat(chunks).contiguous(),
        koffs=torch.as_tensor(np.concatenate(koffs), device=first[1].device),
        plan=plan,
        in_row=rows[INPUT],
        out_row=placed[-1].out_row,
        smem_rows=used,
        edges=edges,
    )


def _as_operand(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """x as a matmul operand of the mode: itself in float32, rounded to
    bf16 (and held in float32) in the bf16 mode."""
    return x if dtype == "float32" else x.to(torch.bfloat16).to(x.dtype)


def stack_forward_plain(packed: PackedStack, x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: [B, c_in, T, 129] -> [B, c_out,
    T, 129].  The same folded weights and per-layer function: for each
    layer, kw shifted copies of the zero-padded rows contracted with the
    weights in float32, then bias, skip, ReLU, residual.  In the bf16 mode
    the weights and each layer's input are rounded to bf16 before the
    contraction (so every product is exact), and everything else stays
    float32, as in the kernel."""
    B, C, T, Fd = x.shape
    h = x.permute(0, 2, 1, 3).reshape(B * T, C, Fd)
    taps = {INPUT: h}
    for lay, (w, bias) in zip(packed.layers, packed.folded):
        w = _as_operand(w, packed.dtype)
        cols = F.pad(_as_operand(h, packed.dtype), ((lay.kw - 1) // 2, lay.kw // 2)).unfold(2, lay.kw, 1)
        y = torch.einsum("ncfk,cko->nof", cols, w)
        y = y + bias[:, None]
        if lay.skip_from is not None:
            y = y + taps[lay.skip_from]
        if lay.use_act:
            y = torch.relu(y)
        if lay.add_from is not None:
            y = y + taps[lay.add_from]
        taps[lay.name] = y
        h = y
    return h.reshape(B, T, packed.c_out, Fd).permute(0, 2, 1, 3).contiguous()


class LaunchPlan(NamedTuple):
    """How `stack_forward` launches the 3xTF32 kernel: one block per frame,
    of `threads` threads and `smem_bytes` of shared memory, `blocks_per_sm`
    of them resident on an SM; its m16n8k8 tiles compute
    `padded_product_ratio` times the products the layers need."""

    threads: int
    smem_bytes: int
    blocks_per_sm: int
    frames_per_block: int
    padded_product_ratio: float


def padded_product_ratio(packed: PackedStack) -> float:
    """Products the 3xTF32 kernel computes (bins padded to M_PAD, K to k8
    chunks, cout to n8 tiles) over the products the layers need (tap j
    meets F_DIM - |j - lo| bins; the rest fall on the zero halo)."""
    done = sum(M_PAD * lay.chunks * K_CHUNK * lay.n_tiles * N_TILE for lay in packed.layers)
    return done / frame_macs(packed)


def model_blocks_per_sm(smem_bytes: int) -> int:
    """Resident blocks per SM as shared memory and the SM's 2048 threads
    allow, without asking the card (registers not modelled;
    `card_blocks_per_sm` asks the CUDA occupancy calculator)."""
    return min(SM_SMEM_BYTES // (smem_bytes + 1024), 2048 // THREADS)


def launch_plan(packed: PackedStack, blocks_per_sm: Optional[int] = None) -> LaunchPlan:
    """The 3xTF32 kernel's launch on a float32 `packed`, at `blocks_per_sm`
    (from `card_blocks_per_sm`) or, when not given, `model_blocks_per_sm`."""
    smem = packed.smem_floats * 4
    per_sm = model_blocks_per_sm(smem) if blocks_per_sm is None else blocks_per_sm
    return LaunchPlan(THREADS, smem, per_sm, 1, padded_product_ratio(packed))


class WgLaunchPlan(NamedTuple):
    """How `stack_forward` launches the wgmma kernel on `frames` frames:
    `grid` persistent blocks (`blocks_per_sm` on each of the card's SMs,
    at most one a frame), each `frames_per_block` frames one after another,
    of `warpgroups` warpgroups (one m64 tile of bins each) and an edge warp
    (bin 128), and `smem_bytes` of shared memory; each layer's weights
    staged by one bulk copy a layer ahead into one of two buffers; its
    tiles compute `padded_product_ratio` times the products the layers
    need."""

    threads: int
    warpgroups: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int
    frames_per_block: int
    weight_buffers_bytes: Tuple[int, int]
    weight_staging: str
    padded_product_ratio: float


def wgmma_padded_product_ratio(packed: PackedStack):
    """Products the wgmma kernel computes (two m64 tiles of bins by wgmma
    and the edge warp's m16 tile by mma.sync, k16 instructions of two k8
    blocks, cout padded to 8) over the products the layers need (as
    `padded_product_ratio` counts them); -> (all, wgmma's, mma.sync's)."""
    k16n = sum(int(r[WgField.INSTR]) * 16 * int(r[WgField.N]) for r in packed.wg.plan)
    need = frame_macs(packed)
    return (WG_TILES * WG_M + WG_EDGE_M) * k16n / need, WG_TILES * WG_M * k16n / need, WG_EDGE_M * k16n / need


def frame_macs(packed: PackedStack) -> int:
    """Multiply-adds a frame of the stack needs: tap j of a layer meets
    F_DIM - |j - lo| bins; the rest fall on the zero halo."""
    need = 0
    for lay in packed.layers:
        lo = (lay.kw - 1) // 2
        need += lay.cin * lay.cout * sum(F_DIM - abs(j - lo) for j in range(lay.kw))
    return need


def wgmma_launch_plan(packed: PackedStack, frames: int, blocks_per_sm: Optional[int] = None,
                      sm_count: int = SM_COUNT) -> WgLaunchPlan:
    """The wgmma kernel's launch on `frames` frames of a bf16 pack, at
    `blocks_per_sm` (from `card_wgmma_blocks_per_sm`) or, when not given,
    as shared memory and the SM's 2048 threads allow (registers not
    modelled), on `sm_count` SMs."""
    smem = packed.wg.smem_bytes
    if blocks_per_sm is None:
        blocks_per_sm = min(SM_SMEM_BYTES // (smem + 1024), 2048 // WG_THREADS)
    grid = max(1, min(frames, blocks_per_sm * sm_count))
    return WgLaunchPlan(WG_THREADS, WG_TILES, smem, blocks_per_sm, grid, -(-frames // grid), packed.wg.buf_bytes,
                        "one bulk copy (TMA) per layer from L2 by the edge warp, a layer ahead, on an mbarrier",
                        wgmma_padded_product_ratio(packed)[0])


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/rced_stack.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("rced_stack")
        lib.rced_stack_forward.restype = ctypes.c_int
        lib.rced_stack_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rced_stack_blocks_per_sm.restype = ctypes.c_int
        lib.rced_stack_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.rced_stack_forward_wgmma.restype = ctypes.c_int
        lib.rced_stack_forward_wgmma.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.rced_stack_wgmma_blocks_per_sm.restype = ctypes.c_int
        lib.rced_stack_wgmma_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.rced_stack_error_string.restype = ctypes.c_char_p
        lib.rced_stack_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"rced_stack {what} failed: {lib.rced_stack_error_string(rc).decode()} ({rc})")


def card_blocks_per_sm(smem_bytes: int, device: torch.device) -> int:
    """Blocks of the 3xTF32 kernel one SM of `device` holds at `smem_bytes`
    each, from the CUDA occupancy calculator (registers and shared
    memory)."""
    lib = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.rced_stack_blocks_per_sm(smem_bytes, ctypes.byref(n))
    _check(lib, rc, "occupancy query")
    return n.value


@functools.lru_cache(maxsize=None)
def card_wgmma_blocks_per_sm(smem_bytes: int, device: torch.device) -> int:
    """Blocks of the wgmma kernel one SM of `device` holds at `smem_bytes`
    each, from the CUDA occupancy calculator (asked once per device and
    size)."""
    lib = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.rced_stack_wgmma_blocks_per_sm(smem_bytes, ctypes.byref(n))
    _check(lib, rc, "wgmma occupancy query")
    return n.value


def _checked(packed: PackedStack, x: torch.Tensor):
    """-> (B, T) of a CUDA input the kernels take; raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"rced_stack runs on cpu or cuda tensors, not {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("rced_stack takes a contiguous float32 tensor")
    B, C, T, Fd = x.shape
    if C != packed.c_in or Fd != F_DIM or B < 1 or T < 1:
        raise ValueError(
            f"rced_stack wants [B, {packed.c_in}, T, {F_DIM}], got {tuple(x.shape)}"
        )
    held = (packed.weights, packed.koffs) if packed.wg is None else (packed.wg.weights,)
    if any(t.device != x.device for t in held):
        raise ValueError(f"packed weights on {held[0].device}, input on {x.device}")
    return B, T


def _launch_mma_sync(packed: PackedStack, x: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 mma.sync kernel on a float32 pack."""
    global launches
    B, T = _checked(packed, x)
    lib = load_library()
    out = torch.empty(B, packed.c_out, T, F_DIM, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.rced_stack_forward(
            x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(), packed.koffs.data_ptr(),
            packed.plan.ctypes.data, len(packed.layers), B, T, packed.c_in, packed.c_out,
            packed.in_row * ROW, packed.out_row * ROW, packed.smem_floats,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(lib, rc, "launch")
    launches += 1
    return out


def _launch_wgmma(packed: PackedStack, x: torch.Tensor) -> torch.Tensor:
    """The bf16 wgmma kernel on a bf16 pack."""
    global launches_bf16_wgmma
    B, T = _checked(packed, x)
    wg = packed.wg
    lib = load_library()
    out = torch.empty(B, packed.c_out, T, F_DIM, dtype=x.dtype, device=x.device)
    plan = np.ascontiguousarray(wg.plan)
    layout = wg.layout()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = wgmma_launch_plan(packed, B * T, card_wgmma_blocks_per_sm(wg.smem_bytes, x.device), sms).grid
    with torch.cuda.device(x.device):
        rc = lib.rced_stack_forward_wgmma(
            x.data_ptr(), out.data_ptr(), wg.weights.data_ptr(), plan.ctypes.data, layout.ctypes.data,
            len(packed.layers), B, T, packed.c_in, packed.c_out, grid,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(lib, rc, "wgmma launch")
    launches_bf16_wgmma += 1
    return out


def stack_forward(packed: PackedStack, x: torch.Tensor) -> torch.Tensor:
    """The inner stack: [B, c_in, T, 129] float32 -> [B, c_out, T, 129],
    in the operand mode `packed` was packed for.

    A CPU tensor runs `stack_forward_plain`.  A CUDA tensor launches the
    CUDA kernel of that mode (the 3xTF32 kernel in float32, the wgmma
    kernel in bf16) or raises; it never falls back to the plain version."""
    if x.device.type == "cpu":
        return stack_forward_plain(packed, x)
    if packed.dtype == "bfloat16":
        return _launch_wgmma(packed, x)
    return _launch_mma_sync(packed, x)


def fused_inference_forward(
    model: ModelDef, params, bn_state, mag: torch.Tensor,
    packed: Optional[PackedStack] = None, dtype: str = "float32",
) -> torch.Tensor:
    """[B, T, F] magnitude -> [B, T, F] enhanced magnitude, inference mode.

    Equivalent to `model.apply(...)` in eval mode with BN folded: layer 1
    (`rced_edges.first_forward`), the inner stack (`stack_forward`) and the
    projection (`rced_edges.proj_forward`), on the card one launch of each
    kernel.  `dtype` is the inner stack's operand mode, as in JAX:
    "bfloat16" runs its products on bf16 weights and operands with float32
    sums; layer 1 and the last projection stay float32 in both modes.  Pass
    `packed` (from `pack_inference_stack`, in the same mode) to skip folding
    and packing on every call, as the inference engine does."""
    if mag.shape[-1] != F_DIM:
        raise ValueError(f"the stack kernel is specialised for F={F_DIM}")
    if packed is None:
        packed = pack_inference_stack(model, params, bn_state, dtype)
    elif packed.dtype != dtype:
        raise ValueError(f"packed for {packed.dtype}, called with dtype={dtype}")
    z = stack_forward(packed, rced_edges.first_forward(packed.edges, mag.contiguous()))
    return rced_edges.proj_forward(packed.edges, z)
