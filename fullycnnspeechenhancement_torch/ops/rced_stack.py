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
  * layer 1 runs as a cuDNN conv on the folded weights, then its ReLU;
  * the inner layers run in one kernel launch that keeps every live tap of
    a frame in shared memory (`stack_forward`); taps that name layer 1
    read the kernel's input.  The kernel runs each layer as a GEMM on the
    tensor cores in 3xTF32: `pack_inference_stack` orders K = (tap, input
    channel), splits the weights into TF32 big and small parts and stores
    them in `mma.sync` fragment order, and gives the kernel each k's
    shared-memory offset (`tap_offsets`);
  * the final (1, 129) projection runs as a cuDNN conv.

`dtype="bfloat16"` is the JAX kernel's bf16 operand mode: the folded
weights are packed in bf16 (`pack_fragments_bf16`) and each layer's input
slab is rounded to bf16 where it meets them; the products are exact and
summed in float32, and the slabs, biases, skips and residuals stay
float32.  Layer 1 and the last projection stay float32 convs, as in JAX.

`stack_forward` is the kernel's wrapper: on a CPU tensor it runs
`stack_forward_plain`, the same arithmetic in plain torch; on a CUDA tensor
it launches the kernel (building it on first use) or raises.  `launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.models.blocks import BN_EPSILON, conv2d_same
from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
from fullycnnspeechenhancement_torch.ops import build

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
K_CHUNK_BF16 = 16  # K per mma of the bf16 mode (m16n8k16)
DTYPES = ("float32", "bfloat16")
MAX_KW = 13
MAX_LAYERS = 16
MAX_COUT = 32  # four n8 tiles
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
SM_SMEM_BYTES = 233_472  # shared memory of one SM; each block also takes 1 KiB
# Floats after the last row: the padded bin 143 reads up to HALO + 6 + 143
# floats past its row's start.
SMEM_SLACK = 2 * HALO + M_PAD - ROW
TF32_MASK = -8192  # 0xffffe000 as int32: clears the 13 low mantissa bits
INPUT = "__input__"

# Kernel launches since the counts were last set to 0: the 3xTF32
# instance and the bf16 one.
launches = 0
launches_bf16 = 0

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
    """One inner layer as the kernel sees it.  Row offsets count channel
    rows of ROW floats in a block's shared memory; -1 means no tap."""

    name: str
    kw: int
    cin: int
    cout: int
    skip_from: Optional[str]
    add_from: Optional[str]
    use_act: bool
    w_off: int  # floats into PackedStack.weights: B fragments, then biases
    k_off: int  # ints into PackedStack.koffs: chunks * k_chunk A offsets
    in_row: int = -1
    out_row: int = -1
    skip_row: int = -1
    add_row: int = -1
    k_chunk: int = K_CHUNK  # K_CHUNK_BF16 in the bf16 mode

    @property
    def k(self) -> int:
        return self.cin * self.kw

    @property
    def chunks(self) -> int:
        return -(-self.k // self.k_chunk)

    @property
    def n_tiles(self) -> int:
        return -(-self.cout // N_TILE)

    @property
    def b_off(self) -> int:
        # a lane's fragment of one tile: 4 float32 words (3xTF32), or 2
        # words of two bf16 each
        words = 4 if self.k_chunk == K_CHUNK else 2
        return self.w_off + self.chunks * self.n_tiles * 32 * words


@dataclasses.dataclass(frozen=True, eq=False)
class PackedStack:
    """A model's BN-folded weights, packed once for `fused_inference_forward`."""

    first: Tuple[ConvSpec, torch.Tensor, torch.Tensor]  # layer 1, OIHW
    last: Tuple[ConvSpec, torch.Tensor, torch.Tensor]  # final projection
    layers: Tuple[InnerLayer, ...]
    folded: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]  # inner (w [cin, kw, cout], b)
    weights: torch.Tensor  # the kernel's B fragments and biases, float32 words
    koffs: torch.Tensor  # the kernel's A offsets, int32
    plan: np.ndarray  # [n_layers, 10] int32, the kernel's layer table
    in_row: int
    out_row: int
    smem_rows: int
    dtype: str = "float32"  # the operand mode, one of DTYPES

    @property
    def c_in(self) -> int:
        return self.layers[0].cin

    @property
    def c_out(self) -> int:
        return self.layers[-1].cout

    @property
    def smem_floats(self) -> int:
        return self.smem_rows * ROW + SMEM_SLACK


def _allocate_rows(layers, c_in):
    """Place each value (the input, each layer's output) at a row offset in
    shared memory for as long as it is live: a value dies after its last
    reader (the next layer, or a later skip/add).  First fit; an output
    never overlaps a value its own layer reads.  Returns (rows of each
    value, rows used)."""
    last_use = {INPUT: 0}
    for i, lay in enumerate(layers):
        last_use[lay.name] = i + 1  # the last one: kept to the copy-out
        for ref in (lay.skip_from, lay.add_from):
            if ref is not None:
                last_use[ref] = max(last_use[ref], i)
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

    place(INPUT, c_in, -1)
    for i, lay in enumerate(layers):
        place(lay.name, lay.cout, i)
    return where, used


def tap_offsets(cin: int, kw: int, k_chunk: int = K_CHUNK) -> np.ndarray:
    """The kernel's A offsets of one layer, [chunks * k_chunk] int32: k =
    j * cin + ci (tap-outer, channel-inner) reads channel ci's row at tap
    j, so A[m, k] = in[offset[k] + m] with offset[k] = ci * ROW + HALO - lo
    + j; the padded k past cin * kw repeat the last offset (their weights
    are zero, and a repeated address is a broadcast, not a bank conflict)."""
    lo = (kw - 1) // 2
    k = np.minimum(np.arange(-(-cin * kw // k_chunk) * k_chunk), cin * kw - 1)
    j, ci = np.divmod(k, cin)
    return (ci * ROW + HALO - lo + j).astype(np.int32)


def gemm_weights(w: torch.Tensor, chunks: int, n_tiles: int, k_chunk: int = K_CHUNK) -> torch.Tensor:
    """w [cin, kw, cout] -> the layer's B [chunks * k_chunk, n_tiles * 8]:
    row j * cin + ci holds w[ci, j], zeros past K and cout."""
    cin, kw, cout = w.shape
    b = torch.zeros(chunks * k_chunk, n_tiles * N_TILE, dtype=torch.float32, device=w.device)
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


def pack_fragments_bf16(b: torch.Tensor) -> torch.Tensor:
    """B [chunks * 16, n_tiles * 8] -> its bf16 fragments for m16n8k16,
    rounded to nearest even and stored two to a float32 word, flat
    [chunks, n_tiles, 32 lanes, 2 words]: lane 4g + t of tile (c, n) holds
    B[16c + t + 4h + 8w, 8n + g] in half h of word w, so its fragment is
    one 8-byte load and mma's k 2t, 2t + 1, 2t + 8, 2t + 9 stand for the
    chunk's k t, t + 4, t + 8, t + 12."""
    kp, np_ = b.shape
    parts = b.contiguous().to(torch.bfloat16).view(
        kp // K_CHUNK_BF16, 2, 2, 4, np_ // N_TILE, N_TILE)  # [c, w, h, t, n, g]
    return parts.permute(0, 4, 5, 3, 1, 2).reshape(-1).contiguous().view(torch.float32)


def unpack_fragments_bf16(frag: torch.Tensor, chunks: int, n_tiles: int) -> torch.Tensor:
    """Inverse of `pack_fragments_bf16`: -> B [chunks * 16, n_tiles * 8],
    bfloat16."""
    parts = frag.contiguous().view(torch.bfloat16).view(chunks, n_tiles, N_TILE, 4, 2, 2)
    return parts.permute(0, 4, 5, 3, 1, 2).reshape(chunks * K_CHUNK_BF16, n_tiles * N_TILE)


def pack_inference_stack(model: ModelDef, params, bn_state, dtype: str = "float32") -> PackedStack:
    """Fold BN and pack the inner layers' weights and plan for the kernel,
    in 3xTF32 fragments (`dtype="float32"`) or bf16 ones ("bfloat16").

    Inner layers must be (1, kw <= 13) convs over 129 bins with at most 32
    output channels; at most 16 of them, whose live taps fit one block's
    shared memory."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype {dtype!r}: the stack kernel takes one of {DTYPES}")
    k_chunk = K_CHUNK if dtype == "float32" else K_CHUNK_BF16
    folded = fold_bn_inference(model, params, bn_state)
    first, last, inner = folded[0], folded[-1], folded[1:-1]
    first_name = first[0].name
    if not 1 <= len(inner) <= MAX_LAYERS:
        raise ValueError(f"{model.name}: {len(inner)} inner layers, kernel takes 1..{MAX_LAYERS}")
    layers, plain, chunks, koffs = [], [], [], []
    w_off = k_off = 0
    cin = first[0].out_ch
    for spec, w, b in inner:
        kh, kw = spec.kernel
        if kh != 1 or not 1 <= kw <= MAX_KW:
            raise ValueError(f"inner layer {spec.name} has kernel {spec.kernel}; needs (1, <= {MAX_KW})")
        cout = spec.out_ch
        if cout > MAX_COUT:
            raise ValueError(f"inner layer {spec.name} has {cout} channels; the kernel takes <= {MAX_COUT}")

        def remap(ref):
            return INPUT if ref == first_name else ref

        lay = InnerLayer(
            spec.name, kw, cin, cout, remap(spec.skip_from), remap(spec.add_from),
            spec.use_act, w_off, k_off, k_chunk=k_chunk,
        )
        w_cko = w[:, :, 0, :].permute(1, 2, 0).contiguous()  # [cin, kw, cout]
        plain.append((w_cko, b))
        bias = torch.zeros(lay.n_tiles * N_TILE, dtype=torch.float32, device=w.device)
        bias[:cout] = b
        gemm = gemm_weights(w_cko, lay.chunks, lay.n_tiles, k_chunk)
        frag = pack_fragments(gemm) if dtype == "float32" else pack_fragments_bf16(gemm)
        chunks += [frag, bias]
        koffs.append(tap_offsets(cin, kw, k_chunk))
        layers.append(lay)
        w_off = lay.b_off + bias.numel()
        k_off += koffs[-1].size
        cin = cout

    rows, used = _allocate_rows(layers, first[0].out_ch)
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
    device = first[1].device
    return PackedStack(
        first=first,
        last=last,
        layers=tuple(placed),
        folded=tuple(plain),
        weights=torch.cat(chunks).contiguous(),
        koffs=torch.as_tensor(np.concatenate(koffs), device=device),
        plan=plan,
        in_row=rows[INPUT],
        out_row=placed[-1].out_row,
        smem_rows=used,
        dtype=dtype,
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
    """How `stack_forward` launches the kernel: one block per frame, of
    `threads` threads and `smem_bytes` of shared memory, `blocks_per_sm` of
    them resident on an SM; its mma tiles (m16n8k8 in 3xTF32, m16n8k16 in
    bf16) compute `padded_product_ratio` times the products the layers
    need."""

    threads: int
    smem_bytes: int
    blocks_per_sm: int
    frames_per_block: int
    padded_product_ratio: float


def padded_product_ratio(packed: PackedStack) -> float:
    """Products the kernel computes (bins padded to M_PAD, K to the mode's
    k8 or k16 chunks, cout to n8 tiles) over the products the layers need (tap j meets
    F_DIM - |j - lo| bins; the rest fall on the zero halo)."""
    done = sum(M_PAD * lay.chunks * lay.k_chunk * lay.n_tiles * N_TILE for lay in packed.layers)
    need = 0
    for lay in packed.layers:
        lo = (lay.kw - 1) // 2
        need += lay.cin * lay.cout * sum(F_DIM - abs(j - lo) for j in range(lay.kw))
    return done / need


def model_blocks_per_sm(smem_bytes: int) -> int:
    """Resident blocks per SM as shared memory and the SM's 2048 threads
    allow, without asking the card (registers not modelled;
    `card_blocks_per_sm` asks the CUDA occupancy calculator)."""
    return min(SM_SMEM_BYTES // (smem_bytes + 1024), 2048 // THREADS)


def launch_plan(packed: PackedStack, blocks_per_sm: Optional[int] = None) -> LaunchPlan:
    """The kernel's launch on `packed`, at `blocks_per_sm` (from
    `card_blocks_per_sm`) or, when not given, `model_blocks_per_sm`."""
    smem = packed.smem_floats * 4
    per_sm = model_blocks_per_sm(smem) if blocks_per_sm is None else blocks_per_sm
    return LaunchPlan(THREADS, smem, per_sm, 1, padded_product_ratio(packed))


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/rced_stack.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("rced_stack")
        lib.rced_stack_forward.restype = ctypes.c_int
        lib.rced_stack_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rced_stack_blocks_per_sm.restype = ctypes.c_int
        lib.rced_stack_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.rced_stack_error_string.restype = ctypes.c_char_p
        lib.rced_stack_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"rced_stack {what} failed: {lib.rced_stack_error_string(rc).decode()} ({rc})")


def card_blocks_per_sm(smem_bytes: int, device: torch.device, dtype: str = "float32") -> int:
    """Blocks of the kernel's `dtype` instance one SM of `device` holds at
    `smem_bytes` each, from the CUDA occupancy calculator (registers and
    shared memory)."""
    lib = load_library()
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.rced_stack_blocks_per_sm(smem_bytes, int(dtype == "bfloat16"), ctypes.byref(n))
    _check(lib, rc, "occupancy query")
    return n.value


def stack_forward(packed: PackedStack, x: torch.Tensor) -> torch.Tensor:
    """The inner stack: [B, c_in, T, 129] float32 -> [B, c_out, T, 129],
    in the operand mode `packed` was packed for.

    A CPU tensor runs `stack_forward_plain`.  A CUDA tensor launches the
    CUDA kernel of that mode or raises; it never falls back to the plain
    version."""
    if x.device.type == "cpu":
        return stack_forward_plain(packed, x)
    if x.device.type != "cuda":
        raise ValueError(f"rced_stack runs on cpu or cuda tensors, not {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("rced_stack takes a contiguous float32 tensor")
    B, C, T, Fd = x.shape
    if C != packed.c_in or Fd != F_DIM or B < 1 or T < 1:
        raise ValueError(
            f"rced_stack wants [B, {packed.c_in}, T, {F_DIM}], got {tuple(x.shape)}"
        )
    if packed.weights.device != x.device or packed.koffs.device != x.device:
        raise ValueError(f"packed weights on {packed.weights.device}, input on {x.device}")
    global launches, launches_bf16
    bf16 = packed.dtype == "bfloat16"
    lib = load_library()
    out = torch.empty(B, packed.c_out, T, F_DIM, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.rced_stack_forward(
            x.data_ptr(), out.data_ptr(), packed.weights.data_ptr(), packed.koffs.data_ptr(),
            packed.plan.ctypes.data, len(packed.layers), B, T, C, packed.c_out,
            packed.in_row * ROW, packed.out_row * ROW, packed.smem_floats, int(bf16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(lib, rc, "launch")
    if bf16:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def fused_inference_forward(
    model: ModelDef, params, bn_state, mag: torch.Tensor,
    packed: Optional[PackedStack] = None, dtype: str = "float32",
) -> torch.Tensor:
    """[B, T, F] magnitude -> [B, T, F] enhanced magnitude, inference mode.

    Equivalent to `model.apply(...)` in eval mode with BN folded.  `dtype`
    is the inner stack's operand mode, as in JAX: "bfloat16" runs its
    products on bf16 weights and operands with float32 sums; layer 1 and
    the last projection stay float32.  Pass `packed` (from
    `pack_inference_stack`, in the same mode) to skip folding and packing
    on every call, as the inference engine does."""
    if mag.shape[-1] != F_DIM:
        raise ValueError(f"the stack kernel is specialised for F={F_DIM}")
    if packed is None:
        packed = pack_inference_stack(model, params, bn_state, dtype)
    elif packed.dtype != dtype:
        raise ValueError(f"packed for {packed.dtype}, called with dtype={dtype}")
    first_spec, w1, b1 = packed.first
    y1 = conv2d_same(mag[:, None], w1, b1)
    if first_spec.use_act:
        y1 = torch.relu(y1)
    z = stack_forward(packed, y1.contiguous())
    last_spec, w_last, b_last = packed.last
    out = conv2d_same(z, w_last, b_last)
    if last_spec.use_act:
        out = torch.relu(out)
    return out[:, 0]
