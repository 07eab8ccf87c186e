"""The edges of the fused inference forward: layer 1 and the final (1, 129)
projection, around the inner stack (`ops/rced_stack.py`).

They replace no Pallas kernel: the JAX package's fused forward leaves both
convs to XLA.  On the card they are two CUDA kernels written by hand
(`csrc/rced_edges.cu`; the source says why they were added, what bounds
them and how its design answers): `rced_first_kernel` (layer 1 with BN
folded, its bias and its ReLU, TF SAME padding by bounds) writes the
[B, C, T, 129] layout the stack kernel reads, and `rced_proj_kernel` (the
projection with its bias) writes the [B, T, 129] result.  Both are float32
on the CUDA cores with sums in a fixed order, in both operand modes of the
stack: layer 1 and the projection are float32 in JAX's bf16 mode too.

`first_forward` and `proj_forward` are the wrappers: on a CPU tensor they
run the plain versions (`first_plain`, `proj_plain`: `conv2d_same`, and the
ReLU); on a CUDA tensor they launch the kernel (building it on first use)
or raise, never falling back.  `launches_first` and `launches_proj` count
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional

import torch

from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
from fullycnnspeechenhancement_torch.models.rced import ConvSpec
from fullycnnspeechenhancement_torch.ops import build

F_DIM = 129
MAX_KH = 8  # csrc kTimeTaps: layer 1's time taps (rows past kh carry zero weights)
MAX_KW = 13
MAX_CHANNELS = 32
FRAMES = 4  # frames of a layer-1 thread's tile (csrc kFrames)
MAX_GROUPS = 2
PROJ_KERNEL = (1, F_DIM)
PROJ_TAPS_PADDED = 132  # csrc kProjTapsPadded
PROJ_FRAMES = 32  # frames of a projection block, one a lane
GROUP_BINS = 8
BIN_GROUPS = -(-F_DIM // GROUP_BINS)  # 17
# The launch plans' thresholds, from timings on an H100 (PERF.md §6):
# layer 1 takes 8 frames a block from about half an SM's worth of such
# blocks; a projection block takes at least 4 warps (which share each
# channel's staging: one-warp blocks wait on it, 63 us at any T <= 499
# against 28 us) and one more bin group a warp for about 7 more tiles.
FIRST_BIG_TILE_BLOCKS = 66
PROJ_MIN_WARPS = 4
PROJ_TILES_A_WARP = 7

# Kernel launches since the counts were last set to 0.
launches_first = 0
launches_proj = 0

_lib: Optional[ctypes.CDLL] = None


@dataclasses.dataclass(frozen=True, eq=False)
class EdgePack:
    """Layer 1 and the projection with BN folded (`w` OIHW, `b` [Cout]),
    and the kernels' copies of their weights: `first_w` [kw][ceil(C / 2)]
    [8][2] (time taps past kh and a channel past an odd C zero),
    `first_b` [2 ceil(C / 2)], `proj_w` [C][132] (zeros past tap 129),
    `proj_b` [1]."""

    first: ConvSpec
    w1: torch.Tensor
    b1: torch.Tensor
    last: ConvSpec
    w_last: torch.Tensor
    b_last: torch.Tensor
    first_w: torch.Tensor
    first_b: torch.Tensor
    proj_w: torch.Tensor
    proj_b: torch.Tensor

    @property
    def channels(self) -> int:
        """Layer 1's output channels."""
        return self.w1.shape[0]

    @property
    def proj_channels(self) -> int:
        """The projection's input channels."""
        return self.w_last.shape[1]


def pack_edges(first, last) -> EdgePack:
    """(spec, w OIHW, b) of layer 1 and of the projection, BN folded, -> an
    EdgePack; raises on an edge the kernels do not take: a layer 1 over
    other than one input channel, with kh above 8, kw above 13 or more than
    32 channels; a last layer other than a (1, 129) conv to one channel from
    at most 32, or one with an activation."""
    spec1, w1, b1 = first
    spec2, w2, b2 = last
    c, cin, kh, kw = w1.shape
    if cin != 1 or not 1 <= kh <= MAX_KH or not 1 <= kw <= MAX_KW or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(
            f"layer 1 {spec1.name} is a {(kh, kw)} conv {cin} -> {c}: the edge kernel takes 1 -> "
            f"<= {MAX_CHANNELS} channels, kh <= {MAX_KH}, kw <= {MAX_KW}"
        )
    cout, cz = w2.shape[:2]
    if tuple(w2.shape[2:]) != PROJ_KERNEL or cout != 1 or not 1 <= cz <= MAX_CHANNELS:
        raise ValueError(
            f"last layer {spec2.name} is a {tuple(w2.shape[2:])} conv {cz} -> {cout}: the edge kernel takes "
            f"a {PROJ_KERNEL} conv <= {MAX_CHANNELS} -> 1"
        )
    if spec2.use_act:
        raise ValueError(f"last layer {spec2.name} has an activation: the edge kernel takes none")
    nch = -(-c // 2)
    fw = torch.zeros(kw, 2 * nch, MAX_KH, dtype=torch.float32, device=w1.device)
    fw[:, :c, :kh] = w1[:, 0].permute(2, 0, 1)  # [kw, c, kh]
    first_w = fw.view(kw, nch, 2, MAX_KH).permute(0, 1, 3, 2).contiguous()  # [kw, pair, tap, 2]
    first_b = torch.zeros(2 * nch, dtype=torch.float32, device=w1.device)
    first_b[:c] = b1
    proj_w = torch.zeros(cz, PROJ_TAPS_PADDED, dtype=torch.float32, device=w2.device)
    proj_w[:, :F_DIM] = w2[0, :, 0]
    return EdgePack(
        first=spec1, w1=w1, b1=b1, last=spec2, w_last=w2, b_last=b2,
        first_w=first_w.reshape(-1), first_b=first_b, proj_w=proj_w.reshape(-1),
        proj_b=b2.reshape(1).to(torch.float32).contiguous(),
    )


def first_plain(edges: EdgePack, mag: torch.Tensor) -> torch.Tensor:
    """Plain torch layer 1: [B, T, 129] -> [B, C, T, 129]."""
    y = conv2d_same(mag[:, None], edges.w1, edges.b1)
    if edges.first.use_act:
        y = torch.relu(y)
    return y.contiguous()


def proj_plain(edges: EdgePack, z: torch.Tensor) -> torch.Tensor:
    """Plain torch projection: [B, C, T, 129] -> [B, T, 129]."""
    return conv2d_same(z, edges.w_last, edges.b_last)[:, 0]


class FirstPlan(NamedTuple):
    """Layer 1's launch: blocks of `groups` x 4 frames, `threads` threads."""

    groups: int
    frames_per_block: int
    threads: int
    grid: int


class ProjPlan(NamedTuple):
    """The projection's launch: blocks of 32 frames and `warps` bin groups of
    8 (of 17), `chunks` of them a tile."""

    warps: int
    chunks: int
    threads: int
    grid: int


def first_plan(batch: int, frames: int) -> FirstPlan:
    """8 frames a block, or 4 where 8 would give under
    FIRST_BIG_TILE_BLOCKS blocks."""
    groups = MAX_GROUPS if batch * -(-frames // (MAX_GROUPS * FRAMES)) >= FIRST_BIG_TILE_BLOCKS else 1
    tile = groups * FRAMES
    return FirstPlan(groups, tile, -(-groups * F_DIM // 32) * 32, batch * -(-frames // tile))


def proj_plan(batch: int, frames: int) -> ProjPlan:
    """A warp for every PROJ_TILES_A_WARP 32-frame tiles, at least
    PROJ_MIN_WARPS and at most all 17 bin groups a block."""
    tiles = batch * -(-frames // PROJ_FRAMES)
    warps = min(BIN_GROUPS, max(PROJ_MIN_WARPS, tiles // PROJ_TILES_A_WARP))
    chunks = -(-BIN_GROUPS // warps)
    return ProjPlan(warps, chunks, 32 * warps, tiles * chunks)


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/rced_edges.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("rced_edges")
        lib.rced_first_forward.restype = ctypes.c_int
        lib.rced_first_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.rced_proj_forward.restype = ctypes.c_int
        lib.rced_proj_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rced_edges_error_string.restype = ctypes.c_char_p
        lib.rced_edges_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check_input(x: torch.Tensor, shape, what: str) -> None:
    """Raise unless `x` is a float32 tensor on the CPU or the card of the
    given shape (None: any size >= 1), contiguous on the card."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rced_edges runs on cpu or cuda tensors, not {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"rced_edges {what} takes float32, got {x.dtype}")
    if x.dim() != len(shape) or any(s < 1 or (w is not None and s != w) for s, w in zip(x.shape, shape)):
        want = ", ".join("n" if w is None else str(w) for w in shape)
        raise ValueError(f"rced_edges {what} wants [{want}], got {tuple(x.shape)}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"rced_edges {what} takes a contiguous tensor on the card")


def _on_card(x: torch.Tensor, *packed) -> None:
    for t in packed:
        if t.device != x.device:
            raise ValueError(f"edge weights on {t.device}, input on {x.device}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"rced_edges {what} failed: {lib.rced_edges_error_string(rc).decode()} ({rc})")


def first_forward(edges: EdgePack, mag: torch.Tensor) -> torch.Tensor:
    """Layer 1: [B, T, 129] float32 -> [B, C, T, 129], contiguous.  A CPU
    tensor runs `first_plain`; a CUDA tensor launches `rced_first_kernel`
    or raises."""
    global launches_first
    _check_input(mag, (None, None, F_DIM), "layer 1")
    if mag.device.type == "cpu":
        return first_plain(edges, mag)
    _on_card(mag, edges.first_w, edges.first_b)
    B, T, _ = mag.shape
    kh, kw = edges.w1.shape[2:]
    lib = load_library()
    out = torch.empty(B, edges.channels, T, F_DIM, dtype=torch.float32, device=mag.device)
    with torch.cuda.device(mag.device):
        rc = lib.rced_first_forward(
            mag.data_ptr(), out.data_ptr(), edges.first_w.data_ptr(), edges.first_b.data_ptr(),
            B, T, edges.channels, kh, kw, int(edges.first.use_act), first_plan(B, T).groups,
            torch.cuda.current_stream(mag.device).cuda_stream,
        )
    _raise_on(lib, rc, "layer 1 launch")
    launches_first += 1
    return out


def proj_forward(edges: EdgePack, z: torch.Tensor) -> torch.Tensor:
    """The projection: [B, C, T, 129] float32 -> [B, T, 129].  A CPU tensor
    runs `proj_plain`; a CUDA tensor launches `rced_proj_kernel` or
    raises."""
    global launches_proj
    _check_input(z, (None, edges.proj_channels, None, F_DIM), "projection")
    if z.device.type == "cpu":
        return proj_plain(edges, z)
    _on_card(z, edges.proj_w, edges.proj_b)
    B, C, T, _ = z.shape
    lib = load_library()
    out = torch.empty(B, T, F_DIM, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = lib.rced_proj_forward(
            z.data_ptr(), out.data_ptr(), edges.proj_w.data_ptr(), edges.proj_b.data_ptr(),
            B, T, C, proj_plan(B, T).warps, torch.cuda.current_stream(z.device).cuda_stream,
        )
    _raise_on(lib, rc, "projection launch")
    launches_proj += 1
    return out


def edge_macs(edges: EdgePack, frames: int):
    """(layer 1's, the projection's) multiply-adds over `frames` frames of
    one row, counting only products that meet a real input (TF SAME zeros
    cost none)."""
    kh, kw = edges.w1.shape[2:]
    top, lo = (kh - 1) // 2, (kw - 1) // 2
    rows = sum(max(0, min(frames, frames + top - i) - max(0, top - i)) for i in range(kh))
    first = edges.channels * rows * sum(F_DIM - abs(j - lo) for j in range(kw))
    centre = (F_DIM - 1) // 2
    proj = edges.proj_channels * frames * sum(F_DIM - abs(j - centre) for j in range(F_DIM))
    return first, proj
