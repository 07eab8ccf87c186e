"""Weight gradient of the blocked inner frequency convs, and their Function.

Counterpart of `fullycnnspeechenhancement_tpu/ops/pallas_dw.py`, whose
Pallas TPU kernel `_dw_kernel` this module replaces with a CUDA kernel
written by hand for Hopper (`csrc/blocked_dw.cu`; the source says what
bounds it and how its design answers).

`models/blocked.py` folds `fb` frequency bins into channels, so each inner
(1, kw) layer becomes a (1, KB) conv over NB blocks of z [B, T, NB, Ci]
(the JAX package's NHWC layout) with padding (dc, KB-1-dc) along NB.  Its
weight gradient is

    dW[d, ci, co] = sum_{b, t, n} zpad[b, t, n + d - dc, ci] * dy[b, t, n, co]

returned as [1, KB, Ci, Co] (HWIO) float32, as `blocked_dw_pallas` returns
it.  z and dy are both float32 or both bfloat16 (the compute dtype, as the
JAX kernel takes them).  float32 runs a 3xTF32 `mma.sync` kernel; bfloat16
runs a `wgmma` kernel fed by TMA where Ci and Co are multiples of 8 and
both tensors 16-byte aligned (`takes_wgmma`: every blocked layer at fb 8),
chosen by shape before the launch.  A bf16 pair of any other shape runs
the 3xTF32 kernel on float32 copies of z and dy: bf16 values are exact in
float32 and their 3xTF32 small parts are 0, so the products are exact and
the result is float32 sums of them, as the `wgmma` kernel's is.
`blocked_dw` is the kernels' wrapper: on a CPU tensor it runs
`blocked_dw_plain`, the same contraction as einsums in float32; on a CUDA
tensor it launches a kernel (building it on first use) or raises.
`launches` (3xTF32) and `launches_bf16` (`wgmma`) count each kernel's
launches.

`blocked_freq_conv` is the autograd Function around the raw blocked conv
(JAX's `custom_vjp`): the forward and dX are cuDNN convs, dW is
`blocked_dw`.  Its tensors keep the JAX layout; NCHW exists only as a
channels-last view handed to cuDNN.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.ops import build

MAX_KB = 8  # taps the kernel is instantiated for
TILE = 32  # ci and co per block of the 3xTF32 kernel (csrc kBn, kBm)
ROW_PAD = 4  # floats after each staged position's channels (csrc kRowPad)
STAGE_POSITIONS = 80  # flat K positions (rows x nbp) aimed at per stage
K_STEP = 8  # K per mma.sync (m16n8k8)
DTYPES = (torch.float32, torch.bfloat16)
FLUSH_POSITIONS = 4096  # K positions between flushes into float32 (csrc kFlushPositions)
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
SM_SMEM_BYTES = 233_472  # shared memory of one SM; each block also takes 1 KiB
MAX_WAVES = 4  # waves of blocks the row splits may take
# The bf16 wgmma kernel (csrc dw_wgmma_kernel): 64 co by tile_ci_wgmma(KB)
# ci a block, stages of 8 rows, two consumer warpgroups that take stages in
# turn and each write a slot of partial sums, a ring of 3 to 8 stages.
TILE_CO_WGMMA = 64  # csrc kWgCo
STAGE_ROWS_WGMMA = 8  # csrc kWgRows
WGMMA_CONSUMERS = 2  # csrc kWgConsumers
WGMMA_MIN_STAGES = 3  # csrc kWgMinStages: a warpgroup holds two stages at once
WGMMA_MAX_STAGES = 8  # csrc kWgMaxStages
MAX_BOX = 256  # the most elements a TMA box takes along one dimension

# Kernel launches since the counts were last set to 0: the 3xTF32
# kernel and the bf16 wgmma kernel.
launches = 0
launches_bf16 = 0

_lib: Optional[ctypes.CDLL] = None
_occupancy: dict = {}


class Plan(NamedTuple):
    """How one launch of the 3xTF32 kernel covers its problem: `tiles`
    blocks of TILE co by TILE ci per row split, stages of `stage_rows`
    rows (`smem_bytes` of shared memory for two, `blocks_per_sm` resident
    blocks at that), and `splits` row splits of `rows_per_split` rows."""

    stage_rows: int
    smem_bytes: int
    blocks_per_sm: int
    tiles: int
    rows_per_split: int
    splits: int


def stage_rows_for(nb: int, kb: int) -> int:
    """Rows per stage: a multiple of the fewest whose nbp = NB + KB - 1
    positions each make whole k8 chunks, with about STAGE_POSITIONS
    positions in all."""
    nbp = nb + kb - 1
    step = K_STEP // math.gcd(nbp, K_STEP)
    return step * max(1, STAGE_POSITIONS // (step * nbp))


def smem_bytes(stage_rows: int, nb: int, kb: int) -> int:
    """Shared memory of one block, two stages (csrc `blocked_dw_smem_bytes`):
    dy [P, TILE + 4] and z [P + KB - 1, TILE + 4] floats, P = stage_rows *
    nbp."""
    positions = stage_rows * (nb + kb - 1)
    return 2 * 4 * (2 * positions + kb - 1) * (TILE + ROW_PAD)


def model_blocks_per_sm(kb: int, smem: int) -> int:
    """Resident blocks per SM of the KB instance as its registers (its
    __launch_bounds__: 4 blocks up to KB = 5, 3 above) and `smem` allow,
    without asking the card (on the card the wrapper asks the CUDA
    occupancy calculator)."""
    return min(4 if kb <= 5 else 3, SM_SMEM_BYTES // (smem + 1024))


def launch_plan(rows: int, nb: int, ci: int, co: int, kb: int, sm_count: int,
                blocks_per_sm: Optional[Callable[[int], int]] = None) -> Plan:
    """The 3xTF32 kernel's stage (`stage_rows_for`) and row splits, at
    least one stage of rows each, whose blocks best fill whole waves of
    sm_count * blocks_per_sm(smem) resident blocks (`model_blocks_per_sm`
    when not given)."""
    stage_rows = stage_rows_for(nb, kb)
    smem = smem_bytes(stage_rows, nb, kb)
    if smem > SMEM_BYTES:
        raise ValueError(f"blocked_dw: NB={nb}, KB={kb} needs {smem} B of shared memory per block")
    per_sm = blocks_per_sm(smem) if blocks_per_sm else model_blocks_per_sm(kb, smem)
    if per_sm < 1:
        raise ValueError(f"blocked_dw: no block of {smem} B of shared memory fits an SM")
    tiles = -(-ci // TILE) * -(-co // TILE)
    rows_per_split, splits = row_splits(rows, stage_rows, tiles, sm_count * per_sm)
    return Plan(stage_rows, smem, per_sm, tiles, rows_per_split, splits)


def row_splits(rows: int, stage_rows: int, tiles: int, slots: int):
    """(rows_per_split, splits): whole stages per split, and the split
    count whose tiles x splits blocks best fill whole waves of `slots`
    resident blocks, over up to MAX_WAVES waves beyond the fewest the tiles
    need (fewer splits on ties)."""
    stages = -(-rows // stage_rows)

    def rows_per(splits: int) -> int:
        return -(-rows // (splits * stage_rows)) * stage_rows

    def fill(splits: int) -> float:  # the share of the waves' slots used
        blocks = tiles * -(-rows // rows_per(splits))
        return blocks / (-(-blocks // slots) * slots)

    least = -(-tiles // slots)
    splits = max(
        (max(1, min(stages, w * slots // tiles)) for w in range(least, least + MAX_WAVES)),
        key=lambda s: (fill(s), -s),
    )
    per = rows_per(splits)
    return per, -(-rows // per)


class WgmmaPlan(NamedTuple):
    """How one launch of the bf16 wgmma kernel covers its problem: `tiles`
    blocks of TILE_CO_WGMMA co by `tile_ci` ci per row split, stages of
    STAGE_ROWS_WGMMA rows by `nbp` staged positions, a ring of `stages`
    (`smem_bytes` of shared memory, `blocks_per_sm` resident blocks at
    that), and `splits` row splits of `rows_per_split` rows."""

    tile_ci: int
    nbp: int
    stages: int
    smem_bytes: int
    blocks_per_sm: int
    tiles: int
    rows_per_split: int
    splits: int


def tile_ci_wgmma(kb: int) -> int:
    """ci per block of the wgmma kernel's KB instance (csrc wg_tile_ci):
    64 x N x KB float32 accumulators a warpgroup fit 128 registers a
    thread."""
    return 64 if kb <= 4 else 32


def wgmma_nbp(nb: int, kb: int) -> int:
    """Staged positions per row: NB + KB - 1, rounded up to even so that a
    stage of 8 rows is whole k16 chunks."""
    return -(-(nb + kb - 1) // 2) * 2


def wgmma_stage_bytes(nbp: int, kb: int) -> int:
    """One stage (csrc wg_stage_bytes): dy [8 nbp K-rows][64 co] and z
    [8 (nbp + KB - 1) K-rows][tile_ci ci] in bf16, rounded up to 1024."""
    raw = 2 * STAGE_ROWS_WGMMA * (nbp * TILE_CO_WGMMA + (nbp + kb - 1) * tile_ci_wgmma(kb))
    return -(-raw // 1024) * 1024


def wgmma_smem_bytes(nbp: int, kb: int, stages: int) -> int:
    """One block (csrc wg_smem_bytes): 1024 bytes of alignment, the ring, a
    flush buffer per consumer warpgroup (tile_ci rows of 64 co floats), and
    a full and an empty mbarrier for each of WGMMA_MAX_STAGES."""
    flush = tile_ci_wgmma(kb) * 4 * TILE_CO_WGMMA
    return 1024 + stages * wgmma_stage_bytes(nbp, kb) + WGMMA_CONSUMERS * flush + 2 * WGMMA_MAX_STAGES * 8


def wgmma_stages(nb: int, kb: int) -> int:
    """The deepest ring, up to WGMMA_MAX_STAGES, whose block fits SMEM_BYTES
    (0 if WGMMA_MIN_STAGES do not fit)."""
    nbp = wgmma_nbp(nb, kb)
    fit = [s for s in range(WGMMA_MIN_STAGES, WGMMA_MAX_STAGES + 1)
           if wgmma_smem_bytes(nbp, kb, s) <= SMEM_BYTES]
    return max(fit, default=0)


def takes_wgmma(z: torch.Tensor, dy: torch.Tensor, kb: int) -> bool:
    """Whether the bf16 pair z [B, T, NB, Ci], dy [B, T, NB, Co] goes to
    the wgmma kernel: Ci and Co multiples of 8 and both tensors 16-byte
    aligned (TMA's rules for its tensor maps), nbp within one TMA box, a
    ring of WGMMA_MIN_STAGES stages within a block's shared memory, and
    fewer than 2^31 rows (TMA's coordinates).  Decided by shape alone,
    before any launch."""
    nb, ci, co = z.shape[-2], z.shape[-1], dy.shape[-1]
    return (z.dtype == dy.dtype == torch.bfloat16 and ci % 8 == 0 and co % 8 == 0
            and z.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
            and wgmma_nbp(nb, kb) <= MAX_BOX and wgmma_stages(nb, kb) > 0
            and z.numel() // max(1, nb * ci) < 2**31)


def wgmma_plan(rows: int, nb: int, ci: int, co: int, kb: int, sm_count: int,
               blocks_per_sm: Optional[Callable[[int], int]] = None) -> WgmmaPlan:
    """The wgmma kernel's plan: the deepest ring that fits, its tiles, and
    row splits of whole stages: as many as one wave of sm_count *
    blocks_per_sm(smem) resident blocks holds (1 a SM when not given: the
    ring takes most of an SM's shared memory), or, for more tiles than a
    wave, those that best fill whole waves (`row_splits`)."""
    nbp, stages = wgmma_nbp(nb, kb), wgmma_stages(nb, kb)
    if nbp > MAX_BOX or not stages:
        raise ValueError(f"blocked_dw: the wgmma kernel does not take NB={nb}, KB={kb}")
    smem = wgmma_smem_bytes(nbp, kb, stages)
    per_sm = blocks_per_sm(smem) if blocks_per_sm else 1
    if per_sm < 1:
        raise ValueError(f"blocked_dw: no block of {smem} B of shared memory fits an SM")
    tile_ci = tile_ci_wgmma(kb)
    tiles = -(-ci // tile_ci) * -(-co // TILE_CO_WGMMA)
    slots = sm_count * per_sm
    if tiles <= slots:
        # one wave: each block's prologue, pipeline fill and last flush are
        # paid once, and the reduce reads the fewest partial slots
        per = -(-rows // (max(1, slots // tiles) * STAGE_ROWS_WGMMA)) * STAGE_ROWS_WGMMA
        rows_per_split, splits = per, -(-rows // per)
    else:
        rows_per_split, splits = row_splits(rows, STAGE_ROWS_WGMMA, tiles, slots)
    return WgmmaPlan(tile_ci, nbp, stages, smem, per_sm, tiles, rows_per_split, splits)


def blocked_dw_plain(z: torch.Tensor, dy: torch.Tensor, kb: int, dc: int) -> torch.Tensor:
    """The contraction as KB einsums (`blocked_dw_reference`): z [B, T, NB,
    Ci], dy [B, T, NB, Co] -> [1, KB, Ci, Co], accumulated in the promoted
    type (float32 for float32 or bfloat16 inputs, float64 for float64)."""
    nb = z.shape[2]
    acc = torch.promote_types(torch.float32, z.dtype)
    zp = F.pad(z.to(acc), (0, 0, dc, kb - 1 - dc))
    dy = dy.to(acc)
    taps = [torch.einsum("btnc,btno->co", zp[:, :, d : d + nb], dy) for d in range(kb)]
    return torch.stack(taps)[None]


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/blocked_dw.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("blocked_dw")
        lib.blocked_dw_forward.restype = ctypes.c_int
        lib.blocked_dw_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.blocked_dw_wgmma.restype = ctypes.c_int
        lib.blocked_dw_wgmma.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.blocked_dw_blocks_per_sm.restype = ctypes.c_int
        lib.blocked_dw_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.blocked_dw_error_string.restype = ctypes.c_char_p
        lib.blocked_dw_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"blocked_dw {what} failed: {lib.blocked_dw_error_string(rc).decode()} ({rc})")


def card_blocks_per_sm(kb: int, device: torch.device, wgmma: bool = False) -> Callable[[int], int]:
    """blocks_per_sm(smem) of the KB instance of the 3xTF32 kernel, or of
    the wgmma one, on `device`, from the CUDA occupancy calculator
    (registers and shared memory), cached."""
    lib = load_library()

    def blocks(smem: int) -> int:
        key = (device.index, kb, smem, wgmma)
        if key not in _occupancy:
            n = ctypes.c_int(0)
            with torch.cuda.device(device):
                rc = lib.blocked_dw_blocks_per_sm(kb, smem, int(wgmma), ctypes.byref(n))
            _check(lib, rc, "occupancy query")
            _occupancy[key] = n.value
        return _occupancy[key]

    return blocks


def _checked(z: torch.Tensor, dy: torch.Tensor, kb: int, dc: int):
    """(rows, NB, Ci, Co) of a CUDA pair the kernels take; raises on any
    other."""
    if z.device.type != "cuda" or dy.device != z.device:
        raise ValueError(f"blocked_dw runs on cpu or cuda tensors, got {z.device} and {dy.device}")
    if z.dtype not in DTYPES or dy.dtype != z.dtype:
        raise ValueError(f"blocked_dw takes two float32 or two bfloat16 tensors, got {z.dtype} and {dy.dtype}")
    if not (z.is_contiguous() and dy.is_contiguous()):
        raise ValueError("blocked_dw takes contiguous [B, T, NB, C] tensors")
    if z.dim() != 4 or dy.dim() != 4 or z.shape[:3] != dy.shape[:3]:
        raise ValueError(f"blocked_dw wants [B, T, NB, C] pairs, got {tuple(z.shape)} and {tuple(dy.shape)}")
    if not (1 <= kb <= MAX_KB and 0 <= dc < kb):
        raise ValueError(f"blocked_dw takes 1 <= KB <= {MAX_KB} and 0 <= dc < KB, got {kb}, {dc}")
    B, T, nb, ci = z.shape
    co = dy.shape[3]
    rows = B * T
    if rows < 1 or nb < 1 or ci < 1 or co < 1:
        raise ValueError(f"blocked_dw got an empty tensor {tuple(z.shape)}, {tuple(dy.shape)}")
    return rows, nb, ci, co


def _launch_mma_sync(z, dy, kb, dc, rows, nb, ci, co) -> torch.Tensor:
    """The 3xTF32 kernel on a checked float32 pair."""
    sm_count = torch.cuda.get_device_properties(z.device).multi_processor_count
    lib = load_library()
    plan = launch_plan(rows, nb, ci, co, kb, sm_count, card_blocks_per_sm(kb, z.device))
    global launches
    out = torch.empty(1, kb, ci, co, dtype=torch.float32, device=z.device)
    part = out if plan.splits == 1 else torch.empty(
        plan.splits, kb, ci, co, dtype=torch.float32, device=z.device
    )
    with torch.cuda.device(z.device):
        rc = lib.blocked_dw_forward(
            z.data_ptr(), dy.data_ptr(), out.data_ptr(), part.data_ptr(),
            rows, nb, ci, co, kb, dc, plan.rows_per_split, plan.splits, plan.stage_rows,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _check(lib, rc, "launch")
    launches += 1
    return out


def _launch_wgmma(z, dy, kb, dc, rows, nb, ci, co) -> torch.Tensor:
    """The bf16 wgmma kernel on a checked pair that `takes_wgmma`."""
    sm_count = torch.cuda.get_device_properties(z.device).multi_processor_count
    lib = load_library()
    plan = wgmma_plan(rows, nb, ci, co, kb, sm_count,
                      card_blocks_per_sm(kb, z.device, wgmma=True))
    global launches_bf16
    out = torch.empty(1, kb, ci, co, dtype=torch.float32, device=z.device)
    # a slot per consumer warpgroup of each split, padded to whole tiles
    part = torch.empty(WGMMA_CONSUMERS * plan.splits, kb, -(-ci // plan.tile_ci) * plan.tile_ci,
                       -(-co // TILE_CO_WGMMA) * TILE_CO_WGMMA, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        rc = lib.blocked_dw_wgmma(
            z.data_ptr(), dy.data_ptr(), out.data_ptr(), part.data_ptr(),
            rows, nb, ci, co, kb, dc, plan.rows_per_split, plan.splits, plan.stages,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    _check(lib, rc, "launch")
    launches_bf16 += 1
    return out


def blocked_dw(z: torch.Tensor, dy: torch.Tensor, kb: int, dc: int) -> torch.Tensor:
    """dW of one blocked freq-conv: z [B, T, NB, Ci], dy [B, T, NB, Co],
    both float32 or both bfloat16 -> [1, KB, Ci, Co] float32.

    CPU tensors run `blocked_dw_plain`.  CUDA tensors launch a kernel or
    raise; they never fall back to the plain version: float32 the 3xTF32
    kernel, bfloat16 the wgmma kernel where `takes_wgmma`, else the 3xTF32
    kernel on float32 copies (by shape, before the launch)."""
    if z.device.type == "cpu" and dy.device.type == "cpu":
        return blocked_dw_plain(z, dy, kb, dc)
    dims = _checked(z, dy, kb, dc)
    if z.dtype == torch.bfloat16:
        if takes_wgmma(z, dy, kb):
            return _launch_wgmma(z, dy, kb, dc, *dims)
        z, dy = z.float(), dy.float()
    return _launch_mma_sync(z, dy, kb, dc, *dims)


def conv_nhwc(z: torch.Tensor, w_hwio: torch.Tensor, pads) -> torch.Tensor:
    """cuDNN conv of NHWC `z` with an HWIO kernel, stride 1, padding
    ((t0, t1), (n0, n1)); NHWC out.  The NCHW tensors cuDNN sees are
    channels-last views of the NHWC ones."""
    (t0, t1), (n0, n1) = pads
    x = F.pad(z.permute(0, 3, 1, 2), (n0, n1, t0, t1))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


class BlockedFreqConv(torch.autograd.Function):
    """Inner blocked freq-conv ([1, KB] kernel, NB padding (dc, KB-1-dc))
    with a custom backward: dX is the mirrored transposed conv (what
    autograd of the conv computes), dW is `blocked_dw`, returned in wb's
    dtype (`_freq_conv_bwd`): under bf16 the float32 dW is rounded to bf16
    here, and the cast that made wb lifts it back to float32."""

    @staticmethod
    def forward(ctx, z, wb, dc: int):
        ctx.save_for_backward(z, wb)
        ctx.dc = dc
        kb = wb.shape[1]
        return conv_nhwc(z, wb, ((0, 0), (dc, kb - 1 - dc)))

    @staticmethod
    def backward(ctx, dy):
        z, wb = ctx.saved_tensors
        dc = ctx.dc
        kb = wb.shape[1]
        dy = dy.contiguous()
        dz = dw = None
        if ctx.needs_input_grad[0]:
            # conv of dy with the tap-flipped, channel-transposed kernel and
            # mirrored padding (`_freq_conv_bwd`)
            w_t = torch.flip(wb, dims=(1,)).transpose(2, 3)
            dz = conv_nhwc(dy, w_t, ((0, 0), (kb - 1 - dc, dc))).to(z.dtype)
        if ctx.needs_input_grad[1]:
            dw = blocked_dw(z.contiguous(), dy, kb, dc).to(wb.dtype)
        return dz, dw, None


def blocked_freq_conv(z: torch.Tensor, wb: torch.Tensor, dc: int) -> torch.Tensor:
    """z [B, T, NB, Ci] (*) wb [1, KB, Ci, Co] -> [B, T, NB, Co], with
    `blocked_dw` in the backward."""
    return BlockedFreqConv.apply(z, wb, dc)
