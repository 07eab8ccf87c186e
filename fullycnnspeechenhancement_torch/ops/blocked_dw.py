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
it.  `blocked_dw` is the kernel's wrapper: on a CPU tensor it runs
`blocked_dw_plain`, the same contraction as einsums; on a CUDA tensor it
launches the kernel (building it on first use) or raises.  `launches`
counts kernel launches.

`blocked_freq_conv` is the autograd Function around the raw blocked conv
(JAX's `custom_vjp`): the forward and dX are cuDNN convs, dW is
`blocked_dw`.  Its tensors keep the JAX layout; NCHW exists only as a
channels-last view handed to cuDNN.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.ops import build

TILE = 64  # ci and co per block (csrc/blocked_dw.cu kTile)
MAX_KB = 8  # taps the kernel is instantiated for
STAGE_SMEM_BYTES = 48 * 1024  # shared memory aimed at for one block's stage
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
MAX_STAGE_ROWS = 4
WAVES = 4  # blocks aimed at per SM, over all row splits

# Kernel launches since the count was last set to 0.
launches = 0

_lib: Optional[ctypes.CDLL] = None


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
        lib.blocked_dw_error_string.restype = ctypes.c_char_p
        lib.blocked_dw_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def launch_plan(rows: int, nb: int, ci: int, co: int, kb: int, sm_count: int):
    """(stage_rows, rows_per_split, splits) for the kernel: as many rows per
    shared-memory stage as fit STAGE_SMEM_BYTES (at most MAX_STAGE_ROWS),
    and enough row splits that the (ci, co) tiles times the splits give
    about WAVES blocks per SM, each split at least one stage long."""
    per_row = 4 * (2 * nb + kb - 1) * TILE
    if per_row > SMEM_BYTES:
        raise ValueError(f"blocked_dw: NB={nb} needs {per_row} B of shared memory per row")
    stage_rows = max(1, min(MAX_STAGE_ROWS, STAGE_SMEM_BYTES // per_row))
    tiles = -(-ci // TILE) * -(-co // TILE)
    splits = max(1, min(-(-rows // stage_rows), -(-WAVES * sm_count // tiles)))
    rows_per_split = -(-rows // splits)
    rows_per_split = -(-rows_per_split // stage_rows) * stage_rows
    return stage_rows, rows_per_split, -(-rows // rows_per_split)


def blocked_dw(z: torch.Tensor, dy: torch.Tensor, kb: int, dc: int) -> torch.Tensor:
    """dW of one blocked freq-conv: z [B, T, NB, Ci], dy [B, T, NB, Co] ->
    [1, KB, Ci, Co] float32.

    CPU tensors run `blocked_dw_plain`.  CUDA tensors launch the CUDA
    kernel or raise; they never fall back to the plain version."""
    if z.device.type == "cpu" and dy.device.type == "cpu":
        return blocked_dw_plain(z, dy, kb, dc)
    if z.device.type != "cuda" or dy.device != z.device:
        raise ValueError(f"blocked_dw runs on cpu or cuda tensors, got {z.device} and {dy.device}")
    if z.dtype != torch.float32 or dy.dtype != torch.float32:
        raise ValueError("blocked_dw takes float32 tensors")
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
    sm_count = torch.cuda.get_device_properties(z.device).multi_processor_count
    stage_rows, rows_per_split, splits = launch_plan(rows, nb, ci, co, kb, sm_count)
    global launches
    lib = load_library()
    out = torch.empty(1, kb, ci, co, dtype=torch.float32, device=z.device)
    part = out if splits == 1 else torch.empty(
        splits, kb, ci, co, dtype=torch.float32, device=z.device
    )
    with torch.cuda.device(z.device):
        rc = lib.blocked_dw_forward(
            z.data_ptr(), dy.data_ptr(), out.data_ptr(), part.data_ptr(),
            rows, nb, ci, co, kb, dc, rows_per_split, splits, stage_rows,
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"blocked_dw launch failed: {lib.blocked_dw_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return out


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
    autograd of the conv computes), dW is `blocked_dw`."""

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
