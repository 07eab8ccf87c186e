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

Each wrapper runs its plain torch version on a CPU tensor and launches its
kernel (building it on first use) on a CUDA tensor, or raises; it never
falls back.  `launches` and `stack_launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fullycnnspeechenhancement_torch.ops import build

MAX_K = 13  # taps the kernels are instantiated for
MAX_TILE = 256  # positions per staged tile of freq_conv
SMEM_BYTES = 232_448  # the most shared memory one Hopper block can use
SLACK = 4  # floats after the last staged row (csrc/freq_conv.cu kSlack)
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


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/freq_conv.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("freq_conv")
        lib.freq_conv_forward.restype = ctypes.c_int
        lib.freq_conv_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.freq_conv_stack_forward.restype = ctypes.c_int
        lib.freq_conv_stack_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_void_p,
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


def _empty_in_order_of(x: torch.Tensor, shape) -> torch.Tensor:
    """An uninitialised tensor of `shape` whose dimensions lie in memory in
    the order of x's strides (outermost first)."""
    order = sorted(range(x.dim()), key=lambda i: x.stride(i), reverse=True)
    buf = torch.empty([shape[i] for i in order], dtype=x.dtype, device=x.device)
    return buf.permute([order.index(i) for i in range(x.dim())])


def _raise_on(lib, name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.freq_conv_error_string(rc).decode()} ({rc})")


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
    K, C, D = w.shape
    B, R, P, _ = x.shape
    lo = _lo(K, lo)
    if not 1 <= K <= MAX_K or dilation < 1:
        raise ValueError(f"freq_conv takes 1 <= K <= {MAX_K} taps and dilation >= 1, got {K}, {dilation}")
    if min(B, R, P, C, D) < 1:
        raise ValueError(f"freq_conv got an empty tensor {tuple(x.shape)}, {tuple(w.shape)}")
    if period < 0 or (period and not 0 <= valid <= period):
        raise ValueError(f"freq_conv takes period >= 0 and 0 <= valid <= period, got {period}, {valid}")
    tile = min(P, MAX_TILE)
    d4 = (D + 3) // 4 * 4
    smem = 4 * (C * K * d4 + C * (tile + (K - 1) * dilation) + SLACK)
    if smem > SMEM_BYTES:
        raise ValueError(f"freq_conv: C={C}, D={D}, K={K}, dilation={dilation} need {smem} B of shared memory")
    y = _empty_in_order_of(x, (B, R, P, D))
    geom = np.array(
        [B, R, P, C, D, *x.stride(), *y.stride(), *w.stride(),
         lo, dilation, int(circular), period, valid, int(relu), tile],
        dtype=np.int64,
    )
    global launches
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.freq_conv_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), geom.ctypes.data, K, scale,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, "freq_conv", rc)
    launches += 1
    return y


def freq_conv_stack(
    x: torch.Tensor, w: torch.Tensor, depth: int, *, frame: int = FRAME, valid: int = VALID,
    scale: float = 1.0,
) -> torch.Tensor:
    """`depth` chained layers on the flat roll layout: x [C, N] (contiguous),
    w [K, C, C] (any strides) -> [C, N] contiguous.  Each layer is the TF
    SAME tap window (lo = (K - 1) // 2) circular over N, then masks lanes
    n % frame >= valid to 0, applies ReLU and multiplies by `scale`.

    A CPU tensor runs `freq_conv_stack_plain`.  A CUDA tensor launches the
    CUDA kernel or raises; it never falls back to the plain version."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return freq_conv_stack_plain(x, w, depth, frame=frame, valid=valid, scale=scale)
    _check_cuda("freq_conv_stack", x, w)
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
    c4 = (C + 3) // 4 * 4
    smem = 4 * (C * K * c4 + 2 * (C * (valid + K - 1) + SLACK))
    if smem > SMEM_BYTES:
        raise ValueError(f"freq_conv_stack: C={C}, K={K} need {smem} B of shared memory")
    y = torch.empty_like(x)
    global stack_launches
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.freq_conv_stack_forward(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), C, N, frame, valid, K, lo, depth,
            *w.stride(), scale, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(lib, "freq_conv_stack", rc)
    stack_launches += 1
    return y
