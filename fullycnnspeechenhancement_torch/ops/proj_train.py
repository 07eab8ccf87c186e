"""The final (1, kw) projection of the blocked training step, forward and
backward, in hand-written CUDA kernels.

It replaces no Pallas kernel: the JAX package leaves the projection to
XLA.  In `models/blocked.py::apply_blocked` the last layer of every
variant (V1, V2, V3) is a (1, 129) conv of the last inner layer's output z
[B, T, NB, fb*C] (the blocked layout, whose memory is [B, T, NB*fb, C]
with the pad band past the real bins zero) to one channel:

    y[b, t, f] = bias + sum_{f', c} z[b, t, f', c] w[0, c, 0, f' - f + lo]

with TF SAME padding (lo = (kw - 1) // 2 taps before, taps outside the
kernel zero), returned as [B, T, F, 1].  On the card in bf16 that was a
cuDNN conv of a padded channels-last copy, about half of a training step's
device time; here it is `csrc/proj_train.cu` (the source says what bounds
it and how its design answers): a forward kernel, a dX kernel that writes
the gradient straight into the blocked layout with its pad band zero, and
a dW kernel that sums dW and the bias's gradient in one pass, with a small
kernel that adds its partial sums in a fixed order.

`proj_train` is the entry point for the bf16 compute dtype.  On a CPU
tensor it runs `proj_plain`, the conv as `apply_blocked` ran it before the
kernels, bit for bit.  On a CUDA tensor it runs the autograd Function
`_Proj`, whose forward and backward are the kernels, or raises, never
falling back.  `apply_blocked` sends float32 (and float64) to `proj_plain`
itself, by an explicit dtype test: that keeps cuDNN's route in full
float32 (no instance of the kernels takes float32).

`proj_toeplitz` is the kernels' formulation in plain PyTorch: flattening
(f', c) into k = f' * C + c makes the projection a product with one
Toeplitz band, whose tap at (k, f) is wflat[k - f * C + lo * C] with
wflat[j * C + c] = w[0, c, 0, j] (zero outside [0, kw * C)) and rows of
the pad band zero.  Its autograd gives dX = dy @ band^T and dW as the
band's diagonal sums of z^T @ dy, as the kernels compute them; the tests
hold it to `proj_plain` in float64.

`launches_fwd`, `launches_dx` and `launches_dw` count the calls that
launch each kernel on the card (dW's call launches its kernel and the
partial sums' kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fullycnnspeechenhancement_torch.models.blocks import tf_same_pads
from fullycnnspeechenhancement_torch.ops import build
from fullycnnspeechenhancement_torch.ops.blocked_dw import conv_nhwc

TILES = 17  # csrc kTiles: n8 tiles over the output bins, so 128 < F <= 136
MAX_CHANNELS = 64  # csrc: C even, 2 <= C <= 64
DW_COLS = 128  # csrc kDwCols: z columns (k = f' * C + c) of a dW block
DW_ROWS = 32  # csrc kDwRows: rows of a dW stage
DW_BLOCKS_PER_SM = 2  # dW blocks aimed at per SM (its launch bounds)

# Calls that launched each kernel on the card since the counts were last set to 0.
launches_fwd = 0
launches_dx = 0
launches_dw = 0

_lib: Optional[ctypes.CDLL] = None


def proj_plain(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor, f_dim: int) -> torch.Tensor:
    """The projection as `apply_blocked` ran it before the kernels: z [B, T,
    NB, fb*C] unblocked to [B, T, f_dim, C], a conv through `conv_nhwc` (cuDNN
    on the card) with w [Cout, C, 1, kw] (OIHW, z's dtype) and TF SAME
    padding, then the bias b [Cout] -> [B, T, f_dim, Cout]."""
    B, T = z.shape[:2]
    cin = w.shape[1]
    xn = z.reshape(B, T, -1, cin)[:, :, :f_dim, :]
    y = conv_nhwc(xn, w.permute(2, 3, 1, 0), tf_same_pads(tuple(w.shape[2:])))
    return y + b


def band(w: torch.Tensor, positions: int, f_dim: int) -> torch.Tensor:
    """The Toeplitz band [positions * C, f_dim] of w [1, C, 1, kw]: tap
    wflat[k - f * C + lo * C] at (k, f), rows of the pad band (k >= f_dim *
    C) zero.  A gather from w, so differentiable in w."""
    C, kw = w.shape[1], w.shape[3]
    lo = (kw - 1) // 2
    k = torch.arange(positions * C, device=w.device)[:, None]
    idx = k - torch.arange(f_dim, device=w.device)[None, :] * C + lo * C
    live = (idx >= 0) & (idx < kw * C) & (k < f_dim * C)
    wflat = w[0, :, 0, :].t().reshape(-1)  # [kw * C]: j * C + c
    return torch.where(live, wflat[idx.clamp(0, kw * C - 1)], wflat.new_zeros(()))


def proj_toeplitz(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor, f_dim: int) -> torch.Tensor:
    """`proj_plain` as the kernels formulate it: z [B, T, NB, fb*C] as [rows,
    positions * C] times `band` (one output channel) plus the bias."""
    B, T, nb, fc = z.shape
    positions = nb * fc // w.shape[1]
    y = z.reshape(B * T, -1) @ band(w, positions, f_dim) + b
    return y.reshape(B, T, f_dim, 1)


def proj_train(z: torch.Tensor, w: torch.Tensor, b: torch.Tensor, f_dim: int) -> torch.Tensor:
    """The projection of z [B, T, NB, fb*C] (bf16) with w [1, C, 1, kw] and
    b [1] in z's dtype -> [B, T, f_dim, 1].  A CPU tensor runs `proj_plain`;
    a CUDA tensor the kernels, or raises."""
    if z.device.type == "cpu":
        return proj_plain(z, w, b, f_dim)
    w, b = w.contiguous(), b.contiguous()
    return _Proj.apply(z, w, b, _checked(z, w, b, f_dim))


class Dims(NamedTuple):
    """A launch's shape: rows B*T, channels C, positions NB*fb, real bins
    f_dim, taps kw and lo = (kw - 1) // 2 before the centre."""

    rows: int
    channels: int
    positions: int
    f_dim: int
    kw: int
    lo: int


class _Proj(torch.autograd.Function):
    """y = the projection of z; the backward is dX and dW, db by the
    kernels, returned in w's and b's dtype (the compute dtype, as
    `BlockedFreqConv` returns its dW), which the casts in `apply_blocked`
    lift to float32.  Saves z, w: no copy of an activation."""

    @staticmethod
    def forward(ctx, z, w, b, dims: Dims):
        ctx.save_for_backward(z, w)
        ctx.dims = dims
        return forward(z, w, b, dims)

    @staticmethod
    def backward(ctx, dy):
        z, w = ctx.saved_tensors
        dims = ctx.dims
        dy = dy.contiguous()
        if dy.data_ptr() % 16:
            dy = dy.clone()
        dz = dw = db = None
        if ctx.needs_input_grad[0]:
            dz = grad_input(dy, w, dims).reshape(z.shape)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = grad_weight(z, dy, dims)
            dw = dw.reshape(w.shape)
        return dz, dw, db, None


def forward(z, w, b, dims: Dims) -> torch.Tensor:
    """y [B, T, f_dim, 1] = the projection of z, rounded once to bf16."""
    global launches_fwd
    B, T = z.shape[:2]
    y = torch.empty(B, T, dims.f_dim, 1, dtype=z.dtype, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        rc = lib.proj_train_forward(z.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), *dims, _stream(z))
    _raise_on(lib, rc, "forward")
    launches_fwd += 1
    return y


def grad_input(dy, w, dims: Dims) -> torch.Tensor:
    """dz [rows, positions * C]: dy against the band's transpose, the pad
    band 0."""
    global launches_dx
    dz = torch.empty(dims.rows, dims.positions * dims.channels, dtype=dy.dtype, device=dy.device)
    lib = load_library()
    with torch.cuda.device(dy.device):
        rc = lib.proj_train_grad_input(dy.data_ptr(), w.data_ptr(), dz.data_ptr(), *dims, _stream(dy))
    _raise_on(lib, rc, "grad input")
    launches_dx += 1
    return dz


class DwPlan(NamedTuple):
    """How a dW launch covers its problem: `tiles` blocks of DW_COLS
    columns by `splits` row splits of `rows_per_split` rows."""

    tiles: int
    rows_per_split: int
    splits: int


def dw_plan(rows: int, columns: int, sm_count: int) -> DwPlan:
    """The splits whose tiles x splits blocks about fill DW_BLOCKS_PER_SM
    blocks on each of `sm_count` SMs, whole stages of DW_ROWS rows each; a
    function of the shape and the card alone, so the sums' order is too."""
    tiles = -(-columns // DW_COLS)
    want = max(1, DW_BLOCKS_PER_SM * sm_count // tiles)
    per = -(-rows // want)
    per = -(-per // DW_ROWS) * DW_ROWS
    return DwPlan(tiles, per, -(-rows // per))


def grad_weight(z, dy, dims: Dims):
    """(dw [C, kw], db [1]) in bf16: float32 sums over every row, added in a
    fixed order."""
    global launches_dw
    C, kw = dims.channels, dims.kw
    sm_count = torch.cuda.get_device_properties(z.device).multi_processor_count
    plan = dw_plan(dims.rows, dims.positions * C, sm_count)
    part = torch.empty(plan.splits * plan.tiles, kw * C, dtype=torch.float32, device=z.device)
    part_db = torch.empty(plan.splits, dtype=torch.float32, device=z.device)
    dw = torch.empty(C, kw, dtype=z.dtype, device=z.device)
    db = torch.empty(1, dtype=z.dtype, device=z.device)
    lib = load_library()
    with torch.cuda.device(z.device):
        rc = lib.proj_train_grad_weight(
            z.data_ptr(), dy.data_ptr(), part.data_ptr(), part_db.data_ptr(), dw.data_ptr(), db.data_ptr(), *dims,
            plan.rows_per_split, plan.splits, _stream(z),
        )
    _raise_on(lib, rc, "grad weight")
    launches_dw += 1
    return dw, db


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/proj_train.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("proj_train")
        p, i = ctypes.c_void_p, ctypes.c_int
        signatures = {
            "proj_train_forward": [p] * 4 + [i] * 6 + [p],
            "proj_train_grad_input": [p] * 3 + [i] * 6 + [p],
            "proj_train_grad_weight": [p] * 6 + [i] * 8 + [p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.proj_train_error_string.restype = ctypes.c_char_p
        lib.proj_train_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _checked(z, w, b, f_dim: int) -> Dims:
    """The Dims of a CUDA call the kernels take; raises on any other: z
    [B, T, NB, fb*C] bf16, contiguous and 16-byte aligned, with NB*fb >=
    f_dim; w [1, C, 1, kw] and b [1] bf16 on z's device; C even and at
    most MAX_CHANNELS; (TILES - 1) * 8 < f_dim <= TILES * 8;
    NB*fb*C a multiple of 8; kw >= 1 with (kw - 1) // 2 < f_dim."""
    if z.device.type != "cuda":
        raise ValueError(f"proj_train runs on cpu or cuda tensors, not {z.device}")
    if z.dim() != 4 or w.dim() != 4 or w.shape[0] != 1 or w.shape[2] != 1 or b.shape != (1,):
        raise ValueError(f"proj_train wants z [B, T, NB, fb*C], w [1, C, 1, kw] and b [1], got {tuple(z.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    for name, t in (("z", z), ("w", w), ("b", b)):
        if t.dtype != torch.bfloat16 or t.device != z.device:
            raise ValueError(f"proj_train takes bfloat16 tensors on one card, got {name} {t.dtype} on {t.device}")
    B, T, nb, fc = z.shape
    C, kw = w.shape[1], w.shape[3]
    if fc % C or C % 2 or not 2 <= C <= MAX_CHANNELS:
        raise ValueError(f"proj_train takes an even C <= {MAX_CHANNELS} that divides fb*C, got C = {C}, "
                         f"fb*C = {fc}")
    positions, lo = nb * fc // C, (kw - 1) // 2
    if not (TILES - 1) * 8 < f_dim <= min(TILES * 8, positions) or positions * C % 8 or lo >= f_dim:
        raise ValueError(f"proj_train takes {(TILES - 1) * 8} < F <= {TILES * 8} real bins of NB*fb "
                         f"positions (NB*fb*C a multiple of 8) and kw < 2F, got F = {f_dim}, NB*fb = {positions}, "
                         f"C = {C}, kw = {kw}")
    if not z.is_contiguous() or z.data_ptr() % 16:
        raise ValueError("proj_train takes a contiguous, 16-byte aligned z on the card")
    if B * T < 1:
        raise ValueError(f"proj_train got an empty z {tuple(z.shape)}")
    return Dims(B * T, C, positions, f_dim, kw, lo)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"proj_train {what} failed: {lib.proj_train_error_string(rc).decode()} ({rc})")
