"""The chain after each batch-normalised conv of the blocked training step,
forward and backward, in hand-written CUDA kernels.

It replaces no Pallas kernel: the JAX package leaves the chain to XLA.  In
`models/blocked.py::apply_blocked` every BN layer's conv output y (before
its bias, in the blocked layout [B, T, NB, fb*C]) goes through

    x = y + b;  (mean, var) = masked moments of x over (B, T, real bins);
    out = act(x * scale + shift + skip) + add, the pad band zeroed

with `scale`, `shift` from `models/blocks.py::bn_scale_shift`, the skip
before the ReLU (V1/V2) and the residual after it (V3).  On the card that
was one PyTorch kernel per operation, and autograd's backward one or more
per gradient, most of a training step's device time; here it is
`csrc/bn_chain.cu` (the source says what bounds it and how its design
answers): two passes forward (the moments, then the output) and two
backward (the gradient's per-channel sums, then the input gradients), each
a kernel that reads its operands once, plus a small kernel that adds a
reduction's partial sums in a fixed order.

`bn_chain` is the entry point.  On a CPU tensor it runs `chain_plain`, the
chain as PyTorch operations (what `apply_blocked` ran before, bit for bit,
which the parity tests hold to the JAX package).  On a CUDA tensor it runs
`chain_closed_form`, or raises, never falling back: the moments, then the
autograd Function `_Chain`, whose backward is the closed form

    gh = g where the ReLU passed (0 in the pad band)
    G1 = sum gh,  G2 = sum gh * xhat   (every frame, real bins; xhat =
                                        (x - mean) * rstd)
    dx = scale * (gh - m / n * (G1 + xhat * G2))
    dgamma = G2,  dbeta = G1,  db = sum dx,  dskip = gh,  dadd = g

(dskip, dadd and dx 0 in the pad band), with m the frame mask on real bins and n its sum.  Under data parallelism
S1, S2 and n go through one all-reduce, as in `moments_from_sums`, and G1,
G2 through the same `reduce`, as the plain chain's autograd does; dgamma,
dbeta and db are this rank's (the step sums them over the ranks).  `chain_closed_form`
runs the same Function on a CPU tensor with the kernels' plain twins
(`moments_twin`, `apply_twin`, `grad_sums_twin`, `grad_apply_twin`), which
the tests hold to autograd of `chain_plain` in float64.

`launches_moments`, `launches_apply`, `launches_grad_sums` and
`launches_grad_apply` count the calls that launch each stage on the card
(a reduction's call launches its kernel and the partial sums' kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from fullycnnspeechenhancement_torch.models.blocks import (
    BN_EPSILON,
    bn_scale_shift,
    moments_from_sums,
    updated_bn_state,
)
from fullycnnspeechenhancement_torch.ops import build

MAX_CHANNELS = 64  # csrc kMaxChannels
REDUCE_BLOCKS = 528  # reduction blocks aimed at: 4 of 256 threads on each of an H100's 132 SMs
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Calls that launched each stage on the card since the counts were last set to 0.
launches_moments = 0
launches_apply = 0
launches_grad_sums = 0
launches_grad_apply = 0

_lib: Optional[ctypes.CDLL] = None


class Batch(NamedTuple):
    """What every layer of one blocked forward shares.  `f_dim` real bins
    of NB * fb; `mask4` [1, 1, NB, fb] in the compute dtype, 1 on real
    bins; in training mode also the frame mask ([B, T], [1, T] or None),
    `m_bn` [rows, T, NB, fb, 1] (the two masks' product, in at least
    float32), `n` the masked (frame, real bin) positions a channel on this
    rank, a 0-d tensor of m_bn's dtype."""

    f_dim: int
    mask4: torch.Tensor
    frame_mask: Optional[torch.Tensor] = None
    m_bn: Optional[torch.Tensor] = None
    n: Optional[torch.Tensor] = None


def make_batch(B: int, T: int, f_dim: int, fb: int, dtype, device, *, is_training: bool,
               frame_mask=None) -> Batch:
    """The Batch of a forward over [B, T, f_dim] with the compute dtype
    `dtype`; `frame_mask` ([B, T] or [1, T], which stays broadcast)
    restricts the BN moments to its frames."""
    nb = -(-f_dim // fb)
    mask4 = (torch.arange(nb * fb, device=device) < f_dim).to(dtype).reshape(1, 1, nb, fb)
    if not is_training:
        return Batch(f_dim, mask4)
    mdt = torch.promote_types(torch.float32, dtype)
    m_bn = mask4.to(mdt)[..., None]  # [1, 1, NB, fb, 1]
    if frame_mask is None:
        n = torch.tensor(float(B * T * f_dim), dtype=mdt, device=device)
    else:
        # [1, T] batch-max masks stay broadcast; the denominator scales by
        # the broadcast factor.
        fm = frame_mask.to(mdt)
        m_bn = m_bn * fm[:, :, None, None, None]
        n = fm.sum() * f_dim * (B // frame_mask.shape[0])
    return Batch(f_dim, mask4, frame_mask, m_bn, n)


def chain_plain(y, p, state, batch: Batch, *, use_norm=True, is_training=True, skip=None, add=None,
                relu=True, reduce=None):
    """The chain as PyTorch operations: y [B, T, NB, fb*C] (the conv output
    before its bias) -> (out, the layer's new BN state, or None where the
    state does not change: eval mode, no BN)."""
    B, T, nb, fc = y.shape
    cout = p["b"].shape[0]
    fb = fc // cout
    dt = y.dtype
    y = y + p["b"].repeat(fb).to(dt)
    new_state = None
    if use_norm:
        if is_training:
            # Masked biased moments over (B, T, real F) per canonical
            # channel, in at least float32.
            y32 = y.to(batch.m_bn.dtype).reshape(B, T, nb, fb, cout)
            mean, var = moments_from_sums(
                (y32 * batch.m_bn).sum(dim=(0, 1, 2, 3)), (y32 * y32 * batch.m_bn).sum(dim=(0, 1, 2, 3)),
                batch.n, reduce,
            )
            new_state = updated_bn_state(state, mean, var)
        else:
            mean, var = state["mean"], state["var"]
        scale, shift = bn_scale_shift(p, mean, var)
        y = y * scale.repeat(fb).to(dt) + shift.repeat(fb).to(dt)
    if skip is not None:
        y = y + skip
    if relu:
        y = torch.relu(y)
    if add is not None:
        y = y + add
    # Re-zero the pad band so the next layer's neighbour-block taps and the
    # next BN's masked sums read true zeros.
    y = (y.reshape(B, T, nb, fb, cout) * batch.mask4[..., None]).reshape(B, T, nb, fb * cout)
    return y, new_state


def bn_chain(y, p, state, batch: Batch, *, skip=None, add=None, relu=True, reduce=None):
    """One BN layer's training chain: y [B, T, NB, fb*C] (the conv output
    before its bias, the compute dtype) -> (out, new BN state).  A CPU
    tensor runs `chain_plain`; a CUDA tensor the kernels, or raises."""
    if y.device.type == "cpu":
        return chain_plain(y, p, state, batch, skip=skip, add=add, relu=relu, reduce=reduce)
    return chain_closed_form(y, p, state, batch, skip=skip, add=add, relu=relu, reduce=reduce)


def chain_closed_form(y, p, state, batch: Batch, *, skip=None, add=None, relu=True, reduce=None):
    """`bn_chain` through the moments and `_Chain`: the kernels on a CUDA
    tensor, their plain twins on a CPU tensor."""
    y, skip, add = (None if t is None else t.contiguous() for t in (y, skip, add))
    _check(y, p, skip, add)
    with torch.no_grad():
        s = moments(y, p["b"], batch)
        total, n_all = s, batch.n
        if reduce is not None:
            # The one all-reduce of S1, S2 and n that `moments_from_sums`
            # makes, made here so that the backward has the count over
            # every rank.
            summed = reduce(torch.cat([s.reshape(-1), batch.n.reshape(1).to(s.dtype)]))
            total, n_all = summed[:-1].reshape(s.shape), summed[-1]
        mean, var = moments_from_sums(total[0], total[1], n_all)
        new_state = updated_bn_state(state, mean, var)
    out = _Chain.apply(y, p["b"], p["gamma"], p["beta"], skip, add, mean, var, s[0], n_all, batch, relu, reduce)
    return out, new_state


class _Chain(torch.autograd.Function):
    """out = the chain's output from y, given the batch's mean and var;
    the backward is the closed form through the masked moments (module
    docstring).  Saves y, the skip source and per-channel tensors: no copy
    of an activation."""

    @staticmethod
    def forward(ctx, y, b, gamma, beta, skip, add, mean, var, s1, n_all, batch, relu, reduce):
        out = apply_chain(y, b, gamma, beta, mean, var, skip, add, relu, batch.f_dim)
        ctx.save_for_backward(y, b, gamma, beta, skip, mean, var, s1, n_all)
        ctx.batch, ctx.relu, ctx.reduce, ctx.has_add = batch, relu, reduce, add is not None
        return out

    @staticmethod
    def backward(ctx, g):
        y, b, gamma, beta, skip, mean, var, s1, n_all = ctx.saved_tensors
        batch, reduce = ctx.batch, ctx.reduce
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        local = grad_sums(g, y, skip, b, gamma, beta, mean, var, ctx.relu, batch.f_dim)
        total = local if reduce is None else reduce(local.reshape(-1)).reshape(local.shape)
        dy, dskip, db = grad_apply(g, y, skip, b, gamma, beta, mean, var, local, total, s1, n_all, batch, ctx.relu)
        dadd = None
        if ctx.has_add:
            B, T, nb, fc = g.shape
            fb = batch.mask4.shape[-1]
            dadd = (g.reshape(B, T, nb, fb, fc // fb) * batch.mask4[..., None]).reshape(g.shape)
        return (dy, db.to(b.dtype), local[1].to(gamma.dtype), local[0].to(beta.dtype), dskip, dadd,
                None, None, None, None, None, None, None)


# --- the four stages: a kernel on a CUDA tensor, the plain twin on a CPU one


def moments(y, b, batch: Batch) -> torch.Tensor:
    """[2, C]: S1, S2 of x = y + b over the real bins, each row weighted by
    the frame mask (at least float32)."""
    global launches_moments
    if y.device.type == "cpu":
        return moments_twin(y, b, batch)
    rows, T, C, positions = _layout(y, b)
    fm, mask_rows = _frame_mask(batch, y)
    rows_per_block, blocks = reduce_plan(rows)
    partial = torch.empty(blocks, 2, C, dtype=torch.float32, device=y.device)
    sums = torch.empty(2, C, dtype=torch.float32, device=y.device)
    lib = load_library()
    with torch.cuda.device(y.device):
        rc = lib.bn_chain_moments(
            y.data_ptr(), b.data_ptr(), _ptr(fm), partial.data_ptr(), sums.data_ptr(), _DTYPE_CODES[y.dtype],
            rows, T, mask_rows, C, positions, batch.f_dim, rows_per_block, _stream(y),
        )
    _raise_on(lib, rc, "moments")
    launches_moments += 1
    return sums


def apply_chain(y, b, gamma, beta, mean, var, skip, add, relu: bool, f_dim: int) -> torch.Tensor:
    """The chain's output, y's shape and dtype: act((y + b) * scale + shift
    + skip) + add on the real bins, rounded once; 0 in the pad band."""
    global launches_apply
    if y.device.type == "cpu":
        return apply_twin(y, b, gamma, beta, mean, var, skip, add, relu, f_dim)
    rows, T, C, positions = _layout(y, b)
    out = torch.empty_like(y)
    lib = load_library()
    with torch.cuda.device(y.device):
        rc = lib.bn_chain_apply(
            y.data_ptr(), _ptr(skip), _ptr(add), out.data_ptr(), b.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), mean.data_ptr(), var.data_ptr(), _DTYPE_CODES[y.dtype], rows, T, C, positions,
            f_dim, int(relu), _stream(y),
        )
    _raise_on(lib, rc, "apply")
    launches_apply += 1
    return out


def grad_sums(g, y, skip, b, gamma, beta, mean, var, relu: bool, f_dim: int) -> torch.Tensor:
    """[2, C]: G1 = sum gh, G2 = sum gh * xhat over every row's real bins."""
    global launches_grad_sums
    if y.device.type == "cpu":
        return grad_sums_twin(g, y, skip, b, gamma, beta, mean, var, relu, f_dim)
    rows, T, C, positions = _layout(y, b)
    rows_per_block, blocks = reduce_plan(rows)
    partial = torch.empty(blocks, 2, C, dtype=torch.float32, device=y.device)
    sums = torch.empty(2, C, dtype=torch.float32, device=y.device)
    lib = load_library()
    with torch.cuda.device(y.device):
        rc = lib.bn_chain_grad_sums(
            g.data_ptr(), y.data_ptr(), _ptr(skip), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            mean.data_ptr(), var.data_ptr(), partial.data_ptr(), sums.data_ptr(), _DTYPE_CODES[y.dtype], rows,
            T, C, positions, f_dim, int(relu), rows_per_block, _stream(y),
        )
    _raise_on(lib, rc, "grad sums")
    launches_grad_sums += 1
    return sums


def grad_apply(g, y, skip, b, gamma, beta, mean, var, local, total, s1, n_all, batch: Batch, relu: bool):
    """(dy, dskip or None, db): the input gradients from this rank's sums
    `local`, every rank's `total`, this rank's forward S1 `s1` and the
    masked count over every rank `n_all` (0-d)."""
    global launches_grad_apply
    if y.device.type == "cpu":
        return grad_apply_twin(g, y, skip, b, gamma, beta, mean, var, local, total, s1, n_all, batch, relu)
    rows, T, C, positions = _layout(y, b)
    fm, mask_rows = _frame_mask(batch, y)
    dy = torch.empty_like(y)
    dskip = None if skip is None else torch.empty_like(y)
    db = torch.empty(C, dtype=torch.float32, device=y.device)
    lib = load_library()
    with torch.cuda.device(y.device):
        rc = lib.bn_chain_grad_apply(
            g.data_ptr(), y.data_ptr(), _ptr(skip), dy.data_ptr(), _ptr(dskip), _ptr(fm), b.data_ptr(),
            gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(), var.data_ptr(), local.data_ptr(),
            total.data_ptr(), s1.data_ptr(), batch.n.data_ptr(), n_all.data_ptr(), db.data_ptr(),
            _DTYPE_CODES[y.dtype], rows, T, mask_rows, C, positions, batch.f_dim, int(relu), _stream(y),
        )
    _raise_on(lib, rc, "grad apply")
    launches_grad_apply += 1
    return dy, dskip, db


# --- the plain twins: the kernels' arithmetic in PyTorch, at least float32


def _work(y, b, f_dim):
    """x = y + b on the real bins, [B, T, f_dim, C] in at least float32."""
    B, T = y.shape[:2]
    C = b.shape[0]
    mdt = torch.promote_types(torch.float32, y.dtype)
    return y.reshape(B, T, -1, C)[:, :, :f_dim].to(mdt) + b.to(mdt), mdt


def _weights(batch: Batch, mdt):
    """The frame mask as [rows, T, 1, 1] weights, or None."""
    if batch.frame_mask is None:
        return None
    return batch.frame_mask.to(mdt)[:, :, None, None]


def _norm(gamma, beta, mean, var, mdt):
    rstd = torch.rsqrt(var.to(mdt) + BN_EPSILON)
    scale = gamma.to(mdt) * rstd
    return rstd, scale, beta.to(mdt) - mean.to(mdt) * scale


def _real(t, f_dim, C, mdt):
    B, T = t.shape[:2]
    return t.reshape(B, T, -1, C)[:, :, :f_dim].to(mdt)


def _padded(real, like):
    """[B, T, f_dim, C] -> like's shape and dtype, zeros in the pad band."""
    B, T, f_dim, C = real.shape
    out = real.new_zeros(B, T, like.shape[2] * like.shape[3] // C, C)
    out[:, :, :f_dim] = real
    return out.reshape(like.shape).to(like.dtype)


def _pre_act(x, scale, shift, skip, f_dim, mdt):
    u = x * scale + shift
    return u if skip is None else u + _real(skip, f_dim, x.shape[3], mdt)


def moments_twin(y, b, batch: Batch) -> torch.Tensor:
    x, mdt = _work(y, b, batch.f_dim)
    w = _weights(batch, mdt)
    xm = x if w is None else x * w
    return torch.stack([xm.sum(dim=(0, 1, 2)), (xm * x).sum(dim=(0, 1, 2))])


def apply_twin(y, b, gamma, beta, mean, var, skip, add, relu: bool, f_dim: int) -> torch.Tensor:
    x, mdt = _work(y, b, f_dim)
    _, scale, shift = _norm(gamma, beta, mean, var, mdt)
    u = _pre_act(x, scale, shift, skip, f_dim, mdt)
    if relu:
        u = torch.relu(u)
    if add is not None:
        u = u + _real(add, f_dim, x.shape[3], mdt)
    return _padded(u, y)


def _passed(g, x, scale, shift, skip, relu, f_dim, mdt):
    gr = _real(g, f_dim, x.shape[3], mdt)
    if not relu:
        return gr
    return torch.where(_pre_act(x, scale, shift, skip, f_dim, mdt) > 0, gr, 0.0)


def grad_sums_twin(g, y, skip, b, gamma, beta, mean, var, relu: bool, f_dim: int) -> torch.Tensor:
    x, mdt = _work(y, b, f_dim)
    rstd, scale, shift = _norm(gamma, beta, mean, var, mdt)
    gh = _passed(g, x, scale, shift, skip, relu, f_dim, mdt)
    return torch.stack([gh.sum(dim=(0, 1, 2)), (gh * ((x - mean.to(mdt)) * rstd)).sum(dim=(0, 1, 2))])


def grad_apply_twin(g, y, skip, b, gamma, beta, mean, var, local, total, s1, n_all, batch: Batch, relu: bool):
    x, mdt = _work(y, b, batch.f_dim)
    rstd, scale, shift = _norm(gamma, beta, mean, var, mdt)
    mean = mean.to(mdt)
    gh = _passed(g, x, scale, shift, skip, relu, batch.f_dim, mdt)
    inv_n = 1.0 / n_all.to(mdt)
    k1 = scale * total[0].to(mdt) * inv_n
    k2 = scale * rstd * total[1].to(mdt) * inv_n
    corr = k1 + k2 * (x - mean)
    w = _weights(batch, mdt)
    dx = scale * gh - (corr if w is None else w * corr)
    n = batch.n.to(mdt)
    db = scale * local[0].to(mdt) - n * k1 - k2 * (s1.to(mdt) - n * mean)
    return _padded(dx, y), None if skip is None else _padded(gh, y), db


# --- the launches


class ReducePlan(NamedTuple):
    rows_per_block: int
    blocks: int


def reduce_plan(rows: int) -> ReducePlan:
    """A reduction's blocks: consecutive rows, about REDUCE_BLOCKS of them;
    a function of the shape alone, so the sums' order is too."""
    per = -(-rows // REDUCE_BLOCKS)
    return ReducePlan(per, -(-rows // per))


def load_library() -> ctypes.CDLL:
    """Build (first use) and load `csrc/bn_chain.cu`."""
    global _lib
    if _lib is None:
        lib = build.load("bn_chain")
        p, i = ctypes.c_void_p, ctypes.c_int
        signatures = {
            "bn_chain_moments": [p] * 5 + [i] * 8 + [p],
            "bn_chain_apply": [p] * 9 + [i] * 7 + [p],
            "bn_chain_grad_sums": [p] * 10 + [i] * 8 + [p],
            "bn_chain_grad_apply": [p] * 17 + [i] * 8 + [p],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.bn_chain_error_string.restype = ctypes.c_char_p
        lib.bn_chain_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(y, p, skip, add) -> None:
    """Raise unless y is [B, T, NB, fb*C] of C <= 64 channels with float32
    per-channel parameters beside it, skip and add (where given) are like
    y; on the card also unless y is float32 or bf16, contiguous and 16-byte
    aligned."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bn_chain runs on cpu or cuda tensors, not {y.device}")
    C = p["b"].shape[0]
    if y.dim() != 4 or p["b"].dim() != 1 or not 1 <= C <= MAX_CHANNELS or y.shape[3] % C:
        raise ValueError(f"bn_chain wants y [B, T, NB, fb*C] with C <= {MAX_CHANNELS}, got {tuple(y.shape)}, "
                         f"C = {C}")
    for name in ("b", "gamma", "beta"):
        if p[name].shape != (C,) or p[name].device != y.device:
            raise ValueError(f"bn_chain {name} must be [{C}] on {y.device}, got {tuple(p[name].shape)} on "
                             f"{p[name].device}")
    for name, t in (("skip", skip), ("add", add)):
        if t is not None and (t.shape != y.shape or t.dtype != y.dtype or t.device != y.device):
            raise ValueError(f"bn_chain {name} must be like y {tuple(y.shape)} {y.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if y.device.type == "cpu":
        return
    if y.dtype not in _DTYPE_CODES:
        raise ValueError(f"bn_chain takes float32 or bfloat16 on the card, got {y.dtype}")
    if any(p[name].dtype != torch.float32 for name in ("b", "gamma", "beta")):
        raise ValueError("bn_chain takes float32 b, gamma and beta on the card")
    for name, t in (("y", y), ("skip", skip), ("add", add)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"bn_chain {name} must be contiguous and 16-byte aligned on the card")


def _layout(y, b):
    """(rows, T, C, positions) of the blocked tensor y."""
    B, T, nb, fc = y.shape
    C = b.shape[0]
    return B * T, T, C, nb * fc // C


def _frame_mask(batch: Batch, y):
    """(the frame mask as a contiguous float32 tensor or None, its rows)."""
    if batch.frame_mask is None:
        return None, 0
    fm = batch.frame_mask.to(torch.float32).contiguous()
    if fm.dim() != 2 or fm.shape[1] != y.shape[1] or fm.shape[0] not in (1, y.shape[0]):
        raise ValueError(f"bn_chain frame mask must be [1 or B, T], got {tuple(fm.shape)}")
    return fm, fm.shape[0]


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(y) -> int:
    return torch.cuda.current_stream(y.device).cuda_stream


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"bn_chain {what} failed: {lib.bn_chain_error_string(rc).decode()} ({rc})")
